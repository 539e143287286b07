"""Launchers: the step builders (steps.py), the server (serve.py) and the
trainer (train.py)."""
