"""Serving launch: the graph builders (steps.py) and the server (serve.py)."""
