"""Kernel tile registry (``tiles.py``); the measured autotuner is ROADMAP
item 9."""
