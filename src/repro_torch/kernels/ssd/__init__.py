"""ssd kernel: CUDA wrapper (kernel.py), plain versions (ref.py), ops."""
