"""reduce kernel: CUDA wrapper (kernel.py), plain version (ref.py), ops."""
