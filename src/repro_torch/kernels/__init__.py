"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``), each
beside its plain PyTorch version (``ref.py``) and its ops wrapper
(``ops.py``).  ``_build.py`` compiles the sources with ``nvcc``."""
