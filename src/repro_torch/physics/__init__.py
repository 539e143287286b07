"""Physics used by the kernels (2-D Euler / FORCE flux)."""
