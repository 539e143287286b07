"""Ripple on PyTorch + CUDA — the port of the JAX package ``repro``.

The module tree mirrors ``repro`` (``core``, ``kernels``, ``physics``,
``tuning``, ``models``, ``launch``, ``runtime``, ``data``, ``optim``,
``checkpoint``), so each port module sits under the same name as its
reference.  The port imports ``torch`` and ``numpy`` only: nothing of JAX
and nothing of ``repro``.  Its kernels are CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` at first use; on a CPU tensor every ops
function computes its plain PyTorch version instead.
"""
