"""PyTorch + CUDA port of the matrix-free geometric-multigrid FEM solver.

The JAX package ``multigrid_tpu`` is the reference this package is held
against; this package imports ``torch`` and numpy, never ``jax`` or
``multigrid_tpu``.  The layout mirrors the JAX package (``core/ mesh/ ops/
solvers/ utils/``), so every module has one JAX twin under the same path.

On CPU tensors every kernel wrapper runs its plain PyTorch version; on CUDA
tensors it launches the hand-written Hopper kernel from ``csrc/`` (built at
first use by :mod:`multigrid_tpu_torch._build`) or raises.
"""
