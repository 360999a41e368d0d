"""Dense-element-matrix Laplace apply: the plain version of the brick kernel.

Twin of ``multigrid_tpu/ops/laplace_dense.py``.  For an affine cell with a
constant coefficient the matrix-free operator is exactly the element
stiffness ``K = sum_d c_d kron(A_z, A_y, A_x)`` with ``A_e = L`` on axis d
and ``M`` otherwise (the (p+1)-point Gauss rule integrates it exactly).
One apply is gather -> ``[C, (p+1)^3] @ K`` -> additive scatter, in the
dtype of the operator (float32 or float64; native fp64 replaces the JAX
package's Ozaki limb splitting).  :func:`dense_apply` is the plain PyTorch
version of the brick operator that the CUDA ``brick_kron`` kernel applies:
``BrickLaplace`` (:mod:`.laplace_kernel`) runs it for CPU tensors, with
the Dirichlet masks around it, and the card checks hold the kernel to it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh.brick import DofGrid
from .laplace import DiagCoef, make_diag_coef
from .windows import gather_cells, scatter_cells


def element_matrix(grid: DofGrid, coef: DiagCoef | None = None) -> np.ndarray:
    """Exact element stiffness for the affine brick cell (fp64)."""
    coef = coef if coef is not None else make_diag_coef(grid)
    b = grid.basis
    K = None
    for d in range(grid.dim):
        mat = np.array([[1.0]])
        for e in range(grid.dim):
            mat = np.kron(mat, b.L if e == d else b.M)
        term = coef.values[d] * mat
        K = term if K is None else K + term
    return K


def dense_apply(x: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Unconstrained ``A x``: cell gather, one matmul with the (symmetric)
    element matrix, additive scatter."""
    n = round(K.shape[0] ** (1.0 / x.ndim))
    w = gather_cells(x, n)
    cells = w.shape[:x.ndim]
    y = w.reshape(-1, K.shape[0]) @ K
    return scatter_cells(y.reshape(cells + (n,) * x.ndim))

