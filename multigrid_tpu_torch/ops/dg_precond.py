"""Transformed Jacobi preconditioner for the SIP-DG operator.

Twin of ``multigrid_tpu/ops/dg_precond.py`` ``JacobiTransformed``
(reference common/laplace_operator_dg.h:2028-2256): per cell
``P^-1 = T3 diag(d)^-1 T3^T``, T3 the tensor product of the 1-D SIP
eigenbasis (``core/dg_basis``) and ``d`` the exact operator diagonal in
that basis, the cell's own face terms included.

The diagonal comes from the translation-invariance shortcut: on a uniform
affine mesh a cell's self-coupling block depends only on its
boundary-adjacency category (3 per axis), so a probe mesh of
``min(cells, 3)`` cells per axis yields every category.  On the probe,
each eigenvector is placed in every cell of one checkerboard parity (face
couplings join opposite parities only) and the f64 operator is applied
once per vector: ``2 n^3`` applies in one batch, on the CPU, at set-up.
Only the full ``inv_diag`` block tensor goes to the device; the
fused Chebyshev kernel (``ops/dg_kernel.dg_cheb``) reads it there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..devices import resolve
from .dg import DGGrid, DGLaplace, sweep


def _transformed_diagonals(op: DGLaplace, T3: np.ndarray) -> np.ndarray:
    """d[ci][i] = t_i^T A_{ci,ci} t_i on ``op``'s mesh, without assembling
    any matrix: checkerboard Rayleigh quotients (JAX twin)."""
    grid = op.grid
    dim, n = grid.dim, grid.n
    Nc = n**dim
    cells = grid.cells
    d = np.zeros(cells + (Nc,))
    vecs = T3.T.reshape((Nc,) + (n,) * dim)      # eigenvector i as a block
    for parity in (0, 1):
        sel = [ci for ci in np.ndindex(*cells) if sum(ci) % 2 == parity]
        if not sel:
            continue
        base = np.zeros((Nc,) + cells + (n,) * dim)
        for ci in sel:
            base[(slice(None),) + ci] = vecs
        ys = op.apply(torch.as_tensor(base, dtype=torch.float64)).numpy()
        for ci in sel:
            blk = ys[(slice(None),) + ci].reshape(Nc, Nc)
            d[ci] = np.einsum("ia,ia->i", blk, vecs.reshape(Nc, Nc))
    return d


class JacobiTransformed:
    """P^-1 = T3 diag^-1 T3^T of one uniform affine DG level."""

    def __init__(self, grid: DGGrid, dtype=torch.float32, device="cuda"):
        self.grid = grid
        self.dtype = dtype
        self.device = resolve(device)
        dim, n = grid.dim, grid.n
        self.dim, self.n = dim, n
        b = grid.basis
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=self.device)
        self.T, self.Tt = t(b.T), t(b.T.T)
        T3 = np.array([[1.0]])
        for _ in range(dim):
            T3 = np.kron(T3, b.T)
        probe_cells = tuple(min(c, 3) for c in grid.cells)
        probe = DGGrid(cells=probe_cells, jacobian=grid.jacobian,
                       degree=grid.degree, kind=grid.kind)
        inv_cat = 1.0 / _transformed_diagonals(
            DGLaplace(probe, torch.float64, "cpu"), T3)
        # category of each cell along each axis: first, interior, last
        idx = []
        for d in range(dim):
            C, P = grid.cells[d], probe_cells[d]
            m = np.full(C, min(1, P - 1))
            m[0] = 0
            m[-1] = P - 1
            idx.append(torch.as_tensor(m, device=self.device))
        cat = t(inv_cat)
        self.inv_diag = cat[idx[0][:, None, None], idx[1][None, :, None],
                            idx[2][None, None, :]].reshape(
                                grid.cells + (n,) * dim).contiguous()

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        """P^-1 u = T3 diag^-1 T3^T u (reference
        common/laplace_operator_dg.h:2084-2095)."""
        return sweep(sweep(u, self.Tt, self.dim) * self.inv_diag, self.T,
                     self.dim)
