"""Transformed Jacobi preconditioner for the SIP-DG operator.

Twin of ``multigrid_tpu/ops/dg_precond.py`` ``JacobiTransformed``
(reference common/laplace_operator_dg.h:2028-2256): per cell
``P^-1 = T3 diag(d)^-1 T3^T``, T3 the tensor product of the 1-D SIP
eigenbasis (``core/dg_basis``) and ``d`` the exact operator diagonal in
that basis, the cell's own face terms included.

The diagonal ``d[c][i] = t_i^T A_cc t_i`` comes from checkerboard probes:
each eigenvector is placed in every cell of one parity (face couplings
join opposite parities only) and the f64 operator is applied once per
vector, ``2 n^dim`` applies in all.  On a uniform affine mesh with a
cell-independent operator a cell's self-coupling block depends only on its
boundary-adjacency category (3 per axis), so the probe runs on a mesh of
``min(cells, 3)`` cells per axis, at set-up, on the preconditioner's device
(at p = 9 it applies the operator to 27,000 dofs for each of 1000
eigenvectors).  An operator with per-cell data (``has_cell_data``:
:class:`~.dg.DGLaplaceVarCoeff`) takes the exact general path instead,
probing the real mesh on its device.
A rank's slab of a grid (``whole``) takes its categories from the whole
grid, its ghost cells too: a pointwise pass (the Chebyshev step with
x = 0) applies ``P^-1`` to the ghost cells, whose result an owned cell
then reads, so they must hold the neighbour's inverse diagonal, not that
of a slab edge.
The fused Chebyshev kernel (``ops/dg_kernel.dg_cheb``) reads ``inv_diag``
on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..devices import resolve
from .dg import DGGrid, DGLaplace, sweep

# elements of one probe batch (eigenvectors x dofs), bounding the memory of
# the general path's applies
_PROBE_ELEMENTS = 1 << 24


def _transformed_diagonals(op: DGLaplace, T3: np.ndarray) -> torch.Tensor:
    """d[c..., i] = t_i^T A_{c,c} t_i on ``op``'s mesh and device (fp64
    ``[C..., n^dim]``), without assembling any matrix: checkerboard
    Rayleigh quotients (JAX twin), the eigenvectors in batches."""
    grid = op.grid
    dim, n = grid.dim, grid.n
    Nc = n**dim
    f64, dev = torch.float64, op.device
    vecs = torch.as_tensor(T3.T.reshape((Nc,) + (n,) * dim), dtype=f64,
                           device=dev)       # eigenvector i as a block
    parity = sum(torch.arange(c, device=dev).reshape(
        [c if e == d else 1 for e in range(dim)])
        for d, c in enumerate(grid.cells)) % 2
    d = torch.zeros(grid.cells + (Nc,), dtype=f64, device=dev)
    batch = max(1, min(Nc, _PROBE_ELEMENTS // grid.n_dofs))
    spread = (1,) * dim
    for par in (0, 1):
        mask = (parity == par).to(f64)
        if not bool(mask.any()):
            continue
        for i0 in range(0, Nc, batch):
            v = vecs[i0:i0 + batch]
            v = v.reshape((v.shape[0],) + spread + v.shape[1:])
            ys = op.apply(mask.reshape(mask.shape + spread) * v)
            q = (ys * v).sum(dim=tuple(range(-dim, 0)))   # [B, C...]
            d[..., i0:i0 + v.shape[0]] += (q * mask).movedim(0, -1)
    return d


class JacobiTransformed:
    """P^-1 = T3 diag^-1 T3^T of one DG level.  ``op``: the level's
    operator, if it is not the constant-coefficient ``DGLaplace`` of
    ``grid``; one with per-cell data (``has_cell_data``) is probed exactly
    on its own mesh, any other by boundary-adjacency category.  ``whole =
    (cells, offset)``: ``grid`` is the block of a grid of ``cells`` cells
    starting at cell ``offset`` (a rank's slab), whose categories it
    takes."""

    def __init__(self, grid: DGGrid, dtype=torch.float32, device="cuda",
                 op=None, *, whole=None):
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
        if op is not None and op.grid != grid:
            raise ValueError("JacobiTransformed: op is of another grid")
        if getattr(op, "has_cell_data", False):
            if whole is not None:
                raise ValueError("JacobiTransformed: a slab of an operator "
                                 "with per-cell data is not supported")
            full = _transformed_diagonals(op.astype(torch.float64), T3)
            self.inv_diag = (1.0 / full).to(dtype).reshape(
                grid.shape).to(self.device).contiguous()
            return
        cells, offset = whole if whole is not None else (grid.cells,
                                                         (0,) * dim)
        probe_cells = tuple(min(c, 3) for c in cells)
        probe = DGGrid(cells=probe_cells, jacobian=grid.jacobian,
                       degree=grid.degree, kind=grid.kind)
        d_cat = _transformed_diagonals(
            DGLaplace(probe, torch.float64, self.device), T3).cpu().numpy()
        # category of each cell along each axis: first, interior, last
        idx = []
        for C, P, o, c in zip(cells, probe_cells, offset, grid.cells):
            if not 0 <= o <= o + c <= C:
                raise ValueError(f"JacobiTransformed: cells [{o}, {o + c}) "
                                 f"outside [0, {C})")
            m = np.full(C, min(1, P - 1))
            m[0] = 0
            m[-1] = P - 1
            idx.append(m[o:o + c])
        self.inv_diag = t((1.0 / d_cat)[np.ix_(*idx)].reshape(grid.shape))

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        """P^-1 u = T3 diag^-1 T3^T u (reference
        common/laplace_operator_dg.h:2084-2095)."""
        return sweep(sweep(u, self.Tt, self.dim) * self.inv_diag, self.T,
                     self.dim)
