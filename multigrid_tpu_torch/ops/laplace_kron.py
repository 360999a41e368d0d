"""Separable (Kronecker) form of the brick operator: the tap tables of the
``brick_kron`` kernel and its plain PyTorch arithmetic.

Twin of ``multigrid_tpu/ops/laplace_kron.py`` (numpy copies of
``assembled_1d`` and ``_diagonals``; the JAX module is not imported).  On
a brick with uniform cells per axis and a constant coefficient the
assembled operator factorises exactly,

    A = sum_d c_d G_{L,d} (x) prod_{e != d} G_{M,e},

with the assembled 1-D mass and stiffness matrices of half-bandwidth p.
An interior row i of either has the taps ``G[i, i + k - p]`` (k = 0..2p)
of its residue ``i mod p``; :func:`kron_taps` gives the p rows of taps per
matrix that the kernel (``csrc/brick_kron.cuh``) takes as parameters, and
:func:`brick_kron_plain` applies them with the kernel's masking: Dirichlet
nodes of x read as 0, every row uses the interior taps of its residue, and
Dirichlet rows are written as 0.  The tests hold the tables and that
arithmetic against the JAX package; the solve's on-card oracle is the
dense element path (``laplace_kernel.brick_apply_plain``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh.brick import DofGrid
from .masks import interior_mask


def _assemble(basis, cells: int) -> tuple[np.ndarray, np.ndarray]:
    p = basis.degree
    n = cells * p + 1
    M = np.zeros((n, n))
    L = np.zeros((n, n))
    for c in range(cells):
        s = slice(c * p, c * p + p + 1)
        M[s, s] += basis.M
        L[s, s] += basis.L
    return M, L


def assembled_1d(grid: DofGrid, axis: int) -> tuple[np.ndarray, np.ndarray]:
    """Global assembled 1-D (mass, stiffness) matrices along ``axis``
    (reference-element matrices tiled over the axis' cells with shared-node
    overlap; fp64)."""
    return _assemble(grid.basis, grid.cells[axis])


def diagonals(G: np.ndarray, p: int) -> list[np.ndarray]:
    """Banded matrix -> aligned diagonals ``D[k][i] = G[i, i + k - p]``
    (zero outside the matrix), k = 0..2p."""
    n = G.shape[0]
    out = []
    for d in range(-p, p + 1):
        D = np.zeros(n)
        i0, i1 = max(0, -d), min(n, n - d)
        D[i0:i1] = G[np.arange(i0, i1), np.arange(i0, i1) + d]
        out.append(D)
    return out


def residue_taps(G: np.ndarray, p: int) -> np.ndarray:
    """``[p, 2p + 1]`` taps of the interior rows of an assembled 1-D matrix
    of at least three cells, by residue: row ``p + r`` stands for residue
    r (a vertex row for r = 0)."""
    D = diagonals(G, p)
    return np.array([[D[k][p + r] for k in range(2 * p + 1)]
                     for r in range(p)])


def kron_taps(grid: DofGrid, coef_values) -> np.ndarray:
    """The kernel's table, fp64 ``[4, p, 2p + 1]``: mass taps, then
    ``c_d`` times the stiffness taps for d = 0 (z), 1 (y), 2 (x).  The
    taps depend only on the reference element (uniform cells), so they are
    read off a three-cell line."""
    p = grid.degree
    M, L = _assemble(grid.basis, 3)
    tm, tl = residue_taps(M, p), residue_taps(L, p)
    return np.stack([tm] + [c * tl for c in coef_values])


def _sweep(u: torch.Tensor, taps: torch.Tensor, axis: int) -> torch.Tensor:
    """``out[i] = sum_k taps[i mod p, k] u[i + k - p]`` along ``axis``
    (zero outside the grid)."""
    p = taps.shape[0]
    n = u.shape[axis]
    pad = [0, 0] * u.ndim
    pad[2 * (u.ndim - 1 - axis):2 * (u.ndim - axis)] = [p, p]
    up = torch.nn.functional.pad(u, pad)
    rows = taps[torch.arange(n, device=u.device) % p]          # [n, 2p + 1]
    shape = [1] * u.ndim
    shape[axis] = n
    out = None
    for k in range(2 * p + 1):
        t = rows[:, k].reshape(shape) * up.narrow(axis, k, n)
        out = t if out is None else out + t
    return out


def brick_kron_plain(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """y = A x by the seven banded sweeps of the kernel, in x's dtype:
    Dirichlet nodes of x read as 0 and are written as 0."""
    t = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    m = interior_mask(x.shape, x.device)
    u = torch.where(m, x, 0)
    v1, v2 = _sweep(u, t[0], 2), _sweep(u, t[3], 2)
    w1 = _sweep(v1, t[0], 1)
    w23 = _sweep(v1, t[2], 1) + _sweep(v2, t[0], 1)
    y = _sweep(w1, t[1], 0) + _sweep(w23, t[0], 0)
    return torch.where(m, y, 0)
