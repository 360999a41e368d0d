"""Cell gather and additive scatter on structured node grids.

Twin of ``multigrid_tpu/ops/windows.py`` (``gather_cells``/``scatter_cells``).
Dof vectors are dense node grids ``u[Z, Y, X]``; a cell's dofs are the
``w``-wide window starting at node ``c * (w - 1)`` along every axis, so
neighbouring cells share one node plane.  The JAX twin keeps the cells in
the interleaved layout ``[C0, w, C1, w, C2, w]``; here they are blocked,
``[C0, C1, C2, w, w, w]``, which is what ``Tensor.unfold`` gives.  The
scatter is the exact adjoint of the gather and adds the two windows that
share a node in a fixed order, so it is deterministic.
"""

from __future__ import annotations

import torch


def gather_cells(u: torch.Tensor, window: int) -> torch.Tensor:
    """Node grid ``[N0, ..., N_{d-1}]`` -> strided view ``[C0, ..., C_{d-1},
    w, ..., w]`` with ``out[c..., j...] = u[c * (w - 1) + j, ...]``."""
    out = u
    for d in range(u.ndim):
        out = out.unfold(d, window, window - 1)
    return out


def scatter_axis(y: torch.Tensor, axis: int) -> torch.Tensor:
    """Additive adjoint of one axis' window: ``[..., N, w, ...]`` ->
    ``[..., N * (w - 1) + 1, ...]``, entries of shared nodes summed."""
    n_cells, window = y.shape[axis], y.shape[axis + 1]
    s = window - 1
    shape = y.shape[:axis] + (n_cells * s + 1,) + y.shape[axis + 2:]
    out = y.new_zeros(shape)
    out.narrow(axis, 0, n_cells * s).unflatten(axis, (n_cells, s)).add_(
        y.narrow(axis + 1, 0, s))
    # the last window column lands on nodes (c + 1) * s
    tail = [slice(None)] * out.ndim
    tail[axis] = slice(s, None, s)
    out[tuple(tail)] += y.select(axis + 1, s)
    return out


def scatter_cells(w: torch.Tensor) -> torch.Tensor:
    """Additive adjoint of :func:`gather_cells`: ``[C0, ..., w, ...]`` (any
    strides) -> node grid."""
    dim = w.ndim // 2
    perm = [a for d in range(dim) for a in (d, dim + d)]
    out = w.permute(perm)                      # [C0, w, C1, w, ...]
    for d in range(dim):
        out = scatter_axis(out, d)
    return out
