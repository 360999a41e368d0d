"""Separable interior masks and weights on structured node grids.

Twin of ``multigrid_tpu/ops/masks.py``.  On the all-faces-Dirichlet brick
the interior mask is an outer product of per-axis 1-D vectors; it is kept
as those factors and broadcast where it is used, and zeroing the boundary
in place touches only the faces.
"""

from __future__ import annotations

import numpy as np
import torch


def axis_reshape(a: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    shape = [1] * dim
    shape[d] = a.shape[0]
    return a.reshape(shape)


def bcast_and(axes) -> torch.Tensor:
    """Broadcast logical AND of per-axis 1-D boolean tensors."""
    dim = len(axes)
    m = None
    for d, a in enumerate(axes):
        e = axis_reshape(a, d, dim)
        m = e if m is None else m & e
    return m


def interior_axes(shape, device=None) -> tuple[torch.Tensor, ...]:
    """Per-axis interior masks of a node grid (False at both ends)."""
    out = []
    for n in shape:
        m = np.ones(n, bool)
        m[0] = m[-1] = False
        out.append(torch.as_tensor(m, device=device))
    return tuple(out)


def interior_mask(shape, device=None) -> torch.Tensor:
    """Broadcast interior mask of a node grid (True off the boundary)."""
    return bcast_and(interior_axes(shape, device))


def zero_boundary_(x: torch.Tensor) -> torch.Tensor:
    """Zero the Dirichlet faces of ``x`` in place (O(surface) work)."""
    for d in range(x.ndim):
        x.select(d, 0).zero_()
        x.select(d, -1).zero_()
    return x
