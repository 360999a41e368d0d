"""Tensorized 2:1 multigrid transfer on structured node grids.

Twin of ``multigrid_tpu/ops/transfer.py`` ``Transfer`` (replacing deal.II
``MGTransferMatrixFree``, reference common/multigrid_solver.h:208-222):
prolongation applies the 1-D two-child embedding ``P[(2p+1), (p+1)]`` per
axis on coarse-cell windows and scatters to the fine grid with touch-count
weights (1/valence averaging, as deal.II does); ``restrict`` is its exact
adjoint.  The constrained flavor (V-cycle) zeroes Dirichlet nodes on both
levels; the unconstrained one prolongates solutions with boundary values.

Plain PyTorch with no kernel, as the JAX twin is plain XLA.  The JAX
package's TPU flavors of the same operator (``MatmulTransfer``,
``WindowedMatmulTransfer``, ``OzakiMatmulTransfer``,
``OzakiWindowedProlongate``) have no counterpart here: they exist for the
TPU's matrix unit, lane layout and missing fp64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..devices import resolve
from ..mesh.brick import DofGrid
from .laplace import apply_1d
from .masks import zero_boundary_
from .windows import gather_cells, scatter_cells


class Transfer:
    def __init__(self, fine: DofGrid, coarse: DofGrid, dtype=torch.float32,
                 device="cuda", constrained: bool = True):
        assert fine.level == coarse.level + 1
        assert fine.degree == coarse.degree
        device = resolve(device)
        self.fine = fine
        self.coarse = coarse
        self.constrained = constrained
        p = fine.degree
        self.n = p + 1
        self.nf = 2 * p + 1
        P = fine.basis.P
        self.P = torch.as_tensor(P, dtype=dtype, device=device)
        self.Pt = torch.as_tensor(np.ascontiguousarray(P.T), dtype=dtype,
                                  device=device)
        # touch-count weights: fine nodes on interior coarse-cell faces are
        # produced by two coarse windows (kept as 1-D factors)
        self.weight_axes = []
        for d in range(fine.dim):
            ncc = coarse.cells[d]
            line = np.ones(ncc * 2 * p + 1)
            if ncc > 1:
                line[2 * p: -1: 2 * p] = 0.5
            self.weight_axes.append(torch.as_tensor(line, dtype=dtype,
                                                    device=device))

    def _weigh_(self, u: torch.Tensor) -> torch.Tensor:
        """Multiply by the separable touch-count weights in place."""
        dim = u.ndim
        for d, w in enumerate(self.weight_axes):
            shape = [1] * dim
            shape[d] = -1
            u.mul_(w.reshape(shape))
        return u

    def _sweep(self, u: torch.Tensor, window: int, mat: torch.Tensor):
        w = gather_cells(u, window)
        dim = u.ndim
        for d in range(dim):
            w = apply_1d(w, mat, dim + d)
        return scatter_cells(w)

    def prolongate(self, u_coarse: torch.Tensor) -> torch.Tensor:
        u = u_coarse
        if self.constrained:
            u = zero_boundary_(u.clone())
        uf = self._weigh_(self._sweep(u, self.n, self.P))
        if self.constrained:
            zero_boundary_(uf)
        return uf

    def restrict(self, u_fine: torch.Tensor) -> torch.Tensor:
        """Adjoint of :meth:`prolongate` (deal.II ``restrict_and_add`` into
        a zeroed vector, reference common/multigrid_solver.h:667-668)."""
        u = self._weigh_(u_fine.clone())
        if self.constrained:
            zero_boundary_(u)
        uc = self._sweep(u, self.nf, self.Pt)
        if self.constrained:
            zero_boundary_(uc)
        return uc
