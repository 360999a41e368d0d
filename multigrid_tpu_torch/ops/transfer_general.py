"""Multigrid transfer on mapped multiblock meshes.

Twin of ``multigrid_tpu/ops/transfer_general.py`` ``GeneralTransfer`` (the
general-geometry counterpart of :mod:`.transfer`, i.e. of deal.II
``MGTransferMatrixFree``): per coarse cell, the 2^dim children's nodes are
the 1-D two-child embedding applied per axis; shared fine nodes are
averaged by their valence.  ``restrict`` is the adjoint of ``prolongate``;
``restrict_solution`` evaluates a fine FE function at the coarse nodes
(minimal_surface's level coefficients).  The constrained flavor (V-cycle)
zeroes Dirichlet nodes on both levels.

Plain PyTorch, as the JAX twin is plain XLA; the scatters are the
deterministic :class:`.laplace_general.NodeScatter`.  The JAX package's
``GeneralTransferDF64`` (compensated f32 pairs for the TPU) has no
counterpart: float64 is native here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.quadrature import lagrange_values
from ..devices import resolve
from ..mesh.mapped import GeneralGrid
from .laplace import apply_1d
from .laplace_general import NodeScatter, grid_tables


class GeneralTransfer:
    def __init__(self, fine: GeneralGrid, coarse: GeneralGrid,
                 dtype=torch.float32, constrained: bool = True,
                 device="cuda"):
        assert fine.level == coarse.level + 1
        self.fine, self.coarse = fine, coarse
        self.dtype = dtype
        self.constrained = constrained
        self.device = device = resolve(device)
        self.dim = dim = fine.dim
        self.n = n = fine.n
        nodes = fine.basis.nodes
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        E = [lagrange_values(nodes, nodes * 0.5),
             lagrange_values(nodes, 0.5 + nodes * 0.5)]
        self.E = [t(e) for e in E]
        self.Et = [t(e.T) for e in E]
        # restriction of a solution: the fine FE function at the coarse
        # nodes that lie in each child (each coarse node in exactly one)
        self.R = []
        for so in (0, 1):
            inside = (nodes <= 0.5 + 1e-14) if so == 0 else (nodes > 0.5 + 1e-14)
            self.R.append(t(lagrange_values(nodes, 2.0 * nodes - so)
                            * inside[:, None]))
        self.offsets = list(np.ndindex(*(2,) * dim))
        child_cells = coarse.child_cells()                  # [Cc, 2^dim]
        # the children's nodes, [Cc, 2^dim, n^dim] flattened
        child_nodes = fine.cell_nodes[child_cells]
        self.child_nodes = torch.as_tensor(child_nodes.reshape(-1),
                                           dtype=torch.int64, device=device)
        self.prolong_scatter = NodeScatter(child_nodes, fine.n_dofs, device)
        self.coarse_nodes, self.coarse_scatter, self.coarse_interior = \
            grid_tables(coarse, device)
        _, _, self.fine_interior = grid_tables(fine, device)
        counts = np.bincount(fine.cell_nodes.reshape(-1), minlength=fine.n_dofs)
        self.weights = t(1.0 / counts)
        coarse_counts = np.bincount(coarse.cell_nodes.reshape(-1),
                                    minlength=coarse.n_dofs)
        self.coarse_counts = t(coarse_counts)
        self.coarse_cell_shape = (coarse.n_cells,) + (n,) * dim
        self.children_shape = ((coarse.n_cells, 2 ** dim) + (n,) * dim)

    def _children(self, u: torch.Tensor) -> torch.Tensor:
        """The fine values of every coarse cell's children,
        ``[Cc, 2^dim, n, .., n]``."""
        return u.index_select(0, self.child_nodes).view(self.children_shape)

    def prolongate(self, u_coarse: torch.Tensor) -> torch.Tensor:
        u = u_coarse
        if self.constrained:
            u = torch.where(self.coarse_interior, u, 0)
        wc = u.index_select(0, self.coarse_nodes).view(self.coarse_cell_shape)
        wf = []
        for offs in self.offsets:
            w = wc
            for d, s in enumerate(offs):
                w = apply_1d(w, self.E[s], 1 + d)
            wf.append(w)
        # contributions agree on shared nodes: valence averaging is exact
        out = self.prolong_scatter(torch.stack(wf, 1)) * self.weights
        if self.constrained:
            out = torch.where(self.fine_interior, out, 0)
        return out

    def restrict(self, u_fine: torch.Tensor) -> torch.Tensor:
        u = u_fine
        if self.constrained:
            u = torch.where(self.fine_interior, u, 0)
        wf = self._children(u * self.weights)
        acc = None
        for s, offs in enumerate(self.offsets):
            w = wf[:, s]
            for d, so in enumerate(offs):
                w = apply_1d(w, self.Et[so], 1 + d)
            acc = w if acc is None else acc + w
        out = self.coarse_scatter(acc)
        if self.constrained:
            out = torch.where(self.coarse_interior, out, 0)
        return out

    def restrict_solution(self, u_fine: torch.Tensor) -> torch.Tensor:
        """Pointwise FE restriction of a *solution* (not a residual): coarse
        node values are the fine FE function at the coarse node points, the
        role of deal.II ``get_restriction_matrix`` in minimal_surface's
        level-coefficient set-up (reference
        minimal_surface/program.cc:416-457)."""
        wf = self._children(u_fine)
        acc = None
        for s, offs in enumerate(self.offsets):
            w = wf[:, s]
            for d, so in enumerate(offs):
                w = apply_1d(w, self.R[so], 1 + d)
            acc = w if acc is None else acc + w
        return self.coarse_scatter(acc) / self.coarse_counts
