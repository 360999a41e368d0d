"""CG <-> DG coupling on one mesh level.

Twin of ``multigrid_tpu/ops/dg_transfer.py`` ``CGDGCoupling``: embeds a
continuous FE_Q field into the DG space and restricts DG residuals onto
the FE_Q space -- the reference's ``prolongate_add_cg_to_dg``
(reference common/laplace_operator_dg.h:1863-1894) and the restrict half
of ``vmult_with_merged_ops<action=1>`` (laplace_operator_dg.h:1798-1819).
The port's cell windows are blocked ``[C0, C1, C2, n, n, n]``, which is
already the DG block layout, so no transpose sits between them.  Plain
PyTorch: gathers, three 1-D contractions and a scatter, as the JAX twin is
plain XLA.  ``DGTransfer`` (DG h-multigrid) is not ported yet.
"""

from __future__ import annotations

import torch

from ..devices import resolve
from ..mesh.brick import DofGrid
from .dg import DGGrid, sweep
from .masks import zero_boundary_
from .windows import gather_cells, scatter_cells


class CGDGCoupling:
    """Between an FE_Q node grid and a DG field on the same mesh level."""

    def __init__(self, cg_grid: DofGrid, dg_grid: DGGrid, dtype=torch.float32,
                 device="cuda"):
        assert cg_grid.cells == dg_grid.cells
        assert cg_grid.degree == dg_grid.degree
        self.cg, self.dg = cg_grid, dg_grid
        self.dim = cg_grid.dim
        self.n = cg_grid.degree + 1
        dev = resolve(device)
        E = dg_grid.basis.nodal_from_gll
        self.E = torch.as_tensor(E, dtype=dtype, device=dev)
        self.Et = torch.as_tensor(E.T.copy(), dtype=dtype, device=dev)

    def cg_to_dg(self, u_cg: torch.Tensor) -> torch.Tensor:
        """Embed (node values read with their boundary, as the reference's
        compressed read does) and change basis; contiguous DG block."""
        return sweep(gather_cells(u_cg, self.n), self.E, self.dim).contiguous()

    def dg_to_cg(self, r_dg: torch.Tensor) -> torch.Tensor:
        """Adjoint: to nodal coefficients, scatter-add into the node grid,
        Dirichlet rows zero (the CG hierarchy solves the constrained
        problem, reference common/multigrid_solver_dg.h:118-148)."""
        return zero_boundary_(scatter_cells(sweep(r_dg, self.Et, self.dim)))
