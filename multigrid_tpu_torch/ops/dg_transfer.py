"""DG level transfer and CG <-> DG coupling.

Twin of ``multigrid_tpu/ops/dg_transfer.py``.

* :class:`DGTransfer`: 2:1 prolongation and restriction between DG levels.
  Each coarse cell maps to its 2^dim children through the 1-D embedding
  matrices ``E0``, ``E1`` of ``core/dg_basis``, one axis at a time; no dof
  is shared, so the transfer is a batched contraction (the role of the
  unconstrained ``MGTransferMatrixFree`` in reference
  common/multigrid_solver_dg_plain.h:150-159).
* :class:`CGDGCoupling`: embeds a
continuous FE_Q field into the DG space and restricts DG residuals onto
the FE_Q space -- the reference's ``prolongate_add_cg_to_dg``
(reference common/laplace_operator_dg.h:1863-1894) and the restrict half
of ``vmult_with_merged_ops<action=1>`` (laplace_operator_dg.h:1798-1819).
The port's cell windows are blocked ``[C0, C1, C2, n, n, n]``, which is
already the DG block layout, so no transpose sits between them.  Plain
PyTorch: gathers, three 1-D contractions and a scatter.

Both are plain PyTorch on every device, as the JAX twins are plain XLA
(no Pallas kernel).  In float32 on the card they need full-precision
matrix products: the solvers turn TF32 off
(``solvers/multigrid.set_full_precision_matmul``).
"""

from __future__ import annotations

import torch

from ..devices import resolve
from ..mesh.brick import DofGrid
from .dg import DGGrid, sweep
from .laplace import apply_1d
from .masks import zero_boundary_
from .windows import gather_cells, scatter_cells


class DGTransfer:
    """Between a DG level and the level of half its cells per axis."""

    def __init__(self, fine: DGGrid, coarse: DGGrid, dtype=torch.float32,
                 device="cuda"):
        if tuple(2 * c for c in coarse.cells) != fine.cells:
            raise ValueError(f"DGTransfer: {fine.cells} cells are not twice "
                             f"{coarse.cells}")
        self.fine, self.coarse = fine, coarse
        self.dim = fine.dim
        dev = resolve(device)
        b = fine.basis
        t = lambda a: torch.as_tensor(a.copy(), dtype=dtype, device=dev)
        self.E = [t(b.E0), t(b.E1)]            # child c = E_c coarse
        self.Et = [t(b.E0.T), t(b.E1.T)]

    def prolongate(self, u: torch.Tensor) -> torch.Tensor:
        """Coarse block ``[C..., n...]`` -> fine block ``[2C..., n...]``."""
        dim = self.dim
        for d in range(dim):
            u = torch.stack([apply_1d(u, E, d - dim) for E in self.E],
                            dim=d + 1).flatten(d, d + 1)
        return u.contiguous()

    def restrict(self, v: torch.Tensor) -> torch.Tensor:
        """The adjoint: fine block -> coarse block."""
        dim = self.dim
        for d in range(dim):
            v = v.unflatten(d, (v.shape[d] // 2, 2))
            v = (apply_1d(v.select(d + 1, 0), self.Et[0], d - dim)
                 + apply_1d(v.select(d + 1, 1), self.Et[1], d - dim))
        return v.contiguous()


class CGDGCoupling:
    """Between an FE_Q node grid and a DG field on the same mesh level."""

    def __init__(self, cg_grid: DofGrid, dg_grid: DGGrid, dtype=torch.float32,
                 device="cuda", faces=()):
        """``faces``: whether the low and high faces of each leading axis
        of ``cg_grid`` are Dirichlet faces (a rank's box pair: not at a
        cut, where :meth:`dg_to_cg` leaves the ghost planes to the
        refresh); the axes it leaves out are."""
        assert cg_grid.cells == dg_grid.cells
        assert cg_grid.degree == dg_grid.degree
        self.cg, self.dg = cg_grid, dg_grid
        faces = [tuple(f) for f in faces]
        self.faces = faces + [(True, True)] * (cg_grid.dim - len(faces))
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
        problem, reference common/multigrid_solver_dg.h:118-148); a face
        at a cut (``faces``) is not zeroed."""
        out = scatter_cells(sweep(r_dg, self.Et, self.dim))
        if all(all(pair) for pair in self.faces):
            return zero_boundary_(out)
        for d, pair in enumerate(self.faces):
            for side, zero in zip((0, -1), pair):
                if zero:
                    out.select(d, side).zero_()
        return out
