"""Multigrid over adaptively refined mesh hierarchies (poisson_l), global
coarsening.

Twin of ``multigrid_tpu/solvers/multigrid_adaptive.py``.  The reference
solves the hanging-node problem with deal.II's Multigrid with local
smoothing and interface matrices (reference poisson_l/program.cc:338-416;
the port has that too, :mod:`.multigrid_local`).  This solver uses the
global-coarsening formulation (deal.II's MGTransferGlobalCoarsening): the
level spaces are whole active meshes, each nested in the next, the
transfers are point-evaluation gathers between nested meshes, and every
level smooths on its whole mesh.

Mixed precision as the main solver: a float32 V-cycle inside the float64
outer CG (reference common/multigrid_solver.h:437/456).  The operators,
transfers and smoothers are plain PyTorch on every device, as their JAX
twins are plain XLA; the restriction is a deterministic scatter
(:class:`..ops.laplace_general.NodeScatter`), so two solves on the card
agree bit for bit.  On the card the outer CG's vector updates and dots are
the CG kernels (``ops/cg_kernel.py``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..devices import resolve
from ..mesh.adaptive import AdaptiveGrid
from ..ops.laplace_adaptive import AdaptiveLaplace
from ..ops.laplace_general import NodeScatter
from .cg import CGResult, cg_solve
from .chebyshev import Chebyshev
from .multigrid import set_full_precision_matmul


class NestedTransfer:
    """Prolongation = point evaluation of the coarse FE function at the fine
    dof positions; restriction = its exact adjoint."""

    def __init__(self, fine: AdaptiveGrid, coarse: AdaptiveGrid,
                 dtype=torch.float32, device="cuda"):
        dev = resolve(device)
        idx, w = fine.point_eval_table(coarse)
        self.idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        self.w = torch.as_tensor(w, dtype=dtype, device=dev)
        self.fine_interior = torch.as_tensor(~fine.boundary, device=dev)
        self.coarse_interior = torch.as_tensor(~coarse.boundary, device=dev)
        self._scatter = NodeScatter(idx, coarse.n_dofs, dev, allow_empty=True)

    def interpolate(self, uc: torch.Tensor) -> torch.Tensor:
        """The coarse function at the fine dofs, boundary included."""
        return torch.sum(uc[self.idx] * self.w, dim=-1)

    def prolongate(self, uc: torch.Tensor) -> torch.Tensor:
        uf = self.interpolate(torch.where(self.coarse_interior, uc, 0))
        return torch.where(self.fine_interior, uf, 0)

    def restrict(self, rf: torch.Tensor) -> torch.Tensor:
        r = torch.where(self.fine_interior, rf, 0)
        out = self._scatter(r[:, None] * self.w)
        return torch.where(self.coarse_interior, out, 0)


class AdaptiveSystem:
    """The f64 system of the finest grid, shared by both adaptive solvers:
    the Dirichlet data, right-hand side, quadrature values of the exact
    solution and the outer CG (ReductionControl(max_iterations, 1e-16,
    rtol)); the solver supplies ``_precond``."""

    def _setup_system(self, grid: AdaptiveGrid, exact_fn: Callable,
                      rhs_fn: Callable) -> None:
        self.op_dp = op = AdaptiveLaplace(grid, self.f_dtype, self.device)
        dim = grid.dim
        vals = np.asarray(exact_fn([grid.dof_xy[:, d] for d in range(dim)]),
                          float)
        t = lambda a: torch.as_tensor(np.array(a, np.float64),
                                      dtype=self.f_dtype, device=self.device)
        self._boundary = torch.as_tensor(grid.boundary, device=self.device)
        self.u_bc = t(np.where(grid.boundary, vals, 0.0))
        qxy = op.quad_points()
        qc = [qxy[..., d] for d in range(dim)]
        f_quad = np.broadcast_to(np.asarray(rhs_fn(qc), float),
                                 (grid.n_cells, op.N))
        self.rhs = op.compute_rhs(t(f_quad), self.u_bc)
        self.exact_quad = t(exact_fn(qc))

    def solve_cg(self, rtol: float = 1e-9, max_iterations: int = 100):
        """Returns (solution with the boundary values, iterations, mean
        reduction per iteration)."""
        res: CGResult = cg_solve(self.op_dp.vmult, self.rhs,
                                 precond=self._precond,
                                 max_iterations=max_iterations, abs_tol=1e-16,
                                 rtol=rtol)
        its = res.iterations
        red = (res.final_norm / res.initial_norm) ** (1.0 / max(its, 1))
        return torch.where(self._boundary, self.u_bc, res.x), its, float(red)

    def l2_error(self, sol: torch.Tensor) -> float:
        return float(self.op_dp.l2_error(sol, self.exact_quad))


class AdaptiveMultigridSolver(AdaptiveSystem):
    """CG preconditioned by one V-cycle over the nested mesh history
    ``grids`` (coarsest first)."""

    n_pre = 2                   # Chebyshev degree on the finer levels
    v_dtype = torch.float32     # the V-cycle's type
    f_dtype = torch.float64     # the outer CG's type

    def __init__(self, grids: list[AdaptiveGrid], exact_fn: Callable,
                 rhs_fn: Callable, device="cuda"):
        self.device = dev = resolve(device)
        if dev.type == "cuda":
            set_full_precision_matmul()
        self.grids = grids
        self.maxlevel = len(grids) - 1
        v_dtype = self.v_dtype
        self.ops = [AdaptiveLaplace(g, v_dtype, dev) for g in grids]
        self.transfers = [None] + [
            NestedTransfer(grids[l], grids[l - 1], v_dtype, dev)
            for l in range(1, len(grids))]
        self.smoothers = []
        for l, op in enumerate(self.ops):
            if l == 0:
                sm = Chebyshev.create(op, op.precond, smoothing_range=1e-3,
                                      degree=None,
                                      eig_cg_n_iterations=grids[l].n_dofs)
            else:
                sm = Chebyshev.create(op, op.precond, smoothing_range=20.0,
                                      degree=self.n_pre,
                                      eig_cg_n_iterations=15)
            self.smoothers.append(sm)
        self._setup_system(grids[-1], exact_fn, rhs_fn)

    def v_cycle(self, level: int, defect: torch.Tensor) -> torch.Tensor:
        if level == 0:
            return self.smoothers[0].vmult(defect)
        upd = self.smoothers[level].vmult(defect)
        t = self.ops[level].vmult_residual(defect, upd)
        dc = self.transfers[level].restrict(t)
        del t
        corr = self.v_cycle(level - 1, dc)
        upd += self.transfers[level].prolongate(corr)
        return self.smoothers[level].step(upd, defect)

    def _precond(self, r: torch.Tensor) -> torch.Tensor:
        return self.v_cycle(self.maxlevel, r.to(self.v_dtype)).to(self.f_dtype)
