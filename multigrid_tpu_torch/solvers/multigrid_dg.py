"""DG-over-CG multigrid solver.

Twin of ``multigrid_tpu/solvers/multigrid_dg.py`` ``MultigridSolverDG``
(reference common/multigrid_solver_dg.h:55-743): the SIP-DG system on the
finest level, solved by an outer f64 CG preconditioned by one
``dg_v_cycle`` = DG Chebyshev (transformed Jacobi) pre-smoothing ->
residual restricted to the FE_Q space -> FE_Q V-cycle -> prolongated back
-> DG post-smoothing (multigrid_solver_dg.h:605-633).

Smoother parameters follow the reference: DG Chebyshev degree ``n_pre``,
smoothing range 20, 15 Lanczos steps; the FE_Q hierarchy below with
coarse range 2e-3 and finest-level degree ``max(1, n_pre - 1)``
(multigrid_solver_dg.h:266-304).  The outer CG uses
ReductionControl(100, 1e-16, tolerance) and reports fractional iterations
``log(tol) / log(rate)`` (multigrid_solver_dg.h:410-424).

The device picks the kernels: on the card the outer CG's A·p is
``dg_apply<double>`` (K9), the smoother's A·x ``dg_apply<float>`` (K7) and
each Chebyshev step ``dg_cheb<float>`` (K8), with the FE_Q V-cycle on the
brick kernels and the CG on the CG vector kernels; on the CPU every call
runs its plain PyTorch version.  ``MultigridSolverDGPlain`` (pure DG
h-multigrid) is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..devices import resolve
from ..mesh.brick import BrickMesh
from ..ops.dg import DGGrid
from ..ops.dg_kernel import DGOperator
from ..ops.dg_precond import JacobiTransformed
from ..ops.dg_transfer import CGDGCoupling
from .cg import CGResult, cg_solve
from .chebyshev import Chebyshev
from .multigrid import MultigridSolver, set_full_precision_matmul


def dg_grid_from_mesh(mesh: BrickMesh, level: int, degree: int,
                      kind: str) -> DGGrid:
    J = np.diag(mesh.h(level))
    return DGGrid(cells=mesh.cells(level),
                  jacobian=tuple(tuple(r) for r in J), degree=degree,
                  kind=kind)


def quad_coords_block(grid: DGGrid, mesh: BrickMesh, level: int):
    """Coordinate arrays broadcastable to the DG block [C..., nq...]."""
    b = grid.basis
    dim = grid.dim
    out = []
    for d in range(dim):
        h = mesh.h(level)[d]
        line = (mesh.origin[d] + h * np.arange(grid.cells[d])[:, None]
                + h * b.quad_points[None, :])
        shape = [1] * (2 * dim)
        shape[d] = grid.cells[d]
        shape[dim + d] = grid.n
        out.append(line.reshape(shape))
    return out


class MultigridSolverDG:
    def __init__(self, mesh: BrickMesh, degree: int, exact_fn: Callable,
                 rhs_fn: Callable, kind: str = "hermite", n_pre: int = 2,
                 n_post: int = 2, device="cuda", v_dtype=torch.float32,
                 f_dtype=torch.float64):
        if n_pre != n_post:
            raise ValueError("the reference requires equal pre/post degree")
        self.device = dev = resolve(device)
        if dev.type == "cuda":
            set_full_precision_matmul()
        self.mesh = mesh
        self.v_dtype, self.f_dtype = v_dtype, f_dtype
        # FE_Q hierarchy with the DG solver's smoother settings
        self.cg = MultigridSolver(
            mesh, degree, exact_fn, rhs_fn, n_pre=n_pre, n_post=n_post,
            n_cycles=1, device=dev, v_dtype=v_dtype, f_dtype=f_dtype,
            coarse_smoothing_range=2e-3, finest_degree=max(1, n_pre - 1))
        L = mesh.max_level
        self.dg_grid = dg_grid_from_mesh(mesh, L, degree, kind)
        self.op = DGOperator(self.dg_grid, v_dtype, dev)      # K7, K8
        self.op_dp = DGOperator(self.dg_grid, f_dtype, dev)   # K9
        self.op_ref = self.op_dp.plain                        # rhs, errors
        self.jacobi = JacobiTransformed(self.dg_grid, v_dtype, dev)
        self.op.install_jacobi(self.jacobi)
        self.coupling = CGDGCoupling(self.cg.grids[L], self.dg_grid, v_dtype,
                                     dev)
        self.smooth_dg = Chebyshev.create(
            self.op, self.jacobi.vmult, smoothing_range=20.0, degree=n_pre,
            eig_cg_n_iterations=15)
        # rhs: DG mass integration of f only (multigrid_solver_dg.h:243-265;
        # the reference applies no weak boundary data here)
        quads = quad_coords_block(self.dg_grid, mesh, L)
        shape = self.dg_grid.shape
        f_quad = torch.tensor(
            np.broadcast_to(np.asarray(rhs_fn(quads), np.float64), shape),
            dtype=f_dtype, device=dev)
        self.rhs = self.op_ref.compute_rhs(f_quad).contiguous()
        del f_quad
        self.exact_quad = torch.tensor(
            np.broadcast_to(np.asarray(exact_fn(quads), np.float64), shape),
            dtype=f_dtype, device=dev)

    def dg_v_cycle(self, defect: torch.Tensor) -> torch.Tensor:
        """multigrid_solver_dg.h:605-633."""
        upd = self.smooth_dg.vmult(defect)
        r = self.op.vmult_residual(defect, upd)
        r_cg = self.coupling.dg_to_cg(r)
        del r
        corr = self.cg.v_cycle(self.cg.maxlevel, r_cg, 1)
        upd += self.coupling.cg_to_dg(corr)
        return self.smooth_dg.step(upd, defect)

    def _precond(self, r: torch.Tensor) -> torch.Tensor:
        return self.dg_v_cycle(r.to(self.v_dtype)).to(self.f_dtype)

    def solve_cg(self, tolerance: float = 1e-3, max_iterations: int = 100):
        """Outer CG on the f64 DG operator (multigrid_solver_dg.h:410-424).
        Returns (solution, fractional iterations, rate per iteration)."""
        res: CGResult = cg_solve(self.op_dp.vmult, self.rhs,
                                 precond=self._precond,
                                 max_iterations=max_iterations, abs_tol=1e-16,
                                 rtol=tolerance)
        its = res.iterations
        rate = (res.final_norm / res.initial_norm) ** (1.0 / max(its, 1))
        frac_its = np.log(tolerance) / np.log(rate) if rate < 1 else np.inf
        return res.x, float(frac_its), float(rate)

    def l2_error(self, u: torch.Tensor, exact_quad: torch.Tensor) -> float:
        return float(self.op_ref.l2_error(u, exact_quad))
