"""Multigrid on mapped multiblock (curved) meshes: FMG and V-cycle-PCG.

Twin of ``multigrid_tpu/solvers/multigrid_general.py``
``GeneralMultigridSolver``: the algorithm of
:class:`.multigrid.MultigridSolver` (reference
common/multigrid_solver.h) on the general-geometry operators --
per-quad-point merged coefficients, index-table gather and scatter,
multiblock transfers.  poisson_shell (variable coefficient, curved shell)
and ``poisson_cube --deform`` solve with it, and minimal_surface's Newton
loop uses it as the linear solver.

Two specializations, as the reference's:

* mixed precision (default): a float32 V-cycle inside float64 FMG
  residuals and an outer float64 CG;
* ``pure_double=True``: an all-float64 V-cycle with fourth-kind
  Chebyshev smoothing on the fine levels, the reference's pairing
  (common/multigrid_solver.h:789-1285, esp. 945-963).

Smoothing: Chebyshev of degree ``n_pre`` over the range 20 on the fine
levels (15 Lanczos steps), and first-kind Chebyshev with an automatic
degree over the range 1e-3 as the coarse solver, its Lanczos run for
``n_dofs`` steps.  The operators, transfers and smoothers are plain
PyTorch on every device (their JAX twins are plain XLA); the outer CG's
vector updates and dots are the CG kernels (``ops/cg_kernel.py``) on the
card.  The JAX package's TPU devices -- compensated f32 pairs
(``dp_df64``), matrix-unit operator forms (``use_mxu``), the block-padded
layout (``block_mode``, ``bp_pad``), jit and pytree plumbing -- have no
counterpart here.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..devices import resolve
from ..mesh.mapped import GeneralGrid, MappedMesh
from ..ops.laplace_general import GeneralLaplace
from ..ops.transfer_general import GeneralTransfer
from .cg import CGResult, cg_solve
from .chebyshev import (FIRST_KIND, FOURTH_KIND, Chebyshev,
                        eig_estimate_start_vector, estimate_eigenvalues,
                        interval_from_spectrum)
from .multigrid import set_full_precision_matmul


class GeneralMultigridSolver:
    """Parameters mirror the JAX twin's (without its TPU options):
    analytic solution (Dirichlet data), right-hand side, coefficient
    callable, pre/post smoothing degree, V-cycles per FMG level and
    ``pure_double``, which fixes the V-cycle's dtype and the fine levels'
    Chebyshev kind (``v_dtype``, ``chebyshev_kind``); ``device`` holds
    every level's tensors (the card unless the caller passes ``"cpu"``)."""

    def __init__(self, mesh: MappedMesh, degree: int, exact_fn: Callable,
                 rhs_fn: Callable, coef_fn: Optional[Callable] = None,
                 n_pre: int = 2, n_post: int = 2, n_cycles: int = 1,
                 pure_double: bool = False, device="cuda"):
        if n_pre != n_post:
            raise ValueError("the reference requires equal pre/post degree")
        self.device = dev = resolve(device)
        if dev.type == "cuda":
            set_full_precision_matmul()
        f_dtype = torch.float64
        v_dtype = f_dtype if pure_double else torch.float32
        self.mesh = mesh
        self.degree = degree
        self.n_cycles = n_cycles
        self.n_pre = n_pre
        self.chebyshev_kind = FOURTH_KIND if pure_double else FIRST_KIND
        self.v_dtype, self.f_dtype = v_dtype, f_dtype
        self.minlevel = 0
        self.maxlevel = mesh.max_level
        L = mesh.n_levels

        self.grids = [GeneralGrid(mesh, l, degree) for l in range(L)]
        self.ops, self.ops_dp = [], []
        for g in self.grids:
            coef = g.merged_coefficient(coef_fn)
            dp = GeneralLaplace(g, f_dtype, coef=coef, device=dev)
            self.ops_dp.append(dp)
            self.ops.append(dp if v_dtype == f_dtype else
                            GeneralLaplace(g, v_dtype, coef=coef, device=dev))
        self.transfers = [None] + [
            GeneralTransfer(self.grids[l], self.grids[l - 1], v_dtype, True,
                            dev) for l in range(1, L)]
        self.transfers_nobc = [None] + [
            GeneralTransfer(self.grids[l], self.grids[l - 1], f_dtype, False,
                            dev) for l in range(1, L)]

        # boundary data (nonzero only on Dirichlet nodes), rhs from the
        # f64 operator, the exact solution at the quadrature points
        self.bmask = [op.interior.logical_not() for op in self.ops_dp]
        self.u_bc, self.rhs, self.exact_quad = [], [], []
        t = lambda a: torch.tensor(np.asarray(a, np.float64), dtype=f_dtype,
                                   device=dev)
        for l, g in enumerate(self.grids):
            vals = np.asarray(exact_fn([g.node_coords[:, d]
                                        for d in range(g.dim)]), np.float64)
            self.u_bc.append(t(np.where(g.boundary, vals, 0.0)))
            qc = [g.quad_coords[..., d] for d in range(g.dim)]
            shape = self.ops_dp[l].cell_shape
            fq = np.broadcast_to(np.asarray(rhs_fn(qc), np.float64),
                                 g.jxw.shape)
            self.rhs.append(self.ops_dp[l].compute_rhs(
                t(fq.reshape(shape)), self.u_bc[l]))
            eq = np.broadcast_to(np.asarray(exact_fn(qc), np.float64),
                                 g.jxw.shape)
            self.exact_quad.append(t(eq.reshape(shape)))
        self.smoothers = [None] * L
        self._setup_smoothers()

    # ------------------------------------------------------------- set-up
    def _setup_smoothers(self) -> None:
        """Every level's point-Jacobi diagonal and Chebyshev interval from
        a CG-Lanczos estimate on the current operators."""
        for l, op in enumerate(self.ops):
            op.inv_diag = op.inverse_diagonal()
            n_it = 15 if l > self.minlevel else op.n_dofs
            rhs0 = eig_estimate_start_vector(op.shape, op.dtype, op.device)
            max_eig, min_eig = estimate_eigenvalues(op.vmult, op.inv_diag.mul,
                                                    n_it, rhs0)
            if l > self.minlevel:
                kind = self.chebyshev_kind
                theta, delta, n_apps = interval_from_spectrum(
                    max_eig, min_eig, 20.0, self.n_pre, kind)
            else:
                kind = FIRST_KIND
                theta, delta, n_apps = interval_from_spectrum(
                    max_eig, min_eig, 1e-3, None, kind)
            self.smoothers[l] = Chebyshev(op, theta, delta, n_apps, max_eig,
                                          min_eig, kind)

    def update_coefficients(self, coefs) -> None:
        """Replace every level's merged coefficient (tensors or arrays
        shaped like ``op.C``), then its diagonal and Chebyshev interval:
        the per-Newton-step refresh of minimal_surface (reference
        minimal_surface/program.cc:458-489).  Unlike the JAX twin, whose
        smoothers keep the set-up's ``max_eig``, the fourth kind's bound
        is refreshed too."""
        for l, C in enumerate(coefs):
            C = torch.as_tensor(C, device=self.device)
            self.ops_dp[l].C = C.to(self.f_dtype)
            if self.ops[l] is not self.ops_dp[l]:
                self.ops[l].C = C.to(self.v_dtype)
        self._setup_smoothers()

    # ------------------------------------------------------------ v-cycle
    def v_cycle(self, level: int, defect: torch.Tensor,
                n_cyc: int) -> torch.Tensor:
        """Returns the correction; reference multigrid_solver.h:640-681."""
        sm = self.smoothers[level]
        if level == self.minlevel:
            return sm.vmult(defect)
        upd = None
        for _ in range(n_cyc):
            upd = sm.vmult(defect) if upd is None else sm.step(upd, defect)
            t = self.ops[level].vmult_residual(defect, upd)
            dc = self.transfers[level].restrict(t)
            del t
            corr = self.v_cycle(level - 1, dc, 1)
            upd = upd + self.transfers[level].prolongate(corr)
            upd = sm.step(upd, defect)
        return upd

    def _fmg(self) -> torch.Tensor:
        """Full multigrid; returns the finest solution without boundary
        values."""
        sm0 = self.smoothers[0]
        d0 = self.rhs[0].to(self.v_dtype)
        sol = sm0.step(sm0.vmult(d0), d0).to(self.f_dtype)
        for l in range(1, self.maxlevel + 1):
            sol_bc = torch.where(self.bmask[l - 1], self.u_bc[l - 1], sol)
            sol = self.transfers_nobc[l].prolongate(sol_bc)
            sol = torch.where(self.bmask[l], 0.0, sol)
            res = self.ops_dp[l].vmult_residual(self.rhs[l], sol)
            upd = self.v_cycle(l, res.to(self.v_dtype), self.n_cycles)
            sol = sol + upd.to(self.f_dtype)
        return sol

    def solve(self) -> torch.Tensor:
        """FMG solve; the finest-level solution with its boundary values."""
        L = self.maxlevel
        return torch.where(self.bmask[L], self.u_bc[L], self._fmg())

    def _precond(self, r: torch.Tensor) -> torch.Tensor:
        return self.v_cycle(self.maxlevel, r.to(self.v_dtype),
                            1).to(self.f_dtype)

    def solve_cg(self, rtol: float = 1e-9, abs_tol: float = 1e-16,
                 max_iterations: int = 1000, b=None):
        """CG on the f64 operator preconditioned by one V-cycle; ``b``
        replaces the right-hand side (the Newton steps pass their
        residual).  Returns (solution with boundary values, iterations,
        reduction per iteration)."""
        L = self.maxlevel
        res: CGResult = cg_solve(self.ops_dp[L].vmult,
                                 self.rhs[L] if b is None else b,
                                 precond=self._precond,
                                 max_iterations=max_iterations,
                                 abs_tol=abs_tol, rtol=rtol)
        its = res.iterations
        red = (res.final_norm / res.initial_norm) ** (1.0 / max(its, 1))
        return torch.where(self.bmask[L], self.u_bc[L], res.x), its, red

    # ----------------------------------------------------------- analysis
    def l2_error(self, level: int, sol: torch.Tensor) -> float:
        u = torch.where(self.bmask[level], self.u_bc[level], sol)
        return float(self.ops_dp[level].l2_error(u, self.exact_quad[level]))

    def v_cycle_timed(self, level: int, defect: torch.Tensor, n_cyc: int,
                      timings) -> torch.Tensor:
        """Instrumented V-cycle filling a ``utils.timing.LevelTimings``
        table (cf. reference common/multigrid_solver.h:347-371)."""
        sm = self.smoothers[level]
        if level == self.minlevel:
            return timings.coarse(sm.vmult, defect)
        upd = None
        for _ in range(n_cyc):
            if upd is None:
                upd = timings.timed(level, "smoother", sm.vmult, defect)
            else:
                upd = timings.timed(level, "smoother", sm.step, upd, defect)
            t = timings.timed(level, "mg_mv", self.ops[level].vmult_residual,
                              defect, upd)
            dc = timings.timed(level, "restrict",
                               self.transfers[level].restrict, t)
            corr = self.v_cycle_timed(level - 1, dc, 1, timings)
            pro = timings.timed(level, "prolongate",
                                self.transfers[level].prolongate, corr)
            upd = timings.timed(level, "mg_vec", torch.add, upd, pro)
            upd = timings.timed(level, "smoother", sm.step, upd, defect)
        return upd
