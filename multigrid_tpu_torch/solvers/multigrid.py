"""Mixed-precision geometric multigrid solver (FMG + CG-with-V-cycle).

Twin of ``multigrid_tpu/solvers/multigrid.py`` ``MultigridSolver``
(reference common/multigrid_solver.h:96-782): a float32 V-cycle inside a
float64 outer iteration, Chebyshev smoothing (degree = n_pre on fine levels,
Chebyshev with an automatic degree as the coarse solver), 2:1 tensorized
transfers, inhomogeneous Dirichlet data by residual lifting.  The casts sit
at the reference's two points: dp residual -> sp defect
(multigrid_solver.h:437) and sp correction -> dp solution
(multigrid_solver.h:456).

The hot path is picked by the device: on a CUDA device every operator
apply, residual, Chebyshev update and CG vector update launches one of the
hand-written kernels (``ops/laplace_kernel.py``, ``ops/cg_kernel.py``); on
the CPU the same calls run their plain PyTorch versions.  The brick
kernels are 3-D: a 2-D level runs the plain ``LaplaceOperator`` on every
device (a :class:`~.fused.PlainLevel`), chosen from the dimension when
the level is built, as the JAX package runs XLA there; the outer CG still
runs on the CG kernels.  There is no other switch.  TF32 is turned off for
float32 matrix products on the card, so the plain float32 code is a
full-float32 oracle.

``parallel.distributed.DistributedMultigrid`` runs this class's V-cycle,
FMG and CG on boxes of cells over ranks; its hooks here are the inner products
(``_cg_dot``, ``_norm``, the smoothers' ``dot``), faces given as None in
``_impose_bc`` and the ``box`` of ``_level_rhs``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..devices import resolve
from ..mesh.brick import BrickMesh, DofGrid
from ..ops.laplace import (LaplaceOperator, compute_bc_slab_correction_host,
                           compute_rhs_host, l2_error_host, make_diag_coef,
                           quad_coords_blocked, _scatter_pair_host)
from ..ops.laplace_kernel import BrickLaplace
from ..ops.masks import zero_boundary_
from ..ops.transfer import Transfer
from .cg import CGResult, cg_solve
from .chebyshev import Chebyshev
from .fused import PlainLevel

# above this many dofs the rhs is assembled on the device from separable
# factors and the L2 error is taken on the host (multigrid_solver.py twin)
_HOST_ASSEMBLY_DOFS = 4_000_000


def _bc_faces_host(g: DofGrid, exact_fn) -> list[np.ndarray]:
    """Analytic boundary values as 2*dim face slabs (axis d kept with
    extent 1), ordered [(d, side) for d for side in (0, 1)]."""
    nodes = g.node_coords()
    faces = []
    for d in range(g.dim):
        for side in (0, 1):
            idx = 0 if side == 0 else g.shape[d] - 1
            sub = [np.take(a, [idx], axis=d) if e == d else a
                   for e, a in enumerate(nodes)]
            shp = list(g.shape)
            shp[d] = 1
            vals = np.broadcast_to(np.asarray(exact_fn(sub), np.float64), shp)
            faces.append(np.ascontiguousarray(vals))
    return faces


def _dense_bc_host(g: DofGrid, faces: list[np.ndarray]) -> np.ndarray:
    """Dense host u_bc node grid from face slabs (host rhs assembly only)."""
    out = np.zeros(g.shape, np.float64)
    i = 0
    for d in range(g.dim):
        for side in (0, 1):
            idx = [slice(None)] * g.dim
            idx[d] = slice(0, 1) if side == 0 else slice(g.shape[d] - 1,
                                                         g.shape[d])
            out[tuple(idx)] = faces[i]
            i += 1
    return out


def set_full_precision_matmul() -> None:
    """Full-float32 matrix products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class MultigridSolver:
    """FE_Q(p) Poisson multigrid on a structured 2-D or 3-D brick.

    Parameters mirror the reference constructor
    (common/multigrid_solver.h:100-106): analytic solution (Dirichlet data),
    right-hand side, constant coefficient, pre/post smoothing degree, number
    of V-cycles per FMG level; ``device`` holds every level's tensors (the
    card unless the caller passes ``"cpu"``).  ``finest_degree`` replaces
    ``n_pre`` as the finest level's smoothing degree (the DG solver's FE_Q
    hierarchy uses ``max(1, n_pre - 1)``, reference
    common/multigrid_solver_dg.h:266-304).
    """

    # the outer CG's inner product: None is cg_solve's own (the whole
    # vector); a decomposed solver sets its sum over the ranks' owned planes
    _cg_dot: Optional[Callable] = None

    def __init__(self, mesh: BrickMesh, degree: int, exact_fn: Callable,
                 rhs_fn: Callable, coefficient: float = 1.0, n_pre: int = 2,
                 n_post: int = 2, n_cycles: int = 1, device="cuda",
                 v_dtype=torch.float32, f_dtype=torch.float64,
                 coarse_smoothing_range: float = 1e-3,
                 finest_degree: Optional[int] = None):
        if n_pre != n_post:
            raise ValueError("the reference requires equal pre/post degree")
        self.device = resolve(device)
        if self.device.type == "cuda":
            set_full_precision_matmul()
        self.mesh = mesh
        self.degree = degree
        self.coefficient = coefficient
        self.n_cycles = n_cycles
        self.v_dtype = v_dtype
        self.f_dtype = f_dtype
        self.minlevel = 0
        self.maxlevel = mesh.max_level
        L = mesh.n_levels
        dev = self.device

        self.grids = [DofGrid(mesh, l, degree) for l in range(L)]
        coefs = [make_diag_coef(g, coefficient) for g in self.grids]
        # sum-factorized oracle: diagonal for the Lanczos estimate, L2 errors
        self.ops_dp = [LaplaceOperator(g, f_dtype, c, dev)
                       for g, c in zip(self.grids, coefs)]
        # the smoothers' preconditioner: the inverse diagonal in float32
        precond = [LaplaceOperator(g, v_dtype, c, dev).inverse_diagonal().mul
                   for g, c in zip(self.grids, coefs)]
        # hot path: the brick kernels (plain versions on the CPU); brick_kron
        # is 3-D, so a 2-D level runs the plain operator on every device (the
        # JAX package runs XLA there, multigrid_tpu/solvers/multigrid.py:195,
        # 215: ``g.dim == 3``), whose Dirichlet rows are the kernel's:
        # identity rows of A
        if mesh.dim == 3:
            self.sp_ops = [BrickLaplace(g, v_dtype, dev, coefficient)
                           for g in self.grids]
            self.dp_ops = [BrickLaplace(g, f_dtype, dev, coefficient)
                           for g in self.grids]
        else:
            self.sp_ops = [PlainLevel(LaplaceOperator(g, v_dtype, c, dev), pc)
                           for g, c, pc in zip(self.grids, coefs, precond)]
            self.dp_ops = self.ops_dp
        self.transfers = [None] + [
            Transfer(self.grids[l], self.grids[l - 1], v_dtype, dev,
                     constrained=True) for l in range(1, L)]
        self.transfers_nobc = [None] + [
            Transfer(self.grids[l], self.grids[l - 1], f_dtype, dev,
                     constrained=False) for l in range(1, L)]

        # u_bc as 2*dim face slabs per level, rhs per level
        # (multigrid_solver.h:224-262)
        self._exact_fn = exact_fn
        self._exact_quad_cache = {}
        self.u_bc = []
        self.rhs = []
        for l, g in enumerate(self.grids):
            faces_np = _bc_faces_host(g, exact_fn)
            self.u_bc.append([torch.tensor(f, dtype=f_dtype, device=dev)
                              for f in faces_np])
            self.rhs.append(self._level_rhs(l, rhs_fn, faces_np, coefs[l]))

        # Chebyshev smoothers (multigrid_solver.h:268-291)
        self._n_pre, self._finest_degree = n_pre, finest_degree
        self._coarse_range = coarse_smoothing_range
        self.smoothers = [self._make_smoother(l, self.sp_ops[l], precond[l])
                          for l in range(L)]

    # ------------------------------------------------------------- set-up
    def _make_smoother(self, l: int, op, precond, *, dot=None,
                       rhs0=None) -> Chebyshev:
        """Level ``l``'s Chebyshev smoother over ``op`` (degree n_pre, the
        finest level's ``finest_degree``) or, on the coarsest level, the
        Chebyshev coarse solver with an automatic degree and one Lanczos
        step per dof; a decomposed level passes its global ``dot`` and its
        slab of the start vector ``rhs0``."""
        if l > self.minlevel:
            # deal.II: smoother_data.degree = n_pre literally
            deg = self._n_pre
            if self._finest_degree is not None and l == self.maxlevel:
                deg = self._finest_degree
            return Chebyshev.create(op, precond, smoothing_range=20.0,
                                    degree=deg, eig_cg_n_iterations=15,
                                    dot=dot, rhs0=rhs0)
        return Chebyshev.create(op, precond,
                                smoothing_range=self._coarse_range,
                                degree=None,
                                eig_cg_n_iterations=self.grids[l].n_dofs,
                                dot=dot, rhs0=rhs0)

    def _level_rhs(self, l: int, rhs_fn, faces_np, coef,
                   box=None) -> torch.Tensor:
        """Level ``l``'s f64 rhs ``b = M f - A u_bc`` (zero Dirichlet rows):
        on the device from separable factors above 4M dofs, else on the
        host; ``box = ((lo, hi), ...)``: only those nodes of the leading
        axes."""
        g = self.grids[l]
        sep = getattr(rhs_fn, "separable_1d", None)
        if sep is not None and g.n_dofs > _HOST_ASSEMBLY_DOFS:
            return self._rhs_separable_device(l, g, sep(g.dim), faces_np,
                                              box=box)
        b = compute_rhs_host(g, rhs_fn, _dense_bc_host(g, faces_np), coef)
        if box is not None:
            b = b[tuple(slice(lo, hi) for lo, hi in box)].copy()
        return torch.as_tensor(b, dtype=self.f_dtype, device=self.device)

    def _impose_bc(self, faces, x: torch.Tensor,
                   inplace: bool = False) -> torch.Tensor:
        """Overwrite the Dirichlet boundary of ``x`` with the face values
        (edges and corners are set more than once with the same value);
        a face given as None is not written (a rank's cut); ``inplace``
        writes into ``x`` instead of a copy."""
        out = x if inplace else x.clone()
        i = 0
        for d in range(out.ndim):
            for side in (0, -1):
                if faces[i] is not None:
                    out.select(d, side).copy_(faces[i].select(d, 0))
                i += 1
        return out

    def _rhs_separable_device(self, level: int, g: DofGrid, factors,
                              faces_np, box=None) -> torch.Tensor:
        """dp rhs ``b = M f - A u_bc`` for rank-1 separable
        f = prod_d factors[d](x_d): the mass term is an outer product of
        1-D host-assembled vectors (exact: cells and quadrature factorize
        per axis), built on the device; only ``2 dim`` thin node slabs of
        the boundary correction are assembled on the host.  ``box = ((lo,
        hi), ...)`` builds only those nodes of the leading axes, with the
        whole grid's values (its outer faces zeroed as Dirichlet rows)."""
        b = g.basis
        S = np.asarray(b.S, np.float64)
        qw = np.asarray(b.quad_weights, np.float64)
        vs = []
        for d in range(g.dim):
            xq = np.asarray(g.axis_quads[d], np.float64)
            fd = np.asarray(factors[d](xq), np.float64)
            vs.append(_scatter_pair_host((fd * qw[None, :]) @ S, g.degree))
        vs[0] = vs[0] * g.jxw_scalar
        box = () if box is None else tuple(box)
        for d, (lo, hi) in enumerate(box):
            vs[d] = vs[d][lo:hi]
        t = lambda a: torch.as_tensor(a, dtype=self.f_dtype, device=self.device)
        # r = v_0 (x) (v_1 (x) ... ), the last axes first
        r = None
        for d in reversed(range(g.dim)):
            shape = [1] * g.dim
            shape[d] = -1
            v = t(vs[d]).reshape(shape)
            r = v if r is None else v * r
        if any(np.any(f) for f in faces_np):
            slices, arrs = compute_bc_slab_correction_host(
                g, faces_np, self.ops_dp[level].coef)
            for sl, a in zip(slices, arrs):
                sl = list(sl) + [slice(None)] * (g.dim - len(sl))
                for d, (lo, hi) in enumerate(box):
                    # the part of the slab inside the box's [lo, hi)
                    z0, z1, _ = sl[d].indices(g.shape[d])
                    o0, o1 = max(z0, lo), min(z1, hi)
                    if o1 <= o0:
                        break
                    a = a.take(range(o0 - z0, o1 - z0), axis=d)
                    sl[d] = slice(o0 - lo, o1 - lo)
                else:
                    r[tuple(sl)] += t(a)
        return zero_boundary_(r)

    def exact_on_quad(self, level: int) -> torch.Tensor:
        """Analytic solution at the quadrature points of one level (blocked
        layout, built lazily: only the analysis paths need it)."""
        if level not in self._exact_quad_cache:
            quads = quad_coords_blocked(self.grids[level])
            self._exact_quad_cache[level] = torch.as_tensor(
                np.asarray(self._exact_fn(quads), dtype=np.float64),
                dtype=self.f_dtype, device=self.device)
        return self._exact_quad_cache[level]

    # ------------------------------------------------------------ v-cycle
    def v_cycle(self, level: int, defect: torch.Tensor,
                n_cyc: int) -> torch.Tensor:
        """Returns the correction; multigrid_solver.h:640-681."""
        sm = self.smoothers[level]
        if level == self.minlevel:
            return sm.vmult(defect)
        upd = None
        for _ in range(n_cyc):
            upd = sm.vmult(defect) if upd is None else sm.step(upd, defect)
            t = self.sp_ops[level].vmult_residual(defect, upd)
            dc = self.transfers[level].restrict(t)
            del t
            corr = self.v_cycle(level - 1, dc, 1)
            upd += self.transfers[level].prolongate(corr)
            upd = sm.step(upd, defect)
        return upd

    # ---------------------------------------------------------------- FMG
    def _fmg(self) -> torch.Tensor:
        """Full multigrid, multigrid_solver.h:386-476; returns the finest
        solution without boundary values."""
        d0 = self.rhs[0].to(self.v_dtype)
        t = self.smoothers[0].vmult(d0)
        t = self.smoothers[0].step(t, d0)
        sol = t.to(self.f_dtype)
        for l in range(1, self.maxlevel + 1):
            sol = self._impose_bc(self.u_bc[l - 1], sol, inplace=True)
            sol = zero_boundary_(self.transfers_nobc[l].prolongate(sol))
            res = self.dp_ops[l].vmult_residual(self.rhs[l], sol)
            upd = self.v_cycle(l, res.to(self.v_dtype), self.n_cycles)
            del res
            sol += upd.to(self.f_dtype)
        return sol

    def solve(self) -> torch.Tensor:
        """FMG solve; returns the finest-level solution including the
        boundary values (cf. get_solution, multigrid_solver.h:376-382)."""
        return self._impose_bc(self.u_bc[self.maxlevel], self._fmg(),
                               inplace=True)

    def solve_analyze(self, compute_errors: Optional[bool] = None):
        """FMG with per-level residual/error reporting
        (multigrid_solver.h:404-475).  Returns (solution, per-level dicts,
        V-cycle reduction rate).  ``compute_errors`` defaults to True up to
        4M dofs (the exact values at the quadrature points crowd memory
        above; :meth:`l2_error` takes the host path there)."""
        if compute_errors is None:
            compute_errors = (self.grids[self.maxlevel].n_dofs
                              <= _HOST_ASSEMBLY_DOFS)

        def err(l, sol):
            if not compute_errors:
                return float("nan")
            return self.l2_error(l, sol, host=False)

        d0 = self.rhs[0].to(self.v_dtype)
        t = self.v_cycle(0, d0, 1)
        t = self.smoothers[0].step(t, d0)
        sol = t.to(self.f_dtype)
        report = []
        reduction = 1.0
        for l in range(1, self.maxlevel + 1):
            sol = self._impose_bc(self.u_bc[l - 1], sol, inplace=True)
            sol = self.transfers_nobc[l].prolongate(sol)
            err_start = err(l, sol)
            zero_boundary_(sol)
            res = self.dp_ops[l].vmult_residual(self.rhs[l], sol)
            res_start = self._norm(l, res)
            upd = self.v_cycle(l, res.to(self.v_dtype), self.n_cycles)
            del res
            sol += upd.to(self.f_dtype)
            del upd
            res_end = self._norm(l, self.dp_ops[l].vmult_residual(self.rhs[l],
                                                               sol))
            err_end = err(l, sol)
            reduction = (res_end / res_start) ** (1.0 / self.n_cycles)
            report.append(dict(level=l, error_start=err_start,
                               residual_start=res_start, residual_end=res_end,
                               error_end=err_end, reduction=reduction))
        solution = self._impose_bc(self.u_bc[self.maxlevel], sol, inplace=True)
        return solution, report, reduction

    # ----------------------------------------------------------------- CG
    def _precond(self, r: torch.Tensor) -> torch.Tensor:
        """One sp V-cycle (multigrid_solver.h:497-510)."""
        return self.v_cycle(self.maxlevel, r.to(self.v_dtype), 1).to(self.f_dtype)

    def solve_cg(self, rtol: float = 1e-9, abs_tol: float = 1e-16,
                 max_iterations: int = 1000):
        """CG on the dp operator preconditioned by one V-cycle
        (multigrid_solver.h:483-493).  Returns (solution with boundary
        values, iterations, reduction per iteration)."""
        L = self.maxlevel
        res: CGResult = cg_solve(self.dp_ops[L].vmult, self.rhs[L],
                                 precond=self._precond,
                                 max_iterations=max_iterations,
                                 abs_tol=abs_tol, rtol=rtol,
                                 dot=self._cg_dot)
        its = res.iterations
        red = (res.final_norm / res.initial_norm) ** (1.0 / max(its, 1))
        return self._impose_bc(self.u_bc[L], res.x, inplace=True), its, red

    # ----------------------------------------------------------- analysis
    def _norm(self, level: int, v: torch.Tensor) -> float:
        """Euclidean norm of a vector of ``level``."""
        return float(torch.linalg.vector_norm(v))

    def l2_error(self, level: int, sol: torch.Tensor,
                 host: Optional[bool] = None) -> float:
        """L2 error of a solution (boundary values are re-imposed); on the
        host (``host`` None: above 4M dofs) or on the device."""
        g = self.grids[level]
        u = self._impose_bc(self.u_bc[level], sol)
        if host is None:
            host = g.n_dofs > _HOST_ASSEMBLY_DOFS
        if host:
            return l2_error_host(g, u.cpu().numpy(), self._exact_fn)
        return float(self.ops_dp[level].l2_error(u, self.exact_on_quad(level)))

    def v_cycle_timed(self, level: int, defect: torch.Tensor, n_cyc: int,
                      timings) -> torch.Tensor:
        """Instrumented V-cycle filling a LevelTimings table
        (cf. multigrid_solver.h:640-681)."""
        sm = self.smoothers[level]
        if level == self.minlevel:
            return timings.coarse(sm.vmult, defect)
        upd = None
        for _ in range(n_cyc):
            if upd is None:
                upd = timings.timed(level, "smoother", sm.vmult, defect)
            else:
                upd = timings.timed(level, "smoother", sm.step, upd, defect)
            t = timings.timed(level, "mg_mv", self.sp_ops[level].vmult_residual,
                              defect, upd)
            dc = timings.timed(level, "restrict",
                               self.transfers[level].restrict, t)
            corr = self.v_cycle_timed(level - 1, dc, 1, timings)
            pro = timings.timed(level, "prolongate",
                                self.transfers[level].prolongate, corr)
            upd = timings.timed(level, "mg_vec", torch.add, upd, pro)
            upd = timings.timed(level, "smoother", sm.step, upd, defect)
        return upd

    def do_matvec(self, x: torch.Tensor) -> torch.Tensor:
        """dp matvec benchmark entry (multigrid_solver.h:623-628)."""
        return self.dp_ops[self.maxlevel].vmult(x)

    def do_matvec_smoother(self, x: torch.Tensor) -> torch.Tensor:
        """sp matvec benchmark entry (multigrid_solver.h:632-637)."""
        return self.sp_ops[self.maxlevel].vmult(x)
