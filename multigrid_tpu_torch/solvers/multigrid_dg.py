"""DG multigrid solvers.

Twin of ``multigrid_tpu/solvers/multigrid_dg.py``.

``MultigridSolverDG`` (reference common/multigrid_solver_dg.h:55-743): the
SIP-DG system on the finest level, solved by an outer f64 CG
preconditioned by one
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
``dg_apply<double>`` (K9), the V-cycle's residual ``dg_apply<float>`` (K7,
``b - A x`` in one launch) and each Chebyshev step ``dg_cheb<float>`` (K8),
all three pencil kernels of ``csrc/dg_pencil.cuh`` (apply bound by the
card's FMA rate, the residual and the step by HBM bytes), with the FE_Q
V-cycle on the brick kernels and the CG on the CG vector kernels; on the
CPU every call runs its plain PyTorch version.

``MultigridSolverDGPlain`` (reference common/multigrid_solver_dg_plain.h:
54-591): pure-DG h-multigrid, every level a SIP-DG operator smoothed by
Chebyshev with the transformed Jacobi, the levels joined by
``DGTransfer``; the coarsest level is solved by Chebyshev with an automatic
degree (range 1e-5, as many Lanczos steps as it has dofs), the finest
smoothed at degree ``max(1, n_pre - 1)``, the others at ``n_pre``
(multigrid_solver_dg_plain.h:186-213).  On the card every level's
Chebyshev step is ``dg_cheb<float>`` (K8), every ``b - A x`` of the
V-cycle ``dg_apply<float>`` (K7) and the outer CG's A·p
``dg_apply<double>`` (K9).  With a coefficient (``coeff_fn``) each level
is a :class:`~..ops.dg.DGLaplaceVarCoeff`, plain PyTorch on every device as
its XLA twin is on the TPU, with the exact per-cell transformed Jacobi;
:class:`VarCoeffLevel` gives it the smoother's interface.  With a curved
geometry (``mapping``) each level is a
:class:`~..ops.dg_curved.DGLaplaceCurved` (per-point geometry, composing
with ``coeff_fn``), plain PyTorch on every device in the same way: as in
the JAX twin (``solvers/multigrid_dg.py:340``) no DG kernel runs on a
curved level, so on the card only the outer CG's kernels launch.

A constant-coefficient level takes the DG kernels where they cover its
grid (:func:`~..ops.dg_kernel.covers`: 3-D, the JAX gate of
``solvers/multigrid_dg.py:139, 339``); a 2-D level is the plain
``DGLaplace`` on every device (:func:`constant_level`), and the solver's
``plain_route`` says so.  The route is chosen when the level is built,
from the grid alone.  The kernels stop at p = 16
(``dg_kernel.MAX_DEGREE``, the top of the JAX package's degree sweep), and
a 3-D level above it is refused on the card: the JAX package runs Pallas
there.

``parallel.distributed.DistributedMultigridDG`` runs both solvers' CG and
V-cycles on z-slabs over ranks; its hooks here are the outer CG's inner
product (``_cg_dot``), the smoothers' ``dot`` and start vector
(``_make_smoother``) and :meth:`_DGOuterCG.l2_error`.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..devices import resolve
from ..mesh.brick import BrickMesh
from ..ops.dg import DGGrid, DGLaplace, DGLaplaceVarCoeff
from ..ops.dg_curved import DGCurvedGrid, DGLaplaceCurved
from ..ops.dg_kernel import DGOperator, covers
from ..ops.dg_precond import JacobiTransformed
from ..ops.dg_transfer import CGDGCoupling, DGTransfer
from .cg import CGResult, cg_solve
from .chebyshev import Chebyshev
from .fused import PlainLevel
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


def _quad_tensor(fn: Callable, quads, shape, dtype, dev) -> torch.Tensor:
    return torch.tensor(np.broadcast_to(np.asarray(fn(quads), np.float64),
                                        shape), dtype=dtype, device=dev)


def constant_level(grid: DGGrid, dtype, dev, jacobi=None, kernel=None):
    """A constant-coefficient DG level, its route chosen from the grid
    alone: a :class:`~..ops.dg_kernel.DGOperator` (the DG kernels on the
    card, their plain versions on the CPU) where ``kernel`` holds, else
    the plain :class:`~..ops.dg.DGLaplace` on every device, as a
    :class:`~.fused.PlainLevel` when a smoother needs ``jacobi`` (its
    transformed Jacobi).  Without ``jacobi`` it is the outer CG's operator
    (``vmult``).  ``kernel`` defaults to :func:`~..ops.dg_kernel.covers`
    (3-D, the JAX gate; the card refuses a 3-D level above the kernels'
    degree); the benchmark drivers pass
    :func:`~..ops.dg_kernel.has_kernel`, timing the plain operator above
    it as the JAX drivers' default XLA operator."""
    if covers(grid) if kernel is None else kernel:
        op = DGOperator(grid, dtype, dev)
        if jacobi is not None:
            op.install_jacobi(jacobi)
        return op
    op = DGLaplace(grid, dtype, dev)
    return op if jacobi is None else PlainLevel(op, jacobi.vmult)


class _DGOuterCG:
    """The outer CG of both DG solvers (multigrid_solver_dg.h:410-424):
    ``op_dp``, ``rhs``, ``_precond`` and ``op_ref`` come from the solver."""

    # the outer CG's inner product: None is cg_solve's own (the whole
    # vector); a decomposed solver sets its sum over the ranks' owned cells
    _cg_dot: Optional[Callable] = None

    def solve_cg(self, tolerance: float = 1e-3, max_iterations: int = 100):
        """Outer CG on the f64 DG operator, ReductionControl(max_iterations,
        1e-16, tolerance).  Returns (solution, fractional iterations
        log(tol) / log(rate), rate per iteration)."""
        res: CGResult = cg_solve(self.op_dp.vmult, self.rhs,
                                 precond=self._precond,
                                 max_iterations=max_iterations, abs_tol=1e-16,
                                 rtol=tolerance, dot=self._cg_dot)
        its = res.iterations
        rate = (res.final_norm / res.initial_norm) ** (1.0 / max(its, 1))
        frac_its = np.log(tolerance) / np.log(rate) if rate < 1 else np.inf
        return res.x, float(frac_its), float(rate)

    def l2_error(self, u: torch.Tensor, exact_quad: torch.Tensor) -> float:
        return float(self.op_ref.l2_error(u, exact_quad))


class MultigridSolverDG(_DGOuterCG):
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
        self.jacobi = JacobiTransformed(self.dg_grid, v_dtype, dev)
        self.op = constant_level(self.dg_grid, v_dtype, dev,
                                 self.jacobi)                  # K7, K8
        self.op_dp = constant_level(self.dg_grid, f_dtype, dev)   # K9
        self.op_ref = getattr(self.op_dp, "plain", self.op_dp)  # rhs, errors
        self.plain_route = not covers(self.dg_grid)
        self.coupling = CGDGCoupling(self.cg.grids[L], self.dg_grid, v_dtype,
                                     dev)
        self.smooth_dg = Chebyshev.create(
            self.op, self.jacobi.vmult, smoothing_range=20.0, degree=n_pre,
            eig_cg_n_iterations=15)
        # rhs: DG mass integration of f only (multigrid_solver_dg.h:243-265;
        # the reference applies no weak boundary data here)
        quads = quad_coords_block(self.dg_grid, mesh, L)
        shape = self.dg_grid.shape
        f_quad = _quad_tensor(rhs_fn, quads, shape, f_dtype, dev)
        self.rhs = self.op_ref.compute_rhs(f_quad).contiguous()
        del f_quad
        self.exact_quad = _quad_tensor(exact_fn, quads, shape, f_dtype, dev)

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


class VarCoeffLevel(PlainLevel):
    """One variable-coefficient or curved DG level
    (:class:`~.fused.PlainLevel`).  A constant-coefficient level is
    :func:`constant_level`'s (on the card :class:`~..ops.dg_kernel.
    DGOperator`'s kernels K7 and K8 in 3-D), so this refuses one there."""

    def __init__(self, op, precond: Callable):
        if op.device.type == "cuda" and not getattr(op, "has_cell_data",
                                                    False):
            raise ValueError("VarCoeffLevel: a constant-coefficient DG level "
                             "runs constant_level's route (DGOperator's "
                             "kernels in 3-D) on the card")
        super().__init__(op, precond)


class MultigridSolverDGPlain(_DGOuterCG):
    def __init__(self, mesh: BrickMesh, degree: int, exact_fn: Callable,
                 rhs_fn: Callable, kind: str = "gauss", n_pre: int = 3,
                 n_post: int = 3, device="cuda", v_dtype=torch.float32,
                 f_dtype=torch.float64, coeff_fn: Optional[Callable] = None,
                 mapping: Optional[Callable] = None):
        """``coeff_fn``: an optional smooth coefficient c(x) (callable on
        the broadcastable quadrature coordinates) for -div(c grad u); each
        level's operator takes it at that level's quadrature points, in
        f64, once.  ``mapping``: an optional smooth chart, ``[N, dim]``
        block coordinates in ``[0, 1]^dim`` -> physical ones, which makes
        every level a curved operator (the chart supersedes the mesh's
        origin and lengths); it composes with ``coeff_fn``."""
        if n_pre != n_post:
            raise ValueError("the reference requires equal pre/post degree")
        self.device = dev = resolve(device)
        if dev.type == "cuda":
            set_full_precision_matmul()
        self.mesh = mesh
        self.v_dtype, self.f_dtype = v_dtype, f_dtype
        L = mesh.n_levels
        self.maxlevel = L - 1
        self.jacobis = []
        if mapping is None:
            self.grids = [dg_grid_from_mesh(mesh, l, degree, kind)
                          for l in range(L)]
        else:
            self.grids = [DGCurvedGrid(mesh.cells(l), mapping, degree, kind,
                                       coeff_fn) for l in range(L)]
        if mapping is None and coeff_fn is None:
            self.ops = []
            for g in self.grids:
                self.jacobis.append(JacobiTransformed(g, v_dtype, dev))
                self.ops.append(constant_level(g, v_dtype, dev,
                                               self.jacobis[-1]))
            self.op_dp = constant_level(self.grids[-1], f_dtype, dev)  # K9
            self.op_ref = getattr(self.op_dp, "plain", self.op_dp)
        else:
            # curved or variable-coefficient levels: plain PyTorch on every
            # device, each level's data taken at its own quadrature points
            coeffs = {}

            def plain(l, dtype):
                g = self.grids[l]
                if mapping is not None:
                    return DGLaplaceCurved(g, dtype, dev)
                if l not in coeffs:
                    coeffs[l] = np.broadcast_to(np.asarray(coeff_fn(
                        quad_coords_block(g, mesh, l)), np.float64), g.shape)
                return DGLaplaceVarCoeff(g, coeffs[l], dtype, dev)

            self.ops = []
            for l, g in enumerate(self.grids):
                op = plain(l, v_dtype)
                self.jacobis.append(JacobiTransformed(g, v_dtype, dev, op=op))
                self.ops.append(VarCoeffLevel(op, self.jacobis[-1].vmult))
            self.op_dp = self.op_ref = plain(L - 1, f_dtype)
        # the DG levels run no kernel (curved, var-coeff, or not covered)
        self.plain_route = not isinstance(self.op_dp, DGOperator)
        self.transfers = [None] + [
            DGTransfer(self.grids[l], self.grids[l - 1], v_dtype, dev)
            for l in range(1, L)]
        self.smoothers = [self._make_smoother(l, op, jac, n_pre)
                          for l, (op, jac) in enumerate(zip(self.ops,
                                                            self.jacobis))]
        quads = (self.grids[-1].quad_phys if mapping is not None
                 else quad_coords_block(self.grids[-1], mesh, L - 1))
        shape = self.grids[-1].shape
        f_quad = _quad_tensor(rhs_fn, quads, shape, f_dtype, dev)
        self.rhs = self.op_ref.compute_rhs(f_quad).contiguous()
        del f_quad
        self.exact_quad = _quad_tensor(exact_fn, quads, shape, f_dtype, dev)

    def _make_smoother(self, l: int, op, jac, n_pre: int, *, dot=None,
                       rhs0=None) -> Chebyshev:
        """Level ``l``'s Chebyshev smoother (multigrid_solver_dg_plain.h:
        186-213): degree ``n_pre`` (the finest level ``max(1, n_pre -
        1)``), or on the coarsest level the coarse solver with an
        automatic degree and one Lanczos step per dof; a decomposed level
        passes its global ``dot`` and its slab of the start vector
        ``rhs0``."""
        if l > 0:
            deg = n_pre if l < self.maxlevel else max(1, n_pre - 1)
            return Chebyshev.create(op, jac.vmult, smoothing_range=20.0,
                                    degree=deg, eig_cg_n_iterations=15,
                                    dot=dot, rhs0=rhs0)
        return Chebyshev.create(op, jac.vmult, smoothing_range=1e-5,
                                degree=None,
                                eig_cg_n_iterations=self.grids[0].n_dofs,
                                dot=dot, rhs0=rhs0)

    def v_cycle(self, level: int, defect: torch.Tensor) -> torch.Tensor:
        """multigrid_solver_dg_plain.h:455-496."""
        if level == 0:
            return self.smoothers[0].vmult(defect)
        upd = self.smoothers[level].vmult(defect)
        t = self.ops[level].vmult_residual(defect, upd)
        dc = self.transfers[level].restrict(t)
        del t
        corr = self.v_cycle(level - 1, dc)
        del dc
        upd += self.transfers[level].prolongate(corr)
        return self.smoothers[level].step(upd, defect)

    def _precond(self, r: torch.Tensor) -> torch.Tensor:
        return self.v_cycle(self.maxlevel, r.to(self.v_dtype)).to(self.f_dtype)
