"""Rank-decomposed multigrid: the FE_Q brick solver over z-slabs.

Twin of ``multigrid_tpu/parallel/distributed.py`` (``level_spec`` and
``DistributedMultigrid``), the rendering of the reference's per-level MPI
decomposition (reference common/multigrid_solver.h:151-200: one
partitioned vector storage per level, every rank active on every level)
for ranks of ``torch.distributed``, one process a rank.

Each rank builds only its part: on a *split* level a z-slab with ghost
planes (:class:`~.halo.Slabs`) and the level's operators on it (the
``brick_kron`` operators in float and double, the Chebyshev smoother,
the transfers), wrapped so that every pass that reads neighbours ends in
a ghost refresh; on a *replicated* level the whole level, computed the
same way on every rank.  The policy is the JAX module's ``min_local``: a
level splits when every rank owns at least ``GHOST_CELLS`` z cells (the
ghost width), else it is replicated; restriction into a replicated level
gathers the ranks' owned planes, prolongation out of it slices.  The
V-cycle, FMG and CG are :class:`~..solvers.multigrid.MultigridSolver`'s
own code; the solver's hooks are the inner products (a sum over the owned
planes of every rank, added in rank order: the same bits on every rank,
so that every rank takes the same branches), the Dirichlet faces (a rank
writes only its true faces) and the L2 errors (owned cells, summed).

On the card each rank's kernels are ``brick_kron<float>`` / ``<double>``,
``cheb_epilogue<float>`` and the CG kernels, as on one device; the planes
move through the backend of :class:`~.sharding.Ranks`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..mesh.brick import BrickMesh, DofGrid
from ..ops.cg_kernel import cg_dot
from ..ops.laplace import LaplaceOperator, l2_sums_host, make_diag_coef, \
    quad_coords_blocked
from ..ops.laplace_kernel import BrickLaplace
from ..ops.transfer import Transfer
from ..solvers.chebyshev import eig_estimate_start_vector
from ..solvers.multigrid import (_HOST_ASSEMBLY_DOFS, MultigridSolver,
                                 _bc_faces_host, set_full_precision_matmul)
from .halo import GHOST_CELLS, Slabs, split_cells
from .sharding import Ranks


def level_bounds(mesh: BrickMesh, world: int) -> list[Optional[list[int]]]:
    """Per level, the z cell boundaries of the ranks' slabs, or None where
    the level is replicated (the JAX ``level_spec``).  A level splits when
    every rank gets at least ``GHOST_CELLS`` z cells.  The coarsest split
    level is cut on cell pairs when a level lies below it, and each finer
    level's cuts are twice the coarser's: the slabs nest, and every cut is
    on a coarse-cell boundary."""
    L = mesh.n_levels
    out: list[Optional[list[int]]] = [None] * L
    split = [world > 1 and mesh.cells(l)[0] >= GHOST_CELLS * world
             for l in range(L)]
    if not any(split):
        return out
    first = split.index(True)
    base = split_cells(mesh.cells(first)[0], world, align=2 if first else 1)
    for l in range(first, L):
        out[l] = [c << (l - first) for c in base]
    return out


class SlabLevel:
    """A split level's operator (``BrickLaplace`` on the rank's slab) as
    the smoother, V-cycle and CG call it: ``vmult``, ``vmult_residual``
    and ``cheb_step``, each followed by the ghost refresh.  The Chebyshev
    step without A x (``x`` None) is pointwise and keeps its input's
    ghosts."""

    def __init__(self, op: BrickLaplace, slabs: Slabs):
        self.op, self.slabs = op, slabs
        self.shape, self.dtype, self.device = op.shape, op.dtype, op.device

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        return self.slabs.refresh(self.op.vmult(x))

    def vmult_residual(self, rhs: torch.Tensor, lhs: torch.Tensor):
        return self.slabs.refresh(self.op.vmult_residual(rhs, lhs))

    def cheb_step(self, b, x, x_old, f1: float, f2: float, out=None):
        y = self.op.cheb_step(b, x, x_old, f1, f2, out=out)
        return y if x is None else self.slabs.refresh(y)


class SlabTransfer:
    """The 2:1 transfer between a split fine level and the level below,
    split or replicated.  The fine slab covers cells ``[g0, g1)`` (even:
    the cuts nest), over the coarse cells ``[g0 / 2, g1 / 2)``; a
    :class:`~..ops.transfer.Transfer` between the two slabs computes every
    owned plane as the whole level would.  ``restrict`` places the result
    in the coarse slab and refreshes it, or on a replicated coarse level
    sums the ranks' owned coarse planes into the whole level;
    ``prolongate`` takes those coarse planes and refreshes the fine slab."""

    def __init__(self, fine: Slabs, coarse: Optional[Slabs],
                 coarse_grid: DofGrid, dtype, device, constrained: bool):
        f = fine.local
        p = coarse_grid.degree
        a, b = f.z0 // 2, f.z1 // 2
        self.tr = Transfer(f, coarse_grid.z_slab(a, b), dtype, device,
                           constrained)
        self.fine, self.coarse = fine, coarse
        self.coarse_shape = tuple(coarse_grid.shape)
        self.rows = (a * p, b * p + 1)            # coarse planes under fine
        last = fine.above is None
        # the coarse planes this rank owns (a replicated coarse level)
        self.owned = (fine.c0 // 2 * p,
                      coarse_grid.shape[0] if last else fine.c1 // 2 * p)

    def _coarse_part(self, u: torch.Tensor) -> torch.Tensor:
        off = self.rows[0] - (0 if self.coarse is None else self.coarse.lo)
        return u[off:off + self.rows[1] - self.rows[0]]

    def restrict(self, u_fine: torch.Tensor) -> torch.Tensor:
        uc = self.tr.restrict(u_fine)
        if self.coarse is not None:
            out = uc.new_zeros(self.coarse.shape)
            self._coarse_part(out).copy_(uc)
            return self.coarse.refresh(out)
        out = uc.new_zeros(self.coarse_shape)
        o0, o1 = self.owned
        out[o0:o1] = uc[o0 - self.rows[0]:o1 - self.rows[0]]
        return self.fine.ranks.sum_(out)

    def prolongate(self, u_coarse: torch.Tensor) -> torch.Tensor:
        return self.fine.refresh(self.tr.prolongate(self._coarse_part(u_coarse)))


class DistributedMultigrid(MultigridSolver):
    """:class:`~..solvers.multigrid.MultigridSolver` on the ranks of
    ``ranks``: the same constructor arguments (3-D bricks; ``device`` is
    the rank's), and the entry points ``solve``, ``solve_analyze``,
    ``solve_cg`` and ``l2_error``, which run decomposed on every split
    level.  A solution is the rank's slab of the finest level (its whole
    grid where that level is replicated): :meth:`owned` gives the planes
    the rank owns, :meth:`collect` the whole grid (small grids)."""

    def __init__(self, mesh: BrickMesh, degree: int, exact_fn: Callable,
                 rhs_fn: Callable, ranks: Ranks, coefficient: float = 1.0,
                 n_pre: int = 2, n_post: int = 2, n_cycles: int = 1,
                 v_dtype=torch.float32, f_dtype=torch.float64,
                 coarse_smoothing_range: float = 1e-3):
        if mesh.dim != 3:
            raise ValueError("the rank-decomposed solver runs 3-D bricks")
        if n_pre != n_post:
            raise ValueError("the reference requires equal pre/post degree")
        self.ranks = ranks
        self.device = dev = ranks.device
        if dev.type == "cuda":
            set_full_precision_matmul()
        self.mesh, self.degree = mesh, degree
        self.coefficient, self.n_cycles = coefficient, n_cycles
        self.v_dtype, self.f_dtype = v_dtype, f_dtype
        self.minlevel, self.maxlevel = 0, mesh.max_level
        L = mesh.n_levels
        self.grids = [DofGrid(mesh, l, degree) for l in range(L)]
        self.slabs = [None if b is None else Slabs(g, ranks, b)
                      for g, b in zip(self.grids, level_bounds(mesh,
                                                               ranks.world))]
        local = [g if s is None else s.local
                 for g, s in zip(self.grids, self.slabs)]
        coefs = [make_diag_coef(g, coefficient) for g in self.grids]
        self.ops_dp = [LaplaceOperator(g, f_dtype, c, dev)
                       for g, c in zip(local, coefs)]
        precond = [LaplaceOperator(g, v_dtype, c, dev).inverse_diagonal().mul
                   for g, c in zip(local, coefs)]

        def level_op(g, s, dtype):
            op = BrickLaplace(g, dtype, dev, coefficient)
            return op if s is None else SlabLevel(op, s)

        self.sp_ops = [level_op(g, s, v_dtype)
                       for g, s in zip(local, self.slabs)]
        self.dp_ops = [level_op(g, s, f_dtype)
                       for g, s in zip(local, self.slabs)]
        self.transfers = [None] + [self._transfer(l, v_dtype, True)
                                   for l in range(1, L)]
        self.transfers_nobc = [None] + [self._transfer(l, f_dtype, False)
                                        for l in range(1, L)]

        self._exact_fn = exact_fn
        self._exact_quad_cache = {}
        self.u_bc, self.rhs = [], []
        for l, g in enumerate(self.grids):
            faces_np = _bc_faces_host(g, exact_fn)
            self.u_bc.append(self.local_faces(l, faces_np))
            self.rhs.append(self._level_rhs(l, rhs_fn, faces_np, coefs[l],
                                            planes=self.planes(l)))

        self._n_pre, self._finest_degree = n_pre, None
        self._coarse_range = coarse_smoothing_range
        self.smoothers = []
        for l, s in enumerate(self.slabs):
            if s is None:
                sm = self._make_smoother(l, self.sp_ops[l], precond[l])
                # every rank runs a replicated level alone: rank 0's
                # interval and degree for all, whatever its rounding
                (sm.theta, sm.delta, degree_f, sm.max_eig,
                 sm.min_eig) = ranks.broadcast_floats(
                    (sm.theta, sm.delta, sm.degree, sm.max_eig, sm.min_eig))
                sm.degree = int(degree_f)
            else:
                sm = self._make_smoother(
                    l, self.sp_ops[l], precond[l], dot=s.dot,
                    rhs0=eig_estimate_start_vector(
                        self.grids[l].shape, v_dtype, dev,
                        planes=(s.lo, s.hi)))
            self.smoothers.append(sm)
        fine = self.slabs[self.maxlevel]
        if fine is not None:
            self._cg_dot = lambda a, c: float(
                ranks.allsum(cg_dot(fine.own(a), fine.own(c))))

    def _transfer(self, l: int, dtype, constrained: bool):
        fine, coarse = self.slabs[l], self.slabs[l - 1]
        if fine is None:
            return Transfer(self.grids[l], self.grids[l - 1], dtype,
                            self.device, constrained)
        return SlabTransfer(fine, coarse, self.grids[l - 1], dtype,
                            self.device, constrained)

    # ---------------------------------------------------------- layout
    def distributed_levels(self) -> list[bool]:
        """Which levels split across the ranks (False: replicated)."""
        return [s is not None for s in self.slabs]

    def planes(self, level: int):
        """The planes ``(lo, hi)`` of axis 0 this rank stores of
        ``level``, or None (the whole level)."""
        s = self.slabs[level]
        return None if s is None else (s.lo, s.hi)

    def local_faces(self, level: int, faces) -> list:
        """This rank's part of the level's six Dirichlet face slabs (numpy,
        ``[(d, side) for d for side in (0, 1)]``): the z faces where the
        slab has them (None at a cut), the others sliced to its planes."""
        s = self.slabs[level]
        out = []
        for i, f in enumerate(faces):
            f = np.asarray(f, np.float64)
            if s is not None:
                if i == 0 and s.below is not None or \
                        i == 1 and s.above is not None:
                    out.append(None)
                    continue
                if i >= 2:
                    f = f[s.lo:s.hi]
            out.append(torch.tensor(np.ascontiguousarray(f),
                                    dtype=self.f_dtype, device=self.device))
        return out

    def owned(self, t: torch.Tensor, level: Optional[int] = None):
        """The planes of a finest-level (or ``level``) vector this rank
        owns; the whole vector on a replicated level."""
        s = self.slabs[self.maxlevel if level is None else level]
        return t if s is None else s.own(t)

    def owned_rows(self, level: Optional[int] = None) -> slice:
        """The global planes of :meth:`owned`."""
        s = self.slabs[self.maxlevel if level is None else level]
        return slice(None) if s is None else s.owned_rows()

    def collect(self, t: torch.Tensor, level: Optional[int] = None):
        """The whole grid of a finest-level (or ``level``) vector, on every
        rank."""
        s = self.slabs[self.maxlevel if level is None else level]
        return t.clone() if s is None else s.collect(t)

    # ------------------------------------------------------- reductions
    def _norm(self, level: int, v: torch.Tensor) -> float:
        s = self.slabs[level]
        if s is None:
            return super()._norm(level, v)
        return math.sqrt(float(s.dot(v, v)))

    def l2_error(self, level: int, sol: torch.Tensor,
                 host: Optional[bool] = None) -> float:
        """L2 error of a solution slab: each rank integrates its owned
        cells (on the host above 4M dofs of the level), the sums are added
        over the ranks."""
        s = self.slabs[level]
        if s is None:
            return super().l2_error(level, sol, host)
        p = self.degree
        u = self._impose_bc(self.u_bc[level], sol)
        u = u[s.c0 * p - s.lo: s.c1 * p - s.lo + 1]
        part = self.grids[level].z_slab(s.c0, s.c1)
        if host is None:
            host = self.grids[level].n_dofs > _HOST_ASSEMBLY_DOFS
        if host:
            sums = l2_sums_host(part, u.cpu().numpy(), self._exact_fn)
            err, vol = (torch.tensor(v, dtype=torch.float64,
                                     device=self.device) for v in sums)
        else:
            if level not in self._exact_quad_cache:
                self._exact_quad_cache[level] = torch.as_tensor(
                    np.asarray(self._exact_fn(quad_coords_blocked(part)),
                               np.float64), dtype=self.f_dtype,
                    device=self.device)
            op = LaplaceOperator(part, self.f_dtype, device=self.device)
            err, vol = op.l2_sums(u, self._exact_quad_cache[level])
        ranks = self.ranks
        return math.sqrt(float(ranks.allsum(err)) / float(ranks.allsum(vol)))
