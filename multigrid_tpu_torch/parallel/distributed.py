"""Rank-decomposed multigrid: the FE_Q brick solver over boxes of cells.

Twin of ``multigrid_tpu/parallel/distributed.py`` (``level_spec`` and
``DistributedMultigrid``), the rendering of the reference's per-level MPI
decomposition (reference common/multigrid_solver.h:151-200: one
partitioned vector storage per level, every rank active on every level)
for ranks of ``torch.distributed``, one process a rank.

The ranks form a grid over z, or over z and y (``shape``; the
experiments' rule is :func:`~.sharding.default_grid`, JAX's: z and y from
4 ranks on).
Each rank builds only its part: on a *split* level a box with ghost
planes (:class:`~.halo.Slabs`) and the level's operators on it (the
``brick_kron`` operators in float and double, the Chebyshev smoother,
the transfers; on a 2-D level the plain operators), wrapped so that every
pass that reads neighbours ends in a ghost refresh; on a *replicated*
level the whole level, computed the same way on every rank.

Split policy (the port's own, :func:`level_bounds`): a level splits on
every axis of the rank grid, or is replicated whole.  It splits when
every rank gets at least ``GHOST_CELLS`` cells along each split axis (the
ghost width) and, when a level lies below it, a pair; the cuts nest along
each axis and lie on coarse-cell boundaries.  The JAX ``level_spec``
splits each axis on its own; here a level split on z alone would be
replicated along y, and its restriction would sum over the y ranks.
Parity with JAX is by results.  A 2-D brick splits its axis 0 by the
rank grid's first axis and its axis 1 by the second, as JAX's positional
``level_spec`` does.  Restriction into a replicated level sums the ranks'
owned nodes, prolongation out of it slices.  The V-cycle, FMG and CG are
:class:`~..solvers.multigrid.MultigridSolver`'s own code; the solver's
hooks are the inner products (a sum over the owned nodes of every rank,
added in rank order: the same bits on every rank, so that every rank
takes the same branches), the Dirichlet faces (a rank writes only its
true faces) and the L2 errors (owned cells, summed).

On the card each rank's kernels are ``brick_kron<float>`` / ``<double>``,
``cheb_epilogue<float>`` and the CG kernels, as on one device; the planes
move through the backend of :class:`~.sharding.Ranks`.

``DistributedMultigridDG`` (the JAX ``dg_block_spec`` and
``DistributedMultigridDG``) does the same for the DG solvers, on boxes of
cells with ghost cell layers (:class:`~.dg_halo.DGSlabs`): DG-plain
splits every level where each rank gets a cell along each split axis (a
pair when a level lies below, :func:`dg_level_bounds`), with one ghost
layer; DG-over-CG puts its DG level on the FE_Q finest level's cuts with
two ghost layers, so that the coupling maps a rank's DG box to its FE_Q
box, and runs the FE_Q hierarchy on :class:`DistributedMultigrid`.  The
one-device solvers' V-cycles and outer CG run unchanged; their hooks are
the outer CG's dot, the smoothers' dot and start vector, and the L2 error
of the owned cells.  Each rank's DG kernels are ``dg_apply<double>``,
``dg_apply<float>`` (the residual) and ``dg_cheb<float>`` on a 3-D brick;
a 2-D brick's DG levels run the plain operators, as on one device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..mesh.brick import BrickMesh, DofGrid
from ..ops.cg_kernel import cg_dot
from ..ops.dg import DGGrid
from ..ops.dg_kernel import covers
from ..ops.dg_precond import JacobiTransformed
from ..ops.dg_transfer import CGDGCoupling, DGTransfer
from ..ops.laplace import LaplaceOperator, l2_sums_host, make_diag_coef, \
    quad_coords_blocked
from ..ops.laplace_kernel import BrickLaplace
from ..ops.transfer import Transfer
from ..solvers.chebyshev import Chebyshev, eig_estimate_start_vector
from ..solvers.fused import PlainLevel
from ..solvers.multigrid import (_HOST_ASSEMBLY_DOFS, MultigridSolver,
                                 _bc_faces_host, set_full_precision_matmul)
from ..solvers.multigrid_dg import (MultigridSolverDG, MultigridSolverDGPlain,
                                    _quad_tensor, constant_level,
                                    dg_grid_from_mesh, quad_coords_block)
from .dg_halo import GHOST_LAYERS, DGSlabs
from .halo import GHOST_CELLS, Slabs, axis_cuts, split_cells
from .sharding import Ranks


def level_bounds(mesh: BrickMesh, grid, min_cells: int = GHOST_CELLS
                 ) -> list[Optional[list]]:
    """Per level, the cell boundaries of the ranks' boxes, or None where
    the level is replicated (the port's twin of the JAX ``level_spec``).
    ``grid``: a number of ranks (the z split: each level's z cuts, a flat
    list) or a rank grid shape ``(nz,)`` / ``(nz, ny)`` (each level's cuts
    per axis, ``[z cuts, y cuts]``).  A level splits when every rank gets
    at least ``min_cells`` cells along each split axis (the ghost width)
    and, when a level lies below it, a pair of cells.  The coarsest split
    level is cut on cell pairs when a level lies below it, and each finer
    level's cuts are twice the coarser's: the boxes nest, and every cut is
    on a coarse-cell boundary."""
    flat = isinstance(grid, (int, np.integer))
    shape = (int(grid),) if flat else tuple(int(n) for n in grid)
    if len(shape) > mesh.dim:
        raise ValueError(f"a rank grid of {shape} on a {mesh.dim}-D mesh")
    world = int(np.prod(shape))
    L = mesh.n_levels
    out: list[Optional[list]] = [None] * L
    split = [world > 1 and all(
        mesh.cells(l)[a] >= max(min_cells, 2 if l else 1) * n
        for a, n in enumerate(shape)) for l in range(L)]
    if not any(split):
        return out
    first = split.index(True)
    base = [split_cells(mesh.cells(first)[a], n, align=2 if first else 1)
            for a, n in enumerate(shape)]
    for l in range(first, L):
        cuts = [[c << (l - first) for c in b] for b in base]
        out[l] = cuts[0] if flat else cuts
    return out


def share_interval(sm, ranks: Ranks):
    """Every rank runs a replicated level alone: rank 0's Chebyshev
    interval and degree for all, whatever its rounding; returns ``sm``."""
    (sm.theta, sm.delta, degree_f, sm.max_eig,
     sm.min_eig) = ranks.broadcast_floats(
        (sm.theta, sm.delta, sm.degree, sm.max_eig, sm.min_eig))
    sm.degree = int(degree_f)
    return sm


class SlabLevel:
    """A split level's operator (``BrickLaplace``, or on a 2-D level the
    plain operator, on the rank's box) as the smoother, V-cycle and CG
    call it: ``vmult``, ``vmult_residual`` and ``cheb_step``, each
    followed by the ghost refresh.  The Chebyshev step without A x (``x``
    None) is pointwise and keeps its input's ghosts.  The levels do not
    run the overlap schedule of :class:`~.halo.SplitApply`: on the card
    its extra launches and copies cost the solves more than the exchange
    it hides (PERF.md, the overlap rows)."""

    def __init__(self, op, slabs: Slabs):
        self.op, self.slabs = op, slabs
        self.shape, self.dtype, self.device = slabs.shape, op.dtype, op.device

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        return self.slabs.refresh(self.op.vmult(x))

    def vmult_residual(self, rhs: torch.Tensor, lhs: torch.Tensor):
        return self.slabs.refresh(self.op.vmult_residual(rhs, lhs))

    def cheb_step(self, b, x, x_old, f1: float, f2: float, out=None):
        y = self.op.cheb_step(b, x, x_old, f1, f2, out=out)
        return y if x is None else self.slabs.refresh(y)


class SlabTransfer:
    """The 2:1 transfer between a split fine level and the level below,
    split or replicated.  Along each split axis the fine box covers cells
    ``[g0, g1)`` (even: the cuts nest), over the coarse cells ``[g0 / 2,
    g1 / 2)``; a :class:`~..ops.transfer.Transfer` between the two boxes
    computes every owned node as the whole level would.  ``restrict``
    places the result in the coarse box and refreshes it, or on a
    replicated coarse level sums the ranks' owned coarse nodes into the
    whole level; ``prolongate`` takes those coarse nodes and refreshes
    the fine box."""

    def __init__(self, fine: Slabs, coarse: Optional[Slabs],
                 coarse_grid: DofGrid, dtype, device, constrained: bool):
        p = coarse_grid.degree
        halves = [(g0 // 2, g1 // 2) for g0, g1 in fine.local.ranges]
        self.tr = Transfer(fine.local, coarse_grid.box(halves), dtype, device,
                           constrained)
        self.fine, self.coarse = fine, coarse
        self.coarse_shape = tuple(coarse_grid.shape)
        # the coarse nodes under the fine box, in the coarse box (or the
        # whole replicated level)
        base = [0] * len(halves) if coarse is None else \
            [lo for lo, _ in coarse.stored]
        self.part = tuple(slice(a * p - o, b * p + 1 - o)
                          for (a, b), o in zip(halves, base))
        # the coarse nodes this rank owns (a replicated coarse level), in
        # the whole level and in the transfer's coarse box
        self.owned = tuple(
            slice(c0 // 2 * p, coarse_grid.shape[d] if nb[1] is None
                  else c1 // 2 * p)
            for d, ((c0, c1), nb) in enumerate(zip(fine.cells, fine.nbrs)))
        self.owned_part = tuple(slice(o.start - a * p, o.stop - a * p)
                                for o, (a, _) in zip(self.owned, halves))

    def restrict(self, u_fine: torch.Tensor) -> torch.Tensor:
        uc = self.tr.restrict(u_fine)
        if self.coarse is not None:
            out = uc.new_zeros(self.coarse.shape)
            out[self.part].copy_(uc)
            return self.coarse.refresh(out)
        out = uc.new_zeros(self.coarse_shape)
        out[self.owned] = uc[self.owned_part]
        return self.fine.ranks.sum_(out)

    def prolongate(self, u_coarse: torch.Tensor) -> torch.Tensor:
        return self.fine.refresh(self.tr.prolongate(u_coarse[self.part]))


class DistributedMultigrid(MultigridSolver):
    """:class:`~..solvers.multigrid.MultigridSolver` on the ranks of
    ``ranks``: the same constructor arguments (2-D and 3-D bricks;
    ``device`` is the rank's), the rank grid ``shape`` (None: ``(world,)``,
    the z split), and the entry points ``solve``, ``solve_analyze``,
    ``solve_cg`` and ``l2_error``, which run decomposed on every split
    level.  A solution is the rank's box of the finest level (its whole
    grid where that level is replicated): :meth:`owned` gives the nodes
    the rank owns, :meth:`collect` the whole grid (small grids)."""

    def __init__(self, mesh: BrickMesh, degree: int, exact_fn: Callable,
                 rhs_fn: Callable, ranks: Ranks, coefficient: float = 1.0,
                 n_pre: int = 2, n_post: int = 2, n_cycles: int = 1,
                 v_dtype=torch.float32, f_dtype=torch.float64,
                 coarse_smoothing_range: float = 1e-3,
                 finest_degree: Optional[int] = None,
                 shape: Optional[tuple] = None):
        if mesh.dim not in (2, 3):
            raise ValueError("the rank-decomposed solver runs 2-D and 3-D "
                             "bricks")
        if n_pre != n_post:
            raise ValueError("the reference requires equal pre/post degree")
        shape = (ranks.world,) if shape is None else tuple(shape)
        if int(np.prod(shape)) != ranks.world:
            raise ValueError(f"a rank grid of {shape} for {ranks.world} "
                             "ranks")
        self.ranks, self.shape = ranks, shape
        self.device = dev = ranks.device
        if dev.type == "cuda":
            set_full_precision_matmul()
        self.mesh, self.degree = mesh, degree
        self.coefficient, self.n_cycles = coefficient, n_cycles
        self.v_dtype, self.f_dtype = v_dtype, f_dtype
        self.minlevel, self.maxlevel = 0, mesh.max_level
        L = mesh.n_levels
        self.grids = [DofGrid(mesh, l, degree) for l in range(L)]
        cuts = level_bounds(mesh, shape[0] if len(shape) == 1 else shape)
        self.slabs = [None if b is None else Slabs(g, ranks, b)
                      for g, b in zip(self.grids, cuts)]
        local = [g if s is None else s.local
                 for g, s in zip(self.grids, self.slabs)]
        coefs = [make_diag_coef(g, coefficient) for g in self.grids]
        self.ops_dp = [LaplaceOperator(g, f_dtype, c, dev)
                       for g, c in zip(local, coefs)]
        precond = [LaplaceOperator(g, v_dtype, c, dev).inverse_diagonal().mul
                   for g, c in zip(local, coefs)]

        def level_op(l, dtype, smoother):
            g, s = local[l], self.slabs[l]
            if mesh.dim == 3:
                op = BrickLaplace(g, dtype, dev, coefficient)
            elif smoother:   # a 2-D level: the plain operators, as on one
                op = PlainLevel(LaplaceOperator(g, dtype, coefs[l], dev),
                                precond[l])                    # device
            else:
                op = self.ops_dp[l]
            return op if s is None else SlabLevel(op, s)

        self.sp_ops = [level_op(l, v_dtype, True) for l in range(L)]
        self.dp_ops = [level_op(l, f_dtype, False) for l in range(L)]
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
            s = self.slabs[l]
            self.rhs.append(self._level_rhs(
                l, rhs_fn, faces_np, coefs[l],
                box=None if s is None else s.stored))

        self._n_pre, self._finest_degree = n_pre, finest_degree
        self._coarse_range = coarse_smoothing_range
        self.smoothers = []
        for l, s in enumerate(self.slabs):
            if s is None:
                sm = share_interval(self._make_smoother(l, self.sp_ops[l],
                                                        precond[l]), ranks)
            else:
                sm = self._make_smoother(
                    l, self.sp_ops[l], precond[l], dot=s.dot,
                    rhs0=eig_estimate_start_vector(
                        self.grids[l].shape, v_dtype, dev, box=s.stored))
            self.smoothers.append(sm)
        fine = self.slabs[self.maxlevel]
        if fine is not None:
            self._cg_dot = lambda a, c: float(fine.dot(a, c, cg_dot))

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

    def stored_index(self, level: int):
        """The nodes of ``level`` this rank stores, one slice a split axis,
        or None (the whole level)."""
        s = self.slabs[level]
        return None if s is None else s.stored_index()

    def local_faces(self, level: int, faces) -> list:
        """This rank's part of the level's Dirichlet face slabs (numpy,
        ``[(d, side) for d for side in (0, 1)]``): a split axis's faces
        where the box has them (None at a cut), every face sliced to the
        box along the split axes across it."""
        s = self.slabs[level]
        out = []
        for i, f in enumerate(faces):
            f = np.asarray(f, np.float64)
            d, side = divmod(i, 2)
            if s is not None:
                if d < len(s.nbrs) and s.nbrs[d][side] is not None:
                    out.append(None)
                    continue
                f = f[tuple(slice(None) if e == d else sl
                            for e, sl in enumerate(s.stored_index()))]
            out.append(torch.tensor(np.ascontiguousarray(f),
                                    dtype=self.f_dtype, device=self.device))
        return out

    def owned(self, t: torch.Tensor, level: Optional[int] = None):
        """The nodes of a finest-level (or ``level``) vector this rank
        owns (a view); the whole vector on a replicated level."""
        s = self.slabs[self.maxlevel if level is None else level]
        return t if s is None else s.own(t)

    def owned_rows(self, level: Optional[int] = None) -> tuple:
        """The global index of :meth:`owned`, one slice a split axis."""
        s = self.slabs[self.maxlevel if level is None else level]
        return (slice(None),) if s is None else s.owned_index()

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
        """L2 error of a solution box: each rank integrates its owned
        cells (on the host above 4M dofs of the level), the sums are added
        over the ranks."""
        s = self.slabs[level]
        if s is None:
            return super().l2_error(level, sol, host)
        p = self.degree
        u = self._impose_bc(self.u_bc[level], sol)
        u = u[tuple(slice(c0 * p - lo, c1 * p - lo + 1) for (c0, c1), (lo, _)
                    in zip(s.cells, s.stored))].contiguous()
        part = self.grids[level].box(s.cells)
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


# ------------------------------------------------------------------ DG
def dg_level_bounds(mesh: BrickMesh, grid, ghost: int = GHOST_LAYERS
                    ) -> list[Optional[list]]:
    """Per DG level, the cell boundaries of the ranks' boxes, or None
    where the level is replicated (the JAX ``dg_block_spec``, cells
    leading; ``grid`` as :func:`level_bounds` takes it): a level splits
    when every rank gets ``ghost`` cells along each split axis (and a pair
    of them when a level lies below), with :func:`level_bounds`' nested
    cuts, so that every cut is on a coarse-cell boundary and
    ``DGTransfer`` maps owned cells to owned cells."""
    return level_bounds(mesh, grid, min_cells=ghost)


class SlabDGLevel(SlabLevel):
    """A split DG level's operator on the rank's box (:func:`_slab_op`: a
    :class:`~..ops.dg_kernel.DGOperator` in 3-D, ``dg_apply`` and
    ``dg_cheb``; the plain one in 2-D): ``vmult`` and a Chebyshev
    step with A x end in the ghost refresh.  ``vmult_residual`` does not:
    its output is read only by cell-local passes on the owned cells (the
    restriction, a ``DGTransfer``) or, on a two-layer box, by
    ``dg_to_cg`` through the first ghost layer, which the residual
    computes right from a refreshed input."""

    def vmult_residual(self, rhs: torch.Tensor, lhs: torch.Tensor):
        return self.op.vmult_residual(rhs, lhs)


def _part(grid: DGGrid, cells) -> DGGrid:
    """``grid`` with ``cells`` cells along its leading axes (a box's
    shape; same geometry)."""
    cells = tuple(cells)
    return DGGrid(cells=cells + grid.cells[len(cells):],
                  jacobian=grid.jacobian, degree=grid.degree, kind=grid.kind)


class SlabDGTransfer:
    """The 2:1 DG transfer between a split fine level and the level below,
    split or replicated.  The cuts nest on coarse-cell boundaries
    (:func:`dg_level_bounds`), so ``restrict`` maps the owned fine cells to
    the owned coarse cells with no exchange, then refreshes the coarse box
    (its smoother reads the ghosts) or, on a replicated coarse level, sums
    the ranks' owned coarse cells into the whole level (exact: zero off
    their owner).  ``prolongate`` needs no exchange either: the coarse
    box's ghost layer covers the fine box's."""

    def __init__(self, fine: DGSlabs, coarse: Optional[DGSlabs],
                 coarse_grid: DGGrid, dtype, device):
        if any(c % 2 for pair in fine.owned for c in pair):
            raise ValueError(f"fine cuts {fine.bounds} are not on coarse "
                             "cells")
        self.fine, self.coarse = fine, coarse
        self.coarse_shape = tuple(coarse_grid.shape)
        owned = [c1 - c0 for c0, c1 in fine.owned]
        self.down = DGTransfer(_part(fine.grid, owned),
                               _part(coarse_grid, [c // 2 for c in owned]),
                               dtype, device)
        self.owned = tuple(slice(c0 // 2, c1 // 2) for c0, c1 in fine.owned)
        # the coarse cells under the fine box: the whole coarse box, or
        # the cells of a replicated level that cover it
        if coarse is not None:
            cover, src = coarse.stored, ()
        else:
            cover = [(s0 // 2, (s1 + 1) // 2) for s0, s1 in fine.stored]
            src = tuple(slice(a0, a1) for a0, a1 in cover)
        self.src = src
        for (a0, a1), (s0, s1) in zip(cover, fine.stored):
            if not 2 * a0 <= s0 < s1 <= 2 * a1:
                raise ValueError("the coarse box does not cover the fine "
                                 "box")
        self.cut = tuple(slice(s0 - 2 * a0, s1 - 2 * a0)
                         for (a0, _), (s0, s1) in zip(cover, fine.stored))
        self.up = DGTransfer(_part(fine.grid, [2 * (a1 - a0)
                                               for a0, a1 in cover]),
                             _part(coarse_grid, [a1 - a0 for a0, a1 in cover]),
                             dtype, device)

    def restrict(self, u_fine: torch.Tensor) -> torch.Tensor:
        uc = self.down.restrict(self.fine.own(u_fine).contiguous())
        if self.coarse is not None:
            out = uc.new_zeros(self.coarse.shape)
            self.coarse.own(out).copy_(uc)
            return self.coarse.refresh(out)
        out = uc.new_zeros(self.coarse_shape)
        out[self.owned] = uc
        return self.fine.ranks.sum_(out)

    def prolongate(self, u_coarse: torch.Tensor) -> torch.Tensor:
        return self.up.prolongate(u_coarse[self.src])[self.cut].contiguous()


class _SlabCoupling:
    """The CG <-> DG coupling between a rank's DG box and its FE_Q box
    (the same cells): ``dg_to_cg`` zeroes the true Dirichlet faces only and
    ends in the FE_Q refresh; ``cg_to_dg`` is cell-local."""

    def __init__(self, coupling: CGDGCoupling, slabs: Slabs):
        self.coupling, self.slabs = coupling, slabs

    def dg_to_cg(self, r_dg: torch.Tensor) -> torch.Tensor:
        return self.slabs.refresh(self.coupling.dg_to_cg(r_dg))

    def cg_to_dg(self, u_cg: torch.Tensor) -> torch.Tensor:
        return self.coupling.cg_to_dg(u_cg)


class _OnRanks:
    """What both DG solvers on ranks share: the finest level's box
    (``dg_slabs``, None where it is replicated), the box's right-hand
    side and exact values, the outer CG's dot and the L2 error of the
    owned cells.  A box's transformed Jacobi takes the whole grid's cell
    categories (``JacobiTransformed(whole=...)``): its ghost cells hold
    the neighbours' inverse diagonal, which the pointwise Chebyshev step
    applies there."""

    def _jacobi(self, grid: DGGrid, slabs) -> JacobiTransformed:
        if slabs is None:
            return JacobiTransformed(grid, self.v_dtype, self.device)
        offset = [s0 for s0, _ in slabs.stored]
        offset += [0] * (grid.dim - len(offset))
        return JacobiTransformed(slabs.local, self.v_dtype, self.device,
                                 whole=(grid.cells, tuple(offset)))

    def _finest(self, mesh: BrickMesh, grid: DGGrid, slabs, rhs_fn,
                exact_fn) -> None:
        self.dg_slabs = slabs
        quads = quad_coords_block(grid, mesh, mesh.max_level)
        if slabs is not None:
            for a, cells in enumerate(slabs.stored_cells()):
                quads[a] = quads[a][(slice(None),) * a + (cells,)]
        shape = grid.shape if slabs is None else slabs.shape
        f_quad = _quad_tensor(rhs_fn, quads, shape, self.f_dtype, self.device)
        self.rhs = self.op_ref.compute_rhs(f_quad).contiguous()
        del f_quad
        self.exact_quad = _quad_tensor(exact_fn, quads, shape, self.f_dtype,
                                       self.device)
        if slabs is not None:
            self._cg_dot = lambda a, c: float(slabs.dot(a, c, cg_dot))

    def l2_error(self, u: torch.Tensor, exact_quad: torch.Tensor) -> float:
        """L2 error of a finest-level box: each rank integrates its owned
        cells, the sums are added over the ranks in rank order."""
        s = self.dg_slabs
        if s is None:
            return super().l2_error(u, exact_quad)
        err, vol = self.op_ref.l2_sums(s.own(u).contiguous(),
                                       s.own(exact_quad).contiguous())
        ranks = self.ranks
        return math.sqrt(float(ranks.allsum(err)) / float(ranks.allsum(vol)))


def _slab_op(grid, slabs, dtype, dev, jacobi=None):
    """A DG level on the rank's box (the whole level where ``slabs`` is
    None) by :func:`~..solvers.multigrid_dg.constant_level`'s route: a
    ``DGOperator`` where ``dg_kernel.covers`` the grid (3-D), else the
    plain ``DGLaplace`` (2-D; a ``PlainLevel`` over ``jacobi``)."""
    op = constant_level(grid if slabs is None else slabs.local, dtype, dev,
                        jacobi)
    return op if slabs is None else SlabDGLevel(op, slabs)


def _plain_of(op):
    """The plain operator of a level built by :func:`_slab_op`."""
    op = getattr(op, "op", op)
    return getattr(op, "plain", op)


class _DGPlainOnRanks(_OnRanks, MultigridSolverDGPlain):
    """:class:`~..solvers.multigrid_dg.MultigridSolverDGPlain` on ranks:
    every split level's operator (:func:`_slab_op`) with its transformed
    Jacobi on the rank's box (one ghost layer, the traces wire), the
    levels joined by :class:`SlabDGTransfer`; replicated levels run alike
    on every rank with rank 0's Chebyshev interval.  The V-cycle and the
    outer CG are the one-device solver's."""

    def __init__(self, mesh: BrickMesh, degree: int, exact_fn, rhs_fn,
                 ranks: Ranks, kind: str, n_pre: int, v_dtype, f_dtype,
                 shape: tuple):
        self.ranks = ranks
        self.device = dev = ranks.device
        if dev.type == "cuda":
            set_full_precision_matmul()
        self.mesh, self.v_dtype, self.f_dtype = mesh, v_dtype, f_dtype
        L = mesh.n_levels
        self.maxlevel = L - 1
        self.grids = [dg_grid_from_mesh(mesh, l, degree, kind)
                      for l in range(L)]
        self.slabs = [None if b is None else DGSlabs(g, ranks, b)
                      for g, b in zip(self.grids,
                                      dg_level_bounds(mesh, shape))]
        self.jacobis = [self._jacobi(g, s)
                        for g, s in zip(self.grids, self.slabs)]
        self.ops = [_slab_op(g, s, v_dtype, dev, j) for g, s, j
                    in zip(self.grids, self.slabs, self.jacobis)]
        fine = self.slabs[-1]
        self.op_dp = _slab_op(self.grids[-1], fine, f_dtype, dev)   # K9
        self.op_ref = _plain_of(self.op_dp)
        self.plain_route = not covers(self.grids[-1])
        self.transfers = [None] + [self._transfer(l) for l in range(1, L)]
        self.smoothers = []
        for l, (op, jac, s) in enumerate(zip(self.ops, self.jacobis,
                                             self.slabs)):
            if s is None:
                self.smoothers.append(share_interval(
                    self._make_smoother(l, op, jac, n_pre), ranks))
            else:
                self.smoothers.append(self._make_smoother(
                    l, op, jac, n_pre, dot=s.dot,
                    rhs0=eig_estimate_start_vector(
                        self.grids[l].shape, v_dtype, dev, box=s.stored)))
        self._finest(mesh, self.grids[-1], fine, rhs_fn, exact_fn)

    def _transfer(self, l: int):
        fine = self.slabs[l]
        if fine is None:
            return DGTransfer(self.grids[l], self.grids[l - 1], self.v_dtype,
                              self.device)
        return SlabDGTransfer(fine, self.slabs[l - 1], self.grids[l - 1],
                              self.v_dtype, self.device)


class _DGOnRanks(_OnRanks, MultigridSolverDG):
    """:class:`~..solvers.multigrid_dg.MultigridSolverDG` on ranks: the DG
    level on the rank's slab of the FE_Q finest level's cells (two ghost
    layers, the traces wire), the FE_Q hierarchy a
    :class:`DistributedMultigrid` with the same cuts, the coupling between
    the two slabs.  The ``dg_v_cycle`` and the outer CG are the one-device
    solver's."""

    def __init__(self, mesh: BrickMesh, degree: int, exact_fn, rhs_fn,
                 ranks: Ranks, kind: str, n_pre: int, v_dtype, f_dtype,
                 shape: tuple):
        self.ranks = ranks
        self.device = dev = ranks.device
        if dev.type == "cuda":
            set_full_precision_matmul()
        self.mesh, self.v_dtype, self.f_dtype = mesh, v_dtype, f_dtype
        self.cg = DistributedMultigrid(
            mesh, degree, exact_fn, rhs_fn, ranks, n_pre=n_pre,
            n_post=n_pre, n_cycles=1, v_dtype=v_dtype, f_dtype=f_dtype,
            coarse_smoothing_range=2e-3, finest_degree=max(1, n_pre - 1),
            shape=shape)
        L = mesh.max_level
        self.dg_grid = dg_grid_from_mesh(mesh, L, degree, kind)
        fe = self.cg.slabs[L]
        slabs = None if fe is None else DGSlabs(
            self.dg_grid, ranks, fe.cuts, GHOST_CELLS)
        self.jacobi = self._jacobi(self.dg_grid, slabs)
        self.op = _slab_op(self.dg_grid, slabs, v_dtype, dev,
                           self.jacobi)                          # K7, K8
        self.op_dp = _slab_op(self.dg_grid, slabs, f_dtype, dev)   # K9
        self.op_ref = _plain_of(self.op_dp)
        self.plain_route = not covers(self.dg_grid)
        if fe is None:
            self.coupling = CGDGCoupling(self.cg.grids[L], self.dg_grid,
                                         v_dtype, dev)
        else:
            self.coupling = _SlabCoupling(CGDGCoupling(
                fe.local, slabs.local, v_dtype, dev,
                faces=[tuple(n is None for n in pair) for pair in fe.nbrs]),
                fe)
        self.smooth_dg = Chebyshev.create(
            self.op, self.jacobi.vmult, smoothing_range=20.0, degree=n_pre,
            eig_cg_n_iterations=15, dot=None if slabs is None else slabs.dot,
            rhs0=None if slabs is None else eig_estimate_start_vector(
                self.dg_grid.shape, v_dtype, dev, box=slabs.stored))
        self._finest(mesh, self.dg_grid, slabs, rhs_fn, exact_fn)


class DistributedMultigridDG:
    """The DG solvers on the ranks of ``ranks`` (twin of the JAX
    ``DistributedMultigridDG``), boxes of cells on the rank grid ``shape``
    (None: ``(world,)``, z-slabs): ``solver="dg-plain"``
    (:class:`~..solvers.multigrid_dg.MultigridSolverDGPlain`, every level
    split where :func:`dg_level_bounds` lets it, one ghost layer) or
    ``"dg"`` (:class:`~..solvers.multigrid_dg.MultigridSolverDG`: the DG
    level on the FE_Q finest level's cuts with two ghost layers, the FE_Q
    hierarchy on :class:`DistributedMultigrid`).  Ghost layers travel on
    the traces wire, so that the owned cells of every pass are the
    one-device bits; the hermite wire is the operator's
    (:class:`~.dg_halo.HaloDGLaplace`).  The same arguments as the
    one-device solvers, on a 3-D or 2-D brick (the device is the rank's).
    Entry points: :meth:`solve_cg`, :meth:`l2_error`, :meth:`owned`,
    :meth:`collect`, :meth:`distributed_levels`; a solution is the rank's
    slab of the finest level (the whole level where it is replicated).  On
    the card each rank's kernels are, in 3-D, ``dg_apply<double>``,
    ``dg_apply<float>`` (the residual), ``dg_cheb<float>``, the CG kernels
    and, for ``"dg"``, F-1's brick kernels; a 2-D level runs the plain
    operator on every device (:func:`_slab_op`, as the one-device solvers
    and the JAX package's XLA), so there the CG kernels alone (and, for
    ``"dg"``, the CG kernels of the 2-D FE_Q hierarchy)."""

    SOLVERS = ("dg-plain", "dg")

    def __init__(self, mesh: BrickMesh, degree: int, exact_fn: Callable,
                 rhs_fn: Callable, ranks: Ranks, solver: str = "dg-plain",
                 kind: Optional[str] = None, n_pre: Optional[int] = None,
                 n_post: Optional[int] = None, v_dtype=torch.float32,
                 f_dtype=torch.float64, shape: Optional[tuple] = None):
        if solver not in self.SOLVERS:
            raise ValueError(f"solver must be one of {self.SOLVERS}, not "
                             f"{solver!r}")
        if n_pre is None:          # the one-device solvers' defaults
            n_pre = 3 if solver == "dg-plain" else 2
        if n_post is not None and n_post != n_pre:
            raise ValueError("the reference requires equal pre/post degree")
        shape = (ranks.world,) if shape is None else tuple(shape)
        if int(np.prod(shape)) != ranks.world:
            raise ValueError(f"a rank grid of {shape} for {ranks.world} "
                             "ranks")
        self.ranks, self.kind, self.shape = ranks, solver, shape
        if solver == "dg-plain":
            self.solver = _DGPlainOnRanks(mesh, degree, exact_fn, rhs_fn,
                                          ranks, kind or "gauss", n_pre,
                                          v_dtype, f_dtype, shape)
        else:
            self.solver = _DGOnRanks(mesh, degree, exact_fn, rhs_fn, ranks,
                                     kind or "hermite", n_pre, v_dtype,
                                     f_dtype, shape)

    @property
    def slabs(self) -> Optional[DGSlabs]:
        """The finest DG level's box (None: replicated)."""
        return self.solver.dg_slabs

    @property
    def exact_quad(self) -> torch.Tensor:
        return self.solver.exact_quad

    @property
    def rhs(self) -> torch.Tensor:
        return self.solver.rhs

    def solve_cg(self, **kw):
        """The outer CG (``tolerance``, ``max_iterations``): (the rank's
        solution slab, fractional iterations, rate)."""
        return self.solver.solve_cg(**kw)

    def l2_error(self, u: torch.Tensor,
                 exact_quad: Optional[torch.Tensor] = None) -> float:
        return self.solver.l2_error(u, self.exact_quad if exact_quad is None
                                    else exact_quad)

    def owned(self, u: torch.Tensor) -> torch.Tensor:
        """The cells of a finest-level box this rank owns (a view)."""
        return u if self.slabs is None else self.slabs.own(u)

    def owned_cells(self) -> tuple:
        """The global cells of :meth:`owned`, one slice a split axis."""
        return (slice(None),) if self.slabs is None else \
            self.slabs.owned_cells()

    def collect(self, u: torch.Tensor) -> torch.Tensor:
        """The whole finest level, on every rank (small grids)."""
        return u.clone() if self.slabs is None else self.slabs.collect(u)

    def distributed_levels(self) -> list[bool]:
        """Which DG levels split across the ranks (False: replicated); for
        ``"dg"`` the DG level, then the FE_Q levels."""
        s = self.solver
        if self.kind == "dg-plain":
            return [sl is not None for sl in s.slabs]
        return [s.dg_slabs is not None] + s.cg.distributed_levels()
