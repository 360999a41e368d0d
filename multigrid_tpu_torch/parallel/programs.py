"""Rank programs: module-level functions that :func:`.sharding.launch`
runs on every rank, each returning rank 0's view as plain numbers and
numpy arrays (a spawned rank imports this module and nothing of its
caller's).

* :func:`halo_program`: one :class:`~.halo.HaloLaplace` (or
  ``HaloLaplace2D``) level: the collected ``vmult`` of a given grid
  vector, its owned nodes against the whole grid's apply, an owned-node
  dot and a few CG iterations in the distributed layout;
* :func:`dg_halo_program`: one :class:`~.dg_halo.HaloDGLaplace` (or
  ``HaloDGLaplace2D``) level: the collected slab-route ``vmult`` and
  ``vmult_plain`` of a given block, an owned-cell dot, the bytes of a
  refresh;
* :func:`dg_program`: poisson_dg or poisson_dg_plain on a
  :class:`~.distributed.DistributedMultigridDG` (outer CG, L2 error), with
  the checks of a decomposed solve against the single-device one (the
  owned cells of ``dg_apply<double>``, ``dg_residual<float>`` and
  ``dg_cheb<float>`` on the slab against ``DGOperator`` on the whole grid
  and against ``vmult_plain``, the transfers' need of no exchange, the CG
  solution against a saved one, two solves, a world of one);
* :func:`overlap_program`: the overlap schedule of one FE_Q level
  (:class:`~.halo.SplitApply`) in both dtypes, against the
  apply-then-refresh order and the whole grid's ``BrickLaplace``;
* :func:`programs`: several of these in one launch;
* :func:`cube_program`: poisson_cube on a
  :class:`~.distributed.DistributedMultigrid` (FMG, V-cycle reduction,
  CG, L2 errors), with the checks of a decomposed solve against the
  single-device one: the owned nodes of the distributed apply against
  ``BrickLaplace`` on the whole grid, the CG solution against a saved
  single-device solution, two CG solves bit for bit, a world of one
  against :class:`~..solvers.multigrid.MultigridSolver`'s bits, the
  kernels' launches summed over the ranks.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np
import torch

from ..mesh.brick import BrickMesh, DofGrid
from .halo import HaloLaplace, HaloLaplace2D
from .sharding import Ranks


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _sync(ranks: Ranks) -> None:
    if ranks.device.type == "cuda":
        torch.cuda.synchronize(ranks.device)
    ranks.barrier()


def halo_program(ranks: Ranks, grid: DofGrid, x: np.ndarray,
                 dtype=torch.float64, n_cg: int = 0,
                 comm_reps: int = 0, shape: Optional[tuple] = None,
                 whole: bool = False) -> dict:
    """``vmult`` of the global ``x`` (collected) on a z split (``shape``
    None or ``(world,)``: :class:`~.halo.HaloLaplace`) or an ``nz x ny``
    rank grid (:class:`~.halo.HaloLaplace2D`), ``x . A x`` by the owned
    nodes, ``n_cg`` unpreconditioned CG iterations on ``A u = b`` with
    ``b`` = ``x`` on the interior, 0 on the boundary (the collected
    ``u``), with ``whole`` the owned nodes of the ``vmult`` against
    ``BrickLaplace`` on the whole grid on every rank (bit for bit, largest
    difference, max|y|), and with ``comm_reps`` the exchange split of the
    ``vmult`` (:meth:`~.halo.HaloLaplace.comm_split_report`).
    ``foreign``: the modules of JAX or of the JAX package the rank has
    loaded (none)."""
    if shape is None or len(shape) == 1:
        halo = HaloLaplace(grid, ranks, dtype)
    else:
        halo = HaloLaplace2D(grid, ranks, shape, dtype)
    xd = halo.distribute(x)
    y = halo.vmult(xd)
    out = dict(vmult=_np(halo.collect(y)), x_ax=float(halo.dot(xd, y)),
               levels=halo.slabs.bounds, foreign=_foreign(),
               bytes=halo.bytes_per_refresh())
    if whole:
        from ..ops.laplace_kernel import BrickLaplace

        one = BrickLaplace(grid, dtype, ranks.device)
        want = one.vmult(torch.as_tensor(x, dtype=dtype,
                                         device=ranks.device))
        out["whole"] = _compare(ranks, halo.slabs.own(y),
                                want[halo.slabs.owned_index()])
        del one, want
    if n_cg:
        m = halo.op.interior
        b = torch.where(m, xd, 0)
        u = torch.zeros_like(b)
        r, p = b.clone(), b.clone()
        rz = halo.dot(r, r)
        for _ in range(n_cg):
            q = halo.vmult(p)
            alpha = rz / halo.dot(p, q)
            u += alpha * p
            r -= alpha * q
            rz2 = halo.dot(r, r)
            p = r + (rz2 / rz) * p
            rz = rz2
        out["cg"] = _np(halo.collect(u))
    if comm_reps:
        out["comm"] = halo.comm_split_report(comm_reps)
    return out


def overlap_program(ranks: Ranks, grid: DofGrid, shape=None, seed: int = 0,
                    comm_reps: int = 0) -> dict:
    """The overlap schedule of ``grid`` (3-D) on the z split (``shape``
    None) or an ``nz x ny`` rank grid: for float32 and float64, on a
    random box (``seed``), whether the split ``vmult``'s box equals the
    apply-then-refresh box bit for bit on every rank (every node, ghosts
    included: both boxes fresh) and its owned nodes the whole grid's
    ``BrickLaplace`` (``checks[type]``: ``whole_box``, ``single``,
    ``max_diff``); the collected float64 ``vmult``; the plan's sub-boxes on
    rank 0 and its ``collective_overlap_report``; with ``comm_reps`` the
    exchange split (:meth:`~.halo.HaloLaplace.comm_split_report`).
    ``foreign`` as :func:`halo_program`."""
    from ..ops.laplace_kernel import BrickLaplace
    from ..utils.overlap import collective_overlap_report

    x = np.random.default_rng(seed).standard_normal(grid.shape)
    out = dict(checks={}, foreign=_foreign())
    for dtype in (torch.float32, torch.float64):
        if shape is None or len(shape) == 1:
            h = HaloLaplace(grid, ranks, dtype)
        else:
            h = HaloLaplace2D(grid, ranks, tuple(shape), dtype)
        if h.split is None:
            raise ValueError(f"{grid.cells} cells on {ranks.world} ranks "
                             "do not split")
        xs = h.distribute(x)
        got = h.vmult(xs)
        single = BrickLaplace(grid, dtype, ranks.device).vmult(
            torch.as_tensor(x, dtype=dtype, device=ranks.device))
        single = single[h.slabs.owned_index()]
        one = _compare(ranks, h.slabs.own(got), single)
        out["checks"]["f32" if dtype == torch.float32 else "f64"] = dict(
            whole_box=_compare(ranks, got, h.vmult_whole(xs))["equal"],
            single=one["equal"], max_diff=one["max_diff"])
        if dtype == torch.float64:
            out["vmult"] = _np(h.collect(got))
            out["boxes"] = [(b.role, b.cells) for b in h.slabs.plan.boxes]
            out["overlap"] = collective_overlap_report(h)
            if comm_reps:
                out["comm"] = h.comm_split_report(comm_reps)
        del h, got, single
    return out


def _foreign() -> list[str]:
    """The modules of JAX or of the JAX package this rank has loaded."""
    return [m for m in sys.modules if m.split(".")[0]
            in ("jax", "jaxlib", "multigrid_tpu", "experiments")]


def dg_halo_program(ranks: Ranks, cases, comm_reps: int = 0,
                    collect: bool = True, whole: bool = False) -> list[dict]:
    """The distributed SIP-DG apply in float64, one entry a case ``(grid,
    x, wire, shape)``: the block ``x`` (numpy, or an int seed of a random
    one) on a z split (``shape`` None: :class:`~.dg_halo.HaloDGLaplace`)
    or an ``nz x ny`` rank grid (:class:`~.dg_halo.HaloDGLaplace2D`), its ghost
    layers filled through ``wire``.  Per case: with ``collect`` the
    collected slab-route ``vmult``, ``vmult_plain`` and ``A A x`` (the
    second apply reading the first's refreshed ghosts); with ``whole`` the
    owned cells of both against ``DGOperator`` on the whole grid on every
    rank (bit for bit, largest difference, max|y|); ``x . A x`` by the
    owned cells, this rank's bytes a refresh, the cuts, and with
    ``comm_reps`` the exchange split of ``vmult``."""
    from ..ops.dg import DGLaplace
    from ..ops.dg_kernel import DGOperator
    from .dg_halo import HaloDGLaplace, HaloDGLaplace2D

    outs = []
    for grid, x, wire, shape in cases:
        if not isinstance(x, np.ndarray):
            x = np.random.default_rng(x).standard_normal(grid.shape)
        op = DGLaplace(grid, torch.float64, ranks.device)
        halo = (HaloDGLaplace(op, ranks, wire) if shape is None
                else HaloDGLaplace2D(op, ranks, shape, wire))
        xd = halo.slabs.refresh(halo.distribute(x))
        y = halo.vmult(xd)
        yp = halo.vmult_plain(xd)
        out = dict(x_ax=float(halo.dot(xd, y)), bounds=halo.slabs.bounds,
                   bytes=halo.bytes_per_refresh(), foreign=_foreign())
        if collect:
            out.update(vmult=_np(halo.collect(y)),
                       vmult_plain=_np(halo.collect(yp)),
                       vmult2=_np(halo.collect(halo.vmult(y))))
        if whole:
            want = DGOperator(grid, torch.float64, ranks.device).vmult(
                torch.as_tensor(x, dtype=torch.float64,
                                device=ranks.device))[
                halo.slabs.owned_cells()]
            for name, got in (("vmult", y), ("vmult_plain", yp)):
                out[name + "_whole"] = _compare(ranks, halo.slabs.own(got),
                                                want)
            del want
        if comm_reps:
            out["comm"] = halo.comm_split_report(comm_reps)
        outs.append(out)
        del halo, xd, y, yp
    return outs


def _compare(ranks: Ranks, got: torch.Tensor, want: torch.Tensor) -> dict:
    """Bit for bit on every rank, the largest difference and max|want|
    over the ranks."""
    same = torch.equal(got, want)
    return dict(equal=ranks.allmax(0.0 if same else 1.0) == 0.0,
                max_diff=ranks.allmax(float((got - want).abs().max())),
                scale=ranks.allmax(float(want.abs().max())))


def _launches(ranks: Ranks) -> dict:
    """The kernels' launch counts, summed over the ranks."""
    from ..ops import cg_kernel, dg_kernel, laplace_kernel

    mine = {**laplace_kernel.LAUNCHES, **cg_kernel.LAUNCHES,
            **dg_kernel.LAUNCHES}
    names = sorted(mine)
    t = torch.tensor([mine[k] for k in names], dtype=torch.float64,
                     device="cpu" if ranks.backend == "gloo" else ranks.device)
    if ranks.world > 1:
        import torch.distributed as dist

        dist.all_reduce(t)
    return {k: int(v) for k, v in zip(names, t.tolist())}


def _reset_launches() -> None:
    from ..ops import cg_kernel, dg_kernel, laplace_kernel

    laplace_kernel.reset_launches()
    cg_kernel.reset_launches()
    dg_kernel.reset_launches()


def cube_program(ranks: Ranks, mesh: BrickMesh, degree: int = 4,
                 n_cycles: int = 2, n_pre: int = 2,
                 reps: int = 1, state: Optional[dict] = None,
                 collect: bool = False, reference: Optional[str] = None,
                 apply_seed: Optional[int] = None, comm_reps: int = 0,
                 single: bool = False, shape: Optional[tuple] = None) -> dict:
    """poisson_cube on ``mesh`` (a cube ladder's brick, 2-D or 3-D) on the
    ranks, on the rank grid ``shape`` (None: the z split).  Always: set-up
    seconds, FMG seconds (best of ``reps``), V-cycle reduction, FMG L2, CG
    seconds, its, reduction, L2, which levels split and their cuts, the
    kernels' launches during the solves summed over the ranks, and
    ``foreign`` (as :func:`halo_program`).  Options:

    * ``state``: :func:`~..convert.load_state` it before solving;
    * ``collect``: the FMG and CG solutions as whole grids;
    * ``reference``: a ``.npy`` file of the single-device CG solution: the
      largest difference of the owned nodes, and max|u|;
    * ``reps`` > 1 also compares the CG solutions of two solves bit for
      bit;
    * ``apply_seed``: the distributed ``vmult`` and ``apply`` of a random
      grid (the seed's) in float32 and float64 against ``BrickLaplace`` on
      the whole grid, owned nodes (corners included), bit for bit and
      largest difference (3-D);
    * ``comm_reps``: :meth:`~.halo.HaloLaplace.comm_split_report` of the
      finest level in float64 on the solver's cuts, ``comm_reps`` applies
      a run (on cuts that split, the overlap schedule's under
      ``"overlap"``);
    * ``single``: the single-device solver's FMG and CG on the same rank,
      bit for bit against the decomposed ones (a world of one).

    Times are rank 0's wall clock between barriers, each ending in a
    device synchronize; on a card ``peak_bytes`` is the largest rank's
    peak device memory through set-up and solves."""
    from .. import convert
    from ..experiments.poisson_cube import exact_fn, rhs_fn
    from .distributed import DistributedMultigrid

    cuda = ranks.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(ranks.device)
    _sync(ranks)
    t0 = time.perf_counter()
    s = DistributedMultigrid(mesh, degree, exact_fn, rhs_fn, ranks,
                             n_pre=n_pre, n_post=n_pre, n_cycles=n_cycles,
                             shape=shape)
    if state is not None:
        convert.load_state(s, state)
    _sync(ranks)
    out = dict(world=ranks.world, backend=ranks.backend, grid=s.shape,
               foreign=_foreign(), setup_time=time.perf_counter() - t0,
               cells=mesh.n_cells(mesh.max_level),
               dofs=s.grids[s.maxlevel].n_dofs,
               levels=s.distributed_levels(),
               bounds=[None if b is None else b.bounds for b in s.slabs])
    _reset_launches()
    fmg_s, cg_s, sols = [], [], []
    sol = None
    for _ in range(reps):
        sol = None
        _sync(ranks)
        t0 = time.perf_counter()
        sol = s.solve()
        _sync(ranks)
        fmg_s.append(time.perf_counter() - t0)
    _, _, reduction = s.solve_analyze()
    its = red = None
    for _ in range(reps):
        _sync(ranks)
        t0 = time.perf_counter()
        sol_cg, its, red = s.solve_cg()
        _sync(ranks)
        cg_s.append(time.perf_counter() - t0)
        sols.append(sol_cg)
        if len(sols) > 2:
            sols.pop(1)
    out["launches"] = _launches(ranks)
    sol_cg = sols[-1]
    out.update(fmg_time=min(fmg_s), fmg_times=fmg_s, reduction=reduction,
               fmg_L2error=s.l2_error(s.maxlevel, sol), cg_time=min(cg_s),
               cg_times=cg_s, cg_its=its, cg_reduction=red,
               cg_L2error=s.l2_error(s.maxlevel, sol_cg))
    if cuda:
        out["peak_bytes"] = ranks.allmax(
            torch.cuda.max_memory_allocated(ranks.device))
    if len(sols) > 1:
        same = torch.equal(s.owned(sols[0]), s.owned(sols[-1]))
        out["cg_repeat_equal"] = ranks.allmax(0.0 if same else 1.0) == 0.0
    if collect:
        out["fmg"] = _np(s.collect(sol))
        out["cg"] = _np(s.collect(sol_cg))
    if reference is not None:
        ref = np.load(reference, mmap_mode="r")
        mine = torch.as_tensor(np.array(ref[s.owned_rows()]),
                               device=ranks.device)
        own = s.owned(sol_cg)
        out["cg_ref_diff"] = ranks.allmax(float((own - mine).abs().max()))
        out["cg_ref_max"] = ranks.allmax(float(mine.abs().max()))
        del mine, own
    del sol, sols, sol_cg
    if apply_seed is not None:
        out["apply"] = _apply_check(ranks, s, apply_seed)
    if comm_reps:
        fine = s.slabs[s.maxlevel]
        halo = HaloLaplace(s.grids[s.maxlevel], ranks, torch.float64,
                           bounds=None if fine is None else fine.bounds)
        out["comm"] = halo.comm_split_report(comm_reps)
        del halo
    if single:
        out["single"] = _single_check(ranks, s, mesh, degree, n_cycles)
    return out


def _apply_check(ranks: Ranks, s, seed: int) -> dict:
    """The finest level's decomposed ``vmult`` and ``apply`` against
    ``BrickLaplace`` on the whole grid, float32 and float64: whether the
    owned nodes (on a rank grid, the corners near both cuts included) are
    equal bit for bit on every rank, and the largest difference."""
    from ..ops.laplace_kernel import BrickLaplace

    g = s.grids[s.maxlevel]
    x = np.random.default_rng(seed).standard_normal(g.shape)
    res = {}
    for dtype, op in ((torch.float32, s.sp_ops[s.maxlevel]),
                      (torch.float64, s.dp_ops[s.maxlevel])):
        whole = BrickLaplace(g, dtype, ranks.device, s.coefficient)
        xg = torch.as_tensor(x, dtype=dtype, device=ranks.device)
        rows = s.owned_rows()
        box = s.stored_index(s.maxlevel)
        xs = xg.clone() if box is None else xg[box].contiguous()
        # the box's own apply: its owned nodes need no refresh
        for mode, dist_fn, one_fn in (
                ("vmult", op.vmult, whole.vmult),
                ("apply", getattr(op, "op", op).apply, whole.apply)):
            want = one_fn(xg)[rows]
            got = s.owned(dist_fn(xs))
            same = torch.equal(got, want)
            diff = float((got - want).abs().max())
            res[f"{mode} {'f32' if dtype == torch.float32 else 'f64'}"] = dict(
                equal=ranks.allmax(0.0 if same else 1.0) == 0.0,
                max_diff=ranks.allmax(diff),
                scale=ranks.allmax(float(want.abs().max())))
        del whole, xg, xs
    return res


def _single_check(ranks: Ranks, s, mesh: BrickMesh, degree: int,
                  n_cycles: int) -> dict:
    """The single-device solver on this rank: its FMG and CG solutions
    against the decomposed solver's, bit for bit."""
    from ..experiments.poisson_cube import build_solver

    one = build_solver(mesh, degree, n_cycles=n_cycles, device=ranks.device)
    fmg = torch.equal(one.solve(), s.solve())
    x1, its1, red1 = one.solve_cg()
    x2, its2, red2 = s.solve_cg()
    return dict(fmg_equal=fmg, cg_equal=torch.equal(x1, x2) and its1 == its2
                and red1 == red2, its=its1)


SINE_K = 3.0


def sine_exact(coords):
    """prod sin(3 pi x_d): the DG problem of the JAX package's distributed
    DG tests (tests/test_distributed_dg.py), on the unit cube."""
    out = 1.0
    for c in coords:
        out = out * np.sin(np.pi * SINE_K * c)
    return out


def sine_rhs(coords):
    return len(coords) * (np.pi * SINE_K) ** 2 * sine_exact(coords)


def dg_problem(problem: str):
    """(exact, rhs) of ``problem``: "cube" (poisson_cube's, the DG
    drivers') or "sine" (:func:`sine_exact`)."""
    if problem == "sine":
        return sine_exact, sine_rhs
    from ..experiments.poisson_cube import exact_fn, rhs_fn

    return exact_fn, rhs_fn


def dg_program(ranks: Ranks, mesh: BrickMesh, path: str = "dg-plain",
               degree: int = 4, kind: Optional[str] = None,
               n_pre: Optional[int] = None,
               tolerance: float = 1e-9, reps: int = 1,
               state: Optional[dict] = None, collect: bool = False,
               reference: Optional[str] = None,
               apply_seed: Optional[int] = None, comm_reps: int = 0,
               comm_wires=("traces",), transfer_seed: Optional[int] = None,
               single: bool = False, problem: str = "cube",
               shape: Optional[tuple] = None) -> dict:
    """poisson_dg (``path="dg"``) or poisson_dg_plain (``"dg-plain"``) on
    ``mesh`` on the ranks (:class:`~.distributed.DistributedMultigridDG`)
    on the rank grid ``shape`` (None: the z split), the right-hand side
    and exact solution of ``problem`` (:func:`dg_problem`).
    Always: set-up seconds, CG seconds (each of ``reps`` solves), frac
    its, rate, L2 error, which levels split and the cuts, the kernels'
    launches during the solves summed over the ranks.  Options:

    * ``state``: :func:`~..convert.load_state` it before solving;
    * ``collect``: the CG solution as the whole block;
    * ``reference``: a ``.npy`` file of the single-device CG solution: the
      largest difference of the owned cells, and max|u|;
    * ``reps`` > 1 also compares the CG solutions of two solves bit for
      bit;
    * ``apply_seed``: on the finest slab (its input's ghosts through the
      traces wire), the owned cells of ``dg_apply<double>``,
      ``dg_residual<float>`` and ``dg_cheb<float>`` against
      ``DGOperator`` on the whole grid, and of ``dg_apply<double>``
      against :meth:`~.dg_halo.HaloDGLaplace.vmult_plain`;
    * ``comm_reps``: :meth:`~.dg_halo.HaloDGLaplace.comm_split_report` of
      the finest level in float32 for each wire of ``comm_wires``;
    * ``transfer_seed``: each split level's ``restrict`` and
      ``prolongate`` against ``DGTransfer`` on the whole grids
      (``"dg-plain"``), or the slab coupling's ``cg_to_dg`` and
      ``dg_to_cg`` against ``CGDGCoupling`` on the whole grids (``"dg"``),
      and the exchanges each makes;
    * ``single``: the single-device solver on the same rank, bit for bit
      against the decomposed one (a world of one).

    Times are rank 0's wall clock between barriers, each ending in a
    device synchronize; on a card ``peak_bytes`` is the largest rank's
    peak device memory through set-up and solves."""
    from .. import convert
    from .distributed import DistributedMultigridDG

    exact_fn, rhs_fn = dg_problem(problem)
    cuda = ranks.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(ranks.device)
    _sync(ranks)
    t0 = time.perf_counter()
    dm = DistributedMultigridDG(mesh, degree, exact_fn, rhs_fn, ranks,
                                solver=path, kind=kind, n_pre=n_pre,
                                shape=shape)
    if state is not None:
        convert.load_state(dm, state)
    _sync(ranks)
    s = dm.solver
    grid = s.grids[-1] if path == "dg-plain" else s.dg_grid
    cuts = None if dm.slabs is None else dm.slabs.bounds
    out = dict(world=ranks.world, backend=ranks.backend, path=path,
               grid=dm.shape, setup_time=time.perf_counter() - t0,
               dg_dofs=grid.n_dofs, plain_route=s.plain_route,
               levels=dm.distributed_levels(),
               bounds=cuts[0] if cuts is not None and len(cuts) == 1
               else cuts, foreign=_foreign())
    _reset_launches()
    cg_s, sols = [], []
    its = rate = None
    for _ in range(reps):
        _sync(ranks)
        t0 = time.perf_counter()
        sol, its, rate = dm.solve_cg(tolerance=tolerance)
        _sync(ranks)
        cg_s.append(time.perf_counter() - t0)
        sols.append(sol)
        if len(sols) > 2:
            sols.pop(1)
    out["launches"] = _launches(ranks)
    sol = sols[-1]
    out.update(cg_time=min(cg_s), cg_times=cg_s, frac_its=its, rate=rate,
               L2=dm.l2_error(sol))
    if cuda:
        out["peak_bytes"] = ranks.allmax(
            torch.cuda.max_memory_allocated(ranks.device))
    if len(sols) > 1:
        same = torch.equal(dm.owned(sols[0]), dm.owned(sols[-1]))
        out["cg_repeat_equal"] = ranks.allmax(0.0 if same else 1.0) == 0.0
    if collect:
        out["cg"] = _np(dm.collect(sol))
    if reference is not None:
        ref = np.load(reference, mmap_mode="r")
        mine = torch.as_tensor(np.array(ref[dm.owned_cells()]),
                               device=ranks.device)
        own = dm.owned(sol)
        out["cg_ref_diff"] = ranks.allmax(float((own - mine).abs().max()))
        out["cg_ref_max"] = ranks.allmax(float(mine.abs().max()))
        del mine, own
    del sol, sols
    if apply_seed is not None:
        out["apply"] = _dg_apply_check(ranks, dm, grid, apply_seed)
    if comm_reps:
        from ..ops.dg import DGLaplace
        from .dg_halo import HaloDGLaplace

        out["comm"] = {}
        for w in comm_wires:
            halo = HaloDGLaplace(DGLaplace(grid, torch.float32, ranks.device),
                                 ranks, w, bounds=cuts or [[0, grid.cells[0]]])
            out["comm"][w] = halo.comm_split_report(comm_reps)
            del halo
    if transfer_seed is not None:
        out["transfers"] = _dg_transfer_check(ranks, dm, transfer_seed)
    if single:
        out["single"] = _dg_single_check(ranks, dm, mesh, degree, path,
                                         kind, n_pre, tolerance, problem)
    return out


def _dg_apply_check(ranks: Ranks, dm, grid, seed: int) -> dict:
    """The finest slab's ``dg_apply<double>``, ``dg_residual<float>`` and
    ``dg_cheb<float>`` (the solver's own operators) against the whole
    grid's level of the same route (``constant_level``: ``DGOperator`` in
    3-D, the plain operator in 2-D), owned cells; and ``dg_apply<double>``
    against the plain JAX algorithm (``vmult_plain``).  On a 2-D grid the
    names stand for the plain passes that take the kernels' place."""
    from ..ops.dg import DGLaplace
    from ..ops.dg_kernel import smoother_iterates
    from ..ops.dg_precond import JacobiTransformed
    from ..solvers.multigrid_dg import constant_level
    from .dg_halo import HaloDGLaplace

    s, slabs, dev = dm.solver, dm.slabs, ranks.device
    f32 = getattr(s, "op", None) or s.ops[-1]
    f64 = s.op_dp
    rng = np.random.default_rng(seed)
    res = {}

    def part(t):
        """A whole block's slab, its ghosts through the wire."""
        if slabs is None:
            return t.clone()
        return slabs.refresh(slabs.distribute(t, t.dtype, dev))

    def own(t):
        return t if slabs is None else slabs.own(t)

    x = torch.as_tensor(rng.standard_normal(grid.shape), dtype=torch.float64,
                        device=dev)
    whole = constant_level(grid, torch.float64, dev)
    y_slab = getattr(f64, "op", f64).vmult(part(x))
    res["dg_apply<double>"] = _compare(ranks, own(y_slab), _own_cells(
        whole.vmult(x), slabs))
    if slabs is not None:
        halo = HaloDGLaplace(DGLaplace(grid, torch.float64, dev), ranks,
                             bounds=slabs.bounds)
        res["dg_apply<double> vs vmult_plain"] = _compare(
            ranks, own(y_slab),
            halo.slabs.own(halo.vmult_plain(halo.distribute(x))))
        del halo
    del x, whole, y_slab
    whole = constant_level(grid, torch.float32, dev,
                           JacobiTransformed(grid, torch.float32, dev))
    b, xi, xo = smoother_iterates(JacobiTransformed(grid, torch.float64, dev),
                                  seed)
    inner = getattr(f32, "op", f32)
    res["dg_residual<float>"] = _compare(
        ranks, own(inner.vmult_residual(part(b), part(xi))),
        _own_cells(whole.vmult_residual(b, xi), slabs))
    f1, f2 = 0.37, 0.011
    res["dg_cheb<float>"] = _compare(
        ranks, own(inner.cheb_step(part(b), part(xi), part(xo), f1, f2)),
        _own_cells(whole.cheb_step(b, xi, xo, f1, f2), slabs))
    return res


def _own_cells(t: torch.Tensor, slabs) -> torch.Tensor:
    """The cells of a whole block that ``slabs``' rank owns."""
    return t if slabs is None else t[slabs.owned_cells()]


def _dg_transfer_check(ranks: Ranks, dm, seed: int) -> list[dict]:
    """Per split DG-plain level: ``restrict`` of a slab against
    ``DGTransfer`` on the whole grids (the owned coarse cells, or the whole
    replicated level), ``prolongate`` of a fresh coarse slab against it on
    every stored fine cell.  For DG-over-CG: ``cg_to_dg`` of a fresh FE_Q
    slab against ``CGDGCoupling`` on the whole grids on every stored DG
    cell, ``dg_to_cg`` on the owned planes.  With the exchanges each made
    (:attr:`Ranks.exchanges`)."""
    from ..ops.dg_transfer import CGDGCoupling, DGTransfer

    s, dev = dm.solver, ranks.device
    rng = np.random.default_rng(seed)
    rand = lambda shape: torch.as_tensor(rng.standard_normal(shape),
                                         dtype=s.v_dtype, device=dev)

    def counted(fn, *args):
        n0 = ranks.exchanges
        got = fn(*args)
        return got, int(ranks.allmax(ranks.exchanges - n0))

    out = []
    if dm.kind == "dg":
        fe, slabs = s.cg.slabs[s.cg.maxlevel], dm.slabs
        if slabs is None:
            return out
        whole = CGDGCoupling(s.cg.grids[s.cg.maxlevel], s.dg_grid, s.v_dtype,
                             dev)
        u, r = rand(whole.cg.shape), rand(s.dg_grid.shape)
        got, n_up = counted(s.coupling.cg_to_dg,
                            u[fe.stored_index()].contiguous())
        up = _compare(ranks, got, whole.cg_to_dg(u)[slabs.stored_cells()])
        got, n_down = counted(s.coupling.dg_to_cg,
                              slabs.distribute(r, s.v_dtype, dev))
        down = _compare(ranks, fe.own(got),
                        whole.dg_to_cg(r)[fe.owned_index()])
        return [dict(cg_to_dg=up, dg_to_cg=down, cg_to_dg_exchanges=n_up,
                     dg_to_cg_exchanges=n_down)]
    for l in range(1, len(s.grids)):
        fine, coarse = s.slabs[l], s.slabs[l - 1]
        if fine is None:
            continue
        whole = DGTransfer(s.grids[l], s.grids[l - 1], s.v_dtype, dev)
        uf, uc = rand(s.grids[l].shape), rand(s.grids[l - 1].shape)
        tr = s.transfers[l]
        got, n_restrict = counted(tr.restrict,
                                  fine.distribute(uf, s.v_dtype, dev))
        want = whole.restrict(uf)
        if coarse is not None:
            got, want = coarse.own(got), want[coarse.owned_cells()]
        r = _compare(ranks, got, want)
        got, n_prolong = counted(
            tr.prolongate, uc if coarse is None
            else coarse.distribute(uc, s.v_dtype, dev))
        p = _compare(ranks, got, whole.prolongate(uc)[fine.stored_cells()])
        out.append(dict(level=l, coarse_split=coarse is not None,
                        restrict=r, prolongate=p,
                        restrict_exchanges=n_restrict,
                        prolongate_exchanges=n_prolong))
    return out


def _dg_single_check(ranks: Ranks, dm, mesh, degree, path, kind, n_pre,
                     tolerance, problem) -> dict:
    """The single-device DG solver on this rank: its CG solution, frac its
    and rate against the decomposed solver's, bit for bit."""
    from ..solvers.multigrid_dg import MultigridSolverDG, \
        MultigridSolverDGPlain

    exact_fn, rhs_fn = dg_problem(problem)
    cls = MultigridSolverDGPlain if path == "dg-plain" else MultigridSolverDG
    one = cls(mesh, degree, exact_fn, rhs_fn,
              kind=kind or ("gauss" if path == "dg-plain" else "hermite"),
              device=ranks.device,
              **({} if n_pre is None else dict(n_pre=n_pre, n_post=n_pre)))
    x1, its1, rate1 = one.solve_cg(tolerance=tolerance)
    x2, its2, rate2 = dm.solve_cg(tolerance=tolerance)
    return dict(cg_equal=torch.equal(x1, x2) and its1 == its2
                and rate1 == rate2, frac_its=its1,
                L2_equal=one.l2_error(x1, one.exact_quad)
                == dm.l2_error(x2))


def dg_programs(ranks: Ranks, mesh: BrickMesh, runs) -> list[dict]:
    """:func:`dg_program` once for each keyword set of ``runs``, in one
    launch."""
    return [dg_program(ranks, mesh, **kw) for kw in runs]


def programs(ranks: Ranks, calls) -> list:
    """Several programs in one launch (one spawn of the ranks): each of
    ``calls`` is ``(function, args, kwargs)``, a function of this module
    run as ``function(ranks, *args, **kwargs)``; their results in order."""
    return [fn(ranks, *args, **kwargs) for fn, args, kwargs in calls]
