"""Rank programs: module-level functions that :func:`.sharding.launch`
runs on every rank, each returning rank 0's view as plain numbers and
numpy arrays (a spawned rank imports this module and nothing of its
caller's).

* :func:`halo_program`: one :class:`~.halo.HaloLaplace` level: the
  collected ``vmult`` of a given grid vector, an owned-plane dot and a
  few CG iterations in the distributed layout;
* :func:`p2p_probe`: whether the backend sends a CUDA tensor from one
  rank to another;
* :func:`cube_program`: poisson_cube on a
  :class:`~.distributed.DistributedMultigrid` (FMG, V-cycle reduction,
  CG, L2 errors), with the checks of a decomposed solve against the
  single-device one: the owned planes of the distributed apply against
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
from .halo import HaloLaplace
from .sharding import Ranks


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _sync(ranks: Ranks) -> None:
    if ranks.device.type == "cuda":
        torch.cuda.synchronize(ranks.device)
    ranks.barrier()


def halo_program(ranks: Ranks, grid: DofGrid, x: np.ndarray,
                 dtype=torch.float64, n_cg: int = 0,
                 comm_reps: int = 0) -> dict:
    """``vmult`` of the global ``x`` (collected), ``x . A x`` by the owned
    planes, ``n_cg`` unpreconditioned CG iterations on ``A u = b`` with
    ``b`` = ``x`` on the interior, 0 on the boundary (the collected
    ``u``), and with ``comm_reps`` the exchange split of the ``vmult``
    (:meth:`~.halo.HaloLaplace.comm_split_report`).  ``foreign``: the
    modules of JAX or of the JAX package the rank has loaded (none)."""
    halo = HaloLaplace(grid, ranks, dtype)
    xd = halo.distribute(x)
    y = halo.vmult(xd)
    out = dict(vmult=_np(halo.collect(y)), x_ax=float(halo.dot(xd, y)),
               levels=halo.slabs.bounds,
               foreign=[m for m in sys.modules if m.split(".")[0]
                        in ("jax", "jaxlib", "multigrid_tpu", "experiments")])
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


def p2p_probe(ranks: Ranks) -> list[str]:
    """Rank 0 sends a tensor on its device to rank 1 with the group's
    backend: each rank's outcome, "ok" or the first line of its error."""
    import torch.distributed as dist

    want = torch.arange(4, dtype=torch.float64)
    t = want.to(ranks.device) if ranks.rank == 0 else torch.zeros(
        4, dtype=torch.float64, device=ranks.device)
    try:
        if ranks.rank == 0:
            dist.send(t, 1)
            msg = "ok"
        else:
            dist.recv(t, 0)
            msg = "ok" if torch.equal(t.cpu(), want) else f"received {t}"
    except RuntimeError as e:
        msg = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    out = [None] * ranks.world
    dist.all_gather_object(out, msg)
    return out


def _launches(ranks: Ranks) -> dict:
    """The kernels' launch counts, summed over the ranks."""
    from ..ops import cg_kernel, laplace_kernel

    mine = {**laplace_kernel.LAUNCHES, **cg_kernel.LAUNCHES}
    names = sorted(mine)
    t = torch.tensor([mine[k] for k in names], dtype=torch.float64,
                     device="cpu" if ranks.backend == "gloo" else ranks.device)
    if ranks.world > 1:
        import torch.distributed as dist

        dist.all_reduce(t)
    return {k: int(v) for k, v in zip(names, t.tolist())}


def _reset_launches() -> None:
    from ..ops import cg_kernel, laplace_kernel

    laplace_kernel.reset_launches()
    cg_kernel.reset_launches()


def cube_program(ranks: Ranks, mesh: BrickMesh, degree: int = 4,
                 n_cycles: int = 2, n_pre: int = 2,
                 reps: int = 1, state: Optional[dict] = None,
                 collect: bool = False, reference: Optional[str] = None,
                 apply_seed: Optional[int] = None, comm_reps: int = 0,
                 single: bool = False) -> dict:
    """poisson_cube on ``mesh`` (a cube ladder's brick) on the ranks.  Always: set-up seconds, FMG
    seconds (best of ``reps``), V-cycle reduction, FMG L2, CG seconds,
    its, reduction, L2, which levels split, and the kernels' launches
    during the solves summed over the ranks.  Options:

    * ``state``: :func:`~..convert.load_state` it before solving;
    * ``collect``: the FMG and CG solutions as whole grids;
    * ``reference``: a ``.npy`` file of the single-device CG solution: the
      largest difference of the owned planes, and max|u|;
    * ``reps`` > 1 also compares the CG solutions of two solves bit for
      bit;
    * ``apply_seed``: the distributed ``vmult`` and ``apply`` of a random
      grid (the seed's) in float32 and float64 against ``BrickLaplace`` on
      the whole grid, owned planes, bit for bit and largest difference;
    * ``comm_reps``: :meth:`~.halo.HaloLaplace.comm_split_report` of the
      finest level in float64, ``comm_reps`` applies a run;
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
                             n_pre=n_pre, n_post=n_pre, n_cycles=n_cycles)
    if state is not None:
        convert.load_state(s, state)
    _sync(ranks)
    out = dict(world=ranks.world, backend=ranks.backend,
               setup_time=time.perf_counter() - t0,
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
        halo = HaloLaplace(s.grids[s.maxlevel], ranks, torch.float64)
        out["comm"] = halo.comm_split_report(comm_reps)
        del halo
    if single:
        out["single"] = _single_check(ranks, s, mesh, degree, n_cycles)
    return out


def _apply_check(ranks: Ranks, s, seed: int) -> dict:
    """The finest level's decomposed ``vmult`` and ``apply`` against
    ``BrickLaplace`` on the whole grid, float32 and float64: whether the
    owned planes are equal bit for bit on every rank, and the largest
    difference."""
    from ..ops.laplace_kernel import BrickLaplace

    g = s.grids[s.maxlevel]
    x = np.random.default_rng(seed).standard_normal(g.shape)
    res = {}
    for dtype, op in ((torch.float32, s.sp_ops[s.maxlevel]),
                      (torch.float64, s.dp_ops[s.maxlevel])):
        whole = BrickLaplace(g, dtype, ranks.device, s.coefficient)
        xg = torch.as_tensor(x, dtype=dtype, device=ranks.device)
        rows = s.owned_rows()
        planes = s.planes(s.maxlevel)
        xs = xg.clone() if planes is None else xg[planes[0]:planes[1]].clone()
        # the slab's own apply: its owned planes need no refresh
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
