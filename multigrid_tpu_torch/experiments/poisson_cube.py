"""poisson_cube experiment: constant-coefficient Poisson on a cube.

Twin of ``experiments/poisson_cube.py`` (the reference program
poisson_cube/program.cc): analytic solution ``prod_d sin(pi k x_d)`` with
k = 3, f = dim (pi k)^2 u on ``[-0.9, 1.0]^dim``, a ladder of cube sizes,
mixed fp32/fp64 multigrid, FMG + CG with the same convergence-table
schema.  Run as

    python -m multigrid_tpu_torch.experiments.poisson_cube 4 minsize maxsize

(positional arguments as the JAX experiment: degree minsize maxsize
n_mg_cycles n_pre n_post {square,doubling}).  ``--dim 2`` runs the 2-D
ladder (the reference refines 2-D meshes three more times), whose levels
run the plain operator on every device (the brick kernels are 3-D).
``--output DIR`` writes each row's FMG solution as a ``.vtr`` file while
the grid stays under ``utils.vtk.SIZE_GUARD`` nodes.  Solves run on the
CUDA device, and the driver stops with an error when there is none;
``--device cpu`` is the only way to run it on the CPU, with the plain
PyTorch operators.

``--devices N`` (N > 1; 0 and 1 mean one device, as in the JAX driver)
runs every row on N ranks of ``torch.distributed``, one process a rank
(``parallel.distributed.DistributedMultigrid``): the ranks form the JAX
experiment's grid (``parallel.sharding.default_grid``: z-slabs below 4 ranks,
a z x y grid from 4 on, 4 -> 2 x 2, 8 -> 2 x 4), and each level splits
into boxes where every rank gets two cells along each split axis; a 2-D
brick splits its two axes the same way.  Rank r runs on
``cuda:(r % cards)``, or the CPU with ``--device cpu``.  ``--backend``
is ``nccl`` (a card for every rank; fewer cards raise) or ``gloo`` (the
CPU, or ranks that share cards).  Rank 0 prints each row with the world
size, grid and backend; the rows carry no matvec columns.  With
``--output`` every rank's owned nodes of the FMG solution are gathered
and rank 0 writes the file, under the same size guard.  ``--deform``
runs on one device only.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..devices import driver_device, resolve
from ..mesh.brick import BrickMesh, doubling_mesh, poisson_cube_mesh
from ..mesh.shapes import deformed_cube
from ..solvers.multigrid import MultigridSolver
from ..solvers.multigrid_general import GeneralMultigridSolver
from ..utils.memory import print_memory_report
from ..utils.tables import print_convergence_table
from ..utils.timing import LevelTimings, time_call
from ..utils.vtk import write_solution

WAVE_NUMBER = 3.0
SIZES = [1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32, 40, 48, 56,
         64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384, 448, 512]


def exact_fn(coords):
    out = 1.0
    for c in coords:
        out = out * np.sin(np.pi * WAVE_NUMBER * c)
    return out


def rhs_fn(coords):
    dim = len(coords)
    return dim * (np.pi * WAVE_NUMBER) ** 2 * exact_fn(coords)


def _rhs_separable_1d(dim):
    """Rank-1 per-axis factors of rhs_fn (f = prod_d f_d(x_d)): lets the
    solver assemble M f on the device from 1-D vectors."""
    k = np.pi * WAVE_NUMBER
    fs = [lambda x: np.sin(k * x) for _ in range(dim)]
    fs[0] = lambda x: dim * k**2 * np.sin(k * x)
    return fs


rhs_fn.separable_1d = _rhs_separable_1d


def build_solver(mesh: BrickMesh, degree: int, n_pre: int = 2,
                 n_post: int = 2, n_cycles: int = 2,
                 device="cuda") -> MultigridSolver:
    return MultigridSolver(mesh, degree, exact_fn, rhs_fn, n_pre=n_pre,
                           n_post=n_post, n_cycles=n_cycles, device=device)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _phase(msg):
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def run_cycle(mesh: BrickMesh, degree: int, n_cycles: int, n_pre: int,
              n_post: int, device="cuda", n_fmg_repeat: int = 3,
              n_cg_repeat: int = 3, n_matvec: int = 50,
              verbose: bool = True, output_dir: str = "") -> dict:
    """One row of the reference convergence table
    (reference poisson_cube/program.cc:255-401); ``output_dir``: write the
    FMG solution there as ``solution_<dofs>.vtr`` (size-guarded)."""
    device = resolve(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _phase("setup...")
    t0 = time.perf_counter()
    solver = build_solver(mesh, degree, n_pre, n_post, n_cycles, device)
    _sync(device)
    grid = solver.grids[solver.maxlevel]
    row = {"cells": mesh.n_cells(mesh.max_level), "dofs": grid.n_dofs,
           "setup_time": time.perf_counter() - t0}
    _phase(f"setup done: {row['setup_time']:.2f} s")

    best = np.inf
    sol = None
    for _ in range(n_fmg_repeat):
        sol = None
        t0 = time.perf_counter()
        sol = solver.solve()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
        _phase(f"fmg rep: {time.perf_counter() - t0:.4f} s")
    row["fmg_time"] = best
    _, _, reduction = solver.solve_analyze()
    _phase("analyze done")
    row["reduction"] = reduction
    row["fmg_L2error"] = solver.l2_error(solver.maxlevel, sol)
    if output_dir:
        # solution dump (reference output_results, program.cc:325-341; the
        # same ~1e5-dof size guard); a card tensor is copied to the host
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, f"solution_{grid.n_dofs}.vtr")
        if write_solution(path, grid, sol.cpu().numpy(), exact_fn):
            _phase(f"wrote {path}")
    del sol
    if verbose and grid.n_dofs < 100_000_000:
        # per-level time table for one V-cycle (print_wall_times,
        # multigrid_solver.h:347-371); the first pass warms up
        timings = LevelTimings()
        defect = solver.rhs[solver.maxlevel].to(solver.v_dtype)
        solver.v_cycle_timed(solver.maxlevel, defect, n_cycles, timings)
        timings.reset()
        solver.v_cycle_timed(solver.maxlevel, defect, n_cycles, timings)
        timings.print_table()
        del defect

    best_cg = np.inf
    sol_cg = None
    for _ in range(n_cg_repeat):
        sol_cg = None
        t0 = time.perf_counter()
        sol_cg, its, red = solver.solve_cg()
        _sync(device)
        best_cg = min(best_cg, time.perf_counter() - t0)
        _phase(f"cg rep: {time.perf_counter() - t0:.4f} s ({its} its)")
    row["cg_time"] = best_cg
    row["cg_its"] = its
    row["cg_reduction"] = red
    row["cg_L2error"] = solver.l2_error(solver.maxlevel, sol_cg)
    del sol_cg

    # matvec benchmarks (program.cc:343-384), on a fixed random input
    for name, fn, dtype in [("mv_outer", solver.do_matvec, solver.f_dtype),
                            ("mv_inner", solver.do_matvec_smoother,
                             solver.v_dtype)]:
        x = torch.as_tensor(np.random.default_rng(0).normal(size=grid.shape),
                            dtype=dtype, device=device)

        def repeat(a):
            for _ in range(n_matvec):
                fn(a)     # each result is dropped at once: one live output

        fn(x)
        best_mv = np.inf
        for _ in range(3):
            _, sec = time_call(repeat, x)
            best_mv = min(best_mv, sec / n_matvec)
        row[name] = best_mv
        del x
    row["mv_outer_dofs_per_s"] = row["dofs"] / row["mv_outer"]
    row["mv_inner_dofs_per_s"] = row["dofs"] / row["mv_inner"]
    if device.type == "cuda":
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    if verbose:
        print({k: (float(v) if isinstance(v, (np.floating, float)) else v)
               for k, v in row.items()})
        # memory telemetry (reference program.cc:273-279)
        print_memory_report(solver)
    return row


def rank_ladder(ranks, meshes, degree: int, n_cycles: int, n_pre: int,
                reps: int = 3, shape=None, output_dir: str = "") -> list:
    """The rows of ``meshes`` on the ranks (``parallel.sharding.launch``
    runs it on every rank) on the rank grid ``shape``; rank 0 prints each
    row as it ends and, with ``output_dir``, writes its FMG solution as
    ``solution_<dofs>.vtr`` while the grid is under the size guard."""
    from ..mesh.brick import DofGrid
    from ..parallel.programs import cube_program
    from ..utils.vtk import SIZE_GUARD

    rows = []
    for mesh in meshes:
        grid = DofGrid(mesh, mesh.max_level, degree)
        dump = bool(output_dir) and grid.n_dofs <= SIZE_GUARD
        row = cube_program(ranks, mesh, degree, n_cycles, n_pre, reps=reps,
                           shape=shape, collect=dump)
        row.pop("launches")
        fmg = row.pop("fmg", None)
        row.pop("cg", None)
        if ranks.rank == 0:
            if dump:
                os.makedirs(output_dir, exist_ok=True)
                path = os.path.join(output_dir,
                                    f"solution_{grid.n_dofs}.vtr")
                write_solution(path, grid, fmg, exact_fn)
                _phase(f"wrote {path}")
            print({k: v for k, v in row.items()
                   if k not in ("bounds", "foreign")}, flush=True)
        rows.append(row)
    return rows


def run_deformed(args, device) -> list:
    """The deformed-manifold ladder on the general (mapped-mesh) path
    (program.cc:405-484, off by default there too): FMG and CG solves with
    their L2 errors, which converge at the optimal p+1 rate."""
    rows = []
    for n_levels in range(2, 9):
        n_dofs = (2 ** n_levels * 2 * args.degree + 1) ** args.dim
        if n_dofs < args.minsize:
            continue
        if n_dofs > min(args.maxsize, 3_000_000):
            break
        s = GeneralMultigridSolver(
            deformed_cube(2, n_levels=n_levels, dim=args.dim), args.degree,
            exact_fn, rhs_fn, n_pre=args.n_pre_smooth,
            n_post=args.n_post_smooth, n_cycles=args.n_mg_cycles,
            device=device)
        t0 = time.perf_counter()
        sol = s.solve()
        _sync(device)
        fmg_t = time.perf_counter() - t0
        fmg_err = s.l2_error(s.maxlevel, sol)
        t0 = time.perf_counter()
        sol_cg, its, red = s.solve_cg()
        _sync(device)
        cg_t = time.perf_counter() - t0
        row = dict(cells=s.grids[-1].n_cells, dofs=s.grids[-1].n_dofs,
                   fmg_time=fmg_t, fmg_L2error=fmg_err, cg_time=cg_t,
                   cg_its=its, cg_reduction=red,
                   cg_L2error=s.l2_error(s.maxlevel, sol_cg))
        print(row)
        rows.append(row)
    print_convergence_table(rows, dim=args.dim)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("degree", type=int, nargs="?", default=4)
    ap.add_argument("minsize", type=int, nargs="?", default=0)
    ap.add_argument("maxsize", type=int, nargs="?", default=10_000_000)
    ap.add_argument("n_mg_cycles", type=int, nargs="?", default=2)
    ap.add_argument("n_pre_smooth", type=int, nargs="?", default=2)
    ap.add_argument("n_post_smooth", type=int, nargs="?", default=2)
    ap.add_argument("mesh", nargs="?", default="square",
                    choices=["square", "doubling"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch operators)")
    ap.add_argument("--deform", action="store_true",
                    help="sinusoidally deformed cube on the general "
                         "(mapped-mesh) path (reference MyManifold, "
                         "program.cc:405-484)")
    ap.add_argument("--dim", type=int, default=3, choices=[2, 3])
    ap.add_argument("--output", default="",
                    help="directory for .vtr solution dumps (size-guarded "
                         "like the reference's output_results)")
    ap.add_argument("--devices", type=int, default=0,
                    help="run each row on this many ranks (one process a "
                         "rank; z-slabs below 4 ranks, a z x y grid from 4 "
                         "on); 0 or 1: one device")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                    help="torch.distributed backend of --devices: nccl (a "
                         "card for every rank) or gloo (the CPU, or ranks "
                         "sharing a card)")
    args = ap.parse_args(argv)
    ranked = args.devices > 1
    if ranked:
        from ..parallel.sharding import check_backend

        if args.deform:
            raise SystemExit("--devices runs the brick rows (no --deform)")
        check_backend(args.backend, args.devices, args.device)
    device = driver_device(args.device)
    if args.deform:
        return run_deformed(args, device)

    meshes = []
    rows = []
    for cycle, size in enumerate(SIZES):
        mesh = (doubling_mesh(cycle, args.dim) if args.mesh == "doubling"
                else poisson_cube_mesh(size, args.dim))
        grid_dofs = int(np.prod([c * args.degree + 1
                                 for c in mesh.cells(mesh.max_level)]))
        if grid_dofs < args.minsize:
            continue
        if grid_dofs > args.maxsize:
            print(f"Projected size {grid_dofs} higher than max size, terminating.")
            break
        print(f"Cycle {cycle}: {mesh.cells(mesh.max_level)} cells, "
              f"{grid_dofs} dofs")
        if ranked:
            meshes.append(mesh)
            continue
        rows.append(run_cycle(mesh, args.degree, args.n_mg_cycles,
                              args.n_pre_smooth, args.n_post_smooth,
                              device=device, output_dir=args.output))
    if ranked:
        from ..parallel.sharding import default_grid, launch

        if args.n_pre_smooth != args.n_post_smooth:
            raise SystemExit("the reference requires equal pre/post degree")
        shape = default_grid(args.devices)
        print(f"# {args.devices} ranks, grid {'x'.join(map(str, shape))}, "
              f"backend {args.backend}, device {device.type}", flush=True)
        rows = launch(rank_ladder, args.devices, args.backend, device.type,
                      args=(meshes, args.degree, args.n_mg_cycles,
                            args.n_pre_smooth),
                      kwargs=dict(shape=shape, output_dir=args.output))
    print_convergence_table(rows, dim=args.dim)
    return rows


if __name__ == "__main__":
    main()
