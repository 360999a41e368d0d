"""poisson_cube experiment: 3-D constant-coefficient Poisson on a cube.

Twin of ``experiments/poisson_cube.py`` (the reference program
poisson_cube/program.cc): analytic solution ``prod_d sin(pi k x_d)`` with
k = 3, f = dim (pi k)^2 u on ``[-0.9, 1.0]^3``, a ladder of cube sizes,
mixed fp32/fp64 multigrid, FMG + CG with the same convergence-table
schema.  Run as

    python -m multigrid_tpu_torch.experiments.poisson_cube 4 minsize maxsize

(positional arguments as the JAX experiment: degree minsize maxsize
n_mg_cycles n_pre n_post {square,doubling}).  Solves run on the CUDA device,
and the driver stops with an error when there is none; ``--device cpu`` is
the only way to run it on the CPU, with the plain PyTorch operators.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..devices import resolve
from ..mesh.brick import BrickMesh, doubling_mesh, poisson_cube_mesh
from ..solvers.multigrid import MultigridSolver
from ..utils.tables import print_convergence_table
from ..utils.timing import LevelTimings, time_call

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
              verbose: bool = True) -> dict:
    """One row of the reference convergence table
    (reference poisson_cube/program.cc:255-401)."""
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
    return row


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
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu to run on "
                               "the CPU")
        print(f"# device: {torch.cuda.get_device_name(device)}")

    rows = []
    for cycle, size in enumerate(SIZES):
        mesh = (doubling_mesh(cycle) if args.mesh == "doubling"
                else poisson_cube_mesh(size))
        grid_dofs = int(np.prod([c * args.degree + 1
                                 for c in mesh.cells(mesh.max_level)]))
        if grid_dofs < args.minsize:
            continue
        if grid_dofs > args.maxsize:
            print(f"Projected size {grid_dofs} higher than max size, terminating.")
            break
        print(f"Cycle {cycle}: {mesh.cells(mesh.max_level)} cells, "
              f"{grid_dofs} dofs")
        rows.append(run_cycle(mesh, args.degree, args.n_mg_cycles,
                              args.n_pre_smooth, args.n_post_smooth,
                              device=device))
    print_convergence_table(rows, dim=3)
    return rows


if __name__ == "__main__":
    main()
