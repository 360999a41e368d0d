"""poisson_shell experiment: variable-coefficient Poisson on a 3-D shell.

Twin of ``experiments/poisson_shell.py`` (the reference program
poisson_shell/program.cc): coefficient ``1 + 1e6 prod_e cos^2(2 pi x_e +
0.1 e)``, solution ``sin(2 pi (x+y))``, spherical shell r in [0.5, 1],
FMG and V-cycle-preconditioned CG; cycle k solves on the 6-block
cubed-sphere shell when k is even and on the 12-block one when k is odd,
with ``n_levels = 1 + k // 2`` (program.cc:424-431).  Mixed precision by
default; ``--pure-double`` is the reference's second specialization (an
all-double V-cycle with fourth-kind Chebyshev).  Run as

    python -m multigrid_tpu_torch.experiments.poisson_shell 4 2000000

(positional arguments as the JAX experiment: degree maxsize n_mg_cycles
n_pre n_post).  Solves run on the CUDA device, and the driver stops with an
error when there is none; ``--device cpu`` runs them on the CPU.  Each row
prints its set-up time apart from the solves, the best of 3 FMG and CG
solves, the per-level V-cycle table and, on the card, the peak memory.
"""

from __future__ import annotations

import argparse
import gc
import sys
import time

import numpy as np
import torch

from ..devices import driver_device
from ..mesh.shapes import hyper_shell, hyper_shell_12
from ..solvers.multigrid_general import GeneralMultigridSolver
from ..utils.tables import print_convergence_table
from ..utils.timing import LevelTimings


def exact_fn(coords):
    return np.sin(2 * np.pi * (coords[0] + coords[1]))


def grad_exact(coords):
    g = 2 * np.pi * np.cos(2 * np.pi * (coords[0] + coords[1]))
    return [g, g] + [0.0 * coords[0] for _ in range(len(coords) - 2)]


def laplacian_exact(coords):
    return -2 * (2 * np.pi) ** 2 * exact_fn(coords)


def coef_fn(coords):
    prod = 1.0
    for e, c in enumerate(coords):
        prod = prod * np.cos(2 * np.pi * c + 0.1 * e) ** 2
    return 1.0 + 1.0e6 * prod


def grad_coef(coords):
    out = []
    for d in range(len(coords)):
        prod = 1.0
        for e, c in enumerate(coords):
            t = np.cos(2 * np.pi * c + 0.1 * e)
            if e == d:
                prod = prod * (-4 * np.pi * t * np.sin(2 * np.pi * c + 0.1 * e))
            else:
                prod = prod * t * t
        out.append(1.0e6 * prod)
    return out


def rhs_fn(coords):
    """-(c Lap(u) + grad(c).grad(u)) (program.cc:216-225)."""
    gc_ = grad_coef(coords)
    gu = grad_exact(coords)
    dot = sum(a * b for a, b in zip(gc_, gu))
    return -(coef_fn(coords) * laplacian_exact(coords) + dot)


def shell_mesh(cycle: int):
    """The mesh of ladder cycle ``cycle`` (program.cc:424-431)."""
    build = hyper_shell if cycle % 2 == 0 else hyper_shell_12
    return build(0.5, 1.0, n_levels=1 + cycle // 2)


def shell_dofs(cycle: int, degree: int) -> int:
    """The finest level's dofs of ladder cycle ``cycle``, without building
    it: ``N p + 1`` radial node layers times a closed quadrilateral
    surface of 6 (or 12) faces of ``N p`` x ``N p`` node intervals, which
    has ``faces (N p)^2 + 2`` nodes; ``N = 2^(n_levels - 1)``."""
    faces = 6 if cycle % 2 == 0 else 12
    m = (1 << (cycle // 2)) * degree
    return (m + 1) * (faces * m * m + 2)


def build_solver(mesh, degree: int = 4, n_pre: int = 3, n_cycles: int = 1,
                 pure_double: bool = False, device="cuda"):
    return GeneralMultigridSolver(mesh, degree, exact_fn, rhs_fn,
                                  coef_fn=coef_fn, n_pre=n_pre, n_post=n_pre,
                                  n_cycles=n_cycles, pure_double=pure_double,
                                  device=device)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _phase(msg):
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def run_row(solver, n_cycles: int = 1, repeat: int = 3,
            verbose: bool = True) -> dict:
    """One row of the convergence table: FMG and CG, best of ``repeat``
    each, the L2 errors and (``verbose``) the per-level V-cycle table."""
    dev = solver.device
    L = solver.maxlevel
    fmg_s, sol = [], None
    for _ in range(repeat):
        sol = None
        t0 = time.perf_counter()
        sol = solver.solve()
        _sync(dev)
        fmg_s.append(time.perf_counter() - t0)
    fmg_err = solver.l2_error(L, sol)
    del sol
    if verbose:
        # per-level time table for one V-cycle (print_wall_times,
        # multigrid_solver.h:347-371); the first pass warms up
        timings = LevelTimings()
        defect = solver.rhs[L].to(solver.v_dtype)
        solver.v_cycle_timed(L, defect, n_cycles, timings)
        timings.reset()
        solver.v_cycle_timed(L, defect, n_cycles, timings)
        timings.print_table()
        del defect
    cg_s, sol_cg = [], None
    for _ in range(repeat):
        sol_cg = None
        t0 = time.perf_counter()
        sol_cg, its, red = solver.solve_cg()
        _sync(dev)
        cg_s.append(time.perf_counter() - t0)
    row = dict(cells=solver.grids[L].n_cells, dofs=solver.grids[L].n_dofs,
               fmg_time=min(fmg_s), fmg_L2error=fmg_err, cg_time=min(cg_s),
               cg_its=its, cg_reduction=red,
               cg_L2error=solver.l2_error(L, sol_cg))
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("degree", type=int, nargs="?", default=4)
    ap.add_argument("maxsize", type=int, nargs="?", default=2_000_000)
    # reference defaults: n_mg_cycles 1, pre/post 3 (program.cc:522-524)
    ap.add_argument("n_mg_cycles", type=int, nargs="?", default=1)
    ap.add_argument("n_pre_smooth", type=int, nargs="?", default=3)
    ap.add_argument("n_post_smooth", type=int, nargs="?", default=3)
    ap.add_argument("--pure-double", action="store_true",
                    help="all-double V-cycle with fourth-kind Chebyshev, the "
                         "reference poisson_shell solver specialization "
                         "(multigrid_solver.h:789-1285, 945-963)")
    ap.add_argument("--cycles", type=int, default=8)
    ap.add_argument("--min-cycle", type=int, default=0,
                    help="first cycle to run (cycles are independent)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    if args.n_pre_smooth != args.n_post_smooth:
        ap.error("n_pre_smooth and n_post_smooth must be equal")
    dev = driver_device(args.device)

    rows = []
    for cycle in range(args.min_cycle, args.cycles):
        if shell_dofs(cycle, args.degree) > args.maxsize:
            print("Max size reached, terminating.")
            break
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _phase(f"cycle {cycle}: set-up...")
        t0 = time.perf_counter()
        s = build_solver(shell_mesh(cycle), args.degree, args.n_pre_smooth,
                         args.n_mg_cycles, args.pure_double, dev)
        _sync(dev)
        setup_s = time.perf_counter() - t0
        g_dofs = s.grids[s.maxlevel].n_dofs
        print(f"Cycle {cycle}: {g_dofs} dofs, set-up {setup_s:.2f} s")
        row = run_row(s, args.n_mg_cycles)
        row["setup_time"] = setup_s
        if dev.type == "cuda":
            row["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        print({k: (float(v) if isinstance(v, (np.floating, float)) else v)
               for k, v in row.items()}, flush=True)
        rows.append(row)
        # free the finished cycle before the next, larger one
        del s
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print_convergence_table(rows, dim=3)
    return rows


if __name__ == "__main__":
    main()
