"""poisson_l experiment: adaptive-mesh Poisson with a reentrant-corner
singularity on the L-shaped domain, 2-D or 3-D (``--dim 3``).

Twin of ``experiments/poisson_l.py`` (the reference program
poisson_l/program.cc): the 2-D hyper_L ``[-1,1]^2`` minus ``[0,1]^2``,
deal.II's ``LSingularityFunction`` u = r^(2/3) sin(2 phi / 3) (harmonic,
f = 0, inhomogeneous Dirichlet data); ``--dim 3`` is the extruded L
(program.cc:478-492; here the prism ``L x [-1,1]``, so the octree cells
stay cubes) with face and edge hanging nodes.  The whole adaptive loop
(program.cc:502-543): solve -> Kelly estimator ->
``refine_and_coarsen_fixed_number(0.15, 0.03)`` -> the new mesh with its
hanging-node constraints -> the solution carried to it, each cycle solved
by CG preconditioned by one V-cycle (global coarsening; the reference's
local smoothing with ``--local-smoothing``).  Run as

    python -m multigrid_tpu_torch.experiments.poisson_l [cycles] \\
        [--degree 2] [--dim 2] [--initial N] [--uniform] [--local-smoothing]

Each cycle prints one row: cells, dofs, constraints, val_L2, grad_L2,
solver_its, reduction, estimator, setup_time (the host set-up of the
meshes, operators, transfers and smoothers), solve_time, and from the
second cycle transfer_rel_diff (the previous solution interpolated to the
new mesh against the new solution); on the card also the peak device
memory.  ``--uniform`` refines uniformly instead.  Solves run on the CUDA
device, and the program stops with an error when there is none; ``--device
cpu`` runs on the CPU.  The set-up is host Python, as in the JAX twin; the
operators are plain PyTorch and the outer CG runs the CG kernels on the
card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..devices import driver_device
from ..mesh.adaptive import AdaptiveGrid, OctForest, QuadForest
from ..ops.laplace_adaptive import KellyEstimator
from ..solvers.multigrid_adaptive import AdaptiveMultigridSolver, NestedTransfer
from ..solvers.multigrid_local import LocalSmoothingMultigrid
from ..utils.memory import device_memory_stats
from .poisson_cube import _sync


def exact_fn(coords):
    """deal.II Functions::LSingularityFunction (zero in the closed first
    quadrant, which holds both reentrant edges); independent of z in 3-D
    (the extruded L keeps the 2-D corner singularity,
    program.cc:85-139)."""
    x, y = np.asarray(coords[0], float), np.asarray(coords[1], float)
    phi = np.arctan2(y, -x) + np.pi
    r2 = x * x + y * y
    val = np.cbrt(np.maximum(r2, 1e-300)) * np.sin(2.0 / 3.0 * phi)
    out = np.where((x >= 0) & (y >= 0), 0.0, val)
    if len(coords) == 3:     # broadcast across z
        out = out + 0.0 * np.asarray(coords[2], float)
    return out


def grad_exact(coords):
    x, y = np.asarray(coords[0], float), np.asarray(coords[1], float)
    phi = np.arctan2(y, -x) + np.pi
    r2 = np.maximum(x * x + y * y, 1e-300)
    r = np.sqrt(r2)
    u_r = 2.0 / 3.0 * r ** (-1.0 / 3.0) * np.sin(2.0 / 3.0 * phi)
    u_phi = r ** (2.0 / 3.0) * 2.0 / 3.0 * np.cos(2.0 / 3.0 * phi)
    gx = u_r * x / r + u_phi * (y / r2)
    gy = u_r * y / r + u_phi * (-x / r2)
    mask = (x >= 0) & (y >= 0)
    out = [np.where(mask, 0.0, gx), np.where(mask, 0.0, gy)]
    if len(coords) == 3:
        z = np.asarray(coords[2], float)
        out = [o + 0.0 * z for o in out] + [0.0 * z + 0.0 * x]
    return out


def rhs_fn(coords):
    return 0.0 * coords[0]


def boundary_fn(xy):
    """Dirichlet on the whole L (prism) boundary (program.cc:486-491:
    boundary_id 0 on all faces of the extruded variant)."""
    x, y = xy[:, 0], xy[:, 1]
    tol = 1e-9
    on = (np.abs(x + 1) < tol) | (np.abs(y + 1) < tol)
    on |= (np.abs(x - 1) < tol) & (y <= tol)
    on |= (np.abs(y - 1) < tol) & (x <= tol)
    on |= (np.abs(x) < tol) & (y >= -tol)
    on |= (np.abs(y) < tol) & (x >= -tol)
    if xy.shape[1] == 3:
        z = xy[:, 2]
        on |= (np.abs(z + 1) < tol) | (np.abs(z - 1) < tol)
    return on


def l_forest(n_uniform: int, dim: int = 2):
    """The L-shaped base, ``[-1,1]^dim`` without the (x > 0, y > 0)
    quadrant (column), refined uniformly ``n_uniform`` times."""
    if dim == 2:
        f = QuadForest(2, -1.0, 2.0,
                       root_mask=lambda ix, iy: not (ix == 1 and iy == 1))
    else:
        f = OctForest(2, -1.0, 2.0,
                      root_mask=lambda ix, iy, iz: not (ix == 1 and iy == 1))
    for _ in range(n_uniform):
        f = f.uniform_refine()
    return f


def mg_ladder(forest, degree: int, min_cells: int = 4):
    """The global-coarsening mesh ladder, coarsest first."""
    forests = [forest]
    while forests[0].n_cells > min_cells:
        c = forests[0].coarsen_global()
        if c.n_cells == forests[0].n_cells:
            break
        forests.insert(0, c)
    return [AdaptiveGrid(f, degree, boundary_fn) for f in forests]


def refine_and_coarsen_fixed_number(forest, eta2, top, bottom):
    """deal.II GridRefinement::refine_and_coarsen_fixed_number: the
    ``int(top n)`` cells of largest ``eta2`` refined, the ``int(bottom n)``
    smallest coarsened."""
    order = forest.sorted_cells()
    idx = np.argsort(eta2)[::-1]
    n_ref = int(top * len(order))
    n_coa = int(bottom * len(order))
    marks_r = [order[i] for i in idx[:n_ref]]
    marks_c = [order[i] for i in idx[len(order) - n_coa:]] if n_coa else []
    return forest.refine(marks_r, marks_c)


def build_solver(forest, degree: int, local_smoothing: bool = False,
                 device="cuda"):
    """The solver of one cycle: global coarsening over the mesh ladder,
    or the reference's local smoothing on the forest's level meshes."""
    if local_smoothing:
        return LocalSmoothingMultigrid(AdaptiveGrid(forest, degree,
                                                    boundary_fn),
                                       exact_fn, rhs_fn, device=device)
    return AdaptiveMultigridSolver(mg_ladder(forest, degree), exact_fn,
                                   rhs_fn, device=device)


def errors(s, sol):
    """deal.II-style absolute norms of the error (integrate_difference,
    program.cc:557-578): (val_L2, grad_L2)."""
    op = s.op_dp
    dim = op.dim
    qxy = op.quad_points()
    qc = [qxy[..., d] for d in range(dim)]
    uq = op._to_quad(op.gather(sol)).reshape(-1, op.N).cpu().numpy()
    jxw = op.jxw().cpu().numpy()
    val_l2 = float(np.sqrt((((uq - exact_fn(qc)) ** 2) * jxw).sum()))
    qshape = (-1,) + (op.n,) * dim
    gex = grad_exact([qxy[..., d].reshape(qshape) for d in range(dim)])
    return val_l2, float(op.h1_seminorm_error(sol, gex))


def run_cycle(forest, degree, rtol=1e-9, local_smoothing=False,
              device="cuda"):
    """Set up and solve one cycle; returns (row, solution, eta2, solver)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    s = build_solver(forest, degree, local_smoothing, device)
    _sync(s.device)
    setup_t = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol, its, red = s.solve_cg(rtol=rtol)
    _sync(s.device)
    solve_t = time.perf_counter() - t0
    g = s.grids[-1]
    val_l2, grad_l2 = errors(s, sol)
    eta2 = KellyEstimator(s.op_dp)(sol)
    row = dict(cells=g.n_cells, dofs=g.n_dofs, constraints=g.n_constraints,
               val_L2=val_l2, grad_L2=grad_l2, solver_its=its, reduction=red,
               estimator=float(np.sqrt(eta2.sum())), setup_time=setup_t,
               solve_time=solve_t)
    if s.device.type == "cuda":
        row["peak_bytes"] = device_memory_stats(s.device)["peak_bytes_in_use"]
    return row, sol, eta2, s


def transfer_rel_diff(grid, prev_grid, prev_sol, sol) -> float:
    """The previous cycle's solution interpolated to the new mesh
    (SolutionTransfer, program.cc:536-542), against the new solution."""
    tr = NestedTransfer(grid, prev_grid, torch.float64, sol.device)
    u0 = tr.interpolate(prev_sol)
    return float(torch.linalg.norm(u0 - sol) / torch.linalg.norm(sol))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("cycles", type=int, nargs="?", default=8)
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3),
                    help="3 = extruded-L octree AMR (program.cc:478-492)")
    ap.add_argument("--initial", type=int, default=None,
                    help="uniform refinements of the L base (reference: 5 in "
                         "2-D, 3 in 3-D; default here 3 / 1)")
    ap.add_argument("--top-fraction", type=float, default=0.15)
    ap.add_argument("--bottom-fraction", type=float, default=0.03)
    ap.add_argument("--max-dofs", type=int, default=2_000_000)
    ap.add_argument("--uniform", action="store_true",
                    help="uniform refinement instead of adaptive")
    ap.add_argument("--local-smoothing", action="store_true",
                    help="level-local smoothing with interface operators "
                         "(the reference's preconditioner) instead of global "
                         "coarsening")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    device = driver_device(args.device)
    if args.initial is None:
        args.initial = 3 if args.dim == 2 else 1
    forest = l_forest(args.initial, args.dim)
    rows = []
    prev = None
    for _ in range(args.cycles):
        row, sol, eta2, s = run_cycle(forest, args.degree,
                                      local_smoothing=args.local_smoothing,
                                      device=device)
        if prev is not None:
            row["transfer_rel_diff"] = transfer_rel_diff(s.grids[-1], *prev,
                                                         sol)
        print({k: (float(v) if isinstance(v, (float, np.floating)) else v)
               for k, v in row.items()}, flush=True)
        rows.append(row)
        prev = (s.grids[-1], sol)
        del s
        if row["dofs"] > args.max_dofs:
            break
        if args.uniform:
            forest = forest.uniform_refine()
        else:
            forest = refine_and_coarsen_fixed_number(
                forest, eta2, args.top_fraction, args.bottom_fraction)

    hdr = ["cells", "dofs", "val_L2", "grad_L2", "solver_its"]
    print("\n" + "  ".join(f"{h:>10s}" for h in hdr))
    for r in rows:
        print("  ".join(
            f"{r[h]:10.4g}" if isinstance(r[h], float) else f"{r[h]:10d}"
            for h in hdr))
    return rows


if __name__ == "__main__":
    main()
