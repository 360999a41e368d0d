"""poisson_dg experiment: 3-D SIP-DG Poisson, DG-over-CG multigrid.

Twin of ``experiments/poisson_dg.py`` (the reference program
poisson_dg/program.cc): FE_DGQHermite-like elements, an outer f64 CG at a
user tolerance (default 1e-3) preconditioned by the ``dg_v_cycle``
(reference common/multigrid_solver_dg.h), the matvec telemetry line and a
convergence table with fractional iteration counts.  Run as

    python -m multigrid_tpu_torch.experiments.poisson_dg 4 minsize maxsize \
        n_mg_cycles n_pre n_post square tolerance [--kind hermite]

(positional arguments as the JAX experiment; sizes count DG dofs).  Solves
run on the CUDA device, and the driver stops with an error when there is
none; ``--device cpu`` runs the plain PyTorch operators on the CPU.

``cg_L2error`` plateaus at about 0.1007 by construction, as in the
reference: the right-hand side is the mass integral of f with no weak
Dirichlet data (multigrid_solver_dg.h:243-265) on the cube [-0.9, 1]^3,
where the analytic solution is not zero on the boundary.  The
acceptance numbers are the iteration counts and rates.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..devices import resolve
from ..mesh.brick import poisson_cube_mesh
from ..solvers.multigrid_dg import MultigridSolverDG
from ..utils.perf_model import dg_matvec_model, print_matvec_details
from ..utils.tables import print_convergence_table
from .poisson_cube import SIZES, _sync, exact_fn, rhs_fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("degree", type=int, nargs="?", default=4)
    ap.add_argument("minsize", type=int, nargs="?", default=0)
    ap.add_argument("maxsize", type=int, nargs="?", default=3_000_000)
    ap.add_argument("n_mg_cycles", type=int, nargs="?", default=1)
    ap.add_argument("n_pre_smooth", type=int, nargs="?", default=3)
    ap.add_argument("n_post_smooth", type=int, nargs="?", default=3)
    ap.add_argument("mesh", nargs="?", default="square")
    ap.add_argument("tolerance", type=float, nargs="?", default=1e-3)
    ap.add_argument("--kind", default="hermite",
                    choices=["hermite", "gll", "gauss"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch operators)")
    args = ap.parse_args(argv)
    try:
        device = resolve(args.device)
    except RuntimeError as e:
        raise RuntimeError(f"{e}; pass --device cpu to run on the CPU") from e
    if device.type == "cuda":
        print(f"# device: {torch.cuda.get_device_name(device)}")

    rows = []
    for size in SIZES:
        mesh = poisson_cube_mesh(size)
        n_dofs = mesh.n_cells(mesh.max_level) * (args.degree + 1) ** 3
        if n_dofs < args.minsize:
            continue
        if n_dofs > args.maxsize:
            break
        print(f"cells/dim {size}: {n_dofs} DG dofs")
        t0 = time.perf_counter()
        s = MultigridSolverDG(mesh, args.degree, exact_fn, rhs_fn,
                              kind=args.kind, n_pre=args.n_pre_smooth,
                              n_post=args.n_post_smooth, device=device)
        _sync(device)
        print(f"# setup: {time.perf_counter() - t0:.3f} s")
        best = np.inf
        sol = None
        for _ in range(4):
            sol = None
            t0 = time.perf_counter()
            sol, frac_its, rate = s.solve_cg(tolerance=args.tolerance)
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        err = s.l2_error(sol, s.exact_quad)
        row = dict(cells=mesh.n_cells(mesh.max_level), dofs=n_dofs,
                   cg_time=best, cg_its=frac_its,
                   cg_reduction=rate, cg_L2error=err)
        del sol
        print(row)
        # matvec telemetry (reference poisson_dg/program.cc:266-309)
        op = s.op_dp
        x = torch.as_tensor(
            np.random.default_rng(0).standard_normal(op.shape),
            dtype=op.dtype, device=device)
        op.vmult(x)
        n_rep = max(5, min(50, 5_000_000 // n_dofs))
        best_mv = np.inf
        for _ in range(3):
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(n_rep):
                op.vmult(x)
            _sync(device)
            best_mv = min(best_mv, (time.perf_counter() - t0) / n_rep)
        m = dg_matvec_model(3, args.degree, mesh.n_cells(mesh.max_level),
                            args.kind, x.element_size(), n_dofs, best_mv)
        print_matvec_details(f"matvec:{args.kind}", m, n_dofs)
        rows.append(row)
        del s, x
    print_convergence_table(rows, dim=3)
    return rows


if __name__ == "__main__":
    main()
