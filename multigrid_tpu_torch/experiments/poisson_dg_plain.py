"""poisson_dg_plain experiment: SIP-DG Poisson solved by pure-DG
h-multigrid, looping over the three DG element types per mesh.

Twin of ``experiments/poisson_dg_plain.py`` (the reference program
poisson_dg_plain/program.cc).  Run as

    python -m multigrid_tpu_torch.experiments.poisson_dg_plain degree \\
        minsize maxsize n_pre tolerance [--dim 2] [--var-coeff]

(positional arguments as the JAX experiment; sizes count DG dofs; sizes
with an odd cell count are skipped, since h-multigrid needs one
refinement).  For each of hermite, gll and gauss: the set-up time, the
best of three outer-CG solves, fractional iterations, rate and L2 error
(on the card also the peak device memory), then the convergence table.
``--dim`` defaults to 2, the reference program's setting (and the JAX
driver's).  The DG kernels are 3-D: a 2-D level runs the plain
``DGLaplace`` on every device, as the JAX package runs XLA there, and its
rows say "(plain)".  They stop at p = 9, and the card refuses a 3-D level
above it (the JAX package runs Pallas there).
Solves run on the CUDA device, and the driver stops with an error when
there is none; ``--device cpu`` runs the plain PyTorch operators on the CPU.
``--var-coeff`` solves -div(c grad u) = f (plain PyTorch on every device);
``--deform [FACTOR]`` deforms the mesh interior by ``FACTOR prod sin(pi
p_d)`` (the chart of the JAX driver, default 0.05; the boundary stays, so
the manufactured solution holds) and solves with the curved SIP-DG
operator, plain PyTorch on every device; it composes with ``--var-coeff``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..devices import driver_device
from ..mesh.brick import poisson_cube_mesh
from ..solvers.multigrid_dg import MultigridSolverDGPlain
from ..utils.memory import device_memory_stats
from ..utils.tables import print_convergence_table
from .poisson_cube import SIZES, _sync, exact_fn, rhs_fn

KINDS = ("hermite", "gll", "gauss")
# manufactured solution of --var-coeff, zero on the [-0.9, 1]^dim boundary:
# u = prod sin(w (x_d + 0.9)), c = 1 + u / 2, so grad c = grad u / 2 and
# f = -(|grad u|^2 / 2 + c lap u)
_W = np.pi / 1.9


def varcoeff_exact(q):
    u = 1.0
    for qd in q:
        u = u * np.sin(_W * (qd + 0.9))
    return u


def varcoeff_coeff(q):
    return 1.0 + 0.5 * varcoeff_exact(q)


def varcoeff_rhs(q):
    u = varcoeff_exact(q)
    grad_dot = 0.0
    for d in range(len(q)):
        du = _W
        for e, qd in enumerate(q):
            du = du * (np.cos(_W * (qd + 0.9)) if e == d
                       else np.sin(_W * (qd + 0.9)))
        grad_dot = grad_dot + 0.5 * du * du
    return -(grad_dot + varcoeff_coeff(q) * (-len(q) * _W**2 * u))


def deform_chart(mesh, fac: float):
    """The ``--deform`` chart: the mesh's box with its interior moved by
    ``fac prod sin(pi p_d)`` (JAX driver, experiments/poisson_dg_plain.py:
    88-101)."""
    org = np.asarray(mesh.origin, np.float64)
    lng = np.asarray(mesh.lengths, np.float64)

    def mapping(p):
        s_ = fac * np.prod(np.sin(np.pi * p), axis=1)
        return org[None, :] + lng[None, :] * p + s_[:, None]

    return mapping


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("degree", type=int, nargs="?", default=3)
    ap.add_argument("minsize", type=int, nargs="?", default=0)
    ap.add_argument("maxsize", type=int, nargs="?", default=1_000_000)
    ap.add_argument("n_pre_smooth", type=int, nargs="?", default=3)
    ap.add_argument("tolerance", type=float, nargs="?", default=1e-3)
    ap.add_argument("--dim", type=int, default=2, choices=[2, 3])
    ap.add_argument("--var-coeff", action="store_true",
                    help="solve -div(c grad u) with c = 1 + u / 2 (plain "
                         "PyTorch operators on every device)")
    ap.add_argument("--deform", type=float, nargs="?", const=0.05,
                    default=None, metavar="FACTOR",
                    help="curved SIP-DG: deform the mesh interior by "
                         "FACTOR * prod sin(pi p_d) (the reference MyManifold "
                         "chart, poisson_cube/program.cc:405-484; boundary "
                         "unchanged); composes with --var-coeff")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch operators)")
    args = ap.parse_args(argv)
    device = driver_device(args.device)
    coeff, exact, rhs = None, exact_fn, rhs_fn
    if args.var_coeff:
        coeff, exact, rhs = varcoeff_coeff, varcoeff_exact, varcoeff_rhs

    tables = {}
    for kind in KINDS:
        rows = []
        for size in SIZES:
            if size % 2:
                continue   # pure-DG h-multigrid needs one refinement
            mesh = poisson_cube_mesh(size, args.dim)
            n_dofs = (mesh.n_cells(mesh.max_level)
                      * (args.degree + 1) ** args.dim)
            if n_dofs < args.minsize:
                continue
            if n_dofs > args.maxsize:
                break
            mapping = (None if args.deform is None
                       else deform_chart(mesh, args.deform))
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            s = MultigridSolverDGPlain(mesh, args.degree, exact, rhs,
                                       kind=kind, n_pre=args.n_pre_smooth,
                                       n_post=args.n_pre_smooth,
                                       device=device, coeff_fn=coeff,
                                       mapping=mapping)
            _sync(device)
            setup = time.perf_counter() - t0
            best = np.inf
            sol = None
            for _ in range(3):
                sol = None
                t0 = time.perf_counter()
                sol, frac_its, rate = s.solve_cg(tolerance=args.tolerance)
                _sync(device)
                best = min(best, time.perf_counter() - t0)
            row = dict(cells=mesh.n_cells(mesh.max_level), dofs=n_dofs,
                       setup_time=setup, cg_time=best, cg_its=frac_its,
                       cg_reduction=rate,
                       cg_L2error=s.l2_error(sol, s.exact_quad))
            if device.type == "cuda":
                row["peak_bytes"] = device_memory_stats(device)[
                    "peak_bytes_in_use"]
            route = ("kernels" if device.type == "cuda"
                     and not s.plain_route else "plain")
            print(kind, f"({route})", row, flush=True)
            rows.append(row)
            del s, sol
        print(f"=== element type: {kind}")
        print_convergence_table(rows, dim=args.dim)
        tables[kind] = rows
    return tables


if __name__ == "__main__":
    main()
