"""solver_dg benchmark: CG on the SIP-DG system at a fixed iteration count,
preconditioned by the transformed Jacobi, with the cell-based operator
against the face-based one.

Twin of ``experiments/solver_dg.py`` (the reference program
solver_dg/program.cc, face-based against cell-based CG).  Run as

    python -m multigrid_tpu_torch.experiments.solver_dg [--degrees 1 2 3 4] \\
        [--steps 12] [--kinds gauss]

Both rows run the same CG loop on the CG vector kernels (``cg_update``,
``cg_dot``, ``cg_xpay`` on the card).  The cell-based operator is
``dg_apply<double>`` (K9) on the card, and above the kernel's degree the
plain ``DGLaplace`` on every device ("(plain)"); the face-based one
(``ops/dg_face.py``, "face (plain)") is plain PyTorch on every device, as
its XLA twin is on the TPU.  The two solutions must agree to 1e-9 of their
largest value (solver_dg/program.cc:240-241).  The JAX driver's third
row, an unfused CG timed against XLA's fused loop, has no counterpart:
PyTorch does not fuse the loop.  Without a card the driver stops with an
error; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from ..devices import driver_device
from ..ops.cg_kernel import cg_dot, cg_update, cg_xpay
from ..ops.dg_face import DGLaplaceFaceBased
from ..ops.dg_kernel import has_kernel
from ..ops.dg_precond import JacobiTransformed
from ..solvers.multigrid_dg import constant_level
from .matvec_dg import bench_grid
from .poisson_cube import _sync

VERIFY_TOL = 1e-9


def cg_fixed(apply, precond, b: torch.Tensor, n_iterations: int):
    """``n_iterations`` of preconditioned CG from x = 0; (x, |r|)."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = precond(r)
    rz = float(cg_dot(r, p))
    rr = float(cg_dot(r, r))
    for _ in range(n_iterations):
        q = apply(p)
        rr = float(cg_update(x, r, p, q, rz / float(cg_dot(p, q))))
        z = precond(r)
        rz_new = float(cg_dot(r, z))
        cg_xpay(p, z, rz_new / rz)
        rz = rz_new
    return x, math.sqrt(rr)


def run(degree: int, kind: str, n_cell_steps: int, n_iterations: int = 50,
        device="cuda") -> dict:
    grid = bench_grid(degree, kind, n_cell_steps, shear=False)
    f64 = torch.float64
    op = constant_level(grid, f64, device, kernel=has_kernel(grid))
    dev = op.device
    face = DGLaplaceFaceBased(grid, f64, dev)
    jac = JacobiTransformed(grid, f64, dev)
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(grid.shape),
                        dtype=f64, device=dev)
    route = "kernel" if dev.type == "cuda" and has_kernel(grid) else "plain"
    results = {}
    for name, apply in ((f"cell-based ({route})", op.vmult),
                        ("face (plain)", face.vmult)):
        cg_fixed(apply, jac.vmult, b, n_iterations)
        best = np.inf
        for _ in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            x, rn = cg_fixed(apply, jac.vmult, b, n_iterations)
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
        per_it = best / n_iterations
        results[name] = (x, per_it)
        print(f"{name:20s} {kind:8s} p={degree} n_dof={grid.n_dofs:>10d}  "
              f"{per_it:.5f} s/it  DoFs/s/it {grid.n_dofs / per_it:.4g}  "
              f"|r|={rn:.3e}", flush=True)
    (x_cell, t_cell), (x_face, t_face) = results.values()
    ref = float(x_face.abs().max())
    verify = float((x_cell - x_face).abs().max()) / ref
    print(f"          verification cell-based vs face solution: "
          f"{verify:.2e}", flush=True)
    if not verify < VERIFY_TOL:
        raise AssertionError(f"{kind} p={degree}: cell-based vs face solution "
                             f"{verify:.3e} >= {VERIFY_TOL:g}")
    return dict(kind=kind, degree=degree, cell_s_per_it=t_cell,
                face_s_per_it=t_face, verify=verify)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--degrees", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--kinds", nargs="+", default=["gauss"],
                    choices=["hermite", "gll", "gauss"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch operators)")
    args = ap.parse_args(argv)
    device = driver_device(args.device)
    rows = []
    for degree in args.degrees:
        for kind in args.kinds:
            rows.append(run(degree, kind, args.steps, device=device))
    return rows


if __name__ == "__main__":
    main()
