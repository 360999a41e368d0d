"""matvec_dg_cheby benchmark: the single-precision DG Chebyshev step (A·x,
the transformed Jacobi and the update in one pass) and the transformed
Jacobi alone.

Twin of ``experiments/matvec_dg_cheby.py`` (the reference program
matvec_dg_cheby/program.cc).  Run as

    python -m multigrid_tpu_torch.experiments.matvec_dg_cheby \\
        [--degrees 3 4 5] [--steps 12] [--kind gauss]

On the card the step is ``dg_cheb<float>`` (K8), on the CPU its plain
PyTorch version; above the kernel's degree (``dg_kernel.MAX_DEGREE``,
16) it is the step composed over the plain ``DGLaplace`` on every device
("(plain)").  Each is verified against the step composed in float64
(``solvers/fused.vmult_with_chebyshev_update`` over the plain operator and
``JacobiTransformed``) at 1e-5 of its largest value, ``dg_cheb``'s bar.
``JacobiTransformed.vmult`` is plain PyTorch on every device.  Without a
card the driver stops with an error; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..devices import driver_device
from ..ops.dg import DGLaplace
from ..ops.dg_kernel import has_kernel
from ..ops.dg_precond import JacobiTransformed
from ..solvers.fused import vmult_with_chebyshev_update
from ..solvers.multigrid_dg import constant_level
from .matvec_dg import bench_grid, best_seconds

F1, F2 = 0.6, 0.2
VERIFY_TOL = 1e-5


def run(degree: int, kind: str, n_cell_steps: int, device="cuda") -> dict:
    grid = bench_grid(degree, kind, n_cell_steps, shear=False)
    f32, f64 = torch.float32, torch.float64
    jac = JacobiTransformed(grid, f32, device)
    dev = jac.device
    op = constant_level(grid, f32, dev, jac, kernel=has_kernel(grid))
    rng = np.random.default_rng(0)
    rhs, x = (torch.as_tensor(rng.standard_normal(grid.shape), dtype=f32,
                              device=dev) for _ in range(2))
    x_old = torch.zeros_like(x)
    got = op.cheb_step(rhs, x, x_old, F1, F2)
    want, _ = vmult_with_chebyshev_update(
        DGLaplace(grid, f64, dev).apply,
        JacobiTransformed(grid, f64, dev).vmult,
        rhs.double(), F1, F2, x.double(), x_old.double())
    verify = float((got.double() - want).abs().max() / want.abs().max())
    n_rep = max(5, min(50, 20_000_000 // grid.n_dofs))
    state = [x, x_old]

    def step():
        state[0], state[1] = op.cheb_step(rhs, *state, F1, F2), state[0]

    route = "kernel" if dev.type == "cuda" and has_kernel(grid) else "plain"
    best = best_seconds(step, n_rep, dev)
    print(f"Chebyshev step ({route}) {kind:8s} p={degree} n_dof="
          f"{grid.n_dofs:>10d}  {best:.5f} s  DoFs/s {grid.n_dofs / best:.4g}"
          f"  verify vs f64 {verify:.2e}", flush=True)
    # the transformed Jacobi alone (program.cc:183-252)
    best_j = best_seconds(lambda: jac.vmult(rhs), n_rep, dev)
    print(f"JacobiTransformed (plain) {kind:8s} p={degree} n_dof="
          f"{grid.n_dofs:>10d}  {best_j:.5f} s  DoFs/s "
          f"{grid.n_dofs / best_j:.4g}", flush=True)
    if not verify < VERIFY_TOL:
        raise AssertionError(f"{kind} p={degree}: verify {verify:.3e} >= "
                             f"{VERIFY_TOL:g}")
    return dict(kind=kind, degree=degree, seconds=best, jacobi_seconds=best_j,
                verify=verify)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--degrees", type=int, nargs="+", default=[3, 4, 5])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--kind", default="gauss",
                    choices=["hermite", "gll", "gauss"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch step)")
    args = ap.parse_args(argv)
    device = driver_device(args.device)
    rows = []
    for degree in args.degrees:
        rows.append(run(degree, args.kind, args.steps, device))
    return rows


if __name__ == "__main__":
    main()
