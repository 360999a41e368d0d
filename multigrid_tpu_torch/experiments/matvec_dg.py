"""matvec_dg benchmark: SIP-DG operator throughput on a sheared
parallelepiped mesh, all three element types.

Twin of ``experiments/matvec_dg.py`` (the reference program
matvec_dg/program.cc:55-77, with its DoFs/s and GFlop/s reporting,
program.cc:176-205).  Run as

    python -m multigrid_tpu_torch.experiments.matvec_dg [--min-degree 1] \\
        [--max-degree 8] [--steps 12] [--dtype float64 float32]

The device picks the operator: on the card ``dg_apply<double>`` (K9) for
float64 and ``dg_apply<float>`` (K7) for float32, on the CPU their plain
PyTorch version.  The kernels stop at p = 16 (``dg_kernel.MAX_DEGREE``,
the top of the JAX package's degree sweep); above it the plain
``DGLaplace`` runs on every device, as the JAX twin's XLA operator does
at every degree, and the row says "(plain)".
Each row is verified
against the face-based operator (``ops/dg_face.py``, plain PyTorch, in
float64 on the same input) as the reference subtracts its reference
operator (program.cc:206-207).  ``--impl curved`` times the per-point
geometry operator (``ops/dg_curved.py``) on the same sheared map given as a
chart, plain PyTorch on every device as its JAX twin is XLA, in the same
rows (DoF/s, float64 and float32).  The TPU flavours of the JAX driver
(``--impl ozaki|df64|pallas``) have no counterpart.  Without a card the
driver stops with an error; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..devices import driver_device
from ..ops.dg import DGGrid
from ..ops.dg_curved import DGCurvedGrid, DGLaplaceCurved
from ..ops.dg_face import DGLaplaceFaceBased
from ..ops.dg_kernel import has_kernel
from ..solvers.multigrid_dg import constant_level
from ..utils.perf_model import dg_matvec_ops
from .poisson_cube import _sync

# bars on max|y - y_face| / max|y_face| (the JAX driver's)
VERIFY_TOL = {torch.float32: 1e-6, torch.float64: 1e-11}


def _bench_box(n_cell_steps: int, shear: bool):
    """Cells per axis, box extents and shear of the benchmark mesh."""
    dim = 3
    base = [(2 if c < n_cell_steps % dim else 1) * 2 ** (n_cell_steps // dim)
            for c in range(dim)]
    left = np.array([-1.0 + 0.05 * (d + 1) for d in range(dim)])
    right = np.array([0.95 - 0.06 * d for d in range(dim)])
    trafo = np.eye(dim)
    if shear:
        trafo = trafo + 0.12 * np.outer(np.arange(1, dim + 1),
                                        np.arange(1, dim + 1))
    return tuple(base), right - left, trafo


def bench_grid(degree: int, kind: str, n_cell_steps: int,
               shear: bool = True) -> DGGrid:
    """The benchmark mesh of reference matvec_dg/program.cc:55-77: 2^(steps
    / 3) cells per axis (the first ``steps % 3`` axes doubled) on a box
    inside [-1, 1]^3, sheared by ``I + 0.12 (a+1)(b+1)`` when ``shear``."""
    base, scale, trafo = _bench_box(n_cell_steps, shear)
    J = trafo @ np.diag(scale / np.array(base))
    return DGGrid(cells=base, jacobian=tuple(tuple(r) for r in J),
                  degree=degree, kind=kind)


def bench_curved_grid(degree: int, kind: str,
                      n_cell_steps: int) -> DGCurvedGrid:
    """The same sheared map as a chart of the per-point geometry operator
    (JAX driver, experiments/matvec_dg.py:53-60): its cell Jacobians are
    :func:`bench_grid`'s, so the face-based operator checks it."""
    base, scale, trafo = _bench_box(n_cell_steps, True)
    return DGCurvedGrid(base, lambda p: (p * scale[None, :]) @ trafo.T,
                        degree, kind)


def best_seconds(fn, n_rep: int, device, rounds: int = 5) -> float:
    """Best over ``rounds`` of the mean host time of ``n_rep`` calls."""
    fn()
    best = np.inf
    for _ in range(rounds):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n_rep):
            fn()
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / n_rep)
    return best


def run(degree: int, kind: str, n_cell_steps: int, dtype=torch.float64,
        device="cuda", impl: str = "fused") -> dict:
    grid = bench_grid(degree, kind, n_cell_steps)
    if impl == "curved":
        op = DGLaplaceCurved(bench_curved_grid(degree, kind, n_cell_steps),
                             dtype, device)
        route = "curved, plain"
    else:
        op = constant_level(grid, dtype, device, kernel=has_kernel(grid))
        route = ("kernel" if op.device.type == "cuda" and has_kernel(grid)
                 else "plain")
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(grid.shape),
                        dtype=dtype, device=op.device)
    y = op.vmult(x)
    y_ref = DGLaplaceFaceBased(grid, torch.float64, op.device).vmult(
        x.double())
    verify = float((y.double() - y_ref).abs().max() / y_ref.abs().max())
    n_rep = max(5, min(100, 20_000_000 // grid.n_dofs))
    best = best_seconds(lambda: op.vmult(x), n_rep, op.device)
    ops = dg_matvec_ops(3, degree, int(np.prod(grid.cells)), kind)
    gbs = 1e-9 * grid.n_dofs * x.element_size() * 3 / best
    print(f"{kind:8s} {str(dtype)[6:]:8s} ({route}) p={degree} "
          f"n_dof={grid.n_dofs:>10d}  {best:.5f} s  DoFs/s "
          f"{grid.n_dofs / best:.4g}  GFlop/s {1e-9 * ops / best:.4g}  GB/s "
          f"{gbs:.4g}  ops/dof {ops / grid.n_dofs:.1f}  verify vs face "
          f"(plain) {verify:.2e}", flush=True)
    if not verify < VERIFY_TOL[dtype]:
        raise AssertionError(f"{kind} p={degree} {dtype}: verify {verify:.3e}"
                             f" >= {VERIFY_TOL[dtype]:g}")
    return dict(kind=kind, degree=degree, dtype=str(dtype), impl=impl,
                route=route, seconds=best, dofs_per_s=grid.n_dofs / best,
                verify=verify)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--min-degree", type=int, default=1)
    ap.add_argument("--max-degree", type=int, default=8)
    ap.add_argument("--steps", type=int, default=12,
                    help="refinement steps (cells = 2^(steps/3))")
    ap.add_argument("--dtype", nargs="+", default=["float64", "float32"],
                    choices=["float64", "float32"])
    ap.add_argument("--impl", default="fused", choices=["fused", "curved"],
                    help="'curved': the per-point geometry operator "
                         "(ops/dg_curved.py, plain PyTorch on every device) "
                         "on the same sheared map as a chart")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch operator)")
    args = ap.parse_args(argv)
    device = driver_device(args.device)
    rows = []
    for degree in range(args.min_degree, args.max_degree + 1):
        for kind in ("hermite", "gll", "gauss"):
            for name in args.dtype:
                rows.append(run(degree, kind, args.steps,
                                getattr(torch, name), device, args.impl))
    return rows


if __name__ == "__main__":
    main()
