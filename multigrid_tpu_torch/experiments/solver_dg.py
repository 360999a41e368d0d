"""solver_dg benchmark: CG on the SIP-DG system at a fixed iteration count,
preconditioned by the transformed Jacobi: the fused cell-based loop, the
face-based operator and the unfused cell-based loop.

Twin of ``experiments/solver_dg.py`` (the reference program
solver_dg/program.cc: face-based, cell-based and interleaved CG).  Run as

    python -m multigrid_tpu_torch.experiments.solver_dg [--degrees 1 2 3 4] \\
        [--steps 12] [--kinds gauss]

Three rows, as the JAX driver's:

* ``cell-based (fused)``: :func:`cg_fused`, the JAX row's whole loop under
  one jit.  An iteration is two passes with the scalars on the device and
  no host sync: ``dg_cg<double>`` (x += alpha_prev p_old, p = z + beta
  p_old, q = A p, alpha = rz / (p . q)) and ``dg_jacobi_cg<double>`` (r -=
  alpha q, z = P^-1 r, beta).  On the card these are the kernels of
  ``csrc/dg_cg_f64.cu`` where ``dg_kernel.has_cg_kernel`` holds (p =
  1..9); above, and for the face row, the same loop runs their plain
  composition (``vmult_with_cg_update`` and ``JacobiTransformed.vmult``),
  marked "(plain)", over the operator of the unfused row;
* ``face (plain)``: that loop over the face-based operator
  (``ops/dg_face.py``), plain PyTorch on every device, as its XLA twin;
* ``unfused``: :func:`cg_fixed`, every step its own launch (``dg_apply``,
  ``cg_dot``, ``cg_update``, ``cg_xpay`` and the plain Jacobi) and three
  host syncs an iteration; ``dg_apply<double>`` where
  ``dg_kernel.has_kernel`` holds (p = 1..16), else the plain operator,
  marked "(plain)".

Then the fusion speedup (unfused / fused), and both cell-based solutions
against the face-based one to 1e-9 of its largest value
(solver_dg/program.cc:240-241).  Without a card the driver stops with an
error; ``--device cpu`` runs on the CPU (the wrappers' plain versions).
"""

from __future__ import annotations

import argparse
import contextlib
import math
import time
from functools import partial

import numpy as np
import torch

from ..devices import driver_device
from ..ops import cg_kernel
from ..ops import dg_kernel as dk
from ..ops.cg_kernel import cg_dot, cg_update, cg_xpay
from ..ops.dg_face import DGLaplaceFaceBased
from ..ops.dg_precond import JacobiTransformed
from ..solvers.multigrid_dg import constant_level
from .matvec_dg import bench_grid
from .poisson_cube import _sync

VERIFY_TOL = 1e-9


def cg_fixed(apply, precond, b: torch.Tensor, n_iterations: int):
    """``n_iterations`` of preconditioned CG from x = 0, every step its own
    launch and the scalars read on the host; (x, |r|)."""
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


def cg_fused(cg_pass, jacobi_pass, b: torch.Tensor, n_iterations: int):
    """``n_iterations`` of preconditioned CG from x = 0 as the fused loop
    (``vmult_with_cg_update``'s form: each iteration's x update rides on
    the next operator pass), the scalars on the device; (x, |r| as a 0-d
    tensor).  ``cg_pass(p_old, z, x, scal, p, q)`` and
    ``jacobi_pass(r, q, scal, z, first=False)``: ``dg_kernel.dg_cg`` and
    ``dg_jacobi_cg`` or their plain versions.  Nothing here reads a device
    value on the host."""
    x = torch.zeros_like(b)
    r = b.clone()
    z, q, p = (torch.empty_like(b) for _ in range(3))
    p_old = torch.zeros_like(b)
    scal = dk.cg_scalars(b.device)
    jacobi_pass(r, None, scal, z, first=True)
    for _ in range(n_iterations):
        cg_pass(p_old, z, x, scal, p, q)
        jacobi_pass(r, q, scal, z)
        p_old, p = p, p_old
    x.addcmul_(p_old, scal[dk.ALPHA])      # the last iteration's x update
    return x, scal[dk.RR].sqrt()


def fused_passes(op, jac, grid, kernel: bool):
    """The fused loop's two passes: the kernels' wrappers over the
    ``DGOperator`` ``op`` (its Jacobi installed) where ``kernel``, else the
    plain composition over ``op.vmult`` and ``jac.vmult``."""
    if kernel:
        scratch = dk.cg_partials(grid, op.device)
        return (partial(dk.dg_cg, op=op, partial=scratch),
                partial(dk.dg_jacobi_cg, op=op, partial=scratch))

    def cg_pass(p_old, z, x, scal, p, q):
        dk.dg_cg_plain(p_old, z, x, scal, p, q, op.vmult)

    def jacobi_pass(r, q, scal, z, first=False):
        dk.dg_jacobi_cg_plain(r, q, scal, z, jac.vmult, first)

    return cg_pass, jacobi_pass


@contextlib.contextmanager
def no_host_sync(dev: torch.device):
    """On the card, PyTorch raises on any operation that synchronizes with
    the host inside the block (``torch.cuda.set_sync_debug_mode``)."""
    if dev.type != "cuda":
        yield
        return
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def run(degree: int, kind: str, n_cell_steps: int, n_iterations: int = 50,
        device="cuda") -> dict:
    """The three rows of one degree and kind; each row's seconds an
    iteration (best of 3 after one warm-up), the launches an iteration of
    the kernels (``launches``, on the card), and both cell-based solutions'
    distance from the face-based one (``verify``: the larger)."""
    grid = bench_grid(degree, kind, n_cell_steps, shear=False)
    f64 = torch.float64
    # the fused row's route from the fused kernels' gate (p <= 9), the
    # unfused row's operator from the pencil kernels' (p <= 16)
    kernel, fused = dk.has_kernel(grid), dk.has_cg_kernel(grid)
    op = constant_level(grid, f64, device, kernel=kernel)
    dev = op.device
    face = DGLaplaceFaceBased(grid, f64, dev)
    jac = JacobiTransformed(grid, f64, dev)
    if kernel:
        op.install_jacobi(jac)
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(grid.shape),
                        dtype=f64, device=dev)
    on_card = dev.type == "cuda"
    mark = lambda k: "" if k else " (plain)"
    rows = {
        "fused": (f"cell-based (fused){mark(fused)}",
                  partial(cg_fused, *fused_passes(op, jac, grid, fused)),
                  fused and on_card),
        "face": ("face (plain)",
                 partial(cg_fused, *fused_passes(face, jac, grid, False)),
                 False),
        "unfused": (f"unfused{mark(kernel)}",
                    partial(cg_fixed, op.vmult, jac.vmult), False),
    }
    results, launches = {}, {}
    for key, (name, solve, sync_free) in rows.items():
        guard = partial(no_host_sync, dev) if sync_free else \
            contextlib.nullcontext
        with guard():
            solve(b, n_iterations)
        best = np.inf
        for _ in range(3):
            before = {**dk.LAUNCHES, **cg_kernel.LAUNCHES}
            _sync(dev)
            t0 = time.perf_counter()
            with guard():
                x, rn = solve(b, n_iterations)
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
        after = {**dk.LAUNCHES, **cg_kernel.LAUNCHES}
        launches[key] = {k: (after[k] - before[k]) / n_iterations
                         for k in after if after[k] != before[k]}
        per_it = best / n_iterations
        results[key] = (x, per_it)
        print(f"{name:24s} {kind:8s} p={degree} n_dof={grid.n_dofs:>10d}  "
              f"{per_it:.5f} s/it  DoFs/s/it {grid.n_dofs / per_it:.4g}  "
              f"|r|={float(rn):.3e}", flush=True)
    t = {k: v[1] for k, v in results.items()}
    print(f"          fusion speedup (unfused / fused cell-based): "
          f"{t['unfused'] / t['fused']:.2f}x", flush=True)
    if on_card:
        for key in ("fused", "unfused"):
            print(f"          launches an iteration, {rows[key][0]}: "
                  f"{launches[key] or 'none (plain)'}", flush=True)
    x_face = results["face"][0]
    ref = float(x_face.abs().max())
    verify = {}
    for key in ("fused", "unfused"):
        verify[key] = float((results[key][0] - x_face).abs().max()) / ref
        print(f"          verification {rows[key][0]} vs face solution: "
              f"{verify[key]:.2e}", flush=True)
        if not verify[key] < VERIFY_TOL:
            raise AssertionError(
                f"{kind} p={degree}: {rows[key][0]} vs face solution "
                f"{verify[key]:.3e} >= {VERIFY_TOL:g}")
    return dict(kind=kind, degree=degree, n_dofs=grid.n_dofs,
                fused_s_per_it=t["fused"], face_s_per_it=t["face"],
                unfused_s_per_it=t["unfused"], launches=launches,
                verify=max(verify.values()), verify_fused=verify["fused"],
                verify_unfused=verify["unfused"])


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
