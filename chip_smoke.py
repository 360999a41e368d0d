"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels of ``multigrid_tpu_torch/csrc`` from the
sources, holds every kernel against its plain PyTorch version on the card,
then drives the port's main path -- the poisson_cube problem (FE_Q(4),
3-D brick, f32 V-cycle inside f64 FMG and V-cycle-preconditioned CG) at
size 64, 16,974,593 dofs -- and checks the result against the reference's
convergence rows.  Every phase raises on a miss; there is no CPU path.

Output: the card line (``nvidia-smi``), per-phase numbers, one JSON line
with the kernels (device kernels launched during the solve, as a trace
counts them: one brick_apply call is 8 parity-class launches, one CG
reduction 2; max error against the plain version; time of kernel and plain
version), the card line again and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SIZE = 64              # poisson_cube size: 64^3 cells, 16,974,593 dofs
# reference convergence row at size 64 (p = 4, 2 V-cycles, 2+2 smoothing)
CG_ITS = 8
CG_REDUCTION = 6.863e-2
VCYCLE_REDUCTION = 0.1375
ROW_TOL = 0.03
L2_BOUND = 1e-7

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "brick_apply<double>": ("multigrid_tpu_torch/csrc/brick_apply.cu",
                            "multigrid_tpu/ops/pallas_windowed.py:340"),
    "brick_apply<float>": ("multigrid_tpu_torch/csrc/brick_apply.cu",
                           "multigrid_tpu/ops/pallas_windowed_sp.py:408"),
    "cheb_epilogue<float>": ("multigrid_tpu_torch/csrc/brick_apply.cu",
                             "multigrid_tpu/ops/pallas_windowed_sp.py:408"),
    "cheb_epilogue<double>": ("multigrid_tpu_torch/csrc/brick_apply.cu",
                              "multigrid_tpu/ops/pallas_windowed.py:340"),
    "cg_update": ("multigrid_tpu_torch/csrc/cg_vec.cu",
                  "multigrid_tpu/ops/pallas_pairvec.py:149"),
    "cg_dot": ("multigrid_tpu_torch/csrc/cg_vec.cu",
               "multigrid_tpu/ops/pallas_pairvec.py:212"),
    "cg_xpay": ("multigrid_tpu_torch/csrc/cg_vec.cu",
                "multigrid_tpu/ops/pallas_pairvec.py:149"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Device time of one call, from CUDA events over ``reps`` calls."""
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


class KernelChecks:
    """Kernel-vs-plain comparisons; keeps the worst error per kernel."""

    def __init__(self, dev):
        self.dev = dev
        self.err = {k: 0.0 for k in KERNELS}
        self.ms = {}
        self.plain_ms = {}

    def note(self, name, got, want, scale, tol):
        err = float((got - want).abs().max())
        self.err[name] = max(self.err[name], err)
        require(err <= tol * scale,
                f"{name}: max|err| {err:.3e} > {tol:g} * {scale:.3e}")

    def rand(self, shape, dtype, seed):
        a = np.random.default_rng(seed).standard_normal(shape)
        return torch.as_tensor(a, dtype=dtype, device=self.dev)

    def operator_checks(self, grid, timed: bool):
        from multigrid_tpu_torch.ops import laplace_kernel as lk

        for dtype, cname, tol in ((torch.float64, "double", 1e-13),
                                  (torch.float32, "float", 2e-6)):
            op = lk.BrickLaplace(grid, dtype, self.dev)
            x = self.rand(grid.shape, dtype, 1)
            y = lk.brick_apply(x, op)
            y_ref = lk.brick_apply_plain(x, op.K)
            self.note(f"brick_apply<{cname}>", y, y_ref,
                      float(y_ref.abs().max()), tol)
            b = self.rand(grid.shape, dtype, 2)
            x_old = self.rand(grid.shape, dtype, 3)
            if dtype == torch.float32:
                args = dict(x=x, x_old=x_old, lines=op.lines, f1=0.37, f2=0.81)
                etol = 3e-6
            else:
                args = dict(x=x, residual_only=True)
                etol = 1e-14
            got = lk.cheb_epilogue(b, y_ref, **args)
            want = lk.cheb_epilogue_plain(b, y_ref, **args)
            self.note(f"cheb_epilogue<{cname}>", got, want,
                      float(want.abs().max()), etol)
            if timed:
                self.ms[f"brick_apply<{cname}>"] = time_ms(
                    lambda: lk.brick_apply(x, op))
                self.plain_ms[f"brick_apply<{cname}>"] = time_ms(
                    lambda: lk.brick_apply_plain(x, op.K))
                self.ms[f"cheb_epilogue<{cname}>"] = time_ms(
                    lambda: lk.cheb_epilogue(b, y_ref, **args))
                self.plain_ms[f"cheb_epilogue<{cname}>"] = time_ms(
                    lambda: lk.cheb_epilogue_plain(b, y_ref, **args))

    def cg_checks(self, n: int, timed: bool):
        from multigrid_tpu_torch.ops import cg_kernel as ck

        f64 = torch.float64
        x, r, p, q, z = (self.rand((n,), f64, s) for s in range(10, 15))
        alpha, beta = 0.7234912384001122, 0.3141592653589793
        x1, r1 = x.clone(), r.clone()
        rr = ck.cg_update(x1, r1, p, q, alpha)
        x2, r2 = x.clone(), r.clone()
        rr_ref = ck.cg_update_plain(x2, r2, p, q, alpha)
        self.note("cg_update", x1, x2, float(x2.abs().max()), 1e-14)
        self.note("cg_update", r1, r2, float(r2.abs().max()), 1e-14)
        self.note("cg_update", rr, rr_ref, float(rr_ref), 1e-14)
        p1, p2 = p.clone(), p.clone()
        ck.cg_xpay(p1, z, beta)
        ck.cg_xpay_plain(p2, z, beta)
        self.note("cg_xpay", p1, p2, float(p2.abs().max()), 1e-14)
        d = ck.cg_dot(r, z)
        d_ref = ck.cg_dot_plain(r, z)
        self.note("cg_dot", d, d_ref, float((r * z).abs().sum()), 1e-14)
        if timed:
            a = 1e-3
            self.ms["cg_update"] = time_ms(lambda: ck.cg_update(x1, r1, p, q, a))
            self.plain_ms["cg_update"] = time_ms(
                lambda: ck.cg_update_plain(x2, r2, p, q, a))
            self.ms["cg_dot"] = time_ms(lambda: ck.cg_dot(r, z))
            self.plain_ms["cg_dot"] = time_ms(lambda: ck.cg_dot_plain(r, z))
            self.ms["cg_xpay"] = time_ms(lambda: ck.cg_xpay(p1, z, 1e-3))
            self.plain_ms["cg_xpay"] = time_ms(
                lambda: ck.cg_xpay_plain(p2, z, 1e-3))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on the card")
    from multigrid_tpu_torch import _build
    from multigrid_tpu_torch.solvers.multigrid import set_full_precision_matmul

    dev = torch.device("cuda", 0)
    set_full_precision_matmul()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"nvcc: {nvcc}")

    # phase 1: build from the sources in this checkout
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    return run(dev, card)


def run(dev: torch.device, card: str) -> int:
    """Phases 2 and 3 on ``dev``: kernel checks, then the main path."""
    from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid, poisson_cube_mesh
    from multigrid_tpu_torch.experiments.poisson_cube import build_solver
    from multigrid_tpu_torch.ops import cg_kernel, laplace_kernel

    # phase 2: every kernel against its plain version on the card
    checks = KernelChecks(dev)
    shapes = [
        ("poisson_cube_mesh(8)", DofGrid(poisson_cube_mesh(8), 3, 4), False),
        ("anisotropic (3,4,5)",
         DofGrid(BrickMesh((3, 4, 5), (-0.9,) * 3, (1.9, 1.3, 1.1)), 0, 4),
         False),
        (f"poisson_cube_mesh({SIZE})",
         DofGrid(poisson_cube_mesh(SIZE), poisson_cube_mesh(SIZE).max_level, 4),
         True),
    ]
    for label, grid, timed in shapes:
        checks.operator_checks(grid, timed)
        checks.cg_checks(grid.n_dofs, timed)
        torch.cuda.synchronize()
        print(f"kernel checks passed at {label}: {grid.shape}")
    for k in KERNELS:
        print(f"  {k}: max|err| {checks.err[k]:.3e}, kernel "
              f"{checks.ms[k]:.4f} ms, plain {checks.plain_ms[k]:.4f} ms "
              f"[{card}]")

    # a small solve on the card against the same solve on the CPU
    small = poisson_cube_mesh(4)
    u_gpu = build_solver(small, 4, device=dev).solve().cpu()
    u_cpu = build_solver(small, 4, device="cpu").solve()
    diff = float((u_gpu - u_cpu).abs().max())
    require(diff <= 1e-5 * float(u_cpu.abs().max()),
            f"size-4 FMG on the card vs CPU: max diff {diff:.3e}")
    print(f"size-4 FMG card vs CPU: max diff {diff:.3e}")

    # phase 3: the main path at size 64
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    solver = build_solver(poisson_cube_mesh(SIZE), 4, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_dofs = solver.grids[solver.maxlevel].n_dofs
    print(f"setup: {setup_s:.2f} s for {n_dofs} dofs [{card}]")

    laplace_kernel.reset_launches()
    cg_kernel.reset_launches()
    fmg_s = []
    sol = None
    for _ in range(3):
        sol = None
        t0 = time.perf_counter()
        sol = solver.solve()
        torch.cuda.synchronize()
        fmg_s.append(time.perf_counter() - t0)
    _, report, reduction = solver.solve_analyze()
    cg_s = []
    sol_cg = None
    for _ in range(3):
        sol_cg = None
        t0 = time.perf_counter()
        sol_cg, its, cg_red = solver.solve_cg()
        torch.cuda.synchronize()
        cg_s.append(time.perf_counter() - t0)
    launches = {**laplace_kernel.LAUNCHES, **cg_kernel.LAUNCHES}

    fmg_l2 = solver.l2_error(solver.maxlevel, sol)
    cg_l2 = solver.l2_error(solver.maxlevel, sol_cg)
    mem = torch.cuda.max_memory_allocated(dev)
    print(f"fmg: {min(fmg_s):.4f} s (runs {', '.join(f'{s:.4f}' for s in fmg_s)})"
          f", L2 {fmg_l2:.4e}, V-cycle reduction {reduction:.4e} [{card}]")
    print(f"cg: {min(cg_s):.4f} s (runs {', '.join(f'{s:.4f}' for s in cg_s)})"
          f", {its} its, reduction {cg_red:.4e}, L2 {cg_l2:.4e} [{card}]")
    print(f"max_memory_allocated: {mem} bytes [{card}]")
    for name, fn, dtype in (("dp", solver.do_matvec, solver.f_dtype),
                            ("sp", solver.do_matvec_smoother, solver.v_dtype)):
        x = checks.rand(solver.grids[solver.maxlevel].shape, dtype, 0)
        ms = time_ms(lambda: fn(x))
        print(f"{name} matvec: {ms / 1e3:.6f} s, {n_dofs / (ms / 1e3):.4e} "
              f"DoF/s [{card}]")
    print(f"launches during the solve: {launches}")

    require(its == CG_ITS, f"cg_its {its} != {CG_ITS}")
    require(abs(cg_red / CG_REDUCTION - 1) <= ROW_TOL,
            f"cg reduction {cg_red:.4e} vs {CG_REDUCTION}")
    require(abs(reduction / VCYCLE_REDUCTION - 1) <= ROW_TOL,
            f"V-cycle reduction {reduction:.4e} vs {VCYCLE_REDUCTION}")
    for name, v in (("fmg", fmg_l2), ("cg", cg_l2)):
        require(np.isfinite(v) and v < L2_BOUND, f"{name} L2 error {v}")
    require(sol.shape == solver.grids[solver.maxlevel].shape
            and bool(torch.isfinite(sol).all()), "FMG solution not finite")
    for k in KERNELS:
        require(launches[k] > 0, f"kernel {k} was not launched by the solve")

    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=launches[k], max_abs_err=checks.err[k],
                    ms=checks.ms[k], plain_ms=checks.plain_ms[k])
               for k, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
