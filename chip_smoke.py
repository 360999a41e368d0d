"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels of ``multigrid_tpu_torch/csrc`` from the
sources, holds every kernel against its plain PyTorch version on the card,
then drives the port's two paths and checks each against the reference's
convergence rows:

* poisson_cube (FE_Q(4), 3-D brick, f32 V-cycle inside f64 FMG and
  V-cycle-preconditioned CG) at size 64, 16,974,593 dofs;
* poisson_dg (SIP-DG, hermite p = 4, outer f64 CG preconditioned by DG
  Chebyshev smoothing around the FE_Q V-cycle) at size 48, 13,824,000 DG
  dofs, rtol 1e-9.

Every phase raises on a miss; there is no CPU path.

Output: the card line (``nvidia-smi``), per-phase numbers, one JSON line
with the kernels (device kernels launched during the two solves, as a trace
counts them: one brick_apply call is 8 parity-class launches, one CG
reduction 2, one DG kernel call 1; max error against the plain version;
time of kernel, plain version and, where one PyTorch call computes the same
function, that call; the least time the card could take, from the bytes
and operations the function needs), the card line again and, last,
``{"ok": true, "device": {...}}``.
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
DG_SIZE = 48           # poisson_dg size: 48^3 cells, 13,824,000 DG dofs
DG_RTOL = 1e-9
# reference-parity poisson_dg rows at rtol 1e-9, 1.0M-2.7M DG dofs
# (docs/tpu_r5/poisson_dg_tight.log): L2 plateau 0.100686 (no weak
# boundary data in the rhs), 5.47-5.54 its, rate 0.0226-0.0237
DG_L2, DG_L2_TOL = 0.10069, 1e-3
DG_RATE = (0.018, 0.032)
DG_ITS = (5.2, 6.2)

# the card's peak rates for the bound (H100 SXM, NVIDIA data sheet):
# HBM3 bandwidth; fp32 outside the tensor cores; fp64 on the tensor cores
# (67 TFLOP/s, twice the 34 of the fp64 units), the higher of the two
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}

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
    "dg_apply<double>": ("multigrid_tpu_torch/csrc/dg_apply.cu",
                         "multigrid_tpu/ops/pallas_dg.py:639"),
    "dg_apply<float>": ("multigrid_tpu_torch/csrc/dg_apply.cu",
                        "multigrid_tpu/ops/pallas_dg.py:438"),
    "dg_cheb<float>": ("multigrid_tpu_torch/csrc/dg_apply.cu",
                       "multigrid_tpu/ops/pallas_dg.py:490"),
}
# kernels each path must launch
CUBE_KERNELS = list(KERNELS)[:7]
DG_KERNELS = ["dg_apply<double>", "dg_apply<float>", "dg_cheb<float>",
              "brick_apply<float>", "cheb_epilogue<float>", "cg_update",
              "cg_dot", "cg_xpay"]


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """The least time (ms) for moving ``nbytes`` through HBM and doing
    ``flops`` at the peak rate of ``dtype``, and which of the two binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
        self.rel = {k: 0.0 for k in KERNELS}   # err / the scale of its bar
        self.ms = {}
        self.plain_ms = {}
        self.bound = {}                      # name -> (ms, "bytes"/"operations")
        self.library_ms = {k: None for k in KERNELS}

    def note(self, name, got, want, scale, tol):
        err = float((got - want).abs().max())
        self.err[name] = max(self.err[name], err)
        self.rel[name] = max(self.rel[name], err / scale)
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
                # brick: x in, y out; sum factorization, (14 n + 5) n^3
                # flops a cell.  Epilogue: b, y, x, x_old in, out (f32
                # update, ~15 flops a node); b, y in, out (f64 residual).
                nodes, n = grid.n_dofs, grid.basis.n
                cells = int(np.prod(grid.cells))
                size = x.element_size()
                self.bound[f"brick_apply<{cname}>"] = bound(
                    2 * size * nodes, cells * (14 * n + 5) * n**3, dtype)
                streams, flops = (5, 15) if dtype == torch.float32 else (3, 1)
                self.bound[f"cheb_epilogue<{cname}>"] = bound(
                    streams * size * nodes, flops * nodes, dtype)

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
            # one PyTorch call computing the same function, where one exists
            self.library_ms["cg_dot"] = time_ms(lambda: torch.dot(r, z))
            self.library_ms["cg_xpay"] = time_ms(
                lambda: torch.add(z, p2, alpha=1e-3))
            # bytes: x, r, p, q in, x, r out; a, b in; p, z in, p out
            for name, streams, flops in (("cg_update", 6, 6), ("cg_dot", 2, 2),
                                         ("cg_xpay", 3, 2)):
                self.bound[name] = bound(streams * 8 * n, flops * n, f64)

    def dg_checks(self, grid, timed: bool):
        """The DG kernels against the plain f64 operator: dg_apply<double>
        at 1e-13·max|y|, dg_apply<float> at 3e-6·max|y|, dg_cheb<float> at
        1e-5·max|out| on the smoother's iterates (every term of the step at
        the output's scale), and with f2 = 0 at 1e-6·max|x|; the timed
        plain versions run in the kernel's dtype."""
        from multigrid_tpu_torch.ops import dg_kernel as dk
        from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed
        from multigrid_tpu_torch.utils.perf_model import dg_matvec_ops

        f32, f64 = torch.float32, torch.float64
        ops = {}
        for dtype in (f32, f64):
            ops[dtype] = dk.DGOperator(grid, dtype, self.dev)
            ops[dtype].install_jacobi(JacobiTransformed(grid, dtype, self.dev))
        x = self.rand(grid.shape, f32, 21)
        x64 = x.double()
        want = dk.dg_apply_plain(x64, ops[f64])
        scale = float(want.abs().max())
        self.note("dg_apply<double>", dk.dg_apply(x64, ops[f64]), want, scale,
                  1e-13)
        self.note("dg_apply<float>", dk.dg_apply(x, ops[f32]).double(), want,
                  scale, 3e-6)
        del want
        b, xc, xo = dk.smoother_iterates(ops[f64].jacobi, 22)
        b64, xc64, xo64 = (t.double() for t in (b, xc, xo))
        for xa, xoa, f1, f2 in ((xc, xo, 0.37, 0.81), (None, None, 0.0, 0.81),
                                (xc, xo, 0.37, 0.0)):
            got = dk.dg_cheb(b, xa, xoa, ops[f32], f1, f2).double()
            want = dk.dg_cheb_plain(b64, None if xa is None else xc64,
                                    None if xoa is None else xo64, ops[f64],
                                    f1, f2)
            scale, tol = ((float(want.abs().max()), 1e-5) if f2
                          else (float(xc64.abs().max()), 1e-6))
            self.note("dg_cheb<float>", got, want, scale, tol)
        del got, want
        if not timed:
            return
        for name, fn, plain in (
                ("dg_apply<double>", lambda: dk.dg_apply(x64, ops[f64]),
                 lambda: dk.dg_apply_plain(x64, ops[f64])),
                ("dg_apply<float>", lambda: dk.dg_apply(x, ops[f32]),
                 lambda: dk.dg_apply_plain(x, ops[f32])),
                ("dg_cheb<float>",
                 lambda: dk.dg_cheb(b, xc, xo, ops[f32], 0.37, 0.81),
                 lambda: dk.dg_cheb_plain(b, xc, xo, ops[f32], 0.37, 0.81))):
            self.ms[name] = time_ms(fn)
            self.plain_ms[name] = time_ms(plain)
        # bytes: x in, y out (dg_cheb: x, b, x_old, inv_diag in, out); flops:
        # the sum-factorized operator, plus for dg_cheb the six 1-D sweeps of
        # the transformed Jacobi, its scaling, the residual and the update
        n_dofs, n = grid.n_dofs, grid.n
        flops = dg_matvec_ops(3, grid.degree, int(np.prod(grid.cells)),
                              grid.kind)
        self.bound["dg_apply<double>"] = bound(2 * 8 * n_dofs, flops, f64)
        self.bound["dg_apply<float>"] = bound(2 * 4 * n_dofs, flops, f32)
        self.bound["dg_cheb<float>"] = bound(
            5 * 4 * n_dofs, flops + (12 * n + 6) * n_dofs, f32)


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


def _counters():
    from multigrid_tpu_torch.ops import cg_kernel, dg_kernel, laplace_kernel

    return (laplace_kernel, cg_kernel, dg_kernel)


def reset_launches() -> None:
    for mod in _counters():
        mod.reset_launches()


def read_launches() -> dict:
    out = {}
    for mod in _counters():
        out.update(mod.LAUNCHES)
    return out


def dg_grid(cells, degree, kind, seed=0):
    """A sheared affine DG grid (the cells of tests/test_pallas_dg.py)."""
    from multigrid_tpu_torch.ops.dg import DGGrid

    rng = np.random.default_rng(seed)
    J = np.diag(1.0 / np.array(cells)) @ (np.eye(3) + 0.08 * rng.random((3, 3)))
    return DGGrid(cells=cells, jacobian=tuple(map(tuple, J)), degree=degree,
                  kind=kind)


def run(dev: torch.device, card: str) -> int:
    """Phases 2 to 4 on ``dev``: kernel checks, then the two paths."""
    from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid, poisson_cube_mesh
    from multigrid_tpu_torch.solvers.multigrid_dg import dg_grid_from_mesh

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
    dg_mesh = poisson_cube_mesh(DG_SIZE)
    dg_shapes = [
        ("sheared DG (3,2,4) p=3 hermite", dg_grid((3, 2, 4), 3, "hermite"),
         False),
        ("sheared DG (4,1,3) p=4 gauss", dg_grid((4, 1, 3), 4, "gauss"),
         False),
        (f"DG poisson_cube_mesh({DG_SIZE}) p=4 hermite",
         dg_grid_from_mesh(dg_mesh, dg_mesh.max_level, 4, "hermite"), True),
    ]
    for label, grid, timed in dg_shapes:
        checks.dg_checks(grid, timed)
        torch.cuda.synchronize()
        print(f"kernel checks passed at {label}: {grid.shape}")
    for k in KERNELS:
        lib = checks.library_ms[k]
        print(f"  {k}: max|err| {checks.err[k]:.3e} ({checks.rel[k]:.2e} of "
              f"the bar's scale), kernel "
              f"{checks.ms[k]:.4f} ms, plain {checks.plain_ms[k]:.4f} ms, "
              f"library {'-' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{checks.bound[k][0]:.4f} ms ({checks.bound[k][1]}) [{card}]")

    # phases 3 and 4: the two paths, each with the counters zeroed just
    # before it and read just after
    launches = {"poisson_cube": cube_path(dev, card, checks),
                "poisson_dg": dg_path(dev, card, checks)}
    for path, names in (("poisson_cube", CUBE_KERNELS),
                        ("poisson_dg", DG_KERNELS)):
        print(f"launches during the {path} solves: {launches[path]}")
        for k in names:
            require(launches[path][k] > 0,
                    f"kernel {k} was not launched by the {path} solves")

    kernels = []
    for k, (src, rep) in KERNELS.items():
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=rep,
            launches=sum(launches[p][k] for p in launches),
            max_abs_err=checks.err[k], ms=checks.ms[k],
            plain_ms=checks.plain_ms[k], bound_ms=checks.bound[k][0],
            bound_by=checks.bound[k][1], library_ms=checks.library_ms[k]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def cube_path(dev, card, checks) -> dict:
    """poisson_cube at size 64: FMG and CG, best of 3 each; returns the
    device kernels launched by the solves."""
    from multigrid_tpu_torch.experiments.poisson_cube import build_solver
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh

    # a small solve on the card against the same solve on the CPU
    small = poisson_cube_mesh(4)
    u_gpu = build_solver(small, 4, device=dev).solve().cpu()
    u_cpu = build_solver(small, 4, device="cpu").solve()
    diff = float((u_gpu - u_cpu).abs().max())
    require(diff <= 1e-5 * float(u_cpu.abs().max()),
            f"size-4 FMG on the card vs CPU: max diff {diff:.3e}")
    print(f"size-4 FMG card vs CPU: max diff {diff:.3e}")

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    solver = build_solver(poisson_cube_mesh(SIZE), 4, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_dofs = solver.grids[solver.maxlevel].n_dofs
    print(f"setup: {setup_s:.2f} s for {n_dofs} dofs [{card}]")

    reset_launches()
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
    launches = read_launches()

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

    require(its == CG_ITS, f"cg_its {its} != {CG_ITS}")
    require(abs(cg_red / CG_REDUCTION - 1) <= ROW_TOL,
            f"cg reduction {cg_red:.4e} vs {CG_REDUCTION}")
    require(abs(reduction / VCYCLE_REDUCTION - 1) <= ROW_TOL,
            f"V-cycle reduction {reduction:.4e} vs {VCYCLE_REDUCTION}")
    for name, v in (("fmg", fmg_l2), ("cg", cg_l2)):
        require(np.isfinite(v) and v < L2_BOUND, f"{name} L2 error {v}")
    require(sol.shape == solver.grids[solver.maxlevel].shape
            and bool(torch.isfinite(sol).all()), "FMG solution not finite")
    return launches


def dg_path(dev, card, checks) -> dict:
    """poisson_dg at size 48 (hermite p = 4, n_pre = n_post = 3, rtol
    1e-9): CG best of 3 after set-up; returns the device kernels launched
    by the solves."""
    from multigrid_tpu_torch.experiments.poisson_cube import exact_fn, rhs_fn
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh
    from multigrid_tpu_torch.solvers.multigrid_dg import MultigridSolverDG
    from multigrid_tpu_torch.utils.perf_model import (dg_matvec_model,
                                                      print_matvec_details)

    def build(mesh, where):
        return MultigridSolverDG(mesh, 4, exact_fn, rhs_fn, kind="hermite",
                                 n_pre=3, n_post=3, device=where)

    # a small solve on the card against the same solve on the CPU
    u_gpu, u_cpu = (build(poisson_cube_mesh(4), where).solve_cg(DG_RTOL)[0].cpu()
                    for where in (dev, "cpu"))
    diff = float((u_gpu - u_cpu).abs().max())
    require(diff <= 1e-5 * float(u_cpu.abs().max()),
            f"size-4 DG solve on the card vs CPU: max diff {diff:.3e}")
    print(f"size-4 DG solve card vs CPU: max diff {diff:.3e}")

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    mesh = poisson_cube_mesh(DG_SIZE)
    solver = build(mesh, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_dofs, n_cells = solver.dg_grid.n_dofs, mesh.n_cells(mesh.max_level)
    print(f"DG setup: {setup_s:.2f} s for {n_dofs} DG dofs, FE_Q finest "
          f"{solver.cg.grids[solver.cg.maxlevel].n_dofs} nodes [{card}]")

    reset_launches()
    cg_s = []
    sol = None
    for _ in range(3):
        sol = None
        t0 = time.perf_counter()
        sol, frac_its, rate = solver.solve_cg(tolerance=DG_RTOL)
        torch.cuda.synchronize()
        cg_s.append(time.perf_counter() - t0)
    launches = read_launches()

    err = solver.l2_error(sol, solver.exact_quad)
    mem = torch.cuda.max_memory_allocated(dev)
    print(f"dg cg: {min(cg_s):.4f} s (runs {', '.join(f'{s:.4f}' for s in cg_s)})"
          f", frac its {frac_its:.4f}, rate {rate:.4e}, L2 {err:.6e} [{card}]")
    print(f"DG max_memory_allocated: {mem} bytes [{card}]")
    x = checks.rand(solver.dg_grid.shape, solver.f_dtype, 0)
    ms = time_ms(lambda: solver.op_dp.vmult(x))
    print_matvec_details("matvec:hermite", dg_matvec_model(
        3, 4, n_cells, "hermite", x.element_size(), n_dofs, ms / 1e3), n_dofs)

    require(sol.shape == solver.dg_grid.shape
            and bool(torch.isfinite(sol).all()), "DG solution not finite")
    require(abs(err - DG_L2) <= DG_L2_TOL, f"DG L2 error {err:.6e} vs {DG_L2}")
    require(DG_RATE[0] <= rate <= DG_RATE[1], f"DG rate {rate:.4e}")
    require(DG_ITS[0] <= frac_its <= DG_ITS[1], f"DG frac its {frac_its:.4f}")
    return launches


if __name__ == "__main__":
    sys.exit(main())
