"""Time the DG kernels (``ops/dg_kernel.py``) on the card.

    python -m multigrid_tpu_torch.experiments.time_dg_cheb [size ...]
        [--degree P ...] [--pencil TYPE:K ...]

The poisson_dg grid of each ``size``^3 cells (default 48, hermite, degree
4: 13,824,000 DG dofs) at each ``--degree``; CUDA events over 50 calls
after 3 warm-ups, three rounds of: the float32 Chebyshev step
(``dg_cheb``, on the smoother's iterates), the step with x = 0, and A·x
and ``b - A x`` (``DGOperator.vmult`` and ``vmult_residual``, on random
inputs) in float32 and float64.
Prints the sha256 of the step's output at each size, so that two trees'
steps can be shown equal bit for bit, and the registers and spills of the
DG kernels at the degree when this process built the library.

``--pencil f32:K`` builds ``csrc/dg_pencil.cu`` alone with K cells per
block for apply and residual (``-DDG_PENCIL=K``) and times them beside
the library's; ``f64:K`` does the same for
``csrc/dg_pencil_f64.cu``; ``cheb:K`` builds ``dg_pencil.cu`` with K cells
per block for the step (``-DDG_CHEB_PENCIL=K``) and times the step.  Each
variant is first checked against the library's output (1e-5·max|out|,
1e-12 in double: K moves x faces between the in-pencil and the neighbour
path, which round apart), and its registers and spills at the degree are
printed.  A variant whose pencil needs more shared memory than a block
may have at a degree (K (7 n^3 + 34 n^2) values, 232,448 bytes) is not
launched there and is listed under ``no_fit``.

Run it with another tree's package on ``PYTHONPATH`` to time that tree in
the same call (``--pencil`` needs this tree's sources).  Prints the card
line and one JSON line (a list, one entry a degree).  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch


def time_ms(fn, reps: int = 50) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


SMEM_LIMIT = 232_448     # bytes of shared memory a block may have (H100)


def fits(spec: str, n: int) -> bool:
    """Whether a pencil spec's K cells of ``n`` points an axis fit a block's
    shared memory (csrc/dg_pencil.cuh:smem_bytes)."""
    what, k = spec.split(":")
    size = 8 if what == "f64" else 4
    return int(k) * (7 * n ** 3 + 34 * n ** 2) * size <= SMEM_LIMIT


def degree_rows(log: str, n: int) -> list[dict]:
    """ptxas rows of the DG kernels at ``n`` points an axis in ``log``."""
    from multigrid_tpu_torch import _build

    return [dict(kernel=r["kernel"], registers=r["registers"],
                 spill_stores=r["spill_stores"], spill_loads=r["spill_loads"])
            for r in _build.ptxas_report(log)
            if "dg_" in r["kernel"] and f"Li{n}E" in r["kernel"]]


def variants(specs: list[str]) -> dict:
    """For each pencil spec (``TYPE:K``): the C entry it times, of
    ``csrc/dg_pencil.cu`` (``f32``, ``cheb``) or ``dg_pencil_f64.cu``
    (``f64``) built alone with it (one nvcc a spec, all started together),
    and the compiler's output."""
    from multigrid_tpu_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for spec in specs:
        what, k = spec.split(":")
        src = "dg_pencil_f64.cu" if what == "f64" else "dg_pencil.cu"
        defs = [f"-D{'DG_CHEB_PENCIL' if what == 'cheb' else 'DG_PENCIL'}="
                f"{int(k)}"]
        out = _build.BUILD_DIR / (f"dg_pencil_{spec.replace(':', '_')}_"
                                  f"{_build._digest()}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", *defs, "-o",
               str(out), str(_build.PACKAGE_DIR / "csrc" / src)]
        procs[spec] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for spec, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {spec}:\n{log}")
        name = {"f32": "dg_apply_f32", "f64": "dg_apply_f64",
                "cheb": "dg_cheb_f32"}[spec.split(":")[0]]
        fn = getattr(ctypes.CDLL(str(out)), name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
        built[spec] = (fn, log)
    return built


def call(fn, *args) -> None:
    launched = ctypes.c_int(0)
    err = fn(*args, ctypes.byref(launched))
    if err:
        raise RuntimeError(f"cudaError {err}")


def size_run(size: int, degree: int, specs: dict, dev) -> dict:
    from multigrid_tpu_torch import _build
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh
    from multigrid_tpu_torch.ops import dg_kernel as dk
    from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed
    from multigrid_tpu_torch.solvers.multigrid_dg import dg_grid_from_mesh

    mesh = poisson_cube_mesh(size)
    grid = dg_grid_from_mesh(mesh, mesh.max_level, degree, "hermite")
    op = dk.DGOperator(grid, torch.float32, dev)
    op.install_jacobi(JacobiTransformed(grid, torch.float32, dev))
    op64 = dk.DGOperator(grid, torch.float64, dev)
    b, x, xo = dk.smoother_iterates(
        JacobiTransformed(grid, torch.float64, dev), 22)
    # random inputs for A x and b - A x: on the smooth iterates A x cancels
    # some 1e5-fold, and no bar on it could tell two pencils apart
    rng = np.random.default_rng(23)
    xr, br = (torch.as_tensor(rng.standard_normal(grid.shape),
                              dtype=torch.float32, device=dev)
              for _ in range(2))
    xr64, br64 = xr.double(), br.double()
    fns = dict(cheb=lambda: dk.dg_cheb(b, x, xo, op, 0.37, 0.81),
               cheb_x0=lambda: dk.dg_cheb(b, None, None, op, 0.0, 0.81),
               apply_f32=lambda: op.vmult(xr),
               residual_f32=lambda: op.vmult_residual(br, xr),
               apply_f64=lambda: op64.vmult(xr64),
               residual_f64=lambda: op64.vmult_residual(br64, xr64))
    want = {k: fns[k]() for k in fns if k != "cheb_x0"}
    torch.cuda.synchronize()
    digest = hashlib.sha256(want["cheb"].cpu().numpy().tobytes()).hexdigest()
    args = (*grid.cells, grid.n, 0, _build.stream_handle(dev))
    no_fit = [spec for spec in specs if not fits(spec, grid.n)]
    for spec, (entry, _) in specs.items():
        what = spec.split(":")[0]
        if spec in no_fit:
            continue
        outs, new = {}, {}
        if what == "cheb":
            outs["cheb"] = torch.empty_like(b)
            new["cheb"] = lambda o=outs["cheb"], entry=entry: call(
                entry, b.data_ptr(), x.data_ptr(), xo.data_ptr(),
                op.jacobi.inv_diag.data_ptr(), op.host_tables.ctypes.data,
                o.data_ptr(), 0.37, 0.81, *args)
        else:
            ops, xs, bs = ((op64, xr64, br64) if what == "f64"
                           else (op, xr, br))
            for mode, key in enumerate((f"apply_{what}", f"residual_{what}")):
                outs[key] = torch.empty_like(xs)
                new[key] = (lambda o=outs[key], mode=mode, ops=ops, xs=xs,
                            bs=bs, entry=entry:
                            call(entry, mode, xs.data_ptr(), bs.data_ptr(),
                                 ops.host_tables.ctypes.data, o.data_ptr(),
                                 *args))
        for key, fn in new.items():
            fn()
            torch.cuda.synchronize()
            diff = float((outs[key] - want[key]).abs().max())
            bar = (1e-12 if what == "f64" else 1e-5) * float(
                want[key].abs().max())
            if diff > bar:
                raise AssertionError(f"{spec} {key}: differs by {diff:.3e}")
            fns[f"{key}@{spec}"] = fn
    rounds = [{k: time_ms(fn) for k, fn in fns.items()} for _ in range(3)]
    return dict(dofs=grid.n_dofs, sha256_cheb=digest, rounds=rounds,
                best={k: min(r[k] for r in rounds) for k in fns},
                no_fit=no_fit)


def main(argv: list[str]) -> int:
    from multigrid_tpu_torch import _build

    ap = argparse.ArgumentParser()
    ap.add_argument("sizes", type=int, nargs="*", default=[48])
    ap.add_argument("--degree", type=int, nargs="+", default=[4])
    ap.add_argument("--pencil", nargs="*", default=[],
                    help="TYPE:K, TYPE f32, f64 or cheb")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_dg_cheb: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    _build.library()
    specs = variants(args.pencil)
    results = []
    for degree in args.degree:
        n = degree + 1
        result = dict(card=card, degree=degree,
                      library_ptxas=degree_rows(_build.build_log, n),
                      variant_ptxas={s: degree_rows(log, n)
                                     for s, (_, log) in specs.items()},
                      sizes={})
        for size in args.sizes:
            result["sizes"][size] = size_run(size, degree, specs, dev)
            torch.cuda.empty_cache()
            print(f"p={degree} size {size}: sha256 of the f32 step "
                  f"{result['sizes'][size]['sha256_cheb']}")
        results.append(result)
    print(card)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
