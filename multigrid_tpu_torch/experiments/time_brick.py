"""Time the f64 brick operator (K1's twin) on the card.

    python -m multigrid_tpu_torch.experiments.time_brick [size ...]
        [--f64-variant CPT:BLOCKS ...]

For each poisson_cube size (default 64 and 128: 257^3 and 513^3 nodes,
FE_Q(4)) the float64 ``BrickLaplace`` of the finest level, on random x and
b from a seeded generator: CUDA events over 50 calls after 3 warm-ups,
three rounds of (apply, vmult, vmult_residual, and the float32 operator's
apply and Chebyshev step beside them), with the device kernels one call
launches (``laplace_kernel.LAUNCHES``) and a digest of each output
(sha256 of its bytes), so that two trees' results can be compared bit for
bit.  ``--f64-variant C:B``
also builds ``csrc/brick_kron_f64.cu`` alone with C z columns a thread
at p <= 4 and a launch bound of B blocks an SM
(``-DBRICK_KRON_F64_CPT=C -DBRICK_KRON_F64_MIN_BLOCKS=B``), prints the
registers and spills of its p = 4 kernels, checks that its apply, vmult
and residual equal the library's bit for bit (the tile shape moves no
rounding: every node sums the same taps in the same order) and times
them beside.  The
script uses only the operator's public methods, so run as a file with
another tree's package on ``PYTHONPATH`` it times that tree's kernels in
the same call (``PYTHONPATH=<tree> python
<tree>/multigrid_tpu_torch/experiments/time_brick.py``).  Prints the card
line and one JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys

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


def variant_entries(variants: list[str]) -> dict:
    """``brick_kron_f64`` of ``csrc/brick_kron_f64.cu`` built alone for
    each variant ("C:B": C z columns a thread at p <= 4, launch bound B),
    one nvcc each, in parallel."""
    from multigrid_tpu_torch import _build

    src = _build.PACKAGE_DIR / "csrc" / "brick_kron_f64.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs, procs = {}, {}
    for v in variants:
        cpt, blocks = v.split(":")
        outs[v] = _build.BUILD_DIR / f"brick_kron_f64_{cpt}_{blocks}_{_build._digest()}.so"
        if not outs[v].exists():
            procs[v] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                 f"-DBRICK_KRON_F64_CPT={cpt}",
                 f"-DBRICK_KRON_F64_MIN_BLOCKS={blocks}", "-o", str(outs[v]),
                 str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    entries = {}
    for v in variants:
        if v in procs:
            log = procs[v].communicate()[0]
            if procs[v].returncode:
                raise RuntimeError(f"{v}: nvcc failed\n{log}")
            for row in _build.ptxas_report(log):
                if "IdLi4E" in row["kernel"]:  # brick_kron_kernel<double, 4, mode>
                    print(f"{v} mode {row['kernel'].split('IdLi4ELi')[1][0]}: "
                          f"{row['registers']} registers, spill stores "
                          f"{row['spill_stores']} B, loads {row['spill_loads']} B")
        fn = ctypes.CDLL(str(outs[v])).brick_kron_f64
        fn.argtypes = _build.SIGNATURES["brick_kron_f64"]
        fn.restype = ctypes.c_int
        entries[v] = fn
    return entries


def main(argv: list[str]) -> int:
    from multigrid_tpu_torch import _build
    from multigrid_tpu_torch.mesh.brick import DofGrid, poisson_cube_mesh
    from multigrid_tpu_torch.ops import laplace_kernel as lk

    ap = argparse.ArgumentParser()
    ap.add_argument("sizes", type=int, nargs="*", default=[64, 128])
    ap.add_argument("--f64-variant", nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_brick: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    entries = variant_entries(args.f64_variant)
    rows = []
    for size in args.sizes:
        mesh = poisson_cube_mesh(size)
        grid = DofGrid(mesh, mesh.max_level, 4)
        op = lk.BrickLaplace(grid, torch.float64, dev)
        op32 = lk.BrickLaplace(grid, torch.float32, dev)
        gen = torch.Generator(dev).manual_seed(size)
        x, b, xo = (torch.randn(grid.shape, dtype=torch.float64, device=dev,
                                generator=gen) for _ in range(3))
        x32, b32, xo32 = (t.float() for t in (x, b, xo))
        fns = dict(apply=lambda: op.apply(x), vmult=lambda: op.vmult(x),
                   residual=lambda: op.vmult_residual(b, x),
                   apply_f32=lambda: op32.apply(x32),
                   cheb_f32=lambda: op32.cheb_step(b32, x32, xo32, 0.37, 0.81))
        launches, digests = {}, {}
        for name, fn in fns.items():
            lk.reset_launches()
            out = fn()
            launches[name] = sum(lk.LAUNCHES.values())
            digests[name] = hashlib.sha256(
                out.cpu().numpy().tobytes()).hexdigest()[:16]
        for k, entry in entries.items():
            for mode in ("apply", "vmult", "residual"):
                out, launched = torch.empty_like(x), ctypes.c_int(0)

                def call(entry=entry, out=out, launched=launched, mode=mode):
                    err = entry(lk.KRON_MODES[mode], x.data_ptr(),
                                b.data_ptr(), None, out.data_ptr(),
                                op.host_taps.ctypes.data, 0.0, 0.0,
                                *grid.shape, grid.degree,
                                _build.stream_handle(dev),
                                ctypes.byref(launched))
                    if err:
                        raise RuntimeError(f"{k}: cudaError {err}")

                call()
                if not torch.equal(out, fns[mode]()):
                    raise AssertionError(f"{k} {mode} differs from the "
                                         "library's kernel")
                fns[f"{mode}_{k}"] = call
        rounds = [{k: time_ms(fn) for k, fn in fns.items()} for _ in range(3)]
        rows.append(dict(size=size, nodes=grid.n_dofs, launches=launches,
                         digests=digests, rounds=rounds,
                         best={k: min(r[k] for r in rounds) for k in fns}))
        del op, op32, x, b, xo, x32, b32, xo32, fns
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps(dict(card=card, tree=str(_build.PACKAGE_DIR.parent),
                          rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
