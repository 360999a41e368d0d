"""Time the DG kernels (``ops/dg_kernel.py``) on the card.

    python -m multigrid_tpu_torch.experiments.time_dg_cheb [size ...]
        [--degree P ...] [--kind KIND ...] [--cg] [--pencil TYPE:K ...]

The poisson_dg grid of each ``size``^3 cells (default 48, hermite, degree
4: 13,824,000 DG dofs) at each ``--degree`` and ``--kind``; CUDA events
over 50 calls after 3 warm-ups, three rounds of: the float32 Chebyshev
step (``dg_cheb``, on the smoother's iterates), the step with x = 0, and
A·x and ``b - A x`` (``DGOperator.vmult`` and ``vmult_residual``, on
random inputs) in float32 and float64; with ``--cg`` also solver_dg's
fused CG passes, ``dg_cg<double>`` and ``dg_jacobi_cg<double>`` (random
p_old, z, x, r, q and the scalars of ``chip_smoke.py``), and ``dg_cg``'s
march tile at each degree (cells a pencil, p buffers, shared memory
bytes, threads and blocks an SM).  solver_dg's grids: ``48 --cg``
(hermite, 13,824,000 DG dofs) and ``64 --kind gauss --cg`` (32,768,000).
Prints at each grid the sha256 of the outputs of the step, A·x and
``b - A x`` in both types, so that two trees' pencil kernels can be shown
equal bit for bit (``12 --degree 1 2 3 4 5 6 7 8 9 --kind hermite gll
gauss``), and the registers and spills of the DG kernels at the degree
when this process built the library.

``--pencil f32:K`` builds ``csrc/dg_pencil.cu`` (with
``dg_pencil_high.cu``, the kernels its step at p = 8, 9 and
``dg_pencil_f64.cu``'s apply and residual at p = 8 call) with K cells per
block for apply and
residual (``-DDG_PENCIL=K``) and times them beside the library's; ``f64:K`` does the same for
``csrc/dg_pencil_f64.cu``; ``cheb:K`` builds ``dg_pencil.cu`` with K cells
per block for the step (``-DDG_CHEB_PENCIL=K``) and times the step;
``cg:K`` (with ``--cg``) builds ``csrc/dg_cg_f64.cu`` with K cells a
block of the march (``-DDG_CG_PENCIL=K``, cut to what fits a block) and
times ``dg_cg``.  Each variant is first checked
against the library's output (1e-5·max|out|, 1e-12 in double: K moves x
faces between the in-pencil and the neighbour path, which round apart),
and its registers and spills at the degree are printed.  A pencil variant
whose pencil needs more shared memory than a block may have at a degree
(K (7 n^3 + 34 n^2) values; in dg_pencil_high.cu's kernels, K (4 n^3 + 22
n^2); 232,448 bytes) is not launched there and is listed under ``no_fit``.  At p = 8, 9
each degree also prints the tile of ``dg_pencil_high.cu``'s kernels
(``dg_kernel.high_tile``: cells, shared bytes, threads, blocks an SM,
registers, local bytes) of the library and of each variant.

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
    shared memory (csrc/dg_pencil.cuh:smem_bytes; at n >= 9
    csrc/dg_pencil_high.cu:HighLayout); the march of ``cg`` cuts K to what
    fits itself."""
    what, k = spec.split(":")[:2]
    if what == "cg":
        return True
    size, k = (8 if what == "f64" else 4), int(k)
    # dg_pencil_high.cu: the step at n = 9, 10, the f64 apply at n = 9
    high = (what == "cheb" and n >= 9) or (what == "f64" and n == 9)
    per_cell = 4 * n ** 3 + 22 * n ** 2 if high else 7 * n ** 3 + 34 * n ** 2
    return k * per_cell * size <= SMEM_LIMIT


def degree_rows(log: str, n: int) -> list[dict]:
    """ptxas rows of the DG kernels at ``n`` points an axis in ``log``."""
    from multigrid_tpu_torch import _build

    return [dict(kernel=r["kernel"], registers=r["registers"],
                 spill_stores=r["spill_stores"], spill_loads=r["spill_loads"])
            for r in _build.ptxas_report(log)
            if "dg_" in r["kernel"] and f"Li{n}E" in r["kernel"]]


SOURCES = {"f32": "dg_pencil.cu", "cheb": "dg_pencil.cu",
           "f64": "dg_pencil_f64.cu", "cg": "dg_cg_f64.cu"}
ENTRIES = {"f32": "dg_apply_f32", "f64": "dg_apply_f64",
           "cheb": "dg_cheb_f32", "cg": "dg_cg_f64"}


def variants(specs: list[str]) -> dict:
    """For each pencil spec (``TYPE:K``): the C entry it times, of
    ``csrc/dg_pencil.cu`` (``f32``, ``cheb``), ``dg_pencil_f64.cu``
    (``f64``), each with ``dg_pencil_high.cu``, or ``dg_cg_f64.cu``
    (``cg``), built with it (one nvcc a spec, all started together), the
    compiler's output and the library itself (for its tile)."""
    from multigrid_tpu_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    csrc = _build.PACKAGE_DIR / "csrc"
    procs = {}
    for spec in specs:
        what, k = spec.split(":")
        srcs = [SOURCES[what]]
        if what != "cg":
            srcs.append("dg_pencil_high.cu")
        macro = dict(cheb="DG_CHEB_PENCIL", cg="DG_CG_PENCIL").get(
            what, "DG_PENCIL")
        defs = [f"-D{macro}={int(k)}"]
        out = _build.BUILD_DIR / (f"dg_pencil_{spec.replace(':', '_')}_"
                                  f"{_build._digest()}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", *defs, "-o",
               str(out), *(str(csrc / src) for src in srcs)]
        procs[spec] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for spec, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {spec}:\n{log}")
        lib = ctypes.CDLL(str(out))
        name = ENTRIES[spec.split(":")[0]]
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
        built[spec] = (fn, log, lib)
    return built


def cg_tile(n: int) -> dict:
    """``dg_cg``'s march tile at ``n`` points an axis, as the library was
    built (``dg_cg_f64_tile``)."""
    from multigrid_tpu_torch import _build

    out = (ctypes.c_int * 5)()
    err = _build.library().dg_cg_f64_tile(n, out)
    if err:
        raise RuntimeError(f"dg_cg_f64_tile: cudaError {err}")
    return dict(zip(("cells", "p_buffers", "smem_bytes", "threads",
                     "blocks_per_sm"), out))


def call(fn, *args) -> None:
    launched = ctypes.c_int(0)
    err = fn(*args, ctypes.byref(launched))
    if err:
        raise RuntimeError(f"cudaError {err}")


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def size_run(size: int, degree: int, kind: str, specs: dict, dev,
             cg: bool) -> dict:
    from multigrid_tpu_torch import _build
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh
    from multigrid_tpu_torch.ops import dg_kernel as dk
    from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed
    from multigrid_tpu_torch.solvers.multigrid_dg import dg_grid_from_mesh

    mesh = poisson_cube_mesh(size)
    grid = dg_grid_from_mesh(mesh, mesh.max_level, degree, kind)
    op = dk.DGOperator(grid, torch.float32, dev)
    op.install_jacobi(JacobiTransformed(grid, torch.float32, dev))
    op64 = dk.DGOperator(grid, torch.float64, dev)
    op64.install_jacobi(JacobiTransformed(grid, torch.float64, dev))
    b, x, xo = dk.smoother_iterates(op64.jacobi, 22)
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
    want = {k: fns[k]() for k in fns}
    if cg:
        # the fused CG's passes on random vectors (chip_smoke.py's scalars)
        p_old, z, x0, r, q = (torch.as_tensor(
            rng.standard_normal(grid.shape), device=dev) for _ in range(5))
        scal = torch.tensor([0.37, 0.61, 1.7, 0.0, 0.0], dtype=torch.float64,
                            device=dev)
        partial = dk.cg_partials(grid, dev)
        cgx, cgs = x0.clone(), scal.clone()
        cgp, cgq = torch.empty_like(x0), torch.empty_like(x0)
        jr, jz = r.clone(), torch.empty_like(r)
        fns["dg_cg"] = lambda: dk.dg_cg(p_old, z, cgx, cgs, cgp, cgq, op64,
                                        partial)
        fns["dg_jacobi_cg"] = lambda: dk.dg_jacobi_cg(jr, q, cgs, jz, op64,
                                                      partial)
        fns["dg_cg"]()
        want["dg_cg"] = (cgx.clone(), cgp.clone(), cgq.clone(), cgs.clone())
    torch.cuda.synchronize()
    digests = {k: digest(want[k]) for k in ("cheb", "cheb_x0", "apply_f32",
                                            "residual_f32", "apply_f64",
                                            "residual_f64")}
    args = (*grid.cells, grid.n, int(op.plain.is_collocation),
            _build.stream_handle(dev))
    no_fit = [spec for spec in specs if not fits(spec, grid.n)]
    for spec, (entry, _, _) in specs.items():
        what = spec.split(":")[0]
        if spec in no_fit or (what == "cg" and not cg):
            continue
        outs, new = {}, {}
        if what == "cheb":
            outs["cheb"] = torch.empty_like(b)
            new["cheb"] = lambda o=outs["cheb"], entry=entry: call(
                entry, b.data_ptr(), x.data_ptr(), xo.data_ptr(),
                op.jacobi.inv_diag.data_ptr(), op.host_tables.ctypes.data,
                o.data_ptr(), 0.37, 0.81, *args)
        elif what == "cg":
            vx, vs = x0.clone(), scal.clone()
            vp, vq = torch.empty_like(x0), torch.empty_like(x0)
            outs["dg_cg"] = (vx, vp, vq, vs)
            new["dg_cg"] = lambda entry=entry: call(
                entry, p_old.data_ptr(), z.data_ptr(), vx.data_ptr(),
                vp.data_ptr(), vq.data_ptr(), vs.data_ptr(),
                op64.host_tables.ctypes.data, partial.data_ptr(),
                partial.numel(), *args)
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
            pairs = (zip(outs[key], want[key]) if key == "dg_cg"
                     else [(outs[key], want[key])])
            for got, ref in pairs:
                diff = float((got - ref).abs().max())
                bar = (1e-12 if got.dtype == torch.float64 else 1e-5) * float(
                    ref.abs().max())
                if diff > bar:
                    raise AssertionError(f"{spec} {key}: differs by "
                                         f"{diff:.3e}")
            if key != "dg_cg":
                digests[f"{key}@{spec}"] = digest(outs[key])
            fns[f"{key}@{spec}"] = fn
    rounds = [{k: time_ms(fn) for k, fn in fns.items()} for _ in range(3)]
    return dict(dofs=grid.n_dofs, kind=kind, sha256=digests, rounds=rounds,
                best={k: min(r[k] for r in rounds) for k in fns},
                no_fit=no_fit)


def main(argv: list[str]) -> int:
    from multigrid_tpu_torch import _build
    from multigrid_tpu_torch.ops import dg_kernel as dk

    ap = argparse.ArgumentParser()
    ap.add_argument("sizes", type=int, nargs="*", default=[48])
    ap.add_argument("--degree", type=int, nargs="+", default=[4])
    ap.add_argument("--kind", nargs="+", default=["hermite"],
                    choices=["hermite", "gll", "gauss"])
    ap.add_argument("--cg", action="store_true",
                    help="also time dg_cg<double> and dg_jacobi_cg<double>")
    ap.add_argument("--pencil", nargs="*", default=[],
                    help="TYPE:K (TYPE f32, f64, cheb or cg)")
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
                                     for s, (_, log, _) in specs.items()},
                      sizes={})
        if n in dk.HIGH_KERNELS_AT:
            # the tile of the kernels at p = 8, 9, of the library and of
            # each variant
            result["high_tiles"] = {"library": dk.high_tile(n), **{
                s: dk.high_tile(n, lib) for s, (_, _, lib) in specs.items()
                if s.split(":")[0] != "cg"}}
            for s, tiles in result["high_tiles"].items():
                for name, tile in tiles.items():
                    print(f"p={degree} tile {s} {name}: " + ", ".join(
                        f"{k} {v}" for k, v in tile.items()))
        if args.cg:
            result["march"] = cg_tile(n)
            rows = [r for r in result["library_ptxas"]
                    if "dg_cg_kernel" in r["kernel"]]
            print(f"p={degree} dg_cg march: " + ", ".join(
                f"{k} {v}" for k, v in result["march"].items()) + "".join(
                f", registers {r['registers']}, spills {r['spill_stores']} "
                f"/ {r['spill_loads']} B" for r in rows))
        for kind in args.kind:
            for size in args.sizes:
                run = size_run(size, degree, kind, specs, dev, args.cg)
                result["sizes"][f"{size} {kind}"] = run
                torch.cuda.empty_cache()
                print(f"p={degree} {kind} size {size}: sha256 " + ", ".join(
                    f"{k} {d}" for k, d in run["sha256"].items()))
                if args.cg:
                    print(f"p={degree} {kind} size {size}: dg_cg "
                          f"{run['best']['dg_cg']:.4f} ms, dg_jacobi_cg "
                          f"{run['best']['dg_jacobi_cg']:.4f} ms " + " ".join(
                              f"{k} {v:.4f}" for k, v in run["best"].items()
                              if k.startswith("dg_cg@")))
        results.append(result)
    print(card)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
