"""Time the DG kernels (``ops/dg_kernel.py``) on the card.

    python -m multigrid_tpu_torch.experiments.time_dg_cheb [size ...]
        [--degree P ...] [--kind KIND ...] [--cg] [--pencil TYPE:K ...]
        [--against DIR ...] [--digests]

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
``b - A x`` in both types and, with ``--cg``, of ``dg_cg``'s x, p, q and
scalars and ``dg_jacobi_cg``'s r, z and scalars (one call each from the
same inputs), so that two trees' kernels can be shown equal bit for bit
(``12 --degree 1 2 3 4 5 6 7 8 9 --kind hermite gll gauss --cg``), and
the registers and spills of the DG kernels at the degree when this
process built the library.

``--against DIR ...`` builds the DG sources of other trees
(``DIR/multigrid_tpu_torch/csrc``: ``dg_pencil.cu``, ``dg_pencil_f64.cu``,
``dg_pencil_high.cu``, ``dg_cg_f64.cu``, one nvcc each, in parallel) into
libraries of their own and times their C entries and this tree's, called
the same way, in the same process, round by round (every mode, ``dg_cg``
and ``dg_jacobi_cg`` with ``--cg``), under ``<mode>@this`` and
``<mode>@<DIR's name>``; their outputs' sha256 are printed beside this
tree's, with the modes whose outputs differ in any bit, and their
registers and spills at each degree.  ``--digests`` prints instead
``ops/dg_kernel.kernel_digests`` (every mode at p = 1..16 in every kind,
the digests ``tests/test_torch_cuda.py`` pins) of this tree's library
and, with ``--against``, of the first other tree's, and the keys that
differ.

``--pencil f32:K`` builds ``csrc/dg_pencil.cu`` (with
``dg_pencil_high.cu``, the kernels its step at p = 8, 9 and
``dg_pencil_f64.cu``'s apply and residual at p = 8 call) with K cells per
block for apply and
residual (``-DDG_PENCIL=K``) and times them beside the library's; ``f64:K`` does the same for
``csrc/dg_pencil_f64.cu``; ``cheb:K`` builds ``dg_pencil.cu`` with K cells
per block for the step (``-DDG_CHEB_PENCIL=K``) and times the step;
``wide:K`` builds the float sources (``dg_pencil.cu`` with
``dg_pencil_high.cu``, ``dg_pencil_wide.cu`` and ``dg_pencil_wide_top.cu``)
with K cells a pencil aimed at p = 10..16 (``-DDG_WIDE_CELLS=K``, cut
to what fits a block) and times the
step, the step with x = 0, apply and residual there; ``wide_f64:K`` the
double sources, apply and residual; at p <= 9 neither is launched;
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
registers, local bytes) of the library and of each variant, and at p
= 10..16 that of ``dg_pencil_wide.cu``'s and ``dg_pencil_wide_f64.cu``'s
kernels (``dg_kernel.wide_tile``; every degree 1..16 times, ``--cg``
only up to p = 9, the fused CG's top).

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
import os
import shutil
import subprocess
import sys
from pathlib import Path

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
    size, k = (8 if what.endswith("f64") else 4), int(k)
    if what.startswith("wide"):   # n = 11..17 only, K cut to what fits
        return n > 10
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
           "f64": "dg_pencil_f64.cu", "cg": "dg_cg_f64.cu",
           "wide": "dg_pencil.cu", "wide_f64": "dg_pencil_f64.cu"}


def bind(lib):
    """``lib`` (a ``ctypes`` library of kernel sources) with the
    signatures of its C entries bound (``_build.SIGNATURES``)."""
    from multigrid_tpu_torch import _build

    for name, argtypes in _build.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def variants(specs: list[str]) -> dict:
    """For each pencil spec (``TYPE:K``): the compiler's output and the
    library of ``csrc/dg_pencil.cu`` (``f32``, ``cheb``),
    ``dg_pencil_f64.cu`` (``f64``), each with ``dg_pencil_high.cu``, or
    ``dg_cg_f64.cu`` (``cg``), built with it (one nvcc a spec, all started
    together)."""
    from multigrid_tpu_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    csrc = _build.PACKAGE_DIR / "csrc"
    procs = {}
    for spec in specs:
        what, k = spec.split(":")
        srcs = [SOURCES[what]]
        if what != "cg":   # the sources its entries hand n >= 9 to
            srcs += ["dg_pencil_high.cu", *(
                ("dg_pencil_wide_f64.cu", "dg_pencil_wide_top_f64.cu")
                if what.endswith("f64") else
                ("dg_pencil_wide.cu", "dg_pencil_wide_top.cu"))]
        macro = dict(cheb="DG_CHEB_PENCIL", cg="DG_CG_PENCIL",
                     wide="DG_WIDE_CELLS", wide_f64="DG_WIDE_CELLS").get(
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
        built[spec] = (log, bind(ctypes.CDLL(str(out))))
    return built


DG_SOURCES = ("dg_pencil.cu", "dg_pencil_f64.cu", "dg_pencil_high.cu",
              "dg_cg_f64.cu")
# the sources of p = 10..16, where a tree has them
DG_WIDE_SOURCES = ("dg_pencil_wide.cu", "dg_pencil_wide_top.cu",
                   "dg_pencil_wide_f64.cu", "dg_pencil_wide_top_f64.cu")


def against_library(tree: str):
    """The DG kernels of another tree (``tree/multigrid_tpu_torch/csrc``)
    built into a library of their own, its C entries' signatures bound
    (``_build.SIGNATURES``), and the compiler's output."""
    import tempfile

    from multigrid_tpu_torch import _build

    csrc = Path(tree).resolve() / "multigrid_tpu_torch" / "csrc"
    sources = DG_SOURCES + tuple(f for f in DG_WIDE_SOURCES
                                 if (csrc / f).exists())
    key = hashlib.sha256(b"".join(
        (csrc / f).read_bytes() for f in (*sources, "dg_pencil.cuh",
                                          "dg_tab.cuh"))).hexdigest()[:16]
    out = _build.BUILD_DIR / f"against_{key}"   # kept for the next process
    if not (out / "lib.so").exists():
        out.mkdir(parents=True, exist_ok=True)
        work = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR))
        log, failed, seconds = _build.compile_sources(
            [csrc / src for src in sources], work)
        if failed:
            raise RuntimeError(f"nvcc failed for {tree}:\n{log}")
        print(f"built {csrc}'s DG kernels: " + ", ".join(
            f"{k} {v:.2f} s" for k, v in seconds.items()))
        (out / "build.log").write_text(log)
        os.replace(work / "lib.so", out / "lib.so")
        shutil.rmtree(work, ignore_errors=True)
    log = (out / "build.log").read_text()
    return bind(ctypes.CDLL(str(out / "lib.so"))), log


def digests_of(lib) -> dict:
    """``dg_kernel.kernel_digests`` with the wrappers calling ``lib``'s
    entries (None: this tree's library)."""
    from multigrid_tpu_torch import _build
    from multigrid_tpu_torch.ops import dg_kernel as dk

    saved = _build.library()
    _build._lib = saved if lib is None else lib
    try:
        return dk.kernel_digests(torch.device("cuda", 0))
    finally:
        _build._lib = saved


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
             cg: bool, others=None) -> dict:
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
        # the preconditioner pass once from the same scalars as dg_cg
        jr0, jz0, js0 = r.clone(), torch.empty_like(r), scal.clone()
        dk.dg_jacobi_cg(jr0, q, js0, jz0, op64, partial)
        want["dg_jacobi_cg"] = (jr0, jz0, js0)
    torch.cuda.synchronize()
    digests = {k: digest(want[k]) for k in ("cheb", "cheb_x0", "apply_f32",
                                            "residual_f32", "apply_f64",
                                            "residual_f64")}
    outs_of = {"dg_cg": ("x", "p", "q", "scalars"),
               "dg_jacobi_cg": ("r", "z", "scalars")}
    for key, names in outs_of.items():
        if key in want:
            digests.update({f"{key} {n}": digest(t)
                            for n, t in zip(names, want[key])})
    args = (*grid.cells, grid.n, int(op.plain.is_collocation),
            _build.stream_handle(dev))
    differ = []
    ptr = lambda t: t.data_ptr()
    tabs = {32: op.host_tables.ctypes.data, 64: op64.host_tables.ctypes.data}

    def raw_calls(lib, keys=None) -> dict:
        """mode -> (fresh outputs, a call of lib's C entry on the inputs
        above), for the modes ``keys`` (default: all)"""
        raw = {}
        keys = keys or ("cheb", "cheb_x0", "apply_f32", "residual_f32",
                        "apply_f64", "residual_f64", "dg_cg", "dg_jacobi_cg")
        for key, x_, xo_, f1 in (("cheb", x, xo, 0.37),
                                 ("cheb_x0", None, None, 0.0)):
            if key not in keys:
                continue
            o = torch.empty_like(b)
            raw[key] = ((o,), lambda o=o, x_=x_, xo_=xo_, f1=f1: call(
                lib.dg_cheb_f32, ptr(b), None if x_ is None else ptr(x_),
                None if xo_ is None else ptr(xo_), ptr(op.jacobi.inv_diag),
                tabs[32], ptr(o), f1, 0.81, *args))
        for bits, xs, bs in ((32, xr, br), (64, xr64, br64)):
            for mode, key in enumerate((f"apply_f{bits}", f"residual_f{bits}")):
                if key not in keys:
                    continue
                entry = getattr(lib, f"dg_apply_f{bits}")
                o = torch.empty_like(xs)
                raw[key] = ((o,), lambda o=o, mode=mode, xs=xs, bs=bs,
                            entry=entry, bits=bits: call(
                    entry, mode, ptr(xs), ptr(bs), tabs[bits], ptr(o), *args))
        if cg and "dg_cg" in keys:
            vx, vs = x0.clone(), scal.clone()
            vp, vq = torch.empty_like(x0), torch.empty_like(x0)
            raw["dg_cg"] = ((vx, vp, vq, vs), lambda: call(
                lib.dg_cg_f64, ptr(p_old), ptr(z), ptr(vx), ptr(vp),
                ptr(vq), ptr(vs), tabs[64], ptr(partial), partial.numel(),
                *args))
        if cg and "dg_jacobi_cg" in keys:
            wr, wz, ws = r.clone(), torch.empty_like(r), scal.clone()
            raw["dg_jacobi_cg"] = ((wr, wz, ws), lambda: call(
                lib.dg_jacobi_cg_f64, ptr(wr), ptr(q), ptr(wz),
                ptr(op64.jacobi.inv_diag), ptr(ws), tabs[64], ptr(partial),
                partial.numel(), int(np.prod(grid.cells)), grid.n, 0,
                args[-1]))
        return raw

    no_fit = [spec for spec in specs if not fits(spec, grid.n)]
    # the modes a pencil variant times (see variants())
    spec_keys = {"cheb": ("cheb",), "cg": ("dg_cg",),
                 "f32": ("apply_f32", "residual_f32"),
                 "f64": ("apply_f64", "residual_f64"),
                 "wide": ("cheb", "cheb_x0", "apply_f32", "residual_f32"),
                 "wide_f64": ("apply_f64", "residual_f64")}
    for spec, (_, lib) in specs.items():
        what = spec.split(":")[0]
        if spec in no_fit or (what == "cg" and not cg):
            continue
        for key, (outs, fn) in raw_calls(lib, spec_keys[what]).items():
            fn()
            torch.cuda.synchronize()
            refs = want[key] if isinstance(want[key], tuple) else (want[key],)
            for got, ref in zip(outs, refs):
                diff = float((got - ref).abs().max())
                bar = (1e-12 if got.dtype == torch.float64 else 1e-5) * float(
                    ref.abs().max())
                if diff > bar:
                    raise AssertionError(f"{spec} {key}: differs by "
                                         f"{diff:.3e}")
            if key != "dg_cg":
                digests[f"{key}@{spec}"] = digest(outs[0])
            fns[f"{key}@{spec}"] = fn
    libs = {"this": _build.library(), **(others or {})}
    for name, lib in (libs.items() if others else ()):
        # each tree's C entries on the same inputs, fresh outputs
        for key, (outs, fn) in raw_calls(lib).items():
            fn()
            torch.cuda.synchronize()
            refs = want[key] if isinstance(want[key], tuple) else (want[key],)
            if not all(torch.equal(a, b_) for a, b_ in zip(outs, refs)):
                differ.append(f"{key}@{name}")
            if key in outs_of:
                digests.update({f"{key} {n}@{name}": digest(t)
                                for n, t in zip(outs_of[key], outs)})
            else:
                digests[f"{key}@{name}"] = digest(outs[0])
            fns[f"{key}@{name}"] = fn
    rounds = [{k: time_ms(fn) for k, fn in fns.items()} for _ in range(3)]
    return dict(dofs=grid.n_dofs, kind=kind, sha256=digests, rounds=rounds,
                best={k: min(r[k] for r in rounds) for k in fns},
                no_fit=no_fit, differ=differ)


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
    ap.add_argument("--against", nargs="*", default=[], metavar="DIR",
                    help="time and compare other trees' DG kernels")
    ap.add_argument("--digests", action="store_true",
                    help="print dg_kernel.kernel_digests instead of timing")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_dg_cheb: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    _build.library()
    built = {Path(d).name: against_library(d) for d in args.against}
    others = {name: lib for name, (lib, _) in built.items()}
    if args.digests:
        mine = digests_of(None)
        out = {"digests": mine}
        if others:
            name = next(iter(others))
            out["against"] = digests_of(others[name])
            out["differ"] = [k for k in mine if out["against"].get(k) != mine[k]]
            print(f"digests: {len(mine)}, differing from {name}: "
                  f"{out['differ'] or 'none'}")
        print(card)
        print(json.dumps(out))
        return 0
    specs = variants(args.pencil)
    results = []
    for degree in args.degree:
        n = degree + 1
        result = dict(card=card, degree=degree,
                      library_ptxas=degree_rows(_build.build_log, n),
                      variant_ptxas={s: degree_rows(log, n)
                                     for s, (log, _) in specs.items()},
                      sizes={})
        if others:
            result["against_ptxas"] = {name: degree_rows(log, n)
                                       for name, (_, log) in built.items()}
            for tree, rows in (("library", result["library_ptxas"]),
                               *result["against_ptxas"].items()):
                for r in rows:
                    print(f"p={degree} ptxas {tree} {r['kernel']}: "
                          f"{r['registers']} registers, spills "
                          f"{r['spill_stores']} / {r['spill_loads']} B")
        if n in dk.HIGH_KERNELS_AT:
            # the tile of the kernels at p = 8, 9, of the library and of
            # each variant
            result["high_tiles"] = {"library": dk.high_tile(n), **{
                s: dk.high_tile(n, lib) for s, (_, lib) in specs.items()
                if s.split(":")[0] != "cg"}}
            for s, tiles in result["high_tiles"].items():
                for name, tile in tiles.items():
                    print(f"p={degree} tile {s} {name}: " + ", ".join(
                        f"{k} {v}" for k, v in tile.items()))
        if degree in dk.WIDE_DEGREES:
            # the tile of the kernels at p = 10..16 (dg_pencil_wide*.cu), of
            # the library and of each wide variant
            result["wide_tiles"] = {"library": dk.wide_tile(n), **{
                s: dk.wide_tile(n, lib, (torch.float64 if s.startswith(
                    "wide_f64:") else torch.float32,))
                for s, (_, lib) in specs.items() if s.startswith("wide")}}
            for s, tiles in result["wide_tiles"].items():
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
                run = size_run(size, degree, kind, specs, dev, args.cg,
                               others)
                result["sizes"][f"{size} {kind}"] = run
                torch.cuda.empty_cache()
                print(f"p={degree} {kind} size {size}: sha256 " + ", ".join(
                    f"{k} {d}" for k, d in run["sha256"].items()))
                if others:
                    print(f"p={degree} {kind} size {size}: outputs differing "
                          f"from this tree's: {run['differ'] or 'none'}; "
                          "best ms " + ", ".join(
                              f"{k} {v:.4f}" for k, v in run["best"].items()))
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
