"""Time the brick operator (K1's and K2's twin) on the card.

    python -m multigrid_tpu_torch.experiments.time_brick [size ...]
        [--degree P] [--plain] [--f64-variant CPT:BLOCKS ...]
        [--high-variant TYPE:CPT:BLOCKS ...]
        [--forms FORM ...] [--layer-variant TXC:TYC:G:THREADS:BLOCKS ...]
    python -m multigrid_tpu_torch.experiments.time_brick [size ...]
        --degree P --levels [--form auto|cell|march|layer]

For each poisson_cube size (default 64 and 128: 257^3 and 513^3 nodes at
the default FE_Q(4); ``--degree 8`` at size 32 and ``--degree 9`` at size
28 give 257^3 and 253^3 nodes, ``--degree 10`` at size 24 241^3 and
``--degree 16`` at size 16 257^3: any degree 1..16 that ``brick_kron``
is built for) the float64 ``BrickLaplace`` of the
finest level, on random x and b from a seeded generator: CUDA events over
50 calls after 3 warm-ups, three rounds of (apply, vmult, vmult_residual,
and the float32 operator's apply and Chebyshev step beside them; with
``--plain`` also both dtypes' dense plain apply), with the device kernels
one call launches (``laplace_kernel.LAUNCHES``) and a digest of each
output (sha256 of its bytes), so that two trees' results can be compared
bit for bit.  ``--f64-variant C:B`` also builds
``csrc/brick_kron_f64.cu`` (with ``brick_kron_wide_f64.cu``, which its
entry hands p = 10..16) alone with C z columns a thread at p <= 4 and
a launch bound of B blocks an SM (``-DBRICK_KRON_F64_CPT=C
-DBRICK_KRON_F64_MIN_BLOCKS=B``); ``--high-variant f32:C:B`` (or
``f64:C:B``) builds that type's source with C columns a thread aimed at
above p = 4 and the launch bound B (``-DBRICK_KRON_HIGH_CPT=C
-DBRICK_KRON_F32_MIN_BLOCKS=B``, or ``..._F64_...``).  Each variant
prints the registers and spills of its kernels at the timed degree,
checks that its modes (apply, vmult, residual in double; apply and the
Chebyshev step in float) equal the library's bit for bit (the tile shape
moves no rounding: every node sums the same taps in the same order) and
is timed beside.  At p = 8, 9 ``--forms march layer`` also times the
float apply, residual and Chebyshev step in each named form of
``brick_kron`` (``laplace_kernel.FORMS``) beside the default form's, and
``--layer-variant TXC:TYC:G:THREADS:BLOCKS`` builds
``csrc/brick_kron_layer.cu`` alone with that layer-march tile at the timed
degree (cells in x and y, input planes a group, threads, launch bound;
``-DBRICK_LAYER_VARIANT=P -DBRICK_LAYER_TXC=..``), prints its registers,
spills, shared bytes and blocks an SM, checks its float apply, residual
and step bit for bit against the library's and times them.  The script
uses only the operator's public methods, so
run as a file with another tree's package on ``PYTHONPATH`` it times that
tree's kernels in the same call (``PYTHONPATH=<tree> python
<tree>/multigrid_tpu_torch/experiments/time_brick.py``, or this file with
``PYTHONPATH=<tree>``).  Prints the card line and one JSON line.  Needs a
CUDA device.

``--levels`` times every level of each size's hierarchy instead (the
node grids of ``poisson_cube_mesh(size)`` at FE_Q(P), coarse to fine: a
poisson_cube row's V-cycle and, for the size of a poisson_dg row, its
FE_Q(P) hierarchy): the double apply, vmult and residual and the float
apply, vmult, residual and Chebyshev step, each as the wall of one wrapper
call (CUDA events over back-to-back calls, as a solve issues them: the host's
cost of a call included) and as the device time of its kernel
(``torch.profiler``: the mean duration of the kernel events of 20
calls), with its bound (bytes through HBM or operations at the peak rate,
the larger) and the digest of its output.  The row ``floor`` is an empty
launch on the same card: the fill kernel of a one-element tensor, timed
the same two ways.  ``--form cell``, ``march`` or ``layer`` runs that
form of the float ``brick_kron`` at p = 8, 9 on every grid (the default
is ``laplace_kernel.brick_form``'s choice; double has only the cell form
there), so that the forms can be timed grid by grid in one call; the
layer march's tile at the degree (``brick_kron_layer_f32_tile``) and,
where this process built the library, the registers and spills of each
form's kernels at the degree are printed first.
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


HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = 67e12            # fp32 outside the tensor cores; fp64 on them
# values each mode moves a node (inputs read once, the output written once)
MODE_VALUES = dict(apply=2, vmult=2, residual=3, apply_f32=2, vmult_f32=2,
                   residual_f32=3, cheb_f32=4)


def device_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """The mean device duration (ms) of the kernel that each call of ``fn``
    launches (one), over the kernel events of a ``torch.profiler`` trace
    of ``reps`` calls; the tracer may drop events, so a trace with fewer
    than half of them is taken again, up to ``tries`` times."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        durs = [e["dur"] for e in events
                if e.get("ph") == "X" and e.get("cat") == "kernel"]
        if reps // 2 <= len(durs) <= reps:
            return sum(durs) / len(durs) / 1e3
    raise RuntimeError(f"device_ms: {len(durs)} kernel events for {reps} "
                       f"calls, {tries} traces")


def forced(auto, form: str):
    """``laplace_kernel.brick_form`` with ``form`` for every float grid
    (double has the cell form alone at p = 8, 9)."""
    return lambda shape, degree, dtype: (
        form if dtype == torch.float32 else auto(shape, degree, dtype))


def with_form(fn, form: str):
    """``fn`` run with the float brick_kron forced to ``form``."""
    from multigrid_tpu_torch.ops import laplace_kernel as lk

    def call():
        auto = lk.brick_form
        lk.brick_form = forced(auto, form)
        try:
            return fn()
        finally:
            lk.brick_form = auto
    return call


def tile_report(degree: int) -> dict:
    """The layer march's tile at ``degree`` (``brick_kron_layer_f32_tile``;
    empty for a tree without it) and, if this process built the library,
    the registers and spills of brick_kron's float kernels there."""
    from multigrid_tpu_torch import _build

    out = {}
    lib = _build.library()
    if hasattr(lib, "brick_kron_layer_f32_tile") and degree in (8, 9):
        t = (ctypes.c_int * 7)()
        err = lib.brick_kron_layer_f32_tile(degree, t)
        if err:
            raise RuntimeError(f"brick_kron_layer_f32_tile: cudaError {err}")
        out["layer_tile"] = dict(zip(
            ("cells_x", "cells_y", "planes_a_group", "threads",
             "shared_bytes", "blocks_an_sm", "march_shared_bytes"), list(t)))
    mark = f"IfLi{degree}ELi"
    forms = (("brick_layer_kernel", "layer"), ("brick_cell_kernel", "cell"),
             ("brick_kron_kernel", "march"))
    out["ptxas"] = [
        dict(form=next(f for k, f in forms if k in r["kernel"]),
             mode=r["kernel"].split(mark)[1][0], registers=r["registers"],
             spill_stores=r["spill_stores"], spill_loads=r["spill_loads"])
        for r in _build.ptxas_report(_build.build_log) if mark in r["kernel"]]
    for k, v in out.items():
        print(f"p={degree} {k}: {v}")
    return out


def level_rows(sizes: list[int], degree: int, dev,
               form: str = "auto") -> list[dict]:
    """``--levels``: every level of each size's hierarchy, coarse to fine
    (see the module note); ``form`` "cell", "march" or "layer" runs that
    form of the float brick_kron on every grid instead of
    ``laplace_kernel.brick_form``'s."""
    from multigrid_tpu_torch.mesh.brick import DofGrid, poisson_cube_mesh
    from multigrid_tpu_torch.ops import laplace_kernel as lk

    if form != "auto":
        lk.brick_form = forced(lk.brick_form, form)

    one = torch.zeros(1, device=dev)
    floor = dict(fill=lambda: one.zero_())
    rows = [dict(size=None, level=None, grid="floor", ms={"fill": min(
        time_ms(floor["fill"]) for _ in range(3))},
        device_ms={"fill": device_ms(floor["fill"])})]
    for size in sizes:
        mesh = poisson_cube_mesh(size)
        for level in range(mesh.n_levels):
            grid = DofGrid(mesh, level, degree)
            op = lk.BrickLaplace(grid, torch.float64, dev)
            op32 = lk.BrickLaplace(grid, torch.float32, dev)
            gen = torch.Generator(dev).manual_seed(size * 100 + level)
            x, b, xo = (torch.randn(grid.shape, dtype=torch.float64,
                                    device=dev, generator=gen)
                        for _ in range(3))
            x32, b32, xo32 = (t.float() for t in (x, b, xo))
            fns = dict(
                apply=lambda: op.apply(x), vmult=lambda: op.vmult(x),
                residual=lambda: op.vmult_residual(b, x),
                apply_f32=lambda: op32.apply(x32),
                vmult_f32=lambda: op32.vmult(x32),
                residual_f32=lambda: op32.vmult_residual(b32, x32),
                cheb_f32=lambda: op32.cheb_step(b32, x32, xo32, 0.37, 0.81))
            digests, launches = {}, {}
            for name, fn in fns.items():
                lk.reset_launches()
                out = fn()
                launches[name] = sum(lk.LAUNCHES.values())
                digests[name] = hashlib.sha256(
                    out.cpu().numpy().tobytes()).hexdigest()[:16]
            nodes = grid.n_dofs
            flops = 14 * (degree + 2) * nodes
            bound = {name: 1e3 * max(
                MODE_VALUES[name] * (4 if name.endswith("_f32") else 8)
                * nodes / HBM_BYTES_PER_S, flops / PEAK_FLOPS)
                for name in fns}
            ms = {name: min(time_ms(fn) for _ in range(3))
                  for name, fn in fns.items()}
            rows.append(dict(size=size, level=level, grid=list(grid.shape),
                             nodes=nodes, launches=launches, ms=ms,
                             device_ms={k: device_ms(fn)
                                        for k, fn in fns.items()},
                             bound_ms=bound,
                             digests=digests))
            print(f"size {size} level {level} {grid.shape}: " + ", ".join(
                f"{k} {ms[k]:.4f} / {rows[-1]['device_ms'][k]:.4f} ms"
                for k in fns), flush=True)
            del op, op32, x, b, xo, x32, b32, xo32, fns
        torch.cuda.empty_cache()
    return rows


def variant_entries(variants: list[str], degree: int) -> dict:
    """The brick entry point built alone for each variant, one nvcc each,
    in parallel: "f64:C:B" of ``--f64-variant`` (C z columns a thread at
    p <= 4, launch bound B), "f32:C:B" / "f64:C:B" of ``--high-variant``
    (``high:`` in front; C columns a thread aimed at above p = 4) or
    "TXC:TYC:G:THREADS:BLOCKS" of ``--layer-variant`` (``layer:`` in
    front; the layer march's tile at ``degree``)."""
    from multigrid_tpu_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs, procs, builds = {}, {}, {}
    for v in variants:
        if v.startswith("layer:"):
            fields = v.removeprefix("layer:").split(":")
            kind, src = "layer", ("brick_kron_layer.cu",)
            defines = [f"-DBRICK_LAYER_VARIANT={degree}"] + [
                f"-DBRICK_LAYER_{k}={f}" for k, f in zip(
                    ("TXC", "TYC", "G", "THREADS", "MIN_BLOCKS"), fields,
                    strict=True)]
            name = f"brick_kron_layer_p{degree}_{'_'.join(fields)}"
        else:
            high = v.startswith("high:")
            kind, cpt, blocks = v.removeprefix("high:").split(":")
            defines = ([f"-DBRICK_KRON_HIGH_CPT={cpt}"] if high
                       else [f"-DBRICK_KRON_F64_CPT={cpt}"])
            defines.append(f"-DBRICK_KRON_{kind.upper()}_MIN_BLOCKS={blocks}")
            # with the type's p = 10..16, which its entry hands on
            src = (("brick_kron.cu", "brick_kron_wide.cu") if kind == "f32"
                   else ("brick_kron_f64.cu", "brick_kron_wide_f64.cu"))
            name = f"brick_kron_{kind}_{'h' if high else ''}{cpt}_{blocks}"
        builds[v] = kind
        outs[v] = _build.BUILD_DIR / f"{name}_{_build._digest()}.so"
        if not outs[v].exists():
            procs[v] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", *defines,
                 "-o", str(outs[v]),
                 *(str(_build.PACKAGE_DIR / "csrc" / f) for f in src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for v in variants:
        kind = builds[v]
        log_path = outs[v].with_suffix(".log")
        if v in procs:
            log = procs[v].communicate()[0]
            if procs[v].returncode:
                raise RuntimeError(f"{v}: nvcc failed\n{log}")
            log_path.write_text(log)
        mark = f"I{'d' if kind == 'f64' else 'f'}Li{degree}ELi"
        log = log_path.read_text() if log_path.exists() else ""
        for row in _build.ptxas_report(log):
            if mark in row["kernel"]:  # brick_*_kernel<T, P, mode>
                print(f"{v} p={degree} mode "
                      f"{row['kernel'].split(mark)[1][0]}: "
                      f"{row['registers']} registers, spill stores "
                      f"{row['spill_stores']} B, loads {row['spill_loads']} B")
        lib = ctypes.CDLL(str(outs[v]))
        fn = getattr(lib, f"brick_kron_{kind}" if kind != "layer"
                     else "brick_kron_layer_f32")
        fn.argtypes = _build.SIGNATURES["brick_kron_f32" if kind != "f64"
                                        else "brick_kron_f64"]
        fn.restype = ctypes.c_int
        if kind == "layer":
            t = (ctypes.c_int * 7)()
            err = lib.brick_kron_layer_f32_tile(degree, t)
            if err:
                raise RuntimeError(f"{v}: tile cudaError {err}")
            print(f"{v} p={degree}: shared {t[4]} B, {t[5]} blocks an SM")
        entries[v] = (kind, fn)
    return entries


def main(argv: list[str]) -> int:
    from multigrid_tpu_torch import _build
    from multigrid_tpu_torch.mesh.brick import DofGrid, poisson_cube_mesh
    from multigrid_tpu_torch.ops import laplace_kernel as lk

    ap = argparse.ArgumentParser()
    ap.add_argument("sizes", type=int, nargs="*", default=[64, 128])
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--plain", action="store_true",
                    help="also time the dense plain apply in both dtypes")
    ap.add_argument("--f64-variant", nargs="*", default=[])
    ap.add_argument("--high-variant", nargs="*", default=[])
    ap.add_argument("--forms", nargs="*", default=[],
                    help="p = 8, 9: also time the float modes in these "
                         "forms of brick_kron")
    ap.add_argument("--layer-variant", nargs="*", default=[],
                    help="p = 8, 9: layer-march tiles TXC:TYC:G:THREADS:"
                         "BLOCKS, built and timed beside")
    ap.add_argument("--levels", action="store_true",
                    help="time every level of each size's hierarchy")
    ap.add_argument("--form", default="auto",
                    choices=["auto", "cell", "march", "layer"],
                    help="--levels: the form of brick_kron on every grid "
                         "(default: laplace_kernel.brick_form's choice)")
    args = ap.parse_args(argv)
    if args.high_variant and args.degree <= 4:
        ap.error("--high-variant tiles apply above p = 4")
    if (args.forms or args.layer_variant) and args.degree not in (8, 9):
        ap.error("--forms and --layer-variant apply at p = 8, 9")
    if not torch.cuda.is_available():
        raise SystemExit("time_brick: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    if args.levels:
        tile = tile_report(args.degree)
        rows = level_rows(args.sizes, args.degree, dev, args.form)
        print(card)
        print(json.dumps(dict(card=card, tree=str(_build.PACKAGE_DIR.parent),
                              degree=args.degree, form=args.form, tile=tile,
                              levels=rows)))
        return 0
    entries = variant_entries(
        [f"f64:{v}" for v in args.f64_variant]
        + [f"high:{v}" for v in args.high_variant]
        + [f"layer:{v}" for v in args.layer_variant], args.degree)
    tile = tile_report(args.degree) if args.degree in (8, 9) else {}
    rows = []
    for size in args.sizes:
        mesh = poisson_cube_mesh(size)
        grid = DofGrid(mesh, mesh.max_level, args.degree)
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
        if args.forms or args.layer_variant:
            fns["residual_f32"] = lambda: op32.vmult_residual(b32, x32)
        for form in args.forms:
            for mode in ("apply_f32", "residual_f32", "cheb_f32"):
                fns[f"{mode}_{form}"] = with_form(fns[mode], form)
        if args.plain:
            fns.update(apply_plain=lambda: lk.brick_apply_plain(x, op.K),
                       apply_f32_plain=lambda: lk.brick_apply_plain(x32,
                                                                    op32.K))
        launches, digests = {}, {}
        for name, fn in fns.items():
            lk.reset_launches()
            out = fn()
            launches[name] = sum(lk.LAUNCHES.values())
            digests[name] = hashlib.sha256(
                out.cpu().numpy().tobytes()).hexdigest()[:16]
        for k, (kind, entry) in entries.items():
            modes = (("apply", "vmult", "residual") if kind == "f64"
                     else ("apply_f32", "residual_f32", "cheb_f32")
                     if kind == "layer" else ("apply_f32", "cheb_f32"))
            for mode in modes:
                f32 = kind != "f64"
                xs, bs, xos = (x32, b32, xo32) if f32 else (x, b, xo)
                host = (op32 if f32 else op).host_taps
                out, launched = torch.empty_like(xs), ctypes.c_int(0)
                kmode = lk.KRON_MODES[mode.removesuffix("_f32")]

                form = (lk.FORMS["layer"] if kind == "layer" else lk.FORMS[
                    lk.brick_form(grid.shape, grid.degree, xs.dtype)])

                def call(entry=entry, out=out, launched=launched,
                         kmode=kmode, xs=xs, bs=bs, xos=xos, host=host,
                         form=form):
                    err = entry(kmode, form, xs.data_ptr(), bs.data_ptr(),
                                xos.data_ptr() if kmode == 3 else None,
                                out.data_ptr(), host.ctypes.data, 0.37,
                                0.81, *grid.shape, grid.degree,
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
                         tile=tile, digests=digests, rounds=rounds,
                         best={k: min(r[k] for r in rounds) for k in fns}))
        del op, op32, x, b, xo, x32, b32, xo32, fns
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps(dict(card=card, tree=str(_build.PACKAGE_DIR.parent),
                          rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
