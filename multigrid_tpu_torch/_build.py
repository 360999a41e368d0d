"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``), one ``nvcc``
per source, all started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The library lives
in ``build/multigrid_tpu_torch/`` beside the package, under a name keyed by
a hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads at once.  Nothing is built when this module is
imported: :func:`library` builds at first use, and only there is ``nvcc``
needed.

Every C entry point launches on the stream it is given, allocates nothing,
writes the number of kernels it launched to its last argument and returns
``cudaGetLastError()``; :func:`launch` calls one and raises on a non-zero
code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCES = [PACKAGE_DIR / "csrc" / "brick_kron.cu",
           PACKAGE_DIR / "csrc" / "brick_kron_layer.cu",
           PACKAGE_DIR / "csrc" / "brick_kron_f64.cu",
           PACKAGE_DIR / "csrc" / "brick_kron_wide.cu",
           PACKAGE_DIR / "csrc" / "brick_kron_wide_f64.cu",
           PACKAGE_DIR / "csrc" / "cheb_epilogue.cu",
           PACKAGE_DIR / "csrc" / "cg_vec.cu",
           PACKAGE_DIR / "csrc" / "dg_pencil.cu",
           PACKAGE_DIR / "csrc" / "dg_pencil_f64.cu",
           PACKAGE_DIR / "csrc" / "dg_pencil_high.cu",
           PACKAGE_DIR / "csrc" / "dg_pencil_wide.cu",
           PACKAGE_DIR / "csrc" / "dg_pencil_wide_top.cu",
           PACKAGE_DIR / "csrc" / "dg_pencil_wide_f64.cu",
           PACKAGE_DIR / "csrc" / "dg_pencil_wide_top_f64.cu",
           PACKAGE_DIR / "csrc" / "dg_cg_f64.cu"]
HEADERS = [PACKAGE_DIR / "csrc" / "brick_kron.cuh",
           PACKAGE_DIR / "csrc" / "dg_pencil.cuh",
           PACKAGE_DIR / "csrc" / "dg_tab.cuh"]
BUILD_DIR = PACKAGE_DIR.parent / "build" / "multigrid_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_D = ctypes.c_double
_I = ctypes.c_int
_LL = ctypes.c_longlong
_N = ctypes.POINTER(ctypes.c_int)
# entry point -> argtypes (all return int = cudaError_t; the last argument
# receives the number of kernels launched)
SIGNATURES = {
    # mode, form, x, b, x_old, out, taps (host), f1, f2, Z, Y, X, p, stream
    "brick_kron_f32": [_I, _I, _P, _P, _P, _P, _P, _D, _D, _I, _I, _I, _I, _P,
                       _N],
    "brick_kron_f64": [_I, _I, _P, _P, _P, _P, _P, _D, _D, _I, _I, _I, _I, _P,
                       _N],
    # the same arguments, form 2 (the layer march), p = 8, 9
    "brick_kron_layer_f32": [_I, _I, _P, _P, _P, _P, _P, _D, _D, _I, _I, _I,
                             _I, _P, _N],
    # p, out[7]: the layer march's tile (cells in x, y, planes a group,
    # threads, shared bytes, blocks an SM) and the z-slab march's shared
    # bytes at p; launches nothing
    "brick_kron_layer_f32_tile": [_I, _N],
    # b, y, x, x_old, lines, out, f1, f2, Z, Y, X, residual_only, stream
    "cheb_epilogue_f64": [_P, _P, _P, _P, _P, _P, _D, _D, _I, _I, _I, _I, _P,
                          _N],
    "cheb_epilogue_f32": [_P, _P, _P, _P, _P, _P, _D, _D, _I, _I, _I, _I, _P,
                          _N],
    # x, r, p, q, alpha, n, partial, out, stream
    "cg_update": [_P, _P, _P, _P, _D, _LL, _P, _P, _P, _N],
    # a, b, n, partial, out, stream
    "cg_dot": [_P, _P, _LL, _P, _P, _P, _N],
    # p, z, beta, n, stream
    "cg_xpay": [_P, _P, _D, _LL, _P, _N],
    # mode, x, b, tables (host), out, C0, C1, C2, n, collocation, stream
    "dg_apply_f64": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _N],
    "dg_apply_f32": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _N],
    # b, x, x_old, inv_diag, tables (host, float32), out, f1, f2, C0, C1,
    # C2, n, collocation, stream
    "dg_cheb_f32": [_P, _P, _P, _P, _P, _P, _D, _D, _I, _I, _I, _I, _I, _P,
                    _N],
    # p_old, z, x, p, q, scalars, tables (host), partial, partial length,
    # C0, C1, C2, n, collocation, stream
    "dg_cg_f64": [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P,
                  _N],
    # r, q, z, inv_diag, scalars, tables (host), partial, partial length,
    # cells, n, first, stream
    "dg_jacobi_cg_f64": [_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _P,
                         _N],
    # n, out[5]: dg_cg's march tile (K, p buffers, shared bytes, threads,
    # blocks an SM); launches nothing
    "dg_cg_f64_tile": [_I, _N],
    # dg_pencil_high.cu's kernels (dg_apply_f64 at n = 9 and dg_cheb_f32 at
    # n = 9, 10 launch them): kernel (0 cheb in float; 1 apply, 2 residual
    # in double), n, out[6]: their tile (cells a pencil, shared bytes,
    # threads, blocks an SM, registers, local bytes); launches nothing
    "dg_high_tile": [_I, _I, _N],
    # out[3]: their launches since the library was loaded, in the order
    # above; launches nothing
    "dg_high_launches": [_N],
    # the kernels at n = 11..17 (dg_pencil_wide*.cu; dg_apply_f32/_f64 and
    # dg_cheb_f32 launch them): mode (0 apply, 1 residual, 2 cheb in
    # float), n, out[6]: their tile, as dg_high_tile's; launches nothing
    "dg_wide_tile_f32": [_I, _I, _N],
    "dg_wide_tile_f64": [_I, _I, _N],
}
# partial-sum slots the reductions of cg_vec.cu use (its kMaxBlocks)
REDUCTION_BLOCKS = 1024

_lib = None
build_log = ""
build_seconds: dict[str, float] = {}   # wall seconds of each nvcc, the link


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmgt_kernels_{_digest()}.so"


def compile_sources(sources: list[Path], work: Path
                    ) -> tuple[str, list[str], dict[str, float]]:
    """``nvcc -c`` of each source into ``work``, all started together, then
    the link into ``work/lib.so``: the compiler's output, the failed
    commands and the wall seconds of each nvcc (by source name) and of the
    link."""
    nvcc = _nvcc()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(work / (src.stem + ".o")),
             str(src)] for src in sources]
    t0 = time.perf_counter()
    outs = [open(work / (src.stem + ".log"), "w+") for src in sources]
    procs = [subprocess.Popen(c, stdout=f, stderr=subprocess.STDOUT)
             for c, f in zip(cmds, outs)]
    seconds: dict[str, float] = {}
    while len(seconds) < len(procs):
        for src, p in zip(sources, procs):
            if src.name not in seconds and p.poll() is not None:
                seconds[src.name] = time.perf_counter() - t0
        time.sleep(0.05)
    logs = []
    for f in outs:
        f.seek(0)
        logs.append(f.read())
        f.close()
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(work / "lib.so"),
            *(c[c.index("-o") + 1] for c in cmds)]
    failed = [" ".join(c) for c, p in zip(cmds, procs) if p.returncode != 0]
    if not failed:
        t1 = time.perf_counter()
        proc = subprocess.run(link, capture_output=True, text=True)
        seconds["link"] = time.perf_counter() - t1
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(" ".join(link))
    log = "\n".join(" ".join(c) + "\n" + lg
                    for c, lg in zip([*cmds, link], logs))
    return log, failed, seconds


def build() -> Path:
    """Compile the sources into the hashed library unless it exists: one
    ``nvcc -c`` per source in parallel, then one link."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    build_log, failed, build_seconds = compile_sources(SOURCES, work)
    (BUILD_DIR / "build.log").write_text(build_log)
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc failed: {failed}\n{build_log}")
    os.replace(work / "lib.so", out)   # atomic: a loader never sees half a file
    shutil.rmtree(work, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(entry: str, *args) -> int:
    """Call the C entry point ``entry`` with ``args`` (its arguments but the
    last) and return the number of kernels it launched; raises if the
    launch failed."""
    launched = ctypes.c_int(0)
    err = getattr(library(), entry)(*args, ctypes.byref(launched))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed: cudaError {err}")
    return launched.value


def ptxas_report(log: str) -> list[dict]:
    """One row per kernel entry of a ``-Xptxas -v`` build log (``build_log``
    or one nvcc's output): its source, its mangled name, registers and
    spill bytes."""
    rows, src, cur = [], None, None
    for line in log.splitlines():
        if " -c " in line and line.rstrip().endswith(".cu"):
            src = Path(line.split()[-1]).name
        elif m := re.search(r"Compiling entry function '(\S+)'", line):
            cur = dict(source=src, kernel=m[1], registers=None,
                       spill_stores=0, spill_loads=0)
            rows.append(cur)
        elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                     r"spill loads", line)):
            cur["spill_stores"], cur["spill_loads"] = int(m[1]), int(m[2])
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(m[1])
    return rows


def sass_report(objects: list[Path], log: str) -> dict:
    """Per kernel of the compiled ``objects`` (``cuobjdump -sass``): its
    source, registers and spill bytes (``log``, the build's ``-Xptxas -v``
    output), SASS instructions and the sha256 of its SASS, with code
    addresses and the anonymous namespace's per-file name left out, so
    that two trees' builds of the same code compare equal.  Keyed by the
    kernel's name with that namespace cut out."""
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    anon = re.compile(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}")
    ptxas = {anon.sub("ANON", r["kernel"]): r for r in ptxas_report(log)}
    out = {}
    for obj in objects:
        sass = subprocess.run([str(cuobjdump), "-sass", str(obj)],
                              capture_output=True, text=True, check=True).stdout
        for block in sass.split("Function : ")[1:]:
            name, body = block.split("\n", 1)
            name = anon.sub("ANON", name.strip())
            lines = [re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).strip()
                     for ln in body.splitlines()]
            lines = [anon.sub("ANON", ln) for ln in lines
                     if ln and not ln.startswith("/* 0x")
                     and not ln.startswith(".")]
            r = ptxas.get(name, {})
            out[name] = dict(source=obj.stem + ".cu",
                             registers=r.get("registers"),
                             spill_stores=r.get("spill_stores"),
                             spill_loads=r.get("spill_loads"),
                             instructions=sum(";" in ln for ln in lines),
                             sass_sha256=hashlib.sha256(
                                 "\n".join(lines).encode()).hexdigest()[:16])
    return out


def stream_handle(device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def main(argv: list[str]) -> int:
    """``python -m multigrid_tpu_torch._build [--tree DIR] [--kernels
    PATH]``: compile the kernel sources of this tree, or of the same files
    in another tree's ``multigrid_tpu_torch/csrc``, into a scratch
    directory as :func:`build` does (the library is not kept) and print
    the wall seconds of each nvcc, the link and the whole build (of the
    sources of this tree that the other tree has); with
    ``--kernels``, write :func:`sass_report` of every kernel to PATH
    (JSON) and print the registers and spills of each."""
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=PACKAGE_DIR.parent)
    ap.add_argument("--kernels", type=Path, default=None)
    args = ap.parse_args(argv)
    csrc = args.tree.resolve() / "multigrid_tpu_torch" / "csrc"
    # this tree's sources that the other tree has (an older tree may lack
    # the newer ones)
    sources = [csrc / src.name for src in SOURCES
               if (csrc / src.name).exists()]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    t0 = time.perf_counter()
    log, failed, seconds = compile_sources(sources, work)
    total = time.perf_counter() - t0
    if not failed and args.kernels is not None:
        report = sass_report([work / (src.stem + ".o") for src in sources],
                             log)
        args.kernels.parent.mkdir(parents=True, exist_ok=True)
        args.kernels.write_text(json.dumps(report, indent=1))
        for name, r in report.items():
            print(f"{r['source']} {name}: {r['registers']} registers, spill "
                  f"{r['spill_stores']} / {r['spill_loads']} B, "
                  f"{r['instructions']} instructions, sass {r['sass_sha256']}")
    shutil.rmtree(work, ignore_errors=True)
    if failed:
        print(log)
        return 1
    print(f"build of {csrc}: {total:.2f} s; " + ", ".join(
        f"{k} {v:.2f} s" for k, v in sorted(seconds.items(),
                                             key=lambda kv: -kv[1])))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
