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
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCES = [PACKAGE_DIR / "csrc" / "brick_apply.cu",
           PACKAGE_DIR / "csrc" / "cg_vec.cu",
           PACKAGE_DIR / "csrc" / "dg_apply.cu"]
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
    # x, y, lm, c0, c1, c2, Z, Y, X, n, stream
    "brick_apply_f64": [_P, _P, _P, _D, _D, _D, _I, _I, _I, _I, _P, _N],
    "brick_apply_f32": [_P, _P, _P, _D, _D, _D, _I, _I, _I, _I, _P, _N],
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
    # x, tables, y, C0, C1, C2, n, collocation, stream
    "dg_apply_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _N],
    "dg_apply_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _N],
    # b, x, x_old, inv_diag, tables, out, f1, f2, C0, C1, C2, n,
    # collocation, stream
    "dg_cheb_f32": [_P, _P, _P, _P, _P, _P, _D, _D, _I, _I, _I, _I, _I, _P,
                    _N],
}
# partial-sum slots the reductions of cg_vec.cu use (its kMaxBlocks)
REDUCTION_BLOCKS = 1024

_lib = None
build_log = ""


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
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmgt_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the sources into the hashed library unless it exists: one
    ``nvcc -c`` per source in parallel, then one link."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    nvcc = _nvcc()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(work / (src.stem + ".o")),
             str(src)] for src in SOURCES]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(work / "lib.so"),
            *(c[c.index("-o") + 1] for c in cmds)]
    failed = [" ".join(c) for c, p in zip(cmds, procs) if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(" ".join(link))
    build_log = "\n".join(" ".join(c) + "\n" + log
                           for c, log in zip([*cmds, link], logs))
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


def stream_handle(device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
