"""ctypes bindings for the host mesh helper (``mesh/meshgen.cpp``).

Twin of ``multigrid_tpu/mesh/native.py``.  The library is built at first
use with ``g++ -O3 -shared -fPIC -std=c++17`` into
``build/multigrid_tpu_torch/`` beside the package, under a name keyed by a
hash of the source, and loaded with ``ctypes``.  A failed build raises:
there is no silent numpy fallback.  The numpy versions
(:func:`quantize_labels_numpy`, :func:`block_cell_nodes_numpy`) stay as
the tests' oracle.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "meshgen.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "multigrid_tpu_torch"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_I64P = ctypes.POINTER(ctypes.c_int64)


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libmeshgen_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``meshgen.cpp`` unless the hashed library exists; raises
    when ``g++`` fails or is missing."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not be run to build {SOURCE.name}: "
                           f"{e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a loader never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The loaded helper library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.mg_unique_nodes.restype = ctypes.c_int64
            lib.mg_unique_nodes.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int32, ctypes.c_double, _I64P]
            lib.mg_block_cell_nodes.restype = None
            lib.mg_block_cell_nodes.argtypes = [
                _I64P, ctypes.c_int32, ctypes.c_int32, _I64P]
            _lib = lib
        return _lib


def quantize_labels_numpy(coords: np.ndarray, tol: float) -> np.ndarray:
    """Group labels of one rounded-coordinate hashing (numpy oracle; the
    labels differ from the native ones, the grouping does not)."""
    keys = np.round(coords / tol).astype(np.int64)
    _, inverse = np.unique(keys, axis=0, return_inverse=True)
    return inverse.reshape(-1)


def _quantize_labels(coords: np.ndarray, tol: float) -> np.ndarray:
    """Group labels from one rounded-coordinate hashing (native)."""
    coords = np.ascontiguousarray(coords, np.float64)
    n, dim = coords.shape
    inverse = np.empty(n, np.int64)
    load().mg_unique_nodes(
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, dim, tol,
        inverse.ctypes.data_as(_I64P))
    return inverse


def unique_nodes(coords: np.ndarray, tol: float, quantize=None):
    """Returns (n_unique, inverse) for rounded-coordinate identification.

    Two copies of one physical node computed through different block
    mappings differ by ~1e-16 * scale and can land on opposite sides of a
    rounding boundary, so the points are hashed at two offset
    quantizations (``round(x / tol)`` and ``round(x / tol + 1/2)``) and the
    two groupings merged by min-label propagation (connected components of
    the two partitions).  ``quantize`` replaces the native hashing (the
    tests pass :func:`quantize_labels_numpy`)."""
    quantize = _quantize_labels if quantize is None else quantize
    coords = np.ascontiguousarray(coords, np.float64)
    n = coords.shape[0]
    inv_a = quantize(coords, tol)
    inv_b = quantize(coords + 0.5 * tol, tol)
    lab = np.arange(n, dtype=np.int64)
    for _ in range(16):
        changed = False
        for inv in (inv_a, inv_b):
            gmin = np.full(int(inv.max()) + 1, n, np.int64)
            np.minimum.at(gmin, inv, lab)
            new = gmin[inv]
            if not np.array_equal(new, lab):
                changed = True
                lab = new
        if not changed:
            break
    uniq, inverse = np.unique(lab, return_inverse=True)
    return int(uniq.shape[0]), inverse.reshape(-1)


def block_cell_nodes(cells, degree: int) -> np.ndarray:
    """Cell -> local node table ``[prod(cells), (p+1)^dim]`` of one
    structured block (node lattice ``cells[d] * p + 1`` per axis, axis 0
    slowest), from the native helper."""
    cells_arr = np.asarray(cells, np.int64)
    n_loc = (degree + 1) ** len(cells)
    out = np.empty((int(np.prod(cells_arr)), n_loc), np.int64)
    load().mg_block_cell_nodes(cells_arr.ctypes.data_as(_I64P),
                               len(cells), degree, out.ctypes.data_as(_I64P))
    return out


def _window_np(x: np.ndarray, axis: int, window: int, stride: int) -> np.ndarray:
    n_cells = (x.shape[axis] - 1) // stride
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(0, x.shape[axis] - 1)
    main = x[tuple(sl)].reshape(x.shape[:axis] + (n_cells, stride)
                                + x.shape[axis + 1:])
    sl[axis] = slice(1, x.shape[axis])
    last = x[tuple(sl)].reshape(x.shape[:axis] + (n_cells, stride)
                                + x.shape[axis + 1:])
    sel = [slice(None)] * main.ndim
    sel[axis + 1] = slice(stride - 1, stride)
    return np.concatenate([main, last[tuple(sel)]], axis=axis + 1)


def block_cell_nodes_numpy(cells, degree: int) -> np.ndarray:
    """numpy oracle of :func:`block_cell_nodes`."""
    dim = len(cells)
    n = degree + 1
    shape = tuple(c * degree + 1 for c in cells)
    idx = np.arange(int(np.prod(shape))).reshape(shape)
    for d in range(dim - 1, -1, -1):
        idx = _window_np(idx, d, n, degree)
    perm = tuple(range(0, 2 * dim, 2)) + tuple(range(1, 2 * dim, 2))
    return idx.transpose(perm).reshape(-1, n ** dim)
