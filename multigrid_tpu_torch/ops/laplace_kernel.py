"""Hot-path brick operator: wrappers of the CUDA kernels with their plain
PyTorch versions and launch counters.

Replaces ``multigrid_tpu/ops/pallas_windowed.py`` (K1, dp A·u and its
residual forms) and ``multigrid_tpu/ops/pallas_windowed_sp.py`` (K2, sp
A·u with its residual and Chebyshev epilogues).  Two kernels:

* ``brick_kron`` (``csrc/brick_kron.cuh``; float32 K2 in
  ``brick_kron.cu``, float64 K1 in ``brick_kron_f64.cu``): one
  node-centric pass of seven banded sweeps that writes each node once, so
  the epilogue fuses -- ``apply`` (y = A x, 0 on Dirichlet rows),
  ``vmult`` (x on Dirichlet rows), ``residual`` (b - A x; b - x on
  Dirichlet rows) and ``cheb`` (x + f1 (x - x_old) + f2 (b - A x) / diag),
  one launch each, in one of three forms with the same bits: the z-slab
  march (p <= 7, and p = 10..16 in both types, ``brick_kron_wide.cu`` /
  ``brick_kron_wide_f64.cu``: one column a thread, the planes of a cell
  layer one a trip), and at p = 8, 9 the cell form (a block a cell) and in
  float the layer march (``brick_kron_layer.cu``: tiles of 4 x 3 / 4 x 4
  cells marching by cell layers with their z ring in shared memory),
  chosen per grid by :func:`brick_form`;
* ``cheb_epilogue`` (``csrc/cheb_epilogue.cu``): the residual ``b - y`` or
  the Chebyshev update ``x + f1 (x - x_old) + f2 (b - y) / diag`` with the
  separable diagonal rebuilt in the kernel, for a given y: the f32 step
  with x = 0, which needs no A x.  Dirichlet rows follow the node-path
  semantics (identity rows of A, diagonal 1).

Each wrapper runs the plain version for a tensor on the CPU and launches
the kernel for a CUDA tensor (or raises); there is no fallback.
:class:`BrickLaplace` routes every CUDA operator, float32 and float64,
through ``brick_kron``, and on the CPU through the dense element path
(``brick_apply_plain``) and ``cheb_epilogue_plain``.  ``LAUNCHES[name]``
counts the device kernels launched, as a trace shows them: one per
``brick_kron`` call (``brick_kron<float>`` / ``brick_kron<double>`` for
the A·x modes, ``brick_kron_cheb<...>`` for the fused step) and one per
``cheb_epilogue``; ``LAUNCHES_BY_GRID[name, (Z, Y, X)]`` counts the
``brick_kron`` launches by kernel name and node grid, so that a solve's
launches can be read level by level.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..devices import resolve
from ..mesh.brick import DofGrid
from .laplace import diag_lines, make_diag_coef
from .laplace_dense import dense_apply, element_matrix
from .laplace_kron import brick_kron_plain, kron_taps
from .masks import interior_mask

LAUNCHES = {"brick_kron<float>": 0, "brick_kron_cheb<float>": 0,
            "brick_kron<double>": 0, "brick_kron_cheb<double>": 0,
            "cheb_epilogue<double>": 0, "cheb_epilogue<float>": 0}
LAUNCHES_BY_GRID: dict = {}
KRON_MODES = {"apply": 0, "vmult": 1, "residual": 2, "cheb": 3}
MAX_DEGREE = 16    # brick_kron's largest instantiation (the JAX package's
                   # degree sweep, tests/test_degree_sweep.py)
CELL_DEGREE = 8    # brick_kron's cell form: p = 8, 9 (CELL_DEGREE up to
                   # WIDE_DEGREE - 1)
WIDE_DEGREE = 10   # p >= WIDE_DEGREE: the z-slab march in both types (the
                   # cell form's neighbourhood outgrows a block there)
# the float forms at p = 8, 9 by the grid's cell count: the cell form up
# to F32_CELL_FORM_MAX_CELLS[p] cells, the layer march above (the step's
# crossover lies between 1728 and 4096 cells at p = 8, between 343 and
# 1728 at p = 9: PERF.md, time_brick --levels --form); double runs the
# cell form on every grid
F32_CELL_FORM_MAX_CELLS = {8: 3000, 9: 1000}
FORMS = {"march": 0, "cell": 1, "layer": 2}
_SUFFIX = {torch.float64: ("f64", "double"), torch.float32: ("f32", "float")}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_GRID.clear()


def _check_grid_tensor(t: torch.Tensor, like, what: str):
    """``t`` must have the shape, dtype and device of ``like`` (a tensor or
    an operator) and be contiguous."""
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"{what}: expected {tuple(like.shape)} {like.dtype} on "
                         f"{like.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


# ------------------------------------------------------------ brick_apply
def brick_apply_plain(x: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Plain version: masked input, dense element apply, zero boundary."""
    m = interior_mask(x.shape, x.device)
    return torch.where(m, dense_apply(torch.where(m, x, 0), K), 0)


def brick_apply(x: torch.Tensor, op: "BrickLaplace") -> torch.Tensor:
    """y = A x (Dirichlet nodes of x read as 0, of y written as 0): the
    plain version on the CPU, ``brick_kron(x, op, "apply")`` on the card."""
    if x.device.type == "cpu":
        return brick_apply_plain(x, op.K)
    if x.device.type != "cuda":
        raise RuntimeError(f"brick_apply: no kernel for device {x.device}")
    return brick_kron(x, op, "apply")


# ----------------------------------------------------------- cheb_epilogue
def diagonal(lines: torch.Tensor, shape) -> torch.Tensor:
    """The diagonal of A from the separable ``lines`` ``[3, Z + Y + X]``,
    1 on Dirichlet rows."""
    Z, Y, X = shape
    diag = None
    for e in range(3):
        term = (lines[e, :Z].reshape(-1, 1, 1)
                * lines[e, Z:Z + Y].reshape(1, -1, 1)
                * lines[e, Z + Y:].reshape(1, 1, -1))
        diag = term if diag is None else diag + term
    return torch.where(interior_mask(shape, lines.device), diag, 1.0)


def cheb_epilogue_plain(b, y=None, x=None, x_old=None, lines=None, f1=0.0,
                        f2=0.0, residual_only=False, out=None):
    """Plain version of :func:`cheb_epilogue` (same arguments)."""
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    m = interior_mask(b.shape, b.device)
    xv = zero if x is None else x
    yv = zero if y is None else y
    r = b - torch.where(m, yv, xv)
    if residual_only:
        res = r
    else:
        xo = zero if x_old is None else x_old
        res = xv + f1 * (xv - xo) + f2 * r / diagonal(lines, b.shape)
    if out is None:
        return res
    return out.copy_(res)


def cheb_epilogue(b: torch.Tensor, y=None, x=None, x_old=None, lines=None,
                  f1: float = 0.0, f2: float = 0.0,
                  residual_only: bool = False, out=None) -> torch.Tensor:
    """Residual ``r = b - y`` (interior) / ``b - x`` (Dirichlet) when
    ``residual_only``; else the Chebyshev update
    ``x + f1 (x - x_old) + f2 r / diag`` with ``diag`` rebuilt from
    ``lines`` ``[3, Z + Y + X]`` (coefficient folded into the z part; 1 on
    Dirichlet rows).  ``x``, ``x_old``, ``y`` may be None (zero).  ``out``
    may be ``x_old`` itself: the update is then in place, which saves a
    full vector per Chebyshev step."""
    if b.device.type == "cpu":
        return cheb_epilogue_plain(b, y, x, x_old, lines, f1, f2,
                                   residual_only, out)
    if b.device.type != "cuda":
        raise RuntimeError(f"cheb_epilogue: no kernel for device {b.device}")
    if b.dtype not in _SUFFIX or b.dim() != 3 or not b.is_contiguous():
        raise ValueError("cheb_epilogue: b must be a contiguous 3-D "
                         "float32/float64 grid")
    for t, what in ((y, "y"), (x, "x"), (x_old, "x_old"), (out, "out")):
        if t is not None:
            _check_grid_tensor(t, b, what)
    Z, Y, X = b.shape
    if not residual_only:
        if lines is None or lines.shape != (3, Z + Y + X) or lines.dtype != b.dtype \
                or lines.device != b.device or not lines.is_contiguous():
            raise ValueError("cheb_epilogue: lines must be [3, Z+Y+X] like b")
    if b.numel() >= 2**31:
        raise ValueError("cheb_epilogue: grid too large for 32-bit indexing")
    if out is None:
        out = torch.empty_like(b)
    suffix, cname = _SUFFIX[b.dtype]
    ptr = lambda t: None if t is None else t.data_ptr()
    LAUNCHES[f"cheb_epilogue<{cname}>"] += _build.launch(
        f"cheb_epilogue_{suffix}", b.data_ptr(), ptr(y), ptr(x), ptr(x_old),
        None if residual_only else lines.data_ptr(), out.data_ptr(),
        float(f1), float(f2), Z, Y, X, int(residual_only),
        _build.stream_handle(b.device))
    return out


# ------------------------------------------------------------- brick_kron
def brick_form(shape, degree: int, dtype) -> str:
    """The form of ``brick_kron`` on a node grid ``shape`` at ``degree``
    in ``dtype``: "march" (the z-slab march) below CELL_DEGREE and from
    WIDE_DEGREE on; at p = 8, 9 "cell" (one block a cell) in double and
    on float grids of at most ``F32_CELL_FORM_MAX_CELLS[degree]`` cells,
    else "layer" (the layer march).  All give the same bits."""
    if degree < CELL_DEGREE or degree >= WIDE_DEGREE:
        return "march"
    z, y, x = shape   # plain ints: this runs on every launch
    cells = ((z - 1) // degree) * ((y - 1) // degree) * ((x - 1) // degree)
    return ("cell" if dtype != torch.float32
            or cells <= F32_CELL_FORM_MAX_CELLS[degree] else "layer")


def brick_kron_reference(x, op: "BrickLaplace", mode: str = "apply", b=None,
                         x_old=None, f1: float = 0.0, f2: float = 0.0,
                         out=None) -> torch.Tensor:
    """Plain version of :func:`brick_kron` (same arguments): the kernel's
    separable arithmetic and tap tables (``laplace_kron.brick_kron_plain``)
    followed by the plain epilogue."""
    y = brick_kron_plain(x, op.taps)
    if mode == "apply":
        res = y
    elif mode == "vmult":
        res = torch.where(interior_mask(x.shape, x.device), y, x)
    elif mode == "residual":
        res = cheb_epilogue_plain(b, y, x=x, residual_only=True)
    else:
        res = cheb_epilogue_plain(b, y, x, x_old, op.lines, f1, f2)
    return res if out is None else out.copy_(res)


def brick_kron(x: torch.Tensor, op: "BrickLaplace", mode: str = "apply",
               b=None, x_old=None, f1: float = 0.0, f2: float = 0.0,
               out=None) -> torch.Tensor:
    """One pass of A x with its epilogue (``mode`` in :data:`KRON_MODES`,
    see the module note), float32 or float64.  ``b`` is read by
    ``residual`` and ``cheb``, ``x_old`` (None: zero) and ``f1``, ``f2`` by
    ``cheb``; ``out`` may alias ``x_old`` or ``b``, never ``x``.  The
    kernel's form is :func:`brick_form`'s."""
    if mode not in KRON_MODES:
        raise ValueError(f"brick_kron: mode must be one of {list(KRON_MODES)}")
    if x.device.type == "cpu":
        return brick_kron_reference(x, op, mode, b, x_old, f1, f2, out)
    if x.device.type != "cuda":
        raise RuntimeError(f"brick_kron: no kernel for device {x.device}")
    if op.dtype not in _SUFFIX or not 1 <= op.grid.degree <= MAX_DEGREE:
        raise ValueError(f"brick_kron: float32/float64 operators of degree "
                         f"1..{MAX_DEGREE} only")
    if mode in ("residual", "cheb") and b is None:
        raise ValueError(f"brick_kron: {mode} needs b")
    for t, what in ((x, "x"), (b, "b"), (x_old, "x_old"), (out, "out")):
        if t is not None:
            _check_grid_tensor(t, op, f"brick_kron: {what}")
    if out is not None and out.data_ptr() == x.data_ptr():
        raise ValueError("brick_kron: out must not alias x")
    Z, Y, X = x.shape
    if Y * X >= 2**31:
        raise ValueError("brick_kron: planes too large for 32-bit offsets")
    if out is None:
        out = torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()
    suffix, cname = _SUFFIX[op.dtype]
    name = f"brick_kron_cheb<{cname}>" if mode == "cheb" else f"brick_kron<{cname}>"
    form = brick_form(x.shape, op.grid.degree, op.dtype)
    entry = "brick_kron_layer_f32" if form == "layer" else f"brick_kron_{suffix}"
    n = _build.launch(
        entry, KRON_MODES[mode], FORMS[form], x.data_ptr(), ptr(b),
        ptr(x_old if mode == "cheb" else None), out.data_ptr(),
        op.host_taps_ptr, float(f1), float(f2), Z, Y, X,
        op.grid.degree, _build.stream_handle(x.device))
    LAUNCHES[name] += n
    key = (name, (Z, Y, X))
    LAUNCHES_BY_GRID[key] = LAUNCHES_BY_GRID.get(key, 0) + n
    return out


def smoother_iterates(op: "BrickLaplace", seed: int):
    """Inputs ``(b, x, x_old)`` in the operator's dtype for holding the
    Chebyshev step against its plain version: a random ``b`` and iterates
    ``x = D^-1 z``, ``x_old = D^-1 z'`` (random ``z``, ``z'``, ``D`` the
    diagonal of A; 1 on Dirichlet rows) as the smoother makes them.  Each
    term of the step is then of the output's scale; with a random ``x``,
    ``D^-1 b`` outweighs ``D^-1 A x`` by the inverse mesh size."""
    rng = np.random.default_rng(seed)
    z = [torch.as_tensor(rng.standard_normal(op.shape), dtype=torch.float64,
                         device=op.device) for _ in range(3)]
    d = diagonal(op.lines.double(), op.shape)
    return tuple(t.to(op.dtype) for t in (z[0], z[1] / d, z[2] / d))


# ---------------------------------------------------------------- operator
class BrickLaplace:
    """A·u of one level in one dtype on one device: the tables the kernel
    reads (the tap table of ``brick_kron``, the diagonal lines) and the
    element matrix its plain version reads.  An operator on a CUDA device
    (``kron``), float32 or float64, runs ``brick_kron``: one launch per
    apply, vmult, residual or Chebyshev step.  On the CPU it runs the dense
    element path and the plain epilogue."""

    def __init__(self, grid: DofGrid, dtype=torch.float32, device="cuda",
                 coefficient: float = 1.0):
        assert grid.dim == 3, "the brick kernels are 3-D"
        self.grid, self.coefficient = grid, coefficient
        self.shape = tuple(grid.shape)
        self.dtype = dtype
        self.device = resolve(device)
        coef = make_diag_coef(grid, coefficient)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=self.device)
        self.K = t(element_matrix(grid, coef))
        lines = diag_lines(grid)
        self.lines = t(np.stack([
            np.concatenate([lines[d][0] * coef.values[d], lines[d][1],
                            lines[d][2]]) for d in range(3)]))
        self.interior = interior_mask(grid.shape, self.device)
        self.taps = kron_taps(grid, coef.values)
        # the kernel's parameter, in the operator's dtype
        self.host_taps = np.ascontiguousarray(
            self.taps, dtype=np.float64 if dtype == torch.float64 else np.float32)
        self.host_taps_ptr = self.host_taps.ctypes.data   # kept alive above
        self.kron = self.device.type == "cuda"

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return brick_apply(x, self)

    def vmult(self, src: torch.Tensor, out=None) -> torch.Tensor:
        """dst = A src with identity rows on Dirichlet nodes (into ``out``
        when given, never ``src``)."""
        if self.kron:
            return brick_kron(src, self, "vmult", out=out)
        y = self.apply(src)
        for d in range(3):
            for i in (0, -1):
                y.select(d, i).copy_(src.select(d, i))
        return y if out is None else out.copy_(y)

    def vmult_residual(self, rhs: torch.Tensor, lhs: torch.Tensor):
        """rhs - A lhs; Dirichlet rows give rhs - lhs."""
        if self.kron:
            return brick_kron(lhs, self, "residual", b=rhs)
        return cheb_epilogue(rhs, self.apply(lhs), x=lhs, residual_only=True)

    def cheb_step(self, b, x, x_old, f1: float, f2: float, out=None):
        """``x + f1 (x - x_old) + f2 D^-1 (b - A x)``: one ``brick_kron``
        pass on the card; on the CPU the dense A x, then the plain
        epilogue.  ``x = None`` needs no A x: the epilogue alone."""
        if x is not None and self.kron:
            return brick_kron(x, self, "cheb", b=b, x_old=x_old, f1=f1, f2=f2,
                              out=out)
        y = None if x is None else self.apply(x)
        return cheb_epilogue(b, y, x, x_old, self.lines, f1, f2, out=out)
