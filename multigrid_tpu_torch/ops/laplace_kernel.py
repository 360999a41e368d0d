"""Hot-path brick operator: wrappers of the CUDA kernels with their plain
PyTorch versions and launch counters.

Replaces ``multigrid_tpu/ops/pallas_windowed.py`` (K1, dp A·u) and
``multigrid_tpu/ops/pallas_windowed_sp.py`` (K2, sp A·u with its residual
and Chebyshev epilogues).  Two kernels from ``csrc/brick_apply.cu``:

* ``brick_apply``: y = A x on the node grid, Dirichlet nodes read as zero
  and written as zero (float64 for the outer solve, float32 for the
  V-cycle);
* ``cheb_epilogue``: the residual ``b - y`` or the Chebyshev update
  ``x + f1 (x - x_old) + f2 (b - y) / diag`` with the separable diagonal
  rebuilt in the kernel; Dirichlet rows follow the node-path semantics
  (identity rows of A, diagonal 1).

Each wrapper runs the plain version for a tensor on the CPU and launches
the kernel for a CUDA tensor (or raises); there is no fallback.
``LAUNCHES[name]`` counts the device kernels launched, as a trace shows
them: one ``brick_apply`` call launches one kernel per non-empty cell
parity class (8 on any grid of at least two cells per axis).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..devices import resolve
from ..mesh.brick import DofGrid
from .laplace import diag_lines, make_diag_coef
from .laplace_dense import dense_apply, element_matrix
from .masks import interior_mask

LAUNCHES = {"brick_apply<double>": 0, "brick_apply<float>": 0,
            "cheb_epilogue<double>": 0, "cheb_epilogue<float>": 0}
_SUFFIX = {torch.float64: ("f64", "double"), torch.float32: ("f32", "float")}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_grid_tensor(t: torch.Tensor, like: torch.Tensor, what: str):
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
    """y = A x (Dirichlet nodes of x read as 0, of y written as 0)."""
    if x.device.type == "cpu":
        return brick_apply_plain(x, op.K)
    if x.device.type != "cuda":
        raise RuntimeError(f"brick_apply: no kernel for device {x.device}")
    if x.dtype not in _SUFFIX or x.dim() != 3 or x.shape != op.shape:
        raise ValueError(f"brick_apply: need a {op.shape} float32/float64 "
                         f"grid, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("brick_apply: x must be contiguous")
    if op.lm.dtype != x.dtype or op.lm.device != x.device:
        raise ValueError("brick_apply: operator tables differ in dtype/device")
    suffix, cname = _SUFFIX[x.dtype]
    y = torch.zeros_like(x)
    c0, c1, c2 = op.coef_values
    Z, Y, X = x.shape
    LAUNCHES[f"brick_apply<{cname}>"] += _build.launch(
        f"brick_apply_{suffix}", x.data_ptr(), y.data_ptr(), op.lm.data_ptr(),
        c0, c1, c2, Z, Y, X, op.n, _build.stream_handle(x.device))
    return y


# ----------------------------------------------------------- cheb_epilogue
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
        Z, Y, X = b.shape
        diag = None
        for e in range(3):
            term = (lines[e, :Z].reshape(-1, 1, 1)
                    * lines[e, Z:Z + Y].reshape(1, -1, 1)
                    * lines[e, Z + Y:].reshape(1, 1, -1))
            diag = term if diag is None else diag + term
        diag = torch.where(m, diag, 1.0)
        res = xv + f1 * (xv - xo) + f2 * r / diag
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


# ---------------------------------------------------------------- operator
class BrickLaplace:
    """A·u of one level in one dtype on one device: the tensors the two
    kernels read (1-D tables, coefficients, diagonal lines) and the element
    matrix their plain versions read."""

    def __init__(self, grid: DofGrid, dtype=torch.float32, device="cuda",
                 coefficient: float = 1.0):
        assert grid.dim == 3, "the brick kernels are 3-D"
        self.grid = grid
        self.shape = tuple(grid.shape)
        self.dtype = dtype
        self.device = resolve(device)
        self.n = grid.basis.n
        coef = make_diag_coef(grid, coefficient)
        self.coef_values = tuple(float(v) for v in coef.values)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=self.device)
        b = grid.basis
        self.lm = t(np.concatenate([b.L.ravel(), b.M.ravel()]))
        self.K = t(element_matrix(grid, coef))
        lines = diag_lines(grid)
        self.lines = t(np.stack([
            np.concatenate([lines[d][0] * coef.values[d], lines[d][1],
                            lines[d][2]]) for d in range(3)]))
        self.interior = interior_mask(grid.shape, self.device)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return brick_apply(x, self)

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        """dst = A src with identity rows on Dirichlet nodes."""
        y = self.apply(src)
        for d in range(3):
            for i in (0, -1):
                y.select(d, i).copy_(src.select(d, i))
        return y

    def vmult_residual(self, rhs: torch.Tensor, lhs: torch.Tensor):
        """rhs - A lhs; Dirichlet rows give rhs - lhs."""
        return cheb_epilogue(rhs, self.apply(lhs), x=lhs, residual_only=True)

    def cheb_step(self, b, x, x_old, f1: float, f2: float, out=None):
        """``x + f1 (x - x_old) + f2 D^-1 (b - A x)``: A x by
        ``brick_apply`` (skipped for ``x = None``), then the epilogue."""
        y = None if x is None else self.apply(x)
        return cheb_epilogue(b, y, x, x_old, self.lines, f1, f2, out=out)
