"""Hot-path SIP-DG operator: wrappers of the CUDA kernels with their plain
PyTorch versions and launch counters.

Replaces ``multigrid_tpu/ops/pallas_dg.py``: K9 ``PallasDGOzaki`` (f64 A·u),
K7 ``PallasDGSP._call`` (f32 A·u) and K8 ``PallasDGSP.cheb_fused`` (one
Chebyshev step with A·x, the transformed-Jacobi preconditioner and the
update in one pass).  Three kernels from ``csrc/dg_apply.cu``:

* ``dg_apply``: y = A x on the DG block ``[C0, C1, C2, n, n, n]``
  (float64 for the outer CG, float32 for the smoother);
* ``dg_cheb``: ``x + f1 (x - x_old) + f2 T3 diag^-1 T3^T (b - A x)``
  (float32); ``x = None`` reads as zero and skips A·x, ``out`` may be
  ``x_old`` itself.

The plain versions are :class:`~.dg.DGLaplace` in the kernel's dtype and,
for ``dg_cheb``, that operator composed with
:meth:`~.dg_precond.JacobiTransformed.vmult`.  Each wrapper runs the plain
version for a tensor on the CPU and launches the kernel for a CUDA tensor
(or raises); there is no fallback.  ``LAUNCHES[name]`` counts device
kernels launched: one per call.  The TPU kernels' persistent lane layout,
bf16 limb stacks and (hi, lo) pairs have no counterpart: the H100 has
fp64, and the vectors stay in the natural block layout end to end.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..devices import resolve
from .dg import DGGrid, DGLaplace, dg_geometry

LAUNCHES = {"dg_apply<double>": 0, "dg_apply<float>": 0, "dg_cheb<float>": 0}
_SUFFIX = {torch.float64: ("f64", "double"), torch.float32: ("f32", "float")}
MAX_DEGREE = 7     # n = 8 nodes per axis: the largest kernel instantiation


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def dg_tables(grid: DGGrid) -> np.ndarray:
    """The kernel's constant table (fp64), in the order of ``Tab`` in
    ``csrc/dg_apply.cu``: S, D, D S, T (n x n each); f0, f1; their rows
    f S and f D S; quadrature weights; Gsym (3 x 3), gvec (3 x 3, one row
    per face direction), sigma (3), jxw (3)."""
    b = grid.basis
    S, D = np.asarray(b.S, np.float64), np.asarray(b.D_col, np.float64)
    f = [np.asarray(b.f0), np.asarray(b.f1)]
    geo = dg_geometry(grid)
    parts = [S, D, D @ S, b.T, *f, *(v @ S for v in f), *(v @ D @ S for v in f),
             b.quad_weights, np.asarray(geo["Gsym"]),
             np.asarray([fd["gvec"] for fd in geo["face"]]),
             [fd["sigma"] for fd in geo["face"]],
             [fd["jxw"] for fd in geo["face"]]]
    return np.concatenate([np.asarray(p, np.float64).ravel() for p in parts])


def _check(t: torch.Tensor, op: "DGOperator", what: str) -> None:
    if t.shape != op.shape or t.dtype != op.dtype or t.device != op.device:
        raise ValueError(f"{what}: expected {op.shape} {op.dtype} on "
                         f"{op.device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _launch_args(op: "DGOperator"):
    C0, C1, C2 = op.grid.cells
    return C0, C1, C2, op.grid.n, int(op.plain.is_collocation)


def _kernel_device(t: torch.Tensor, op: "DGOperator", name: str) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {t.device}")
    if op.dtype not in _SUFFIX or op.grid.dim != 3 \
            or not 1 <= op.grid.degree <= MAX_DEGREE:
        raise ValueError(f"{name}: 3-D float32/float64 grids of degree 1.."
                         f"{MAX_DEGREE} only")
    if t.numel() >= 2**31:
        raise ValueError(f"{name}: vector too large for 32-bit indexing")


# -------------------------------------------------------------- dg_apply
def dg_apply_plain(x: torch.Tensor, op: "DGOperator") -> torch.Tensor:
    return op.plain.apply(x)


def dg_apply(x: torch.Tensor, op: "DGOperator") -> torch.Tensor:
    """y = A x (SIP-DG, Dirichlet mirror at the domain boundary)."""
    if x.device.type == "cpu":
        return dg_apply_plain(x, op)
    _kernel_device(x, op, "dg_apply")
    _check(x, op, "dg_apply: x")
    suffix, cname = _SUFFIX[x.dtype]
    y = torch.empty_like(x)
    LAUNCHES[f"dg_apply<{cname}>"] += _build.launch(
        f"dg_apply_{suffix}", x.data_ptr(), op.tables.data_ptr(), y.data_ptr(),
        *_launch_args(op), _build.stream_handle(x.device))
    return y


# --------------------------------------------------------------- dg_cheb
def dg_cheb_plain(b, x, x_old, op: "DGOperator", f1: float, f2: float,
                  out=None) -> torch.Tensor:
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    xv = zero if x is None else x
    xo = zero if x_old is None else x_old
    r = b if x is None else b - op.plain.apply(x)
    res = xv + f1 * (xv - xo) + f2 * op.jacobi.vmult(r)
    return res if out is None else out.copy_(res)


def dg_cheb(b: torch.Tensor, x, x_old, op: "DGOperator", f1: float,
            f2: float, out=None) -> torch.Tensor:
    """One Chebyshev step ``x + f1 (x - x_old) + f2 P^-1 (b - A x)`` with
    the transformed Jacobi ``P^-1`` installed in ``op``.  ``x``/``x_old``
    may be None (zero); ``out`` may be ``x_old`` (in place), never ``x``."""
    if op.jacobi is None:
        raise ValueError("dg_cheb: install_jacobi first")
    if b.device.type == "cpu":
        return dg_cheb_plain(b, x, x_old, op, f1, f2, out)
    _kernel_device(b, op, "dg_cheb")
    if b.dtype != torch.float32:
        raise ValueError("dg_cheb: float32 only")
    for t, what in ((b, "b"), (x, "x"), (x_old, "x_old"), (out, "out"),
                    (op.jacobi.inv_diag, "inv_diag")):
        if t is not None:
            _check(t, op, f"dg_cheb: {what}")
    if out is not None and x is not None and out.data_ptr() == x.data_ptr():
        raise ValueError("dg_cheb: out must not alias x")
    if out is None:
        out = torch.empty_like(b)
    ptr = lambda t: None if t is None else t.data_ptr()
    LAUNCHES["dg_cheb<float>"] += _build.launch(
        "dg_cheb_f32", b.data_ptr(), ptr(x), ptr(x_old),
        op.jacobi.inv_diag.data_ptr(), op.tables.data_ptr(), out.data_ptr(),
        float(f1), float(f2), *_launch_args(op), _build.stream_handle(b.device))
    return out


def smoother_iterates(jacobi, seed: int):
    """Float32 inputs ``(b, x, x_old)`` for holding ``dg_cheb`` against its
    plain version: a random ``b`` and iterates ``x = P^-1 z``, ``x_old =
    P^-1 z'`` (random ``z``, ``z'``) as the smoother makes them, ``P^-1``
    being ``jacobi`` (float64).  Each term of the step is then of the
    output's scale.  With a random ``x`` instead, ``P^-1 b`` outweighs
    ``P^-1 A x`` by a factor of 1e5 to 1e7 in the hermite basis, and no
    bar on the output could see whether A was applied."""
    rng = np.random.default_rng(seed)
    z = [torch.as_tensor(rng.standard_normal(jacobi.grid.shape),
                         dtype=torch.float64, device=jacobi.device)
         for _ in range(3)]
    return (z[0].float(), jacobi.vmult(z[1]).float(),
            jacobi.vmult(z[2]).float())


# ---------------------------------------------------------------- operator
class DGOperator:
    """A·u of one DG level in one dtype on one device: the kernels' table
    and the plain operator; ``install_jacobi`` adds the preconditioner the
    fused Chebyshev step applies."""

    def __init__(self, grid: DGGrid, dtype=torch.float32, device="cuda"):
        self.grid = grid
        self.shape = tuple(grid.shape)
        self.dtype = dtype
        self.device = resolve(device)
        self.plain = DGLaplace(grid, dtype, self.device)
        self.tables = torch.as_tensor(dg_tables(grid), dtype=dtype,
                                      device=self.device)
        self.jacobi = None

    def install_jacobi(self, jacobi) -> None:
        """``jacobi``: a :class:`~.dg_precond.JacobiTransformed` of this
        grid in this dtype on this device."""
        if jacobi.grid != self.grid or jacobi.inv_diag.dtype != self.dtype:
            raise ValueError("install_jacobi: grid or dtype differs")
        self.jacobi = jacobi

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        return dg_apply(x, self)

    def vmult_residual(self, rhs: torch.Tensor, lhs: torch.Tensor):
        return rhs - dg_apply(lhs, self)

    def cheb_step(self, b, x, x_old, f1: float, f2: float, out=None):
        """``x + f1 (x - x_old) + f2 P^-1 (b - A x)`` in one kernel pass."""
        return dg_cheb(b, x, x_old, self, f1, f2, out=out)
