"""Hot-path SIP-DG operator: wrappers of the CUDA kernels with their plain
PyTorch versions and launch counters.

Replaces ``multigrid_tpu/ops/pallas_dg.py``: K9 ``PallasDGOzaki`` (f64 A·u),
K7 ``PallasDGSP._call`` (f32 A·u) and K8 ``PallasDGSP.cheb_fused`` (one
Chebyshev step with A·x, the transformed-Jacobi preconditioner and the
update in one pass).  All three are pencil kernels, one phase body in
``csrc/dg_pencil.cuh`` (a pencil of cells along x a block, lines of nodes
in registers, each face inside the pencil evaluated once: the algebra of
:mod:`.dg_face`), built in float (``dg_pencil.cu``) and double
(``dg_pencil_f64.cu``):

* ``dg_apply`` / ``dg_residual``: y = A x, or ``b - A x`` in the same
  launch, on the DG block ``[C0, C1, C2, n, n, n]`` (float64 for the outer
  CG, float32 for the smoother's residual).  On an H100 apply is bound by
  the FMA rate (about 201 flop a dof at p = 4), the residual by HBM
  bytes;
* ``dg_cheb``: ``x + f1 (x - x_old) + f2 T3 diag^-1 T3^T (b - A x)``
  (float32); ``x = None`` reads as zero and skips A·x, ``out`` may be
  ``x_old`` itself.

At the degrees of :data:`HIGH_DEGREES` (``dg_cheb`` at p = 8, 9,
``dg_apply`` in float64 at p = 8) the same C entries run a design of their
own, ``csrc/dg_pencil_high.cu``: the template's pencils with each phase
turning its lines in place (4 n^3 + 22 n^2 shared values a cell instead of
7 n^3 + 34 n^2), so that two blocks share an SM in double too, with the
template's bits; :func:`high_launches` reads how many times the library
launched those kernels, and :func:`high_tile` reports their tile on the
card.  ``dg_apply`` in float32
at p = 8, 9 and in float64 at p = 9 keep the template (no variant of the
other was faster there without spilling).  At p = 10..16
(:data:`WIDE_DEGREES`, n = 11..17) every mode runs the same body over the
in-place layout too, in ``csrc/dg_pencil_wide.cu`` (float) and
``dg_pencil_wide_f64.cu`` (double; p = 14..16 in
``dg_pencil_wide_top*.cu``), a pencil of two cells (one in double above p
= 12) and one block an SM, where the template's layout outgrows a block's
shared memory; :func:`wide_tile` reports their tile.

Two more kernels carry solver_dg's fused CG row, float64, its scalars on
the device (``csrc/dg_cg_f64.cu``; no Pallas kernel: the JAX row is XLA's
fusion of the whole loop under one jit):

* ``dg_cg``: x += alpha_prev p_old, p = z + beta p_old, q = A p, then
  alpha = rz / (p . q) on the device: a z march (a block walks a run of
  layers of a column of pencils, stages the next layer's p_old, z and x
  while the current one computes, and hands each +-z face trace to the
  next layer), so each value is read from device memory once;
* ``dg_jacobi_cg``: per cell r -= alpha q, z = T3 diag^-1 T3^T r, then
  beta = (r . z) / rz, rz = r . z, rr = r . r on the device.

Their plain versions compose :func:`~..solvers.fused.vmult_with_cg_update`
and :meth:`~.dg_precond.JacobiTransformed.vmult`.

The plain versions are :class:`~.dg.DGLaplace` in the kernel's dtype and,
for ``dg_cheb``, that operator composed with
:meth:`~.dg_precond.JacobiTransformed.vmult`.  Each wrapper runs the plain
version for a tensor on the CPU and launches the kernel for a CUDA tensor
(or raises); there is no fallback.  ``LAUNCHES[name]`` counts device
kernels launched: one per call (a residual counts under ``dg_apply<T>``),
two for ``dg_cg`` and ``dg_jacobi_cg`` (the pass, then one block that
finishes its reduction).
The TPU kernels' persistent lane layout, bf16 limb stacks and (hi, lo)
pairs have no counterpart: the H100 has fp64, and the vectors stay in the
natural block layout end to end.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..devices import resolve
from ..solvers.fused import vmult_with_cg_update
from .dg import DGGrid, DGLaplace, dg_geometry

LAUNCHES = {"dg_apply<double>": 0, "dg_apply<float>": 0, "dg_cheb<float>": 0,
            "dg_cg<double>": 0, "dg_jacobi_cg<double>": 0}
# the degrees at which LAUNCHES' pencil kernels run csrc/dg_pencil_high.cu
HIGH_DEGREES = {"dg_apply<double>": (8,), "dg_cheb<float>": (8, 9)}
# the degrees at which every pencil kernel runs csrc/dg_pencil_wide*.cu
WIDE_DEGREES = tuple(range(10, 17))
_SUFFIX = {torch.float64: ("f64", "double"), torch.float32: ("f32", "float")}
MAX_DEGREE = 16    # n = 17 nodes per axis: the largest pencil instantiation,
                   # the top of the JAX package's degree sweep
                   # (tests/test_degree_sweep.py) and of the double in-place
                   # layout a block holds (208,080 B at one cell)
CG_MAX_DEGREE = 9  # the fused CG's kernels (dg_cg, dg_jacobi_cg): n = 10


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def dg_tables(grid: DGGrid) -> np.ndarray:
    """The kernels' constant table (fp64), in the order of ``Tab`` in
    ``csrc/dg_tab.cuh``: S, D, D S, T (n x n each); f0, f1; their rows
    f S and f D S; quadrature weights; Gsym (3 x 3), gvec (3 x 3, one row
    per face direction), sigma (3), jxw (3); S T and D S T (n x n each,
    the back end of ``dg_cheb`` folded into T3^T)."""
    b = grid.basis
    S, D = np.asarray(b.S, np.float64), np.asarray(b.D_col, np.float64)
    f = [np.asarray(b.f0), np.asarray(b.f1)]
    geo = dg_geometry(grid)
    parts = [S, D, D @ S, b.T, *f, *(v @ S for v in f), *(v @ D @ S for v in f),
             b.quad_weights, np.asarray(geo["Gsym"]),
             np.asarray([fd["gvec"] for fd in geo["face"]]),
             [fd["sigma"] for fd in geo["face"]],
             [fd["jxw"] for fd in geo["face"]], S @ b.T, D @ S @ b.T]
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


def covers(grid: DGGrid) -> bool:
    """Whether a constant-coefficient DG level of ``grid`` runs the DG
    kernels: 3-D, the JAX gate (``multigrid_tpu/solvers/multigrid_dg.py:139,
    339``: ``dim == 3``; Pallas K7 and K8 have no degree limit).  The
    solvers choose a level's route by this when they build it; a 2-D level
    runs the plain operator on every device, as the JAX package runs XLA
    there.  The kernels are built for p = 1..:data:`MAX_DEGREE` (16, the
    top of the JAX package's own degree sweep); a covered level above it
    has no kernel (:func:`has_kernel`), so :class:`DGOperator` refuses it
    on the card."""
    return grid.dim == 3


def has_kernel(grid: DGGrid) -> bool:
    """Whether the pencil kernels (``dg_apply``, ``dg_residual``,
    ``dg_cheb``) are built for ``grid``: covered, degree 1..MAX_DEGREE (p
    = 1..16, n = 2..17 nodes an axis)."""
    return covers(grid) and 1 <= grid.degree <= MAX_DEGREE


def has_cg_kernel(grid: DGGrid) -> bool:
    """Whether the fused CG's kernels (``dg_cg``, ``dg_jacobi_cg``) are
    built for ``grid``: covered, degree 1..CG_MAX_DEGREE (p = 1..9).
    ``dg_cg``'s z march holds a column of pencils of 256 / n^2 cells, none
    at n = 17, and its layer buffers outgrow a block above p = 12."""
    return covers(grid) and 1 <= grid.degree <= CG_MAX_DEGREE


def _kernel_device(t: torch.Tensor, op: "DGOperator", name: str,
                   gate=has_kernel) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {t.device}")
    if op.dtype not in _SUFFIX or not gate(op.grid):
        top = MAX_DEGREE if gate is has_kernel else CG_MAX_DEGREE
        raise ValueError(f"{name}: 3-D float32/float64 grids of degree 1.."
                         f"{top} only")
    if t.numel() >= 2**31:
        raise ValueError(f"{name}: vector too large for 32-bit indexing")


# ----------------------------------------------------- dg_apply, dg_residual
_APPLY, _RESIDUAL = 0, 1     # the modes of the C entries dg_apply_f32/_f64


def dg_apply_plain(x: torch.Tensor, op: "DGOperator") -> torch.Tensor:
    return op.plain.apply(x)


def dg_residual_plain(b: torch.Tensor, x: torch.Tensor,
                      op: "DGOperator") -> torch.Tensor:
    return b - op.plain.apply(x)


def _launch_apply(mode: int, x: torch.Tensor, b, op: "DGOperator",
                  name: str) -> torch.Tensor:
    _kernel_device(x, op, name)
    _check(x, op, f"{name}: x")
    if b is not None:
        _check(b, op, f"{name}: b")
    suffix, cname = _SUFFIX[x.dtype]
    out = torch.empty_like(x)
    LAUNCHES[f"dg_apply<{cname}>"] += _build.launch(
        f"dg_apply_{suffix}", mode, x.data_ptr(),
        None if b is None else b.data_ptr(), op.host_tables.ctypes.data,
        out.data_ptr(), *_launch_args(op), _build.stream_handle(x.device))
    return out


def dg_apply(x: torch.Tensor, op: "DGOperator") -> torch.Tensor:
    """y = A x (SIP-DG, Dirichlet mirror at the domain boundary)."""
    if x.device.type == "cpu":
        return dg_apply_plain(x, op)
    return _launch_apply(_APPLY, x, None, op, "dg_apply")


def dg_residual(b: torch.Tensor, x: torch.Tensor,
                op: "DGOperator") -> torch.Tensor:
    """``b - A x`` in one pass (a new tensor)."""
    if b.device.type == "cpu":
        return dg_residual_plain(b, x, op)
    return _launch_apply(_RESIDUAL, x, b, op, "dg_residual")


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
        op.jacobi.inv_diag.data_ptr(), op.host_tables.ctypes.data,
        out.data_ptr(), float(f1), float(f2), *_launch_args(op),
        _build.stream_handle(b.device))
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


# --------------------------------------------------- the kernels at p = 8, 9
# cell grids (C0, C1, C2) at the edges of csrc/dg_pencil_high.cu's kernels:
# a one-cell column, a one-layer row ragged in x (7 cells: pencils of 3 and
# 2 leave 1), and many pencils with a ragged last one (40 x 4 rows of 5
# cells); the card tests and chip_smoke.py hold the pencil kernels on them
HIGH_CELLS = ((6, 1, 1), (1, 1, 7), (40, 4, 5))
# the kernels in the order of dg_high_tile's first argument, and those built
# at n points an axis
HIGH_KERNELS = ("dg_cheb<float>", "dg_apply<double>", "dg_residual<double>")
HIGH_KERNELS_AT = {9: HIGH_KERNELS, 10: HIGH_KERNELS[:1]}
HIGH_TILE = ("cells", "smem_bytes", "threads", "blocks_per_sm", "registers",
             "local_bytes")


def high_tile(n: int, lib=None) -> dict:
    """The tile of csrc/dg_pencil_high.cu's kernels at ``n`` (9 or 10)
    points an axis, by kernel (:data:`HIGH_KERNELS_AT`): cells a pencil,
    dynamic shared bytes a block, threads a block, blocks an SM (the
    occupancy calculator), registers and local (spilled) bytes a thread;
    of the port's library, or of ``lib`` (a ``ctypes`` library built with
    other pencils).  Needs the card."""
    lib = _build.library() if lib is None else lib
    fn = lib.dg_high_tile
    fn.argtypes = _build.SIGNATURES["dg_high_tile"]
    fn.restype = ctypes.c_int
    out = {}
    for name in HIGH_KERNELS_AT[n]:
        i = HIGH_KERNELS.index(name)
        vals = (ctypes.c_int * len(HIGH_TILE))()
        err = fn(i, n, vals)
        if err:
            raise RuntimeError(f"dg_high_tile({name}, {n}): cudaError {err}")
        out[name] = dict(zip(HIGH_TILE, vals))
    return out


# the wide kernels in the order of dg_wide_tile's first argument (the
# modes of the C entries), by dtype
WIDE_KERNELS = {torch.float32: ("dg_apply<float>", "dg_residual<float>",
                                "dg_cheb<float>"),
                torch.float64: ("dg_apply<double>", "dg_residual<double>")}


def wide_tile(n: int, lib=None, dtypes=tuple(WIDE_KERNELS)) -> dict:
    """The tile of csrc/dg_pencil_wide*.cu's kernels at ``n`` (11..17)
    points an axis, by kernel (:data:`WIDE_KERNELS` of ``dtypes``), with
    :data:`HIGH_TILE`'s fields; of the port's library or of ``lib``.
    Needs the card."""
    lib = _build.library() if lib is None else lib
    out = {}
    for dtype in dtypes:
        names = WIDE_KERNELS[dtype]
        fn = getattr(lib, f"dg_wide_tile_{_SUFFIX[dtype][0]}")
        fn.argtypes = _build.SIGNATURES[f"dg_wide_tile_{_SUFFIX[dtype][0]}"]
        fn.restype = ctypes.c_int
        for mode, name in enumerate(names):
            vals = (ctypes.c_int * len(HIGH_TILE))()
            err = fn(mode, n, vals)
            if err:
                raise RuntimeError(f"dg_wide_tile({name}, {n}): cudaError "
                                   f"{err}")
            out[name] = dict(zip(HIGH_TILE, vals))
    return out


def high_launches() -> dict:
    """How many times the library has launched csrc/dg_pencil_high.cu's
    kernels since it was loaded, counted by the C code where it launches
    them, under the names of :data:`LAUNCHES` (the double apply and
    residual together).  Needs the card."""
    vals = (ctypes.c_int * len(HIGH_KERNELS))()
    _build.library().dg_high_launches(vals)
    return {"dg_cheb<float>": vals[0], "dg_apply<double>": vals[1] + vals[2]}


# ------------------------------------------------------ dg_cg, dg_jacobi_cg
# the fused CG's device scalars: one float64 vector, in the order of
# csrc/dg_cg_f64.cu's Scalar
CG_SCALARS = ("alpha", "beta", "rz", "rr", "pq")
ALPHA, BETA, RZ, RR, PQ = range(len(CG_SCALARS))


def cg_scalars(device) -> torch.Tensor:
    """The fused CG's scalars (:data:`CG_SCALARS`), zero."""
    return torch.zeros(len(CG_SCALARS), dtype=torch.float64,
                       device=resolve(device))


def cg_partials(grid: DGGrid, device) -> torch.Tensor:
    """Scratch for the block partials of ``dg_cg`` and ``dg_jacobi_cg`` on
    ``grid``: two a cell bound both kernels' grids (a block takes at least
    one cell)."""
    return torch.empty(2 * int(np.prod(grid.cells)), dtype=torch.float64,
                       device=resolve(device))


# cell grids (C0, C1, C2) that take dg_cg's z march to its ends: one layer,
# a column cut into runs (20 layers, runs of at least 8), and at every
# degree a pencil row longer than the widest pencil (16 cells at p = 1)
# with a ragged last pencil (37); the card tests and chip_smoke.py hold
# dg_cg on them
MARCH_CELLS = ((1, 3, 7), (20, 2, 3), (2, 2, 37))


def dg_cg_plain(p_old, z, x, scal, p, q, apply) -> None:
    """The operator pass of one fused CG iteration, in place:
    :func:`~..solvers.fused.vmult_with_cg_update` over ``apply`` with
    alpha_prev = ``scal[ALPHA]`` and beta = ``scal[BETA]`` (x += alpha_prev
    p_old; p = z + beta p_old; q = A p), then ``scal[PQ]`` = p . q and
    ``scal[ALPHA]`` = rz / (p . q)."""
    x_new, p_new, q_new, sums = vmult_with_cg_update(
        apply, scal[ALPHA], scal[BETA], z, z, p_old, x)
    x.copy_(x_new)
    p.copy_(p_new)
    q.copy_(q_new)
    scal[PQ] = sums[0]
    scal[ALPHA] = scal[RZ] / sums[0]


def dg_jacobi_cg_plain(r, q, scal, z, precond, first: bool = False) -> None:
    """The preconditioner pass of one fused CG iteration, in place: r -=
    ``scal[ALPHA]`` q, z = ``precond(r)``, then ``scal[BETA]`` = (r . z) /
    rz, ``scal[RZ]`` = r . z, ``scal[RR]`` = r . r.  ``first``: the pass
    before the loop (q unread, r unchanged, beta = 0)."""
    if not first:
        r.sub_(scal[ALPHA] * q)
    z.copy_(precond(r))
    rz = torch.dot(r.reshape(-1), z.reshape(-1))
    scal[BETA] = 0.0 if first else rz / scal[RZ]
    scal[RZ] = rz
    scal[RR] = torch.dot(r.reshape(-1), r.reshape(-1))


def _cg_check(op: "DGOperator", name: str, tensors, outs) -> None:
    _kernel_device(tensors[0][0], op, name, has_cg_kernel)
    if op.dtype != torch.float64:
        raise ValueError(f"{name}: float64 only")
    for t, what in tensors + outs:
        _check(t, op, f"{name}: {what}")
    ptrs = {t.data_ptr() for t, _ in tensors}
    for t, what in outs:
        if t.data_ptr() in ptrs:
            raise ValueError(f"{name}: {what} must not alias an input")


def _scratch(op: "DGOperator", scal, partial):
    if scal.dtype != torch.float64 or scal.numel() < len(CG_SCALARS) \
            or scal.device != op.device or not scal.is_contiguous():
        raise ValueError("the fused CG's scalars: a contiguous float64 "
                         f"vector of {len(CG_SCALARS)} on {op.device}")
    if partial is None:
        partial = cg_partials(op.grid, op.device)
    if partial.dtype != torch.float64 or partial.device != op.device:
        raise ValueError(f"partial: float64 on {op.device}")
    return partial


def dg_cg(p_old, z, x, scal, p, q, op: "DGOperator", partial=None) -> None:
    """The operator pass of one fused CG iteration (float64): x +=
    alpha_prev p_old, p = z + beta p_old, q = A p, ``scal[PQ]`` = p . q,
    ``scal[ALPHA]`` = rz / (p . q), the scalars read and written on the
    device (:data:`CG_SCALARS`).  ``p`` and ``q`` alias none of the
    inputs; ``partial``: scratch (:func:`cg_partials`)."""
    if z.device.type == "cpu":
        return dg_cg_plain(p_old, z, x, scal, p, q, op.plain.apply)
    _cg_check(op, "dg_cg", [(z, "z"), (p_old, "p_old"), (x, "x")],
              [(p, "p"), (q, "q")])
    partial = _scratch(op, scal, partial)
    LAUNCHES["dg_cg<double>"] += _build.launch(
        "dg_cg_f64", p_old.data_ptr(), z.data_ptr(), x.data_ptr(),
        p.data_ptr(), q.data_ptr(), scal.data_ptr(),
        op.host_tables.ctypes.data, partial.data_ptr(), partial.numel(),
        *_launch_args(op), _build.stream_handle(z.device))


def dg_jacobi_cg(r, q, scal, z, op: "DGOperator", partial=None,
                 first: bool = False) -> None:
    """The preconditioner pass of one fused CG iteration (float64) with the
    transformed Jacobi installed in ``op``: r -= alpha q, z = T3 diag^-1
    T3^T r, ``scal[BETA]`` = (r . z) / rz, ``scal[RZ]`` = r . z,
    ``scal[RR]`` = r . r on the device.  ``first``: the pass before the
    loop (q unread and may be None, r unchanged, beta = 0)."""
    if op.jacobi is None:
        raise ValueError("dg_jacobi_cg: install_jacobi first")
    if r.device.type == "cpu":
        return dg_jacobi_cg_plain(r, q, scal, z, op.jacobi.vmult, first)
    ins = [(r, "r"), (op.jacobi.inv_diag, "inv_diag")]
    if not first:
        ins.append((q, "q"))
    _cg_check(op, "dg_jacobi_cg", ins, [(z, "z")])
    partial = _scratch(op, scal, partial)
    LAUNCHES["dg_jacobi_cg<double>"] += _build.launch(
        "dg_jacobi_cg_f64", r.data_ptr(),
        None if first else q.data_ptr(), z.data_ptr(),
        op.jacobi.inv_diag.data_ptr(), scal.data_ptr(),
        op.host_tables.ctypes.data, partial.data_ptr(), partial.numel(),
        int(np.prod(op.grid.cells)), op.grid.n, int(first),
        _build.stream_handle(r.device))


# ------------------------------------------------------------- digests
# the cells of kernel_digests: x ragged in every pencil length (7 cells), y
# with an interior row, z two runs of dg_cg's march (runs of at least 8)
DIGEST_CELLS = (9, 3, 7)
DIGEST_MODES = ("apply<double>", "residual<double>", "apply<float>",
                "residual<float>", "cheb<float>", "cheb<float> x=0",
                "dg_cg<double>", "dg_jacobi_cg<double>")


def kernel_digests(device, degrees=range(1, MAX_DEGREE + 1),
                   kinds=("hermite", "gll", "gauss")) -> dict:
    """``"p=<p> <kind> <mode>"`` -> the first 16 hex digits of the sha256
    of each DG kernel's outputs (:data:`DIGEST_MODES`) on the sheared grid
    of :data:`DIGEST_CELLS` cells, on seeded inputs: float32 values x (seed
    1), b (2), x_old (3), held exactly in float64 too; a seeded inv_diag
    (4, in [0.5, 1.5)) in place of the Jacobi's, so that no digest depends
    on PyTorch's own kernels; the step with x (f1 = 0.37, f2 = 0.81) and
    with x = 0; ``dg_cg`` (x, p, q and the scalars, from p_old, z, x of
    seeds 5, 6, 7) and ``dg_jacobi_cg`` (r, z and the scalars, from r, q of
    seeds 8, 9), each from the scalars (0.37, 0.61, 1.7, 0, 0); the fused
    CG's two only up to :data:`CG_MAX_DEGREE`.  Pins the kernels' bits
    (tests/test_torch_cuda.py, chip_smoke.py).  Needs the card."""
    import hashlib
    import types

    dev = resolve(device)

    def seeded(shape, seed, dtype=torch.float32):
        a = np.random.default_rng(seed).standard_normal(shape)
        return torch.as_tensor(a, dtype=torch.float32, device=dev).to(dtype)

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    cells = DIGEST_CELLS
    J = np.diag(1.0 / np.array(cells)) @ (
        np.eye(3) + 0.08 * np.random.default_rng(0).random((3, 3)))
    out = {}
    for p in degrees:
        for kind in kinds:
            grid = DGGrid(cells=cells, jacobian=tuple(map(tuple, J)),
                          degree=p, kind=kind)
            x, b, xo = (seeded(grid.shape, s) for s in (1, 2, 3))
            inv = torch.as_tensor(0.5 + np.random.default_rng(4).random(
                grid.shape), dtype=torch.float32, device=dev)
            res = {}
            for dtype in (torch.float64, torch.float32):
                op = DGOperator(grid, dtype, dev)
                op.install_jacobi(types.SimpleNamespace(
                    grid=grid, inv_diag=inv.to(dtype)))
                xt, bt = x.to(dtype), b.to(dtype)
                cname = _SUFFIX[dtype][1]
                res[f"apply<{cname}>"] = digest(dg_apply(xt, op))
                res[f"residual<{cname}>"] = digest(dg_residual(bt, xt, op))
                if dtype == torch.float32:
                    res["cheb<float>"] = digest(
                        dg_cheb(b, x, xo, op, 0.37, 0.81))
                    res["cheb<float> x=0"] = digest(
                        dg_cheb(b, None, None, op, 0.0, 0.81))
                    continue
                if p > CG_MAX_DEGREE:
                    continue
                scal0 = torch.tensor([0.37, 0.61, 1.7, 0.0, 0.0],
                                     dtype=torch.float64, device=dev)
                p_old, z, xc = (seeded(grid.shape, s, dtype)
                                for s in (5, 6, 7))
                pp, qq, sc = (torch.empty_like(xc), torch.empty_like(xc),
                              scal0.clone())
                dg_cg(p_old, z, xc, sc, pp, qq, op)
                res["dg_cg<double>"] = digest(xc, pp, qq, sc)
                r, q = (seeded(grid.shape, s, dtype) for s in (8, 9))
                zj, sc = torch.empty_like(r), scal0.clone()
                dg_jacobi_cg(r, q, sc, zj, op)
                res["dg_jacobi_cg<double>"] = digest(r, zj, sc)
            out.update({f"p={p} {kind} {m}": res[m] for m in DIGEST_MODES
                        if m in res})
    return out


# ---------------------------------------------------------------- operator
class DGOperator:
    """A·u of one DG level in one dtype on one device: the kernels' table
    (in host memory in the operator's dtype; every kernel takes it as a
    kernel parameter) and the plain operator; ``install_jacobi`` adds the
    preconditioner the fused Chebyshev step applies.  On the card it takes
    a 3-D grid of degree 1..:data:`MAX_DEGREE` (16) and refuses any other
    ("no DG kernel"); on the CPU any grid."""

    def __init__(self, grid: DGGrid, dtype=torch.float32, device="cuda"):
        self.grid = grid
        self.shape = tuple(grid.shape)
        self.dtype = dtype
        self.device = resolve(device)
        if self.device.type == "cuda" and not has_kernel(grid):
            raise ValueError(f"DGOperator: no DG kernel for a {grid.dim}-D "
                             f"grid of degree {grid.degree} (3-D, 1.."
                             f"{MAX_DEGREE} only)")
        self.plain = DGLaplace(grid, dtype, self.device)
        self.host_tables = dg_tables(grid).astype(
            np.float64 if dtype == torch.float64 else np.float32)
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
        return dg_residual(rhs, lhs, self)

    def cheb_step(self, b, x, x_old, f1: float, f2: float, out=None):
        """``x + f1 (x - x_old) + f2 P^-1 (b - A x)`` in one kernel pass."""
        return dg_cheb(b, x, x_old, self, f1, f2, out=out)
