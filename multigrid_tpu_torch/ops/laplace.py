"""Matrix-free FE_Q Laplace operator, sum-factorized (the oracle).

Twin of ``multigrid_tpu/ops/laplace.py`` for the affine brick with a
constant coefficient (``DiagCoef``).  Cells are evaluated in the blocked
layout ``[C0, C1, C2, n, n, n]`` of :mod:`.windows`: interpolate to the
Gauss points with ``S``, differentiate with the collocation matrix
``D_col``, scale by the merged coefficient ``c_d * w_q`` and integrate back
(reference common/laplace_operator.h:436-558).  Dirichlet rows are identity
rows (laplace_operator.h:573-601).

This operator serves setup and analysis: the separable inverse diagonal,
rhs assembly and L2 errors.  The solve's hot path runs
:class:`multigrid_tpu_torch.ops.laplace_kernel.BrickLaplace`.  The host
helpers at the bottom are numpy copies of the JAX module's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..devices import resolve
from ..mesh.brick import DofGrid
from .masks import interior_mask
from .windows import gather_cells, scatter_cells


@dataclass(frozen=True)
class DiagCoef:
    """Affine geometry + constant coefficient: the merged tensor is the
    diagonal ``c * det(J) / h_d^2``, one value per axis
    (reference common/laplace_operator.h:447-491)."""

    values: tuple[float, ...]


def make_diag_coef(grid: DofGrid, coefficient: float = 1.0) -> DiagCoef:
    jxw = grid.jxw_scalar
    return DiagCoef(tuple(coefficient * jxw / h**2 for h in grid.h))


def apply_1d(w: torch.Tensor, mat: torch.Tensor, axis: int) -> torch.Tensor:
    """Contract ``mat[out, in]`` against axis ``axis`` of ``w``."""
    return torch.movedim(torch.tensordot(w, mat, dims=([axis], [1])), -1, axis)


def quad_coords_blocked(grid: DofGrid) -> list[np.ndarray]:
    """Quadrature coordinates broadcastable to ``[C0, C1, C2, q, q, q]``
    (the blocked twin of ``DofGrid.quad_coords_interleaved``)."""
    dim = grid.dim
    out = []
    for d in range(dim):
        q = grid.axis_quads[d]
        shape = [1] * (2 * dim)
        shape[d] = q.shape[0]
        shape[dim + d] = q.shape[1]
        out.append(q.reshape(shape))
    return out


def diag_lines(grid: DofGrid) -> list[list[np.ndarray]]:
    """Per-axis 1-D factors of the separable diagonal: ``lines[d][e]`` is the
    window-scatter of ``L_ii`` (e == d) or ``M_ii`` (e != d) along axis e,
    so ``diag(A) = sum_d c_d prod_e lines[d][e][i_e]`` (fp64 numpy)."""
    b = grid.basis
    mdiag, ldiag = np.diag(b.M), np.diag(b.L)
    p = grid.degree
    out = []
    for d in range(grid.dim):
        row = []
        for e in range(grid.dim):
            vec = ldiag if e == d else mdiag
            line = np.zeros(grid.cells[e] * p + 1)
            for c in range(grid.cells[e]):
                line[c * p: c * p + p + 1] += vec
            row.append(line)
        out.append(row)
    return out


class LaplaceOperator:
    """A·u for -div(c grad u) with FE_Q(p) on one brick level."""

    def __init__(self, grid: DofGrid, dtype=torch.float32,
                 coef: Optional[DiagCoef] = None, device="cuda"):
        self.grid = grid
        self.dtype = dtype
        self.device = device = resolve(device)
        b = grid.basis
        self.n = b.n
        self.dim = grid.dim
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        self.S = t(b.S)
        self.St = t(b.S.T)
        self.D = t(b.D_col)
        self.Dt = t(b.D_col.T)
        self.coef = coef if coef is not None else make_diag_coef(grid)
        qw = b.quad_weights
        w3 = np.ones([1] * (2 * self.dim))
        for d in range(self.dim):
            shape = [1] * (2 * self.dim)
            shape[self.dim + d] = self.n
            w3 = w3 * qw.reshape(shape)
        self.w3d = t(w3)
        self._diag_lines = [[t(a) for a in row] for row in diag_lines(grid)]

    @property
    def interior(self) -> torch.Tensor:
        return interior_mask(self.grid.shape, self.device)

    def _local(self, d: int) -> int:
        return self.dim + d

    def _to_quad(self, w):
        for d in range(self.dim):
            w = apply_1d(w, self.S, self._local(d))
        return w

    def _from_quad_t(self, w):
        for d in range(self.dim):
            w = apply_1d(w, self.St, self._local(d))
        return w

    def _stiffness_cells(self, w):
        """Cell-local stiffness action on gathered node values."""
        uq = self._to_quad(w)
        acc = None
        for d in range(self.dim):
            g = apply_1d(uq, self.D, self._local(d))
            g = g * (self.coef.values[d] * self.w3d)
            term = apply_1d(g, self.Dt, self._local(d))
            acc = term if acc is None else acc + term
        return self._from_quad_t(acc)

    def apply_cells(self, u: torch.Tensor) -> torch.Tensor:
        """Unconstrained operator: gather -> evaluate -> scatter."""
        return scatter_cells(self._stiffness_cells(gather_cells(u, self.n)))

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        """dst = A src, identity rows on Dirichlet nodes."""
        m = self.interior
        y = self.apply_cells(torch.where(m, src, 0))
        return torch.where(m, y, src)

    def vmult_residual(self, rhs, lhs):
        """rhs - A lhs; constrained rows give rhs - lhs."""
        m = self.interior
        y = self.apply_cells(torch.where(m, lhs, 0))
        return torch.where(m, rhs - y, rhs - lhs)

    def compute_rhs(self, f_quad: torch.Tensor, u_bc: torch.Tensor):
        """b = M f - A u_bc with zero Dirichlet rows; ``f_quad`` on the
        blocked quadrature layout, ``u_bc`` read unmasked
        (reference common/laplace_operator.h:804-845)."""
        jxw = self.grid.jxw_scalar
        fv = self._from_quad_t(f_quad.to(self.dtype) * (self.w3d * jxw))
        y = fv - self._stiffness_cells(gather_cells(u_bc, self.n))
        return torch.where(self.interior, scatter_cells(y), 0)

    def inverse_diagonal(self) -> torch.Tensor:
        """1/diag(A) with 1.0 on Dirichlet rows, built from the separable
        1-D factors (reference common/laplace_operator.h:745-800)."""
        dim = self.dim
        diag = None
        for d in range(dim):
            term = None
            for e in range(dim):
                shape = [1] * dim
                shape[e] = -1
                f = self._diag_lines[d][e].reshape(shape)
                term = f if term is None else term * f
            term = term * self.coef.values[d]
            diag = term if diag is None else diag + term
        diag = torch.where(self.interior, diag, 1.0)
        return 1.0 / diag

    def interpolate_to_quad(self, u):
        return self._to_quad(gather_cells(u, self.n))

    def l2_error(self, u: torch.Tensor, exact_quad: torch.Tensor) -> torch.Tensor:
        """Volume-weighted L2 error against exact values at the quadrature
        points (reference common/multigrid_solver.h:298-343)."""
        jxw = self.w3d * self.grid.jxw_scalar
        uq = self.interpolate_to_quad(u)
        err = torch.sum((uq - exact_quad) ** 2 * jxw)
        vol = torch.sum(torch.broadcast_to(jxw, uq.shape))
        return torch.sqrt(err / vol)


# ------------------------------------------------------------ host helpers
def _scatter_pair_host(a: np.ndarray, p: int) -> np.ndarray:
    """Additively merge trailing ``[..., nc, n]`` cell windows (n = p+1,
    stride p) into dense nodes ``[..., nc*p+1]`` (numpy)."""
    nc, n = a.shape[-2], a.shape[-1]
    lead = a.shape[:-2]
    main = a[..., :p].reshape(lead + (nc * p,))
    tail = np.concatenate(
        [np.zeros(lead + (nc, p - 1), a.dtype), a[..., p:]], axis=-1
    ).reshape(lead + (nc * p,))
    pad = [(0, 0)] * len(lead)
    return (np.pad(main, pad + [(0, 1)]) + np.pad(tail, pad + [(1, 0)]))


def _scatter_cells_host(y: np.ndarray, p: int) -> np.ndarray:
    """Per-cell values ``[cz, cy, cx, nz, ny, nx]`` additively merged into a
    dense node block ``[cz*p+1, cy*p+1, cx*p+1]`` (numpy)."""
    t = y.transpose(0, 3, 1, 4, 2, 5)       # [cz, nz, cy, ny, cx, nx]
    t = _scatter_pair_host(t, p)            # [cz, nz, cy, ny, X]
    t = np.moveaxis(t, 4, 2)                # [cz, nz, X, cy, ny]
    t = _scatter_pair_host(t, p)            # [cz, nz, X, Y]
    t = t.transpose(0, 1, 3, 2)             # [cz, nz, Y, X]
    t = t.transpose(2, 3, 0, 1)             # [Y, X, cz, nz]
    return np.moveaxis(_scatter_pair_host(t, p), 2, 0)  # [Z, Y, X]


def _cell_windows_host(u: np.ndarray, n: int, p: int) -> np.ndarray:
    from numpy.lib.stride_tricks import sliding_window_view

    w = sliding_window_view(u, n, axis=0)[::p]
    w = sliding_window_view(w, n, axis=1)[:, ::p]
    return sliding_window_view(w, n, axis=2)[:, :, ::p]


def compute_bc_slab_correction_host(grid: DofGrid, faces, coef=None):
    """``-A u_bc`` restricted to its support, as six disjoint node slabs.

    Only boundary-adjacent cells see u_bc, so the six disjoint boundary
    cell blocks are assembled (O(surface) work) into the six node slabs
    that tile the support.  Returns ``(slab_slices, slab_arrays)``;
    boundary rows are NOT zeroed."""
    assert grid.dim == 3
    coef = coef if coef is not None else make_diag_coef(grid)
    from .laplace_dense import element_matrix

    p = grid.degree
    n = grid.basis.n
    N = n ** 3
    K_el = element_matrix(grid, coef)
    ncz, ncy, ncx = grid.cells
    assert min(ncz, ncy, ncx) >= 2, "slab decomposition needs >=2 cells/axis"
    Z, Y, X = grid.shape
    zi, yi = slice(n, Z - n), slice(n, Y - n)
    slab_slices = [
        (slice(0, n),), (slice(Z - n, Z),),
        (zi, slice(0, n)), (zi, slice(Y - n, Y)),
        (zi, yi, slice(0, n)), (zi, yi, slice(X - n, X)),
    ]
    slab_bounds = []
    for sl in slab_slices:
        sl = tuple(sl) + (slice(None),) * (3 - len(sl))
        slab_bounds.append([s.indices(e)[:2] for s, e in zip(sl, (Z, Y, X))])
    out = [np.zeros(tuple(b1 - b0 for b0, b1 in bb), np.float64)
           for bb in slab_bounds]

    blocks = [
        ((0, 1), (0, ncy), (0, ncx)),
        ((ncz - 1, ncz), (0, ncy), (0, ncx)),
        ((1, ncz - 1), (0, 1), (0, ncx)),
        ((1, ncz - 1), (ncy - 1, ncy), (0, ncx)),
        ((1, ncz - 1), (1, ncy - 1), (0, 1)),
        ((1, ncz - 1), (1, ncy - 1), (ncx - 1, ncx)),
    ]
    for blk in blocks:
        if any(c1 <= c0 for c0, c1 in blk):
            continue
        lo = tuple(c0 * p for c0, _ in blk)
        ext = tuple((c1 - c0) * p + 1 for c0, c1 in blk)
        u = np.zeros(ext, np.float64)
        i = 0
        for d in range(3):
            for side in (0, 1):
                g_idx = 0 if side == 0 else grid.shape[d] - 1
                if lo[d] <= g_idx < lo[d] + ext[d]:
                    sel = [slice(l, l + e) for l, e in zip(lo, ext)]
                    sel[d] = slice(0, 1)
                    usel = [slice(None)] * 3
                    usel[d] = slice(g_idx - lo[d], g_idx - lo[d] + 1)
                    u[tuple(usel)] = faces[i][tuple(sel)]
                i += 1
        if not np.any(u):
            continue
        w = _cell_windows_host(u, n, p)
        cells_shape = w.shape[:3]
        y2 = -(np.ascontiguousarray(w).reshape(-1, N) @ K_el.T)
        blockR = _scatter_cells_host(y2.reshape(cells_shape + (n, n, n)), p)
        for bb, arr in zip(slab_bounds, out):
            ov = [(max(l, b0), min(l + e, b1))
                  for l, e, (b0, b1) in zip(lo, ext, bb)]
            if any(o1 <= o0 for o0, o1 in ov):
                continue
            src = tuple(slice(o0 - l, o1 - l) for (o0, o1), l in zip(ov, lo))
            dst = tuple(slice(o0 - b0, o1 - b0)
                        for (o0, o1), (b0, _) in zip(ov, bb))
            arr[dst] += blockR[src]
    return slab_slices, out


def compute_rhs_host(grid: DofGrid, rhs_fn, u_bc_np: np.ndarray,
                     coef: Optional[DiagCoef] = None,
                     z_slab_cells: int = 4) -> np.ndarray:
    """Host (numpy, fp64) rhs assembly ``b = M f - A u_bc`` with zero
    Dirichlet rows, in slabs of ``z_slab_cells`` cell layers: the mass
    action and the element stiffness are one ``[cells, N]`` dgemm each.
    ``rhs_fn=None`` skips the mass term."""
    assert grid.dim == 3
    coef = coef if coef is not None else make_diag_coef(grid)
    b = grid.basis
    n, p = b.n, grid.degree
    S = np.asarray(b.S, np.float64)
    qw = np.asarray(b.quad_weights, np.float64)
    w3 = qw[:, None, None] * qw[None, :, None] * qw[None, None, :]
    ncz, ncy, ncx = grid.cells
    jxw = grid.jxw_scalar
    qz, qy, qx = (np.asarray(grid.axis_quads[d], np.float64) for d in range(3))
    from .laplace_dense import element_matrix

    N = n ** 3
    S3 = np.kron(np.kron(S, S), S)
    W = S3.T * (w3.ravel() * jxw)[None, :]
    K_el = element_matrix(grid, coef)

    out = np.zeros(grid.shape, np.float64)
    u = np.asarray(u_bc_np, np.float64)
    ubc_zero = not np.any(u)
    for z0 in range(0, ncz, z_slab_cells):
        cz = min(z_slab_cells, ncz - z0)
        if rhs_fn is not None:
            coords = [
                qz[z0: z0 + cz].reshape(cz, 1, 1, n, 1, 1),
                qy.reshape(1, ncy, 1, 1, n, 1),
                qx.reshape(1, 1, ncx, 1, 1, n),
            ]
            fq = np.broadcast_to(np.asarray(rhs_fn(coords), np.float64),
                                 (cz, ncy, ncx, n, n, n))
            y2 = fq.reshape(cz * ncy * ncx, N) @ W.T
        else:
            y2 = np.zeros((cz * ncy * ncx, N))
        if not ubc_zero:
            w = _cell_windows_host(u[z0 * p: (z0 + cz) * p + 1], n, p)
            if rhs_fn is None:
                # correction-only mode: only boundary-adjacent cells see u_bc
                sel = np.zeros((cz, ncy, ncx), bool)
                if z0 == 0:
                    sel[0] = True
                if z0 + cz == ncz:
                    sel[cz - 1] = True
                sel[:, 0, :] = sel[:, -1, :] = True
                sel[:, :, 0] = sel[:, :, -1] = True
                wsel = np.ascontiguousarray(w[sel]).reshape(-1, N)
                y2[sel.reshape(-1)] -= wsel @ K_el.T
            else:
                y2 -= np.ascontiguousarray(w).reshape(-1, N) @ K_el.T
        t = _scatter_cells_host(y2.reshape(cz, ncy, ncx, n, n, n), p)
        out[z0 * p: (z0 + cz) * p + 1] += t
    interior = ~np.asarray(grid.boundary_mask())
    return np.where(interior, out, 0.0)


def l2_error_host(grid: DofGrid, u_np: np.ndarray, exact_fn,
                  z_slab_cells: int = 4) -> float:
    """Host (numpy, fp64) volume-weighted L2 error against the analytic
    solution, in z slabs; ``u_np`` carries its boundary values
    (reference common/multigrid_solver.h:298-343)."""
    from numpy.lib.stride_tricks import sliding_window_view

    assert grid.dim == 3
    b = grid.basis
    n, p = b.n, grid.degree
    St = np.asarray(b.S, np.float64).T
    qw = np.asarray(b.quad_weights, np.float64)
    w3 = qw[:, None, None] * qw[None, :, None] * qw[None, None, :]
    ncz, ncy, ncx = grid.cells
    jxw = grid.jxw_scalar
    qz, qy, qx = (np.asarray(grid.axis_quads[d], np.float64) for d in range(3))
    err = 0.0
    for z0 in range(0, ncz, z_slab_cells):
        cz = min(z_slab_cells, ncz - z0)
        rows = np.asarray(u_np[z0 * p: (z0 + cz) * p + 1], np.float64)
        t = sliding_window_view(rows, n, axis=0)[::p] @ St
        t = sliding_window_view(t, n, axis=1)[:, ::p] @ St
        t = sliding_window_view(t, n, axis=2)[:, :, ::p] @ St
        coords = [
            qz[z0: z0 + cz].reshape(cz, 1, 1, n, 1, 1),
            qy.reshape(1, ncy, 1, 1, n, 1),
            qx.reshape(1, 1, ncx, 1, 1, n),
        ]
        exact = np.asarray(exact_fn(coords), np.float64)
        d = t - exact
        err += float(np.sum(d * d * w3))
    vol = float(w3.sum()) * ncz * ncy * ncx * jxw
    return float(np.sqrt(err * jxw / vol))
