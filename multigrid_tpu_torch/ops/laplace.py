"""Matrix-free FE_Q Laplace operator, sum-factorized (the oracle).

Twin of ``multigrid_tpu/ops/laplace.py``.  Cells are evaluated in the
blocked layout ``[C0, C1, C2, n, n, n]`` of :mod:`.windows`: interpolate
to the Gauss points with ``S``, differentiate with the collocation matrix
``D_col``, apply the merged coefficient and integrate back (reference
common/laplace_operator.h:436-558).  The coefficient is ``DiagCoef`` (the
affine brick with a constant coefficient: ``c_d * w_q`` a direction) or
``SymCoef`` (a full symmetric tensor a quadrature point, JxW and weight
included, laplace_operator.h:493-522).  Dirichlet rows are identity rows
(laplace_operator.h:573-601).

This operator serves setup and analysis: the separable inverse diagonal,
rhs assembly and L2 errors.  The solve's hot path runs
:class:`multigrid_tpu_torch.ops.laplace_kernel.BrickLaplace`.  The host
helpers at the bottom are numpy copies of the JAX module's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from ..devices import resolve
from ..mesh.brick import DofGrid
from .masks import interior_mask
from .windows import gather_cells, scatter_cells


_SYM2 = ((0, 0), (1, 1), (0, 1))
_SYM3 = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


def sym_components(dim: int):
    """Storage order of a symmetric tensor's components, diagonal first
    (reference common/laplace_operator.h:382-386)."""
    return _SYM2 if dim == 2 else _SYM3


def sym_index(dim: int, a: int, b: int) -> int:
    return sym_components(dim).index((min(a, b), max(a, b)))


@dataclass(frozen=True)
class DiagCoef:
    """Affine geometry + constant coefficient: the merged tensor is the
    diagonal ``c * det(J) / h_d^2``, one value per axis
    (reference common/laplace_operator.h:447-491)."""

    values: tuple[float, ...]


@dataclass
class SymCoef:
    """The full symmetric merged coefficient of each quadrature point, JxW
    and quadrature weight included (reference
    common/laplace_operator.h:493-522): a tensor (or array) broadcastable
    to the blocked layout ``[C0, C1, (C2,) q, q, (q,) n_sym]``, components
    in :func:`sym_components` order.  The JAX class stores it interleaved,
    ``[C0, q, C1, q, ..., n_sym]``: :func:`~..convert.sym_coef_from_jax`."""

    array: object


Coef = Union[DiagCoef, SymCoef]


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
                 coef: Optional[Coef] = None, device="cuda"):
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
        if isinstance(self.coef, SymCoef):
            self.coef = SymCoef(torch.as_tensor(coef.array, dtype=dtype,
                                                device=device))
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

    def _quad_op(self, g: list) -> list:
        """The merged coefficient applied to the gradients at the
        quadrature points (reference common/laplace_operator.h:436-523)."""
        dim = self.dim
        if isinstance(self.coef, DiagCoef):
            return [g[d] * (self.coef.values[d] * self.w3d)
                    for d in range(dim)]
        C = self.coef.array
        out = []
        for a in range(dim):
            acc = None
            for b in range(dim):
                term = C[..., sym_index(dim, a, b)] * g[b]
                acc = term if acc is None else acc + term
            out.append(acc)
        return out

    def _stiffness_cells(self, w):
        """Cell-local stiffness action on gathered node values."""
        uq = self._to_quad(w)
        g = self._quad_op([apply_1d(uq, self.D, self._local(d))
                           for d in range(self.dim)])
        acc = None
        for d in range(self.dim):
            term = apply_1d(g[d], self.Dt, self._local(d))
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
        """1/diag(A) with 1.0 on Dirichlet rows (reference
        common/laplace_operator.h:745-800): from the separable 1-D factors
        for a ``DiagCoef``; for a ``SymCoef`` the coefficient contracted
        with the factor tables ``T_a T_b`` of each axis (``T`` the
        derivative ``D`` along a component's own axes, else ``S``; the
        off-diagonal components twice), scattered to the nodes."""
        dim = self.dim
        diag = None
        if isinstance(self.coef, DiagCoef):
            for d in range(dim):
                term = None
                for e in range(dim):
                    shape = [1] * dim
                    shape[e] = -1
                    f = self._diag_lines[d][e].reshape(shape)
                    term = f if term is None else term * f
                term = term * self.coef.values[d]
                diag = term if diag is None else diag + term
        else:
            b = self.grid.basis
            C = self.coef.array
            for s, (a, bb) in enumerate(sym_components(dim)):
                term = C[..., s] * (1.0 if a == bb else 2.0)
                for e in range(dim):
                    F = (b.D if a == e else b.S) * (b.D if bb == e else b.S)
                    F = torch.as_tensor(F.T, dtype=self.dtype,
                                        device=self.device)    # [n, q]
                    term = apply_1d(term, F, self._local(e))
                diag = term if diag is None else diag + term
            diag = scatter_cells(torch.broadcast_to(
                diag, tuple(self.grid.cells) + (self.n,) * dim))
        diag = torch.where(self.interior, diag, 1.0)
        return 1.0 / diag

    def interpolate_to_quad(self, u):
        return self._to_quad(gather_cells(u, self.n))

    def l2_sums(self, u: torch.Tensor, exact_quad: torch.Tensor):
        """The integrals of ``(u - exact)^2`` and of 1 over the grid (0-d
        tensors), whose ratio's root is :meth:`l2_error`; the parts a rank
        adds up."""
        jxw = self.w3d * self.grid.jxw_scalar
        uq = self.interpolate_to_quad(u)
        err = torch.sum((uq - exact_quad) ** 2 * jxw)
        vol = torch.sum(torch.broadcast_to(jxw, uq.shape))
        return err, vol

    def l2_error(self, u: torch.Tensor, exact_quad: torch.Tensor) -> torch.Tensor:
        """Volume-weighted L2 error against exact values at the quadrature
        points (reference common/multigrid_solver.h:298-343)."""
        err, vol = self.l2_sums(u, exact_quad)
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
    """Per-cell values ``[c_0, ..., c_{d-1}, n, ..., n]`` additively merged
    into a dense node block ``[c_0 p + 1, ...]`` (numpy), the last axis
    first."""
    dim = y.ndim // 2
    t = y.transpose([a for d in range(dim) for a in (d, dim + d)])
    for d in reversed(range(dim)):
        # [c_0, n_0, ..., c_d, n_d, N_{d+1}, ...]: merge the pair of axis d
        t = np.moveaxis(t, (2 * d, 2 * d + 1), (-2, -1))
        t = np.moveaxis(_scatter_pair_host(t, p), -1, 2 * d)
    return t


def _cell_windows_host(u: np.ndarray, n: int, p: int) -> np.ndarray:
    """``[N_0, ...]`` -> strided view ``[c_0, ..., n, ...]`` of the cell
    windows (numpy)."""
    from numpy.lib.stride_tricks import sliding_window_view

    w = u
    for d in range(u.ndim):
        w = sliding_window_view(w, n, axis=d)[(slice(None),) * d
                                              + (slice(None, None, p),)]
    return w


def compute_bc_slab_correction_host(grid: DofGrid, faces, coef=None):
    """``-A u_bc`` restricted to its support, as ``2 dim`` disjoint node
    slabs.

    Only boundary-adjacent cells see u_bc, so the ``2 dim`` disjoint
    boundary cell blocks are assembled (O(surface) work) into the node
    slabs that tile the support: along axis d the first and the last ``n``
    node planes, inside the earlier axes' interior.  Returns
    ``(slab_slices, slab_arrays)``; boundary rows are NOT zeroed."""
    coef = coef if coef is not None else make_diag_coef(grid)
    from .laplace_dense import element_matrix

    dim = grid.dim
    p = grid.degree
    n = grid.basis.n
    N = n ** dim
    K_el = element_matrix(grid, coef)
    ncs = grid.cells
    assert min(ncs) >= 2, "slab decomposition needs >=2 cells/axis"
    shape = grid.shape
    slab_slices, blocks = [], []
    for d in range(dim):
        inner = tuple(slice(n, shape[e] - n) for e in range(d))
        inner_cells = tuple((1, ncs[e] - 1) for e in range(d))
        rest = tuple((0, ncs[e]) for e in range(d + 1, dim))
        for side in (0, 1):
            slab_slices.append(inner + (slice(0, n) if side == 0 else
                                        slice(shape[d] - n, shape[d]),))
            blocks.append(inner_cells + ((0, 1) if side == 0 else
                                         (ncs[d] - 1, ncs[d]),) + rest)
    slab_bounds = []
    for sl in slab_slices:
        sl = tuple(sl) + (slice(None),) * (dim - len(sl))
        slab_bounds.append([s.indices(e)[:2] for s, e in zip(sl, shape)])
    out = [np.zeros(tuple(b1 - b0 for b0, b1 in bb), np.float64)
           for bb in slab_bounds]

    for blk in blocks:
        if any(c1 <= c0 for c0, c1 in blk):
            continue
        lo = tuple(c0 * p for c0, _ in blk)
        ext = tuple((c1 - c0) * p + 1 for c0, c1 in blk)
        u = np.zeros(ext, np.float64)
        i = 0
        for d in range(dim):
            for side in (0, 1):
                g_idx = 0 if side == 0 else shape[d] - 1
                if lo[d] <= g_idx < lo[d] + ext[d]:
                    sel = [slice(l, l + e) for l, e in zip(lo, ext)]
                    sel[d] = slice(0, 1)
                    usel = [slice(None)] * dim
                    usel[d] = slice(g_idx - lo[d], g_idx - lo[d] + 1)
                    u[tuple(usel)] = faces[i][tuple(sel)]
                i += 1
        if not np.any(u):
            continue
        w = _cell_windows_host(u, n, p)
        cells_shape = w.shape[:dim]
        y2 = -(np.ascontiguousarray(w).reshape(-1, N) @ K_el.T)
        blockR = _scatter_cells_host(y2.reshape(cells_shape + (n,) * dim), p)
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


def _slab_quads(grid: DofGrid, z0: int, cz: int) -> list[np.ndarray]:
    """Quadrature coordinates of cell layers ``z0 .. z0 + cz`` of axis 0,
    broadcastable to ``[cz, c_1, ..., n, ...]``."""
    dim, n = grid.dim, grid.basis.n
    out = []
    for d in range(dim):
        q = np.asarray(grid.axis_quads[d], np.float64)
        if d == 0:
            q = q[z0: z0 + cz]
        shape = [1] * (2 * dim)
        shape[d], shape[dim + d] = q.shape[0], n
        out.append(q.reshape(shape))
    return out


def _weights(grid: DofGrid) -> np.ndarray:
    """Tensor product of the 1-D quadrature weights, ``[n] * dim``."""
    qw = np.asarray(grid.basis.quad_weights, np.float64)
    w = qw
    for _ in range(grid.dim - 1):
        w = np.multiply.outer(w, qw)
    return w


def compute_rhs_host(grid: DofGrid, rhs_fn, u_bc_np: np.ndarray,
                     coef: Optional[DiagCoef] = None,
                     z_slab_cells: int = 4) -> np.ndarray:
    """Host (numpy, fp64) rhs assembly ``b = M f - A u_bc`` with zero
    Dirichlet rows, in slabs of ``z_slab_cells`` cell layers of axis 0:
    the mass action and the element stiffness are one ``[cells, N]`` dgemm
    each.  ``rhs_fn=None`` skips the mass term."""
    coef = coef if coef is not None else make_diag_coef(grid)
    dim = grid.dim
    b = grid.basis
    n, p = b.n, grid.degree
    S = np.asarray(b.S, np.float64)
    nc0, rest = grid.cells[0], tuple(grid.cells[1:])
    jxw = grid.jxw_scalar
    from .laplace_dense import element_matrix

    N = n ** dim
    Sk = S
    for _ in range(dim - 1):
        Sk = np.kron(Sk, S)
    W = Sk.T * (_weights(grid).ravel() * jxw)[None, :]
    K_el = element_matrix(grid, coef)

    out = np.zeros(grid.shape, np.float64)
    u = np.asarray(u_bc_np, np.float64)
    ubc_zero = not np.any(u)
    for z0 in range(0, nc0, z_slab_cells):
        cz = min(z_slab_cells, nc0 - z0)
        cells = (cz,) + rest
        if rhs_fn is not None:
            fq = np.broadcast_to(np.asarray(rhs_fn(_slab_quads(grid, z0, cz)),
                                            np.float64), cells + (n,) * dim)
            y2 = fq.reshape(-1, N) @ W.T
        else:
            y2 = np.zeros((int(np.prod(cells)), N))
        if not ubc_zero:
            w = _cell_windows_host(u[z0 * p: (z0 + cz) * p + 1], n, p)
            if rhs_fn is None:
                # correction-only mode: only boundary-adjacent cells see u_bc
                sel = np.zeros(cells, bool)
                if z0 == 0:
                    sel[0] = True
                if z0 + cz == nc0:
                    sel[cz - 1] = True
                for d in range(1, dim):
                    idx = [slice(None)] * dim
                    for end in (0, -1):
                        idx[d] = end
                        sel[tuple(idx)] = True
                wsel = np.ascontiguousarray(w[sel]).reshape(-1, N)
                y2[sel.reshape(-1)] -= wsel @ K_el.T
            else:
                y2 -= np.ascontiguousarray(w).reshape(-1, N) @ K_el.T
        t = _scatter_cells_host(y2.reshape(cells + (n,) * dim), p)
        out[z0 * p: (z0 + cz) * p + 1] += t
    interior = ~np.asarray(grid.boundary_mask())
    return np.where(interior, out, 0.0)


def l2_error_host(grid: DofGrid, u_np: np.ndarray, exact_fn,
                  z_slab_cells: int = 4) -> float:
    """Host (numpy, fp64) volume-weighted L2 error against the analytic
    solution, in slabs of cell layers of axis 0; ``u_np`` carries its
    boundary values (reference common/multigrid_solver.h:298-343)."""
    err, vol = l2_sums_host(grid, u_np, exact_fn, z_slab_cells)
    return float(np.sqrt(err / vol))


def l2_sums_host(grid: DofGrid, u_np: np.ndarray, exact_fn,
                 z_slab_cells: int = 4) -> tuple[float, float]:
    """The integrals of ``(u - exact)^2`` and of 1 over the grid (host,
    fp64), whose ratio's root is :func:`l2_error_host`."""
    from numpy.lib.stride_tricks import sliding_window_view

    dim = grid.dim
    b = grid.basis
    n, p = b.n, grid.degree
    St = np.asarray(b.S, np.float64).T
    wq = _weights(grid)
    nc0 = grid.cells[0]
    jxw = grid.jxw_scalar
    err = 0.0
    for z0 in range(0, nc0, z_slab_cells):
        cz = min(z_slab_cells, nc0 - z0)
        t = np.asarray(u_np[z0 * p: (z0 + cz) * p + 1], np.float64)
        for d in range(dim):
            t = sliding_window_view(t, n, axis=d)[(slice(None),) * d
                                                  + (slice(None, None, p),)]
            t = t @ St
        exact = np.asarray(exact_fn(_slab_quads(grid, z0, cz)), np.float64)
        diff = t - exact
        err += float(np.sum(diff * diff * wq))
    vol = float(wq.sum()) * int(np.prod(grid.cells)) * jxw
    return err * jxw, vol
