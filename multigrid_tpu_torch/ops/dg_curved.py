"""SIP-DG Laplace operator with per-point geometry on a smoothly mapped
structured block.

Twin of ``multigrid_tpu/ops/dg_curved.py``.  The affine operator of
:mod:`.dg` takes one constant Jacobian per level; here every geometry
constant becomes an array at the quadrature points (the DG sibling of the
FE_Q general path, :mod:`.laplace_general` on :mod:`..mesh.mapped`):

* the volume term reads a merged symmetric tensor ``c w detJ J^-1 J^-T``
  per quadrature point (reference common/laplace_operator.h:388-429, here
  for the DG form);
* the face terms read, per face point, the surface measure ``detJ |J^-T
  e_d|``, the conormal ``(J^-1 J^-T e_d) / |J^-T e_d|`` and the penalty
  ``sigma = (p+1)^2 |n J^-1|`` (the both-side Jacobian penalty of
  common/laplace_operator_dg_face.h:106-109, per point).  The mapping is
  smooth, so both cells of a face see the same face-point geometry,
  evaluated once per face.

The geometry is evaluated at set-up in f64 numpy by complex-step
differentiation of the mapping (:func:`..mesh.mapped._map_jacobian`), in
chunks of points so that the complex temporaries stay bounded; an optional
smooth coefficient c(x) is folded into the volume tensor and the face
tables at their own points.  The Dirichlet boundary keeps the mirror
``u+ = -u-``, ``n.grad u+ = n.grad u-`` (laplace_operator_dg.h:1469-1485),
with weak (Nitsche) data in :meth:`DGLaplaceCurved.compute_rhs`.

Plain PyTorch on every device, as its JAX twin is plain XLA: on the card
it runs its PyTorch operations on the card and no kernel of this package.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.dg_basis import GAUSS, make_dg_basis
from ..mesh.mapped import Block, _map_jacobian
from .dg import DGLaplace, sweep
from .laplace import apply_1d

# points per chunk of the set-up's geometry evaluation (complex128 mapping
# temporaries and [chunk, dim, dim] Jacobians)
_GEOM_CHUNK = 1 << 20


def _kron_weights(qw: np.ndarray, k: int) -> np.ndarray:
    w = np.array([1.0])
    for _ in range(k):
        w = np.kron(w, qw)
    return w


class DGCurvedGrid:
    """One level of a DG discretization on a smoothly mapped structured block.

    ``mapping``: ``[N, dim]`` block coordinates in ``[0, 1]^dim`` ->
    ``[N, dim]`` physical ones.  ``coeff_fn``: an optional smooth c(x),
    called on a list of per-dimension physical coordinate arrays (the
    convention of the FE_Q general path)."""

    def __init__(self, cells, mapping: Callable, degree: int,
                 kind: str = GAUSS, coeff_fn: Optional[Callable] = None):
        self.cells = tuple(int(c) for c in cells)
        self.mapping = mapping
        self.degree = degree
        self.kind = kind
        self.coeff_fn = coeff_fn
        dim = len(self.cells)
        self.dim = dim
        b = make_dg_basis(degree, kind)
        self.basis = b
        n = degree + 1
        self.n = n
        qp = b.quad_points
        h = 1.0 / np.asarray(self.cells, np.float64)
        blk = Block(cells=self.cells, mapping=mapping)

        def geom_at(flat):
            """Physical coordinates, |detJ|, J^-1 and G = J^-1 J^-T of the
            cell map (block map times the cell size) at ``flat``."""
            N = flat.shape[0]
            X = np.empty((N, dim))
            detJ = np.empty(N)
            Jinv = np.empty((N, dim, dim))
            G = np.empty((N, dim, dim))
            for i0 in range(0, N, _GEOM_CHUNK):
                sl = slice(i0, min(N, i0 + _GEOM_CHUNK))
                X[sl] = np.asarray(mapping(flat[sl]), np.float64)
                J = _map_jacobian(blk, flat[sl]) * h[None, :]
                detJ[sl] = np.abs(np.linalg.det(J))
                Jinv[sl] = np.linalg.inv(J)
                G[sl] = np.einsum("nab,ncb->nac", Jinv[sl], Jinv[sl])
            return X, detJ, Jinv, G

        # ------------------------------------------------------ volume geometry
        vshape = self.cells + (n,) * dim
        Ps = []
        for e in range(dim):
            line = (np.arange(self.cells[e])[:, None] + qp[None, :]) * h[e]
            shp = [1] * (2 * dim)
            shp[e] = self.cells[e]
            shp[dim + e] = n
            Ps.append(np.broadcast_to(line.reshape(shp), vshape))
        flat = np.stack([P.reshape(-1) for P in Ps], axis=1)
        X, detJ, _, G = geom_at(flat)
        del flat
        self.quad_phys = [X[:, d].reshape(vshape) for d in range(dim)]
        w3 = _kron_weights(b.quad_weights, dim)
        w3_full = np.tile(w3, int(np.prod(self.cells))).reshape(vshape)
        self.jxw_vol = detJ.reshape(vshape) * w3_full    # the pure measure
        c = 1.0
        if coeff_fn is not None:
            c = np.asarray(coeff_fn(self.quad_phys), np.float64)
        cw = self.jxw_vol * c
        # the symmetric tensor: upper triangle once, mirrors aliased
        self.Gw = [[None] * dim for _ in range(dim)]
        for a in range(dim):
            for e in range(a, dim):
                arr = cw * G[:, a, e].reshape(vshape)
                self.Gw[a][e] = arr
                self.Gw[e][a] = arr
        del X, detJ, G, cw

        # -------------------------------------------------------- face geometry
        # face arrays: cell axis d extended to C_d + 1 (the face planes),
        # node axes the perpendicular directions in increasing order (the
        # layout of the operator's trace arrays)
        self.face_jxw = []      # surface measure with the perpendicular weights
        self.face_sigma = []    # penalty (coefficient folded in)
        self.face_gvec = []     # conormal [e] arrays (coefficient folded in)
        self.face_phys = []     # physical face-point coordinates [e]
        for d in range(dim):
            others = [e for e in range(dim) if e != d]
            fcells = list(self.cells)
            fcells[d] += 1
            fshape = tuple(fcells) + (n,) * (dim - 1)
            Ps = []
            for e in range(dim):
                shp = [1] * (2 * dim - 1)
                if e == d:
                    line = np.arange(self.cells[d] + 1) * h[d]
                    shp[d] = self.cells[d] + 1
                else:
                    line = (np.arange(self.cells[e])[:, None]
                            + qp[None, :]) * h[e]
                    shp[e] = self.cells[e]
                    shp[dim + others.index(e)] = n
                Ps.append(np.broadcast_to(line.reshape(shp), fshape))
            flat = np.stack([P.reshape(-1) for P in Ps], axis=1)
            Xf, detJf, Jinvf, Gf = geom_at(flat)
            r = Jinvf[:, d, :]                       # J^-T e_d per point
            rn = np.linalg.norm(r, axis=1)
            n_unit = r / rn[:, None]
            gvec = Gf[:, d, :] / rn[:, None]         # conormal . grad_ref
            sigma = n * n * np.linalg.norm(
                np.einsum("na,nab->nb", n_unit, Jinvf), axis=1)
            cf = 1.0
            phys = [Xf[:, e].reshape(fshape) for e in range(dim)]
            if coeff_fn is not None:
                cf = np.asarray(coeff_fn(phys), np.float64).reshape(-1)
            wperp = _kron_weights(b.quad_weights, dim - 1)
            wperp_full = np.tile(
                wperp, int(np.prod(fcells))).reshape(fshape)
            self.face_jxw.append(
                (detJf * rn).reshape(fshape) * wperp_full)
            self.face_sigma.append((sigma * cf).reshape(fshape))
            self.face_gvec.append(
                [(gvec[:, e] * cf).reshape(fshape) for e in range(dim)])
            self.face_phys.append(phys)

    @property
    def n_dofs(self) -> int:
        return int(np.prod(self.cells)) * self.n**self.dim

    @property
    def shape(self) -> tuple[int, ...]:
        return self.cells + (self.n,) * self.dim

    def boundary_quad_coords(self, d: int, side: int):
        """Physical coordinates of the quadrature points of the boundary
        face (d, side): per-dimension arrays of trace shape with cell axis
        d of extent 1 (broadcastable against a layer mask), for weak
        Dirichlet data."""
        k = 0 if side == 0 else self.cells[d]
        return [np.take(self.face_phys[d][e], [k], axis=d)
                for e in range(self.dim)]


class DGLaplaceCurved(DGLaplace):
    """SIP-DG A·u with fused cell and face evaluation and per-point
    geometry, in plain PyTorch.

    The block layout, traces, lifts and mirror of the affine operator;
    every scalar geometry constant is an array at the quadrature points.
    ``has_cell_data`` sends :class:`~.dg_precond.JacobiTransformed` to its
    exact per-cell probe."""

    has_cell_data = True

    def __init__(self, grid: DGCurvedGrid, dtype=torch.float32,
                 device="cuda"):
        t = self._basis_tables(grid, dtype, device)
        dim = grid.dim
        self.Gw = [[None] * dim for _ in range(dim)]
        for a in range(dim):
            for e in range(a, dim):
                arr = t(grid.Gw[a][e])
                self.Gw[a][e] = arr
                self.Gw[e][a] = arr
        self.jxw_vol = t(grid.jxw_vol)
        # per (direction, cell side) slices of the face tables: the face of
        # cell k on side s is face plane k + s
        self._wf, self._sig, self._gv = [], [], []
        for d in range(dim):
            C = grid.cells[d]
            wf_d, sig_d, gv_d = [], [], []
            for s in (0, 1):
                take = lambda a: t(np.take(a, np.arange(s, C + s), axis=d))
                wf_d.append(take(grid.face_jxw[d]))
                sig_d.append(take(grid.face_sigma[d]))
                gv_d.append([take(grid.face_gvec[d][e]) for e in range(dim)])
            self._wf.append(wf_d)
            self._sig.append(sig_d)
            self._gv.append(gv_d)

    def astype(self, dtype) -> "DGLaplaceCurved":
        return self if dtype == self.dtype else DGLaplaceCurved(
            self.grid, dtype, self.device)

    # --------------------------------------------------------------- vmult
    def apply(self, u: torch.Tensor) -> torch.Tensor:
        dim = self.dim
        v = u if self.is_collocation else sweep(u, self.S, dim)
        g = [apply_1d(v, self.D, self._node_axis(d)) for d in range(dim)]
        # volume term: the per-point merged tensor (w detJ c folded in)
        acc = []
        for e in range(dim):
            t = None
            for f_ in range(dim):
                term = self.Gw[e][f_] * g[f_]
                t = term if t is None else t + term
            acc.append(t)
        vacc = torch.zeros_like(v)
        for d in range(dim):
            tr_u = [self._trace(v, d, s) for s in (0, 1)]
            # conormal-projected gradient trace per side, each side with its
            # own face-point geometry; the two cells of a face share it, so
            # the neighbour's shifted trace is consistent
            gn_own = []
            for so in (0, 1):
                t = None
                for e in range(dim):
                    term = self._gv[d][so][e] * self._trace(g[e], d, so)
                    t = term if t is None else t + term
                gn_own.append(t)
            for s in (0, 1):
                sign = 1.0 if s == 1 else -1.0
                gv = self._gv[d][s]
                u_m = tr_u[s]
                gn_m = sign * gn_own[s]
                u_p = self._shift(tr_u[1 - s], -u_m, d, s)
                gn_p = sign * self._shift(gn_own[1 - s], gn_own[s], d, s)
                jump = u_m - u_p
                t_val = self._sig[d][s] * jump - 0.5 * (gn_m + gn_p)
                t_gr = -0.5 * jump
                wf = self._wf[d][s]
                vacc = vacc + self._lift(t_val * wf, d, s)
                for e in range(dim):
                    acc[e] = acc[e] + self._lift(
                        t_gr * wf * (sign * gv[e]), d, s)
        y = vacc
        for e in range(dim):
            y = y + apply_1d(acc[e], self.Dt, self._node_axis(e))
        return y if self.is_collocation else sweep(y, self.St, dim)

    # ----------------------------------------------------------------- rhs
    def compute_rhs(self, f_quad: torch.Tensor, g_bc=None) -> torch.Tensor:
        """b = (f, phi) plus weak Dirichlet data with per-point geometry.
        ``g_bc``: dict (d, side) -> boundary values at the face quadrature
        points (trace shape, broadcastable; see
        :meth:`DGCurvedGrid.boundary_quad_coords`)."""
        dim = self.dim
        vacc = f_quad.to(self.dtype) * self.jxw_vol
        acc = [None] * dim
        for (d, s), gval in (g_bc or {}).items():
            sign = 1.0 if s == 1 else -1.0
            lay = np.zeros(self.grid.cells[d])
            lay[-1 if s == 1 else 0] = 1.0
            mask_shape = [1] * (dim * 2 - 1)
            mask_shape[d] = self.grid.cells[d]
            mask = torch.as_tensor(lay.reshape(mask_shape), dtype=self.dtype,
                                   device=self.device)
            gm = torch.as_tensor(gval, dtype=self.dtype,
                                 device=self.device) * mask
            t_val = 2.0 * self._sig[d][s] * gm
            t_gr = -gm
            wf = self._wf[d][s]
            vacc = vacc + self._lift(t_val * wf, d, s)
            for e in range(dim):
                term = self._lift(t_gr * wf * (sign * self._gv[d][s][e]), d, s)
                acc[e] = term if acc[e] is None else acc[e] + term
        y = vacc
        for e in range(dim):
            if acc[e] is not None:
                y = y + apply_1d(acc[e], self.Dt, self._node_axis(e))
        return y if self.is_collocation else sweep(y, self.St, dim)

    # ------------------------------------------------------------ analysis
    def l2_error(self, u: torch.Tensor,
                 exact_quad: torch.Tensor) -> torch.Tensor:
        uq = self.to_quad_values(u)
        err = torch.sum((uq - exact_quad) ** 2 * self.jxw_vol)
        return torch.sqrt(err / torch.sum(self.jxw_vol))
