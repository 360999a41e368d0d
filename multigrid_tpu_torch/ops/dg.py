"""SIP-DG Laplace operator on structured meshes, sum-factorized (the plain
version of the DG kernels).

Twin of ``multigrid_tpu/ops/dg.py`` (``DGGrid``, ``DGLaplace``), itself the
reference's ``LaplaceOperatorCompactCombine``
(reference common/laplace_operator_dg.h:350-2024): one pass evaluates cell
gradients, extracts own and neighbour face traces, applies the SIP flux
and lifts everything back.

Layout: DG vectors are blocks ``[C0, C1, C2, n, n, n]`` (cell axes first,
node axes last, x fastest); any leading batch axes are carried along, which
the transformed-Jacobi probe uses.  Geometry: one constant affine Jacobian
per level, sheared parallelepipeds included.  Dirichlet boundary: the
mirror ``u+ = -u-``, ``du+ = du-`` (reference
common/laplace_operator_dg.h:1469-1485); penalty ``sigma = (p+1)^2 |n J^-1|``.

This is the sum-factorized XLA-style form of the JAX package, written with
PyTorch contractions.  It is the oracle of ``ops/dg_kernel.py`` (the CUDA
kernels for K7, K8, K9), assembles the right-hand side and measures L2
errors.  :class:`DGLaplaceVarCoeff` adds a coefficient per quadrature
point (-div(c grad u)); it is plain PyTorch on every device, as its XLA
twin is on the TPU.

The multi-device trace wire of the JAX twin is here too:
:meth:`DGLaplace.boundary_traces` (the evaluated value and normal-gradient
traces of a boundary cell layer), :meth:`DGLaplace.boundary_coeff_planes`
(the two face-controlling Hermite coefficient planes, degree >= 3) with
:meth:`DGLaplace.traces_from_coeff_planes` (the receiver's traces), and
``apply(u, ext=...)``, whose ghost traces replace the Dirichlet mirror at
a slab edge.  Together they are the plain version of the distributed
apply (``parallel/dg_halo.HaloDGLaplace.vmult_plain``); the solvers'
slabs run the kernels on ghost cell layers instead.  ``compute_rhs`` takes
the weak Dirichlet data ``g_bc`` as the JAX twin does (the solvers, like
the reference's, pass none).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ..core.dg_basis import GAUSS, HERMITE, DGBasis1D, make_dg_basis
from ..devices import resolve
from .laplace import apply_1d


@dataclass(frozen=True)
class DGGrid:
    """One level of a DG discretization on an affine-image structured mesh."""

    cells: tuple[int, ...]
    jacobian: tuple[tuple[float, ...], ...]   # constant dim x dim cell map J
    degree: int
    kind: str = GAUSS

    @property
    def dim(self) -> int:
        return len(self.cells)

    @cached_property
    def basis(self) -> DGBasis1D:
        return make_dg_basis(self.degree, self.kind)

    @property
    def n(self) -> int:
        return self.degree + 1

    @property
    def n_dofs(self) -> int:
        return int(np.prod(self.cells)) * self.n**self.dim

    @property
    def shape(self) -> tuple[int, ...]:
        return self.cells + (self.n,) * self.dim

    @cached_property
    def J(self) -> np.ndarray:
        return np.asarray(self.jacobian, np.float64)


def hermite_basis_change(grid: DGGrid):
    """The 1-D coefficient maps of ``grid``'s element to the Hermite-like
    basis and back (fp64, ``(to, back)``), or None for the hermite kind:
    the coefficient-form wire's pack and its receiver's expansion."""
    if grid.kind == HERMITE:
        return None
    n, b = grid.n, grid.basis
    hb = make_dg_basis(grid.degree, HERMITE)
    colloc = grid.kind == GAUSS
    S = np.eye(n) if colloc else np.asarray(b.S, np.float64)
    S_inv = np.eye(n) if colloc else np.asarray(b.S_inv, np.float64)
    return hb.S_inv @ S, S_inv @ hb.S


def sweep(u: torch.Tensor, M: torch.Tensor, dim: int) -> torch.Tensor:
    """``M`` applied along each of the last ``dim`` (node) axes of ``u``,
    the first node axis first."""
    for d in range(dim):
        u = apply_1d(u, M, d - dim)
    return u


def dg_geometry(grid: DGGrid) -> dict:
    """Constants of the affine cell map (fp64 floats): ``detJ``; the
    volume metric ``Gsym[e][f] = detJ (J^-1 J^-T)[e, f]``; per face
    direction d the face area factor ``jxw``, the normal-gradient vector
    ``gvec`` and the penalty ``sigma`` (JAX ``DGLaplace.__init__``)."""
    dim, n = grid.dim, grid.n
    Jinv = np.linalg.inv(grid.J)
    detJ = float(abs(np.linalg.det(grid.J)))
    G = Jinv @ Jinv.T
    faces = []
    for d in range(dim):
        r = Jinv.T[:, d]
        rn = np.linalg.norm(r)
        faces.append(dict(jxw=float(detJ * rn),
                          gvec=[float(v) for v in G[d] / rn],
                          sigma=float(n**2 * np.linalg.norm(r / rn @ Jinv))))
    return dict(detJ=detJ, Gsym=[[float(detJ * G[a, b]) for b in range(dim)]
                                 for a in range(dim)], face=faces)


class DGLaplace:
    """SIP-DG A·u with fused cell+face evaluation, in plain PyTorch."""

    def __init__(self, grid: DGGrid, dtype=torch.float32, device="cuda"):
        t = self._basis_tables(grid, dtype, device)
        b = grid.basis
        geo = dg_geometry(grid)
        self.detJ, self.Gsym, self.face = geo["detJ"], geo["Gsym"], geo["face"]
        qw = b.quad_weights
        w3 = np.ones((1,) * self.dim)
        for d in range(self.dim):
            s = [1] * self.dim
            s[d] = self.n
            w3 = w3 * qw.reshape(s)
        self.w3d = t(w3)
        # perpendicular weight products of the faces of each direction
        self.wperp = [t(functools.reduce(np.multiply.outer, [
            qw for e in range(self.dim) if e != d], np.ones(())))
            for d in range(self.dim)]

    def _basis_tables(self, grid, dtype, device):
        """The grid, dtype, device and 1-D basis tables every DG operator
        keeps; returns the converter to this dtype and device."""
        self.grid = grid
        self.dtype = dtype
        self.device = resolve(device)
        b = grid.basis
        self.dim, self.n = grid.dim, grid.n
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=self.device)
        self.S, self.St = t(b.S), t(b.S.T)
        self.D, self.Dt = t(b.D_col), t(b.D_col.T)
        self.f = [t(b.f0), t(b.f1)]
        self.is_collocation = grid.kind == GAUSS
        return t

    # ------------------------------------------------------------- helpers
    def _node_axis(self, d: int) -> int:
        return d - self.dim

    def _trace(self, a, d, side):
        """Contract node axis d with the face vector -> face trace array
        ``[..., C0, C1, C2, n, n]``."""
        return torch.tensordot(a, self.f[side], dims=([self._node_axis(d)], [0]))

    def _lift(self, t, d, side):
        """Adjoint of :meth:`_trace`: outer product with the face vector."""
        vec = self.f[side].reshape((self.n,) + (1,) * (self.dim - 1 - d))
        return t.unsqueeze(self._node_axis(d)) * vec

    def _shift(self, tr_opp, edge, d, side, ext=None):
        """The neighbour's trace across face (d, side): the opposite-side
        trace of the next cell along cell axis d; at the domain boundary
        the boundary layer of ``edge`` or, given, the one-layer ghost
        trace ``ext``."""
        ax = d - 2 * self.dim + 1          # cell axis d of a trace array
        C = tr_opp.shape[ax]
        if side == 1:
            return torch.cat([tr_opp.narrow(ax, 1, C - 1),
                              edge.narrow(ax, C - 1, 1) if ext is None
                              else ext], dim=ax)
        return torch.cat([edge.narrow(ax, 0, 1) if ext is None else ext,
                          tr_opp.narrow(ax, 0, C - 1)], dim=ax)

    def _layer(self, u, d, side):
        """The first (side 0) or last (side 1) cell layer along cell axis
        ``d`` of a block (a view, the axis kept with length 1)."""
        ax = d - 2 * self.dim
        return u.narrow(ax, 0 if side == 0 else u.shape[ax] - 1, 1)

    # ------------------------------------------------------ the trace wire
    def boundary_traces(self, u: torch.Tensor, d: int = 0) -> dict:
        """The (value, gvec . grad_ref) traces of the first and last cell
        layer along cell axis ``d``: the payload a neighbouring slab needs
        (JAX ``DGLaplace.boundary_traces``).  ``{side: (u_trace,
        gn_trace)}``, side the face of this block (0 low, 1 high), each a
        trace array ``[..., C0, C1, C2, n, n]`` with cell axis ``d`` one
        layer long; only the two layers are evaluated."""
        dim, fd = self.dim, self.face[d]
        out = {}
        for s in (0, 1):
            uL = self._layer(u, d, s)
            vL = uL if self.is_collocation else sweep(uL, self.S, dim)
            tg = None
            for e in range(dim):
                term = fd["gvec"][e] * self._trace(
                    apply_1d(vL, self.D, self._node_axis(e)), d, s)
                tg = term if tg is None else tg + term
            out[s] = (self._trace(vL, d, s), tg)
        return out

    def boundary_coeff_planes(self, u: torch.Tensor, d: int = 0) -> dict:
        """The Hermite coefficient-form payload (JAX
        ``DGLaplace.boundary_coeff_planes``; the reference's FE_DGQHermite
        ghost packing, laplace_operator_dg.h:1017-1039): per side, the two
        coefficient planes of the boundary cell layer along cell axis
        ``d`` that carry the face value and the face normal derivative,
        ``{side: (c_val, c_der)}`` with cell axis ``d`` one layer long and
        node axis ``d`` removed.  A slice for the hermite kind, one 1-D
        change of basis along the normal for gauss and gll.  Degree >= 3
        (below it the Hermite-like basis is nodal and a face depends on
        every coefficient)."""
        if self.grid.degree < 3:
            raise ValueError("the coefficient-form wire needs degree >= 3 "
                             "(the Hermite-like end structure); use the "
                             "trace wire below")
        n, axis = self.n, self._node_axis(d)
        out = {}
        for s in (0, 1):
            uL = self._layer(u, d, s)
            if self._hermite_from_self is not None:
                uL = apply_1d(uL, self._hermite_from_self, axis)
            iv, ig = (0, 1) if s == 0 else (n - 1, n - 2)
            out[s] = (uL.select(axis, iv), uL.select(axis, ig))
        return out

    @cached_property
    def _hermite_from_self(self):
        """1-D change of basis, this element's coefficients -> Hermite-like
        ones (None for the hermite kind: its pack is a slice)."""
        maps = hermite_basis_change(self.grid)
        return None if maps is None else torch.as_tensor(
            maps[0], dtype=self.dtype, device=self.device)

    def traces_from_coeff_planes(self, planes, d: int):
        """The (value, gvec . grad_ref) face traces of
        :meth:`boundary_traces` from a coefficient-form payload ``(c_val,
        c_der)``: the Hermite end coefficients are the face value and the
        reference normal derivative; the tangential gradient components
        are derivatives of the value trace, taken here, never shipped."""
        c_val, c_der = planes
        dim, fd = self.dim, self.face[d]
        tan = [e for e in range(dim) if e != d]

        def tanpos(e):                     # node axis of a plane array
            return tan.index(e) - (dim - 1)

        tu, gnorm = c_val, c_der
        if not self.is_collocation:
            for e in tan:
                tu = apply_1d(tu, self.S, tanpos(e))
                gnorm = apply_1d(gnorm, self.S, tanpos(e))
        tg = fd["gvec"][d] * gnorm
        for e in tan:
            tg = tg + fd["gvec"][e] * apply_1d(tu, self.D, tanpos(e))
        return tu, tg

    # --------------------------------------------------------------- vmult
    def apply(self, u: torch.Tensor, ext=None) -> torch.Tensor:
        """y = A u (full SIP operator; reference
        common/laplace_operator_dg.h:963-1108).  ``ext``: optional
        ``{(d, side): (u_trace, gn_trace)}`` one-layer ghost traces of a
        neighbouring block (:meth:`boundary_traces` of its facing side),
        which replace the Dirichlet mirror at that edge."""
        ext = ext or {}
        dim = self.dim
        v = u if self.is_collocation else sweep(u, self.S, dim)
        g = [apply_1d(v, self.D, self._node_axis(d)) for d in range(dim)]
        acc = []
        for e in range(dim):
            t = None
            for f_ in range(dim):
                term = self.Gsym[e][f_] * g[f_]
                t = term if t is None else t + term
            acc.append(t * self.w_vol)
        vacc = torch.zeros_like(v)
        for d in range(dim):
            fd = self.face[d]
            tr_u = [self._trace(v, d, s) for s in (0, 1)]
            tr_gn = []
            for s in (0, 1):
                t = None
                for e in range(dim):
                    term = fd["gvec"][e] * self._trace(g[e], d, s)
                    t = term if t is None else t + term
                tr_gn.append(t)           # gvec . grad_ref, no sign yet
            wf = fd["jxw"] * self.wperp[d]
            for s in (0, 1):
                sign = 1.0 if s == 1 else -1.0
                u_m = tr_u[s]
                gn_m = sign * tr_gn[s]
                ext_u, ext_g = ext.get((d, s), (None, None))
                u_p = self._shift(tr_u[1 - s], -u_m, d, s, ext_u)
                gn_p = sign * self._shift(tr_gn[1 - s], tr_gn[s], d, s, ext_g)
                # the jump first: sigma u- and sigma u+ cancel on smooth u
                t_val, t_gr = self._flux(d, s, u_m - u_p, gn_m, gn_p)
                vacc = vacc + self._lift(t_val * wf, d, s)
                for e in range(dim):
                    acc[e] = acc[e] + self._lift(
                        t_gr * wf * (sign * fd["gvec"][e]), d, s)
        y = vacc
        for e in range(dim):
            y = y + apply_1d(acc[e], self.Dt, self._node_axis(e))
        return y if self.is_collocation else sweep(y, self.St, dim)

    @property
    def w_vol(self) -> torch.Tensor:
        """Weights of the volume term at the quadrature points."""
        return self.w3d

    def _flux(self, d, s, jump, gn_m, gn_p):
        """SIP flux on the faces (d, s): the value and gradient terms."""
        return (self.face[d]["sigma"] * jump - 0.5 * (gn_m + gn_p),
                -0.5 * jump)

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        return self.apply(u)

    def vmult_residual(self, rhs: torch.Tensor, lhs: torch.Tensor):
        return rhs - self.apply(lhs)

    def astype(self, dtype) -> "DGLaplace":
        """The same operator in another dtype (the exact per-cell
        ``JacobiTransformed`` probes in float64)."""
        return self if dtype == self.dtype else type(self)(self.grid, dtype,
                                                           self.device)

    # ----------------------------------------------------------------- rhs
    def compute_rhs(self, f_quad: torch.Tensor, g_bc=None) -> torch.Tensor:
        """b = (f, phi) from the values of f at the quadrature points
        ``[C0, C1, C2, q, q, q]``, plus the weak Dirichlet data ``g``:
        sum over the boundary faces of (g, sigma phi - n.grad phi), in the
        coefficient-weighted form (g, sigma c phi - c n.grad phi) on
        :class:`DGLaplaceVarCoeff`.  ``g_bc``: dict (d, side) -> the values
        of g at the face quadrature points (face-trace shape ``[C0, C1, C2,
        q, q]``, or broadcastable to it); only the boundary cell layer of
        each entry is read.  The DG solvers pass none: their right-hand side
        is the mass integral alone."""
        b = f_quad.to(self.dtype) * (self.w3d * self.detJ)
        if g_bc is None:
            return b if self.is_collocation else sweep(b, self.St, self.dim)
        vacc = b
        acc = [torch.zeros_like(b) for _ in range(self.dim)]
        for (d, s), gval in g_bc.items():
            fd = self.face[d]
            sign = 1.0 if s == 1 else -1.0
            wf = fd["jxw"] * self.wperp[d]
            shape = [1] * (2 * self.dim - 1)
            shape[d] = self.grid.cells[d]
            mask = torch.zeros(self.grid.cells[d], dtype=self.dtype,
                               device=self.device)
            mask[-1 if s == 1 else 0] = 1.0
            g = torch.as_tensor(gval, dtype=self.dtype,
                                device=self.device) * mask.reshape(shape)
            c_m = self._boundary_coeff(d, s)
            if c_m is not None:
                g = c_m * g
            vacc = vacc + self._lift(2.0 * fd["sigma"] * g * wf, d, s)
            for e in range(self.dim):
                acc[e] = acc[e] + self._lift(
                    -g * wf * (sign * fd["gvec"][e]), d, s)
        y = vacc
        for e in range(self.dim):
            y = y + apply_1d(acc[e], self.Dt, self._node_axis(e))
        return y if self.is_collocation else sweep(y, self.St, self.dim)

    def _boundary_coeff(self, d: int, s: int):
        """The coefficient's own trace on the faces (d, s) that weighs the
        weak Dirichlet data, or None (c = 1)."""
        return None

    # ------------------------------------------------------------ analysis
    def to_quad_values(self, u: torch.Tensor) -> torch.Tensor:
        return u if self.is_collocation else sweep(u, self.S, self.dim)

    def l2_sums(self, u: torch.Tensor, exact_quad: torch.Tensor):
        """``(sum (u - exact)^2 JxW, sum JxW)`` over the cells of ``u``
        (0-d tensors; a rank sums them over the ranks)."""
        uq = self.to_quad_values(u)
        jxw = self.w3d * self.detJ
        err = torch.sum((uq - exact_quad) ** 2 * jxw)
        vol = torch.sum(torch.broadcast_to(jxw, uq.shape))
        return err, vol

    def l2_error(self, u: torch.Tensor, exact_quad: torch.Tensor) -> torch.Tensor:
        err, vol = self.l2_sums(u, exact_quad)
        return torch.sqrt(err / vol)


class DGLaplaceVarCoeff(DGLaplace):
    """SIP-DG A·u of -div(c grad u), ``c > 0`` given at the quadrature
    points (block layout ``[C..., q...]``; twin of the JAX
    ``DGLaplaceVarCoeff``).  The face terms take arithmetic means::

        a(u,v) = sum_K (c grad u, grad v)_K
               - sum_F ( <{c du/dn}, [v]> + <{c dv/dn}, [u]>
                         - sigma_F <{c} [u], [v]> )

    with the Dirichlet mirror ``u+ = -u-``, ``c+ = c-``.  ``c`` is kept in
    the operator's dtype (``astype`` converts that copy, as the JAX twin
    does).  ``has_cell_data`` sends :class:`~.dg_precond.JacobiTransformed`
    to its exact per-cell path."""

    has_cell_data = True

    def __init__(self, grid: DGGrid, c_quad, dtype=torch.float32,
                 device="cuda"):
        super().__init__(grid, dtype, device)
        c = torch.as_tensor(c_quad if isinstance(c_quad, torch.Tensor)
                            else np.array(c_quad), dtype=dtype,
                            device=self.device)
        if tuple(c.shape) != grid.shape:
            raise ValueError(f"coefficient shape {tuple(c.shape)} != "
                             f"{grid.shape}")
        self.c = c
        self._c_w = c * self.w3d
        # per face (d, s): own and neighbour coefficient traces, the
        # neighbour's replicated across the boundary (c+ = c-)
        self._c_face = []
        for d in range(grid.dim):
            tr = [self._trace(c, d, s) for s in (0, 1)]
            self._c_face.append([(tr[s], self._shift(tr[1 - s], tr[s], d, s))
                                 for s in (0, 1)])

    def apply(self, u: torch.Tensor, ext=None) -> torch.Tensor:
        """y = A u; no ghost traces (``ext``): the coefficient's face
        traces would have to cross the wire too, as in the JAX twin."""
        if ext:
            raise ValueError("distributed halos are not wired for the "
                             "variable-coefficient DG operator")
        return super().apply(u)

    def astype(self, dtype) -> "DGLaplaceVarCoeff":
        return self if dtype == self.dtype else DGLaplaceVarCoeff(
            self.grid, self.c.to(dtype), dtype, self.device)

    @property
    def w_vol(self) -> torch.Tensor:
        return self._c_w

    def _boundary_coeff(self, d: int, s: int):
        return self._c_face[d][s][0]

    def _flux(self, d, s, jump, gn_m, gn_p):
        c_m, c_p = self._c_face[d][s]
        return (self.face[d]["sigma"] * 0.5 * (c_m + c_p) * jump
                - 0.5 * (c_m * gn_m + c_p * gn_p), -0.5 * c_m * jump)
