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
errors.  Not ported yet, for want of a caller: the weak Dirichlet data of
``compute_rhs``, ``DGLaplaceVarCoeff`` and the multi-device trace wire.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ..core.dg_basis import GAUSS, DGBasis1D, make_dg_basis
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
        self.wperp = [t(np.outer(*[qw for e in range(self.dim) if e != d]))
                      for d in range(self.dim)]

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

    def _shift(self, tr_opp, edge, d, side):
        """The neighbour's trace across face (d, side): the opposite-side
        trace of the next cell along cell axis d, ``edge`` at the domain
        boundary."""
        ax = d - 2 * self.dim + 1          # cell axis d of a trace array
        C = tr_opp.shape[ax]
        if side == 1:
            return torch.cat([tr_opp.narrow(ax, 1, C - 1),
                              edge.narrow(ax, C - 1, 1)], dim=ax)
        return torch.cat([edge.narrow(ax, 0, 1), tr_opp.narrow(ax, 0, C - 1)],
                         dim=ax)

    # --------------------------------------------------------------- vmult
    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """y = A u (full SIP operator; reference
        common/laplace_operator_dg.h:963-1108)."""
        dim = self.dim
        v = u if self.is_collocation else sweep(u, self.S, dim)
        g = [apply_1d(v, self.D, self._node_axis(d)) for d in range(dim)]
        acc = []
        for e in range(dim):
            t = None
            for f_ in range(dim):
                term = self.Gsym[e][f_] * g[f_]
                t = term if t is None else t + term
            acc.append(t * self.w3d)
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
                u_p = self._shift(tr_u[1 - s], -u_m, d, s)
                gn_p = sign * self._shift(tr_gn[1 - s], tr_gn[s], d, s)
                # the jump first: sigma u- and sigma u+ cancel on smooth u
                jump = u_m - u_p
                t_val = fd["sigma"] * jump - 0.5 * (gn_m + gn_p)
                t_gr = -0.5 * jump
                vacc = vacc + self._lift(t_val * wf, d, s)
                for e in range(dim):
                    acc[e] = acc[e] + self._lift(
                        t_gr * wf * (sign * fd["gvec"][e]), d, s)
        y = vacc
        for e in range(dim):
            y = y + apply_1d(acc[e], self.Dt, self._node_axis(e))
        return y if self.is_collocation else sweep(y, self.St, dim)

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        return self.apply(u)

    def vmult_residual(self, rhs: torch.Tensor, lhs: torch.Tensor):
        return rhs - self.apply(lhs)

    # ----------------------------------------------------------------- rhs
    def compute_rhs(self, f_quad: torch.Tensor) -> torch.Tensor:
        """b = (f, phi) from the values of f at the quadrature points
        ``[C0, C1, C2, q, q, q]`` (no weak boundary data: the DG solver's
        right-hand side is the mass integral alone)."""
        b = f_quad.to(self.dtype) * (self.w3d * self.detJ)
        return b if self.is_collocation else sweep(b, self.St, self.dim)

    # ------------------------------------------------------------ analysis
    def to_quad_values(self, u: torch.Tensor) -> torch.Tensor:
        return u if self.is_collocation else sweep(u, self.S, self.dim)

    def l2_error(self, u: torch.Tensor, exact_quad: torch.Tensor) -> torch.Tensor:
        uq = self.to_quad_values(u)
        jxw = self.w3d * self.detJ
        err = torch.sum((uq - exact_quad) ** 2 * jxw)
        vol = torch.sum(torch.broadcast_to(jxw, uq.shape))
        return torch.sqrt(err / vol)
