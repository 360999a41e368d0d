"""Face-based SIP-DG Laplace operator: the independent oracle of the DG
kernels.

Twin of ``multigrid_tpu/ops/dg_face.py`` ``DGLaplaceFaceBased`` (the
reference's ``MFReference::LaplaceOperatorFaceBased``,
common/laplace_operator_dg_face.h:19-166): a separate cell term, then a
loop over the faces in which each face, interior or boundary, is evaluated
ONCE and its flux lifted into both cells beside it.  The fused operator of
:mod:`.dg` visits every interior face twice, once from each cell, so the
two share no face algebra.  ``csrc/dg_pencil.cuh`` evaluates the faces inside
a block's pencil of cells once, as here; this module is the CPU mirror of
that algebra.

Bilinear form per face with the fixed normal ``+e_d`` of the minus (lower)
cell::

    sigma [u][v] - {n.grad u}[v] - [u]{n.grad v},   [u] = u- - u+

The Dirichlet boundary uses the mirror ``u+ = -u-``, ``n.grad u+ =
n.grad u-``; penalty ``sigma = (p+1)^2 |n J^-1|`` (:func:`.dg.dg_geometry`).
Vectors are blocks ``[C..., n...]`` (no batch axes).
"""

from __future__ import annotations

import torch

from ..core.dg_basis import GAUSS
from ..devices import resolve
from .dg import DGGrid, dg_geometry, sweep
from .laplace import apply_1d


class DGLaplaceFaceBased:
    """SIP-DG A·u as a cell term plus a once-per-face loop, plain PyTorch."""

    def __init__(self, grid: DGGrid, dtype=torch.float64, device="cuda"):
        self.grid = grid
        self.dtype = dtype
        self.device = resolve(device)
        self.dim, self.n = grid.dim, grid.n
        b = grid.basis
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
        self.S, self.St = t(b.S), t(b.S.T.copy())
        self.D, self.Dt = t(b.D_col), t(b.D_col.T.copy())
        self.f = [t(b.f0), t(b.f1)]
        self.is_collocation = grid.kind == GAUSS
        geo = dg_geometry(grid)
        self.Gsym, self.face = geo["Gsym"], geo["face"]
        qw = t(b.quad_weights)
        self.w3d = qw
        for _ in range(self.dim - 1):
            self.w3d = self.w3d[..., None] * qw
        # weights of the face quadrature of direction d: the other axes'
        self.wperp = []
        for d in range(self.dim):
            w = torch.ones((), dtype=dtype, device=self.device)
            for _ in range(self.dim - 1):
                w = w[..., None] * qw
            self.wperp.append(w)

    def _trace(self, a, d, side):
        """Node axis d contracted with the face vector: ``[C..., n^(dim-1)]``."""
        return torch.tensordot(a, self.f[side], dims=([self.dim + d], [0]))

    def _lift(self, t, d, side):
        """Adjoint of :meth:`_trace`."""
        vec = self.f[side].reshape((self.n,) + (1,) * (self.dim - 1 - d))
        return t.unsqueeze(self.dim + d) * vec

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        dim = self.dim
        v = u if self.is_collocation else sweep(u, self.S, dim)
        g = [apply_1d(v, self.D, dim + e) for e in range(dim)]
        # cell term (laplace_operator_dg_face.h:35-45)
        acc = [sum(self.Gsym[e][k] * g[k] for k in range(dim)) * self.w3d
               for e in range(dim)]
        vacc = torch.zeros_like(v)
        # faces: the C_d + 1 faces of direction d, each once
        for d in range(dim):
            fg = self.face[d]
            t_lo, t_hi = self._trace(v, d, 0), self._trace(v, d, 1)
            gn_lo = sum(fg["gvec"][e] * self._trace(g[e], d, 0)
                        for e in range(dim))
            gn_hi = sum(fg["gvec"][e] * self._trace(g[e], d, 1)
                        for e in range(dim))
            C = self.grid.cells[d]
            # face k: minus side from cell k - 1, plus side from cell k; the
            # Dirichlet mirror stands in for the missing cell at either end
            first, last = t_lo.narrow(d, 0, 1), t_hi.narrow(d, C - 1, 1)
            um = torch.cat([-first, t_hi], dim=d)
            up = torch.cat([t_lo, -last], dim=d)
            gm = torch.cat([gn_lo.narrow(d, 0, 1), gn_hi], dim=d)
            gp = torch.cat([gn_lo, gn_hi.narrow(d, C - 1, 1)], dim=d)
            jump = um - up           # before any scaling
            wf = fg["jxw"] * self.wperp[d]
            flux_val = (fg["sigma"] * jump - 0.5 * (gm + gp)) * wf
            flux_grad = (-0.5 * jump) * wf
            # each face lifted into both cells: +[v] at the minus cell's high
            # face, -[v] at the plus cell's low face; {n.grad v} adds
            # flux_grad gvec to both cells' gradient accumulators
            vacc = (vacc + self._lift(flux_val.narrow(d, 1, C), d, 1)
                    - self._lift(flux_val.narrow(d, 0, C), d, 0))
            to_minus, to_plus = flux_grad.narrow(d, 1, C), flux_grad.narrow(d, 0, C)
            for e in range(dim):
                acc[e] = (acc[e] + self._lift(to_minus * fg["gvec"][e], d, 1)
                          + self._lift(to_plus * fg["gvec"][e], d, 0))
        y = vacc
        for e in range(dim):
            y = y + apply_1d(acc[e], self.Dt, dim + e)
        return y if self.is_collocation else sweep(y, self.St, dim)

    apply = vmult

    def vmult_residual(self, rhs: torch.Tensor, lhs: torch.Tensor):
        return rhs - self.vmult(lhs)
