"""1-D tables for discontinuous (DG) tensor-product elements.

Copy of ``multigrid_tpu/core/dg_basis.py`` (numpy only; the port keeps its
own copy so that it never imports the JAX package).  Covers the reference's
three DG element types (reference common/laplace_operator_dg.h:369-385):

* type 0 ``hermite``: Hermite-like basis where face value/derivative depend
  on two coefficients per face (FE_DGQHermite) — enables 2-plane halo
  compression in the multi-chip path;
* type 1 ``gll``: nodal Gauss-Lobatto (FE_DGQ);
* type 2 ``gauss``: nodal on Gauss points = quadrature collocation
  (FE_DGQArbitraryNodes(QGauss)).

Also builds the 1-D SIP cell matrix with both-end interior-face penalty and
its generalized eigenbasis w.r.t. the 1-D mass matrix — the
``LocalBasisTransformer`` type-0 data used by the transformed Jacobi
preconditioner (reference common/laplace_operator_dg.h:180-246).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .quadrature import gauss, gauss_lobatto, lagrange_derivatives, lagrange_values

HERMITE = "hermite"
GLL = "gll"
GAUSS = "gauss"
DG_TYPES = (HERMITE, GLL, GAUSS)


def _hermite_like_basis(degree: int) -> np.ndarray:
    """Coefficient matrix B[i, k] of basis polynomial i in the monomial basis
    x^k, with Hermite-like end conditions: basis 0/1 control value/derivative
    at x=0, basis n-2/n-1 at x=1, interior functions vanish to 2nd order at
    both ends (deal.II polynomials::HermiteLikeInterpolation role)."""
    n = degree + 1
    if degree < 3:
        # fall back to GLL nodal for very low degree (as deal.II does)
        nodes, _ = gauss_lobatto(n) if degree > 0 else (np.array([0.5]), None)
        B = np.zeros((n, n))
        for i in range(n):
            vals = np.zeros(n)
            vals[i] = 1.0
            B[i] = np.polynomial.polynomial.polyfit(nodes, vals, degree)
        return B
    # constraint matrix: rows = conditions on polynomial coefficients
    # conditions: p(0), p'(0), p(1), p'(1), and (n-4) interior moments
    mono = np.eye(n)  # coefficient space
    conds = []
    k = np.arange(n)
    conds.append((0.0 ** k))                     # p(0)
    d0 = np.zeros(n)
    d0[1] = 1.0
    conds.append(d0)                              # p'(0)
    conds.append(np.ones(n))                     # p(1)
    conds.append(k.astype(float))                # p'(1)
    # interior conditions: values at interior GLL points of degree-4 rule
    if n > 4:
        pts, _ = gauss(n - 4)
        for x in pts:
            conds.append(x ** k)
    Cmat = np.asarray(conds)
    # basis i defined by unit condition i: B rows solve Cmat @ coeffs = e_i
    B = np.linalg.solve(Cmat, np.eye(n)).T
    # reorder: [p(0), p'(0), interior..., p'(1), p(1)] so the two
    # face-relevant coefficients per side sit at the array ends
    order = [0, 1] + list(range(4, n)) + [3, 2]
    return B[order]


@dataclass(frozen=True)
class DGBasis1D:
    degree: int
    kind: str
    quad_points: np.ndarray   # (nq,) Gauss points on [0,1], nq = degree+1
    quad_weights: np.ndarray
    S: np.ndarray             # (nq, n) basis values at quad points
    S_inv: np.ndarray         # (n, nq) quad(collocation) -> basis coefficients
    D_col: np.ndarray         # (nq, nq) collocation derivative
    f0: np.ndarray            # (nq,) value-at-0 from collocation values
    f1: np.ndarray            # (nq,)
    d0: np.ndarray            # (nq,) derivative-at-0 from collocation values
    d1: np.ndarray            # (nq,)
    M: np.ndarray             # (n, n) 1-D mass matrix
    E0: np.ndarray            # (n, n) coarse coeffs -> child-0 coeffs
    E1: np.ndarray            # (n, n) coarse coeffs -> child-1 coeffs
    sip_1d: np.ndarray        # (n, n) 1-D SIP cell matrix (interior faces both ends)
    eigvals: np.ndarray       # (n,) generalized eigenvalues of sip vs mass
    T: np.ndarray             # (n, n) eigenvectors (columns), T^T M T = I
    nodal_from_gll: np.ndarray  # (n, n) GLL-nodal coeffs -> this basis coeffs

    @property
    def n(self) -> int:
        return self.degree + 1


@lru_cache(maxsize=None)
def make_dg_basis(degree: int, kind: str = GAUSS) -> DGBasis1D:
    assert kind in DG_TYPES
    n = degree + 1
    qp, qw = gauss(n)

    def poly_eval(B, pts, deriv=0):
        out = np.zeros((pts.size, n))
        for i in range(n):
            c = np.polynomial.polynomial.Polynomial(B[i])
            out[:, i] = c.deriv(deriv)(pts) if deriv else c(pts)
        return out

    if kind == GAUSS:
        S = np.eye(n)
        gll_nodes, _ = gauss_lobatto(n) if degree > 0 else (np.array([0.5]), None)
        # coefficients in the Gauss-nodal basis of a function given by GLL
        # values: coeff_i = u(qp_i) = sum_j u_gll_j l^gll_j(qp_i)
        nodal_from_gll = lagrange_values(gll_nodes, qp)
    elif kind == GLL:
        nodes, _ = gauss_lobatto(n) if degree > 0 else (np.array([0.5]), None)
        S = lagrange_values(nodes, qp)
        nodal_from_gll = np.eye(n)
    else:  # hermite-like
        B = _hermite_like_basis(degree)
        S = poly_eval(B, qp)
        gll_nodes, _ = gauss_lobatto(n)
        # GLL values -> hermite coefficients: solve S_h(gll) c = u(gll)
        Sh_at_gll = poly_eval(B, gll_nodes)
        nodal_from_gll = np.linalg.inv(Sh_at_gll)

    S_inv = np.linalg.inv(S)
    D_col = lagrange_derivatives(qp, qp)
    # 2:1 child embeddings: coarse poly evaluated at the child's quad points,
    # converted back to coefficients (the DG analogue of MGTransferMatrixFree,
    # no node sharing so no valence weights needed)
    if kind == GAUSS:
        Vq0 = lagrange_values(qp, qp * 0.5)
        Vq1 = lagrange_values(qp, 0.5 + qp * 0.5)
    elif kind == GLL:
        nodes_, _ = gauss_lobatto(n) if degree > 0 else (np.array([0.5]), None)
        Vq0 = lagrange_values(nodes_, qp * 0.5)
        Vq1 = lagrange_values(nodes_, 0.5 + qp * 0.5)
    else:
        B = _hermite_like_basis(degree)
        order_fix = B  # already reordered
        Vq0 = poly_eval(order_fix, qp * 0.5)
        Vq1 = poly_eval(order_fix, 0.5 + qp * 0.5)
    E0 = S_inv @ Vq0
    E1 = S_inv @ Vq1
    f0 = lagrange_values(qp, np.array([0.0]))[0]
    f1 = lagrange_values(qp, np.array([1.0]))[0]
    d0 = lagrange_derivatives(qp, np.array([0.0]))[0]
    d1 = lagrange_derivatives(qp, np.array([1.0]))[0]

    M = np.einsum("q,qi,qj->ij", qw, S, S)
    # 1-D SIP matrix with interior-face terms on both ends, penalty (p+1)^2
    # (reference common/laplace_operator_dg.h:180-222, penalty_factor=1).
    # Basis derivative values at quad points: D_col @ S.
    Sg = D_col @ S
    L = np.einsum("q,qi,qj->ij", qw, Sg, Sg)
    penalty = float(n * n)
    b0 = f0 @ S   # basis values at 0
    b1 = f1 @ S
    g0 = d0 @ S   # basis derivatives at 0
    g1 = d1 @ S
    sip = (
        L
        + penalty * (np.outer(b0, b0) + np.outer(b1, b1))
        + 0.5 * (np.outer(g0, b0) + np.outer(b0, g0))
        - 0.5 * (np.outer(g1, b1) + np.outer(b1, g1))
    )
    # generalized symmetric eigenproblem sip v = lambda M v without scipy:
    # Cholesky M = R^T R, solve standard problem on R^{-T} sip R^{-1}
    R = np.linalg.cholesky(M).T
    Rinv = np.linalg.inv(R)
    Astd = Rinv.T @ sip @ Rinv
    w, V = np.linalg.eigh(Astd)
    T = Rinv @ V
    return DGBasis1D(
        degree=degree,
        kind=kind,
        quad_points=qp,
        quad_weights=qw,
        S=S,
        S_inv=S_inv,
        D_col=D_col,
        f0=f0,
        f1=f1,
        d0=d0,
        d1=d1,
        M=M,
        E0=E0,
        E1=E1,
        sip_1d=sip,
        eigvals=w,
        T=T,
        nodal_from_gll=nodal_from_gll,
    )
