"""1-D reference-element tables for tensor-product FE_Q / FE_DGQ elements.

Counterpart of the tables that deal.II's ``FEEvaluation`` /
``MGTransferMatrixFree`` keep internally and that the reference's even-odd
kernel consumes (reference common/matrix_vector_kernel.h:30-216).  A copy
of ``multigrid_tpu/core/basis.py`` (numpy only), so that the PyTorch port
never imports the JAX package; the CUDA brick kernel reads its 1-D ``M``
and ``L`` tables from here.

All tables are fp64 numpy, computed once at setup.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .quadrature import gauss, gauss_lobatto, lagrange_derivatives, lagrange_values


@dataclass(frozen=True)
class Basis1D:
    """Tables for degree-p Lagrange elements with (p+1)-point Gauss quadrature.

    Mirrors the information in deal.II's shape-info used at
    reference common/laplace_operator.h:535-557 (evaluate/integrate
    gradients) and reference common/multigrid_solver.h:160.
    """

    degree: int
    nodes: np.ndarray          # (n,) Gauss-Lobatto support points on [0,1]
    quad_points: np.ndarray    # (n,) Gauss points on [0,1]
    quad_weights: np.ndarray   # (n,)
    S: np.ndarray              # (nq, n) values of node basis at quad points
    D: np.ndarray              # (nq, n) derivatives of node basis at quad points
    D_col: np.ndarray          # (nq, nq) collocation derivative on quad points
    P: np.ndarray              # (2p+1, n) two-child embedding (prolongation)
    M: np.ndarray              # (n, n) 1-D mass matrix (exact for degree p)
    L: np.ndarray              # (n, n) 1-D stiffness matrix on [0,1]

    @property
    def n(self) -> int:
        return self.degree + 1


@lru_cache(maxsize=None)
def make_basis(degree: int) -> Basis1D:
    n = degree + 1
    nodes, _ = gauss_lobatto(n) if degree > 0 else (np.array([0.5]), np.array([1.0]))
    qp, qw = gauss(n)
    S = lagrange_values(nodes, qp)
    D = lagrange_derivatives(nodes, qp)
    # collocation derivative on the Gauss points: D_col = D @ S^{-1}; equal to
    # the Lagrange derivative matrix of the Gauss-point basis.
    D_col = lagrange_derivatives(qp, qp)
    # 2:1 embedding: coarse cell [0,1] split into [0,.5],[.5,1]; fine nodes of
    # the two children form 2p+1 unique points (tensorized by
    # deal.II MGTransferMatrixFree, see SURVEY.md section 2.2).
    fine_pts = np.concatenate([nodes * 0.5, 0.5 + nodes[1:] * 0.5])
    P = lagrange_values(nodes, fine_pts)
    M = np.einsum("q,qi,qj->ij", qw, S, S)
    L = np.einsum("q,qi,qj->ij", qw, D, D)
    return Basis1D(
        degree=degree,
        nodes=nodes,
        quad_points=qp,
        quad_weights=qw,
        S=S,
        D=D,
        D_col=D_col,
        P=P,
        M=M,
        L=L,
    )
