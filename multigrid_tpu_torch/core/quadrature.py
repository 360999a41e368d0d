"""1-D quadrature rules and node sets (fp64 numpy, setup-time only).

Copy of ``multigrid_tpu/core/quadrature.py``: replacement for deal.II's ``QGauss<1>`` / FE_Q Gauss-Lobatto
support points as used by the reference (e.g.
reference common/multigrid_solver.h:160 uses ``QGauss<1>(fe_degree+1)``;
FE_Q nodal points are Gauss-Lobatto).
"""

from __future__ import annotations

import numpy as np


def gauss(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre points/weights on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def gauss_lobatto(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Lobatto-Legendre points/weights on [0, 1] (n >= 2).

    Interior points are the roots of P'_{n-1}; weights
    w_i = 2 / (n (n-1) P_{n-1}(x_i)^2) on [-1, 1].
    """
    if n < 2:
        raise ValueError("Gauss-Lobatto needs at least 2 points")
    if n == 2:
        x = np.array([-1.0, 1.0])
    else:
        # roots of derivative of Legendre polynomial P_{n-1}
        leg = np.polynomial.legendre.Legendre.basis(n - 1)
        dleg = leg.deriv()
        x = np.sort(dleg.roots().real)
        x = np.concatenate([[-1.0], x, [1.0]])
    pn = np.polynomial.legendre.Legendre.basis(n - 1)(x)
    w = 2.0 / (n * (n - 1) * pn**2)
    return 0.5 * (x + 1.0), 0.5 * w


def lagrange_values(nodes: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Matrix S[a, i] = l_i(points[a]) of Lagrange basis on ``nodes``.

    Barycentric form for numerical stability at high degree (the reference
    supports degrees up to 16, reference matvec_dg/program.cc:34-35).
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    points = np.asarray(points, dtype=np.float64)
    n = nodes.size
    # barycentric weights
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    bw = 1.0 / diff.prod(axis=1)
    out = np.zeros((points.size, n))
    for a, x in enumerate(points):
        d = x - nodes
        exact = np.nonzero(np.abs(d) < 1e-14)[0]
        if exact.size:
            out[a, exact[0]] = 1.0
        else:
            t = bw / d
            out[a] = t / t.sum()
    return out


def lagrange_derivatives(nodes: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Matrix D[a, i] = l_i'(points[a]) of Lagrange basis on ``nodes``."""
    nodes = np.asarray(nodes, dtype=np.float64)
    points = np.asarray(points, dtype=np.float64)
    n = nodes.size
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    bw = 1.0 / diff.prod(axis=1)
    # derivative matrix on the node set itself (standard formulas)
    dnode = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                dnode[i, j] = (bw[j] / bw[i]) / (nodes[i] - nodes[j])
        dnode[i, i] = -np.sum(dnode[i, np.arange(n) != i])
    # values of l_j' at arbitrary points via l_j'(x) = sum_k dnode[k,j] l_k(x)?
    # That identity holds only on the nodes. Use direct differentiation of the
    # barycentric form instead:
    out = np.zeros((points.size, n))
    for a, x in enumerate(points):
        d = x - nodes
        exact = np.nonzero(np.abs(d) < 1e-14)[0]
        if exact.size:
            out[a] = dnode[exact[0]]
        else:
            t = bw / d
            s = t.sum()
            l = t / s
            # derivative of l_j = l_j * (sum_k l_k/(x-x_k) - 1/(x-x_j))
            inv = 1.0 / d
            common = np.dot(l, inv)
            out[a] = l * (common - inv)
    return out
