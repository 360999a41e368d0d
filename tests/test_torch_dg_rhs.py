"""The weak Dirichlet data of the DG right-hand side against the JAX
package, on the CPU.

* ``DGLaplace.compute_rhs(f_quad, g_bc)`` and the coefficient-weighted
  ``DGLaplaceVarCoeff.compute_rhs`` against their JAX twins
  (``multigrid_tpu/ops/dg.py``), to 1e-12 of max|b| in f64, in 2-D and 3-D,
  every kind, on sheared grids; without ``g_bc`` the mass integral alone,
  as before.
* The rate of tests/test_dg_operator.py ``test_dg_mms_convergence`` with
  the port: dense solves of the SIP system with inhomogeneous weak
  Dirichlet data converge faster than p + 0.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.ops import dg as j_dg
from multigrid_tpu_torch.ops import dg as t_dg

jax.config.update("jax_enable_x64", True)

KINDS = ["hermite", "gll", "gauss"]
# (cells, degree, shear): 2-D and 3-D, an axis of one cell
GRIDS = [((3, 2), 3, 0.12), ((2, 3, 2), 2, 0.07), ((1, 2, 3), 3, 0.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_grid(cls, cells, degree, kind, shear=0.0, h=None):
    dim = len(cells)
    J = np.diag(h or [1.0 / c for c in cells])
    if shear:
        T = np.eye(dim) + shear * np.outer(np.arange(1, dim + 1),
                                           np.arange(1, dim + 1))
        J = T @ J
    return cls(cells=tuple(cells), jacobian=tuple(tuple(r) for r in J),
               degree=degree, kind=kind)


def rhs_inputs(grid, seed):
    """f at the quadrature points, the coefficient c > 0, and g on every
    boundary face (face-trace arrays over all cells: ``compute_rhs`` reads
    only the boundary layer)."""
    rng = np.random.default_rng(seed)
    dim = grid.dim
    f = rng.standard_normal(grid.shape)
    c = 1.0 + rng.random(grid.shape)
    trace = grid.cells + (grid.n,) * (dim - 1)
    g_bc = {(d, s): rng.standard_normal(trace)
            for d in range(dim) for s in (0, 1)}
    return f, c, g_bc


def both_ops(cells, degree, kind, shear, var_coeff, c):
    jg = make_grid(j_dg.DGGrid, cells, degree, kind, shear)
    tg = make_grid(t_dg.DGGrid, cells, degree, kind, shear)
    if var_coeff:
        return (j_dg.DGLaplaceVarCoeff(jg, c, jnp.float64),
                t_dg.DGLaplaceVarCoeff(tg, c, torch.float64, "cpu"))
    return (j_dg.DGLaplace(jg, jnp.float64),
            t_dg.DGLaplace(tg, torch.float64, "cpu"))


@pytest.mark.parametrize("var_coeff", [False, True],
                         ids=["constant", "var_coeff"])
@pytest.mark.parametrize("cells,degree,shear", GRIDS)
@pytest.mark.parametrize("kind", KINDS)
def test_compute_rhs_weak_dirichlet_matches_jax(kind, cells, degree, shear,
                                                var_coeff):
    grid = make_grid(t_dg.DGGrid, cells, degree, kind, shear)
    f, c, g_bc = rhs_inputs(grid, 31)
    jop, top = both_ops(cells, degree, kind, shear, var_coeff, c)
    want = np.asarray(jop.compute_rhs(
        jnp.asarray(f), {k: jnp.asarray(v) for k, v in g_bc.items()}))
    got = top.compute_rhs(torch.as_tensor(f), g_bc).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
    # one face alone, given as a tensor that broadcasts over the face
    # points (the shape the curved operator's callers pass)
    one = {(0, 1): g_bc[(0, 1)][..., :1]}
    want1 = np.asarray(jop.compute_rhs(
        jnp.asarray(f), {k: jnp.asarray(v) for k, v in one.items()}))
    got1 = top.compute_rhs(torch.as_tensor(f),
                           {k: torch.as_tensor(v) for k, v in one.items()})
    np.testing.assert_allclose(got1.numpy(), want1, rtol=0,
                               atol=1e-12 * np.abs(want1).max())
    # no data: the mass integral alone, the JAX twin's value
    want0 = np.asarray(jop.compute_rhs(jnp.asarray(f)))
    got0 = top.compute_rhs(torch.as_tensor(f)).numpy()
    np.testing.assert_allclose(got0, want0, rtol=0,
                               atol=1e-12 * np.abs(want0).max())


@pytest.mark.parametrize("kind", ["gauss", "hermite"])
def test_dg_mms_convergence_with_weak_dirichlet_data(kind):
    """tests/test_dg_operator.py:84-128 on the port: dense solves of the
    SIP system with the weak Dirichlet data of a smooth solution that is
    not zero on the boundary converge at p + 1 (above p + 0.5)."""
    degree = 2
    errs = []

    def exact(x, y):
        return np.sin(2.1 * x + 0.3) * np.cos(1.7 * y - 0.2)

    for nc in (2, 4):
        grid = make_grid(t_dg.DGGrid, (nc, nc), degree, kind,
                         h=[0.9 / nc, 1.1 / nc])
        op = t_dg.DGLaplace(grid, torch.float64, "cpu")
        N = grid.n_dofs
        eye = torch.eye(N, dtype=torch.float64).reshape((N,) + grid.shape)
        A = op.apply(eye).reshape(N, N).T.numpy()
        b = grid.basis
        hx, hy = 0.9 / nc, 1.1 / nc
        qx = np.arange(nc)[:, None] * hx + hx * b.quad_points[None, :]
        qy = np.arange(nc)[:, None] * hy + hy * b.quad_points[None, :]
        X, Y = qx[:, None, :, None], qy[None, :, None, :]
        f_quad = np.broadcast_to((2.1**2 + 1.7**2) * exact(X, Y), grid.shape)
        g_bc = {}
        for d, s in [(0, 0), (0, 1), (1, 0), (1, 1)]:
            if d == 0:
                xv = np.full((nc, nc, grid.n), 0.0 if s == 0 else 0.9)
                yv = np.broadcast_to(qy[None, :, :], (nc, nc, grid.n))
            else:
                xv = np.broadcast_to(qx[:, None, :], (nc, nc, grid.n))
                yv = np.full((nc, nc, grid.n), 0.0 if s == 0 else 1.1)
            g_bc[(d, s)] = exact(xv, yv)
        rhs = op.compute_rhs(torch.as_tensor(np.array(f_quad)),
                             g_bc)
        u = np.linalg.solve(A, rhs.numpy().reshape(-1)).reshape(grid.shape)
        ex = torch.as_tensor(np.array(
            np.broadcast_to(exact(X, Y), grid.shape)))
        errs.append(float(op.l2_error(torch.as_tensor(u), ex)))
    rate = np.log2(errs[0] / errs[1])
    assert rate > degree + 0.5, (errs, rate)
