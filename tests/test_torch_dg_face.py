"""The port's face-based SIP-DG oracle (``ops/dg_face.py``) on the CPU.

* Against the JAX ``DGLaplaceFaceBased`` and against the port's fused
  ``DGLaplace``, in f64 at 1e-12·max|y|: hermite, gll and gauss, the
  sheared (3, 2, 4) p = 3 grid of tests/test_dg_face.py, the sheared grids
  of tests/test_pallas_dg.py with one-cell axes; in 2-D against the JAX
  operator alone (the port's fused operator is 3-D).
* Symmetric and positive definite, assembled column by column.
* ``dg_cheb_plain`` with A taken from the face-based operator against the
  step with the fused one on the smoother's iterates (the inputs on which
  the card checks ``dg_cheb<float>``), at 1e-12·max|out|.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.ops import dg as j_dg
from multigrid_tpu.ops.dg_face import DGLaplaceFaceBased as JFace
from multigrid_tpu_torch.ops import dg as t_dg
from multigrid_tpu_torch.ops import dg_kernel as dk
from multigrid_tpu_torch.ops.dg_face import DGLaplaceFaceBased
from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed

jax.config.update("jax_enable_x64", True)

KINDS = ["hermite", "gll", "gauss"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sheared_07(dim):
    """The cell map of tests/test_dg_face.py: 0.7 I with J[0, 1] = 0.21."""
    J = np.eye(dim) * 0.7
    J[0, 1] = 0.21
    return tuple(map(tuple, J))


def sheared_rand(cells, seed=0):
    """The sheared affine map of tests/test_pallas_dg.py:20-25."""
    rng = np.random.default_rng(seed)
    J = np.diag(1.0 / np.array(cells)) @ (np.eye(3) + 0.08 * rng.random((3, 3)))
    return tuple(map(tuple, J))


# (cells, degree, jacobian)
GRIDS = {
    "face_3d": ((3, 2, 4), 3, sheared_07(3)),
    "face_2d": ((3, 2), 3, sheared_07(2)),
    "one_cell_x": ((2, 3, 1), 2, sheared_rand((2, 3, 1))),
    "one_cell_z": ((1, 2, 3), 4, sheared_rand((1, 2, 3))),
    "one_cell": ((1, 1, 1), 3, sheared_rand((1, 1, 1))),
}


def grids(name, kind):
    cells, p, jac = GRIDS[name]
    return (j_dg.DGGrid(cells=cells, jacobian=jac, degree=p, kind=kind),
            t_dg.DGGrid(cells=cells, jacobian=jac, degree=p, kind=kind))


def rel_err(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max()


@pytest.mark.parametrize("name", sorted(GRIDS))
@pytest.mark.parametrize("kind", KINDS)
def test_face_based_matches_jax_and_fused(kind, name):
    gj, gt = grids(name, kind)
    u = np.random.default_rng(3).standard_normal(gt.shape)
    want = np.asarray(JFace(gj, jnp.float64).vmult(jnp.asarray(u)))
    face = DGLaplaceFaceBased(gt, torch.float64, "cpu")
    y = face.vmult(torch.as_tensor(u)).numpy()
    assert rel_err(y, want) < 1e-12
    if gt.dim == 3:      # the port's fused operator is 3-D
        fused = t_dg.DGLaplace(gt, torch.float64, "cpu").apply(
            torch.as_tensor(u))
        assert rel_err(y, fused.numpy()) < 1e-12
    b = np.random.default_rng(4).standard_normal(gt.shape)
    r = face.vmult_residual(torch.as_tensor(b), torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(r, b - want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("cells,J,kind", [
    ((2, 3), ((0.5, 0.0), (0.0, 0.8)), "gauss"),
    ((2, 1, 2), sheared_rand((2, 1, 2)), "hermite")])
def test_face_based_symmetric_and_positive(cells, J, kind):
    """Structural checks not routed through any other operator: the SIP
    form is symmetric, and positive definite at this penalty."""
    grid = t_dg.DGGrid(cells=cells, jacobian=J, degree=2, kind=kind)
    face = DGLaplaceFaceBased(grid, torch.float64, "cpu")
    N = grid.n_dofs
    eye = torch.eye(N, dtype=torch.float64).reshape((N,) + grid.shape)
    cols = torch.stack([face.vmult(e).reshape(-1) for e in eye], dim=1).numpy()
    assert np.abs(cols - cols.T).max() < 1e-12 * np.abs(cols).max()
    assert np.linalg.eigvalsh(0.5 * (cols + cols.T)).min() > 0


@pytest.mark.parametrize("name", ["face_3d", "one_cell_x", "one_cell_z"])
@pytest.mark.parametrize("kind", KINDS)
def test_dg_cheb_plain_through_face_based(kind, name):
    """One Chebyshev step with A from the face-based operator against the
    step with the fused one, on the smoother's iterates, with and without
    x and x_old."""
    _, gt = grids(name, kind)
    op = dk.DGOperator(gt, torch.float64, "cpu")
    op.install_jacobi(JacobiTransformed(gt, torch.float64, "cpu"))
    face_op = types.SimpleNamespace(
        plain=DGLaplaceFaceBased(gt, torch.float64, "cpu"), jacobi=op.jacobi)
    b, x, xo = (t.double() for t in dk.smoother_iterates(op.jacobi, 5))
    for args in ((x, xo, 0.37, 0.81), (None, None, 0.0, 0.81),
                 (x, None, 0.0, 0.5)):
        want = dk.dg_cheb_plain(b, *args[:2], op, *args[2:])
        got = dk.dg_cheb_plain(b, *args[:2], face_op, *args[2:])
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
