"""The port's ``LaplaceOperator`` with a full symmetric coefficient
(``multigrid_tpu_torch.ops.laplace.SymCoef``), against the JAX
``LaplaceOperator(..., SymCoef)`` and the port's ``DiagCoef`` path.

Twin of tests/test_laplace_operator.py:44 (``test_sym_coef_matches_diag``:
the ``SymCoef`` that holds the affine diagonal gives the ``DiagCoef``
operator, to 1e-11), plus a random symmetric positive-definite tensor a
quadrature point, made with numpy from a seed in the JAX package's
interleaved layout and handed to the port through
``convert.sym_coef_from_jax``: ``vmult`` and ``inverse_diagonal`` equal
the JAX operator's to 1e-12 of the largest value, on 2 x 2 cells at p = 3
and 2 x 2 x 2 cells at p = 2, float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.mesh.brick import BrickMesh as JBrickMesh
from multigrid_tpu.mesh.brick import DofGrid as JDofGrid
from multigrid_tpu.ops.laplace import LaplaceOperator as JLaplaceOperator
from multigrid_tpu.ops.laplace import SymCoef as JSymCoef
from multigrid_tpu_torch.convert import sym_coef_from_jax
from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid
from multigrid_tpu_torch.ops.laplace import (LaplaceOperator, SymCoef,
                                             make_diag_coef, sym_components)

CASES = [((2, 2), 3), ((2, 2, 2), 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids(cells, degree):
    geo = dict(coarse_cells=cells, origin=(-0.3,) * len(cells),
               lengths=(1.1, 0.8, 1.3)[:len(cells)])
    return (DofGrid(BrickMesh(**geo), 0, degree),
            JDofGrid(JBrickMesh(**geo), 0, degree))


def _random_spd(grid, seed):
    """A symmetric positive-definite tensor a quadrature point, components
    in ``sym_components`` order, JAX's interleaved layout
    ``[C0, q, C1, q, ..., n_sym]``."""
    dim, nq = grid.dim, grid.degree + 1
    rng = np.random.default_rng(seed)
    shape = tuple(v for c in grid.cells for v in (c, nq))
    m = rng.standard_normal(shape + (dim, dim))
    t = m @ np.swapaxes(m, -1, -2) + dim * np.eye(dim)
    return np.stack([t[..., a, b] for a, b in sym_components(dim)], axis=-1)


@pytest.mark.parametrize("cells,degree", CASES)
def test_sym_coef_matches_diag(cells, degree):
    """The SymCoef that holds the affine diagonal (``c_d w_q``, the
    off-diagonal components 0) is the DiagCoef operator."""
    grid, _ = _grids(cells, degree)
    dim, nq = grid.dim, degree + 1
    diag = make_diag_coef(grid)
    w = grid.basis.quad_weights
    wq = w
    for _ in range(dim - 1):
        wq = np.multiply.outer(wq, w)
    C = np.zeros(tuple(grid.cells) + (nq,) * dim + (len(sym_components(dim)),))
    for d in range(dim):
        C[..., d] = diag.values[d] * wq
    op_diag = LaplaceOperator(grid, torch.float64, diag, "cpu")
    op_sym = LaplaceOperator(grid, torch.float64, SymCoef(C), "cpu")
    x = torch.as_tensor(np.random.default_rng(6).normal(size=grid.shape))
    np.testing.assert_allclose(op_sym.vmult(x).numpy(),
                               op_diag.vmult(x).numpy(), rtol=0, atol=1e-11)
    np.testing.assert_allclose(op_sym.inverse_diagonal().numpy(),
                               op_diag.inverse_diagonal().numpy(), rtol=1e-11)


@pytest.mark.parametrize("cells,degree", CASES)
def test_random_sym_coef_matches_jax(cells, degree):
    grid, jgrid = _grids(cells, degree)
    C = _random_spd(grid, seed=len(cells))
    jop = JLaplaceOperator(jgrid, jnp.float64, JSymCoef(jnp.asarray(C)))
    op = LaplaceOperator(grid, torch.float64, sym_coef_from_jax(C), "cpu")
    x = np.random.default_rng(7).normal(size=grid.shape)
    for got, want in (
            (op.vmult(torch.as_tensor(x)), jop.vmult(jnp.asarray(x))),
            (op.inverse_diagonal(), jop.inverse_diagonal())):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


def test_sym_coef_layout():
    """``sym_coef_from_jax`` moves the cell axes ahead of the quadrature
    axes and keeps a broadcast axis of extent 1."""
    a = np.arange(2 * 3 * 4 * 3 * 3).reshape(2, 3, 4, 3, 3)
    b = sym_coef_from_jax(a).array
    assert b.shape == (2, 4, 3, 3, 3)
    assert b[1, 2, 0, 1, 2] == a[1, 0, 2, 1, 2]
    assert sym_coef_from_jax(np.ones((1, 3, 1, 3, 3))).array.shape == \
        (1, 1, 3, 3, 3)
