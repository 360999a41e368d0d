"""Port vs JAX twin: 1-D tables, meshes, dof grids, masks and the cell
gather/scatter (multigrid_tpu_torch core/, mesh/, ops/masks, ops/windows).
The numpy modules are copies, so tables and coordinates must be equal
exactly; the cell gather/scatter adds the same pairs in the same order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.core import basis as jbasis
from multigrid_tpu.core import quadrature as jquad
from multigrid_tpu.mesh import brick as jbrick
from multigrid_tpu.ops import windows as jwin
from multigrid_tpu_torch.core import basis as tbasis
from multigrid_tpu_torch.core import quadrature as tquad
from multigrid_tpu_torch.mesh import brick as tbrick
from multigrid_tpu_torch.ops import masks as tmasks
from multigrid_tpu_torch.ops import windows as twin


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 7])
def test_basis_tables_equal(degree):
    a, b = jbasis.make_basis(degree), tbasis.make_basis(degree)
    for name in ("nodes", "quad_points", "quad_weights", "S", "D", "D_col",
                 "P", "M", "L"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_quadrature_rules_equal(n):
    for fn in ("gauss", "gauss_lobatto"):
        for x, y in zip(getattr(jquad, fn)(n), getattr(tquad, fn)(n)):
            np.testing.assert_array_equal(x, y)


MESHES = {
    "cube4": lambda m: m.poisson_cube_mesh(4),
    "cube6": lambda m: m.poisson_cube_mesh(6),
    "doubling4": lambda m: m.doubling_mesh(4),
    "aniso": lambda m: m.BrickMesh((3, 4, 5), (-0.9,) * 3, (1.9, 1.3, 1.1)),
}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_dofgrid_coordinates_equal(mesh):
    mj, mt = MESHES[mesh](jbrick), MESHES[mesh](tbrick)
    assert (mj.coarse_cells, mj.origin, mj.lengths, mj.n_levels) == (
        mt.coarse_cells, mt.origin, mt.lengths, mt.n_levels)
    for level in range(mj.n_levels):
        gj, gt = jbrick.DofGrid(mj, level, 4), tbrick.DofGrid(mt, level, 4)
        assert gj.shape == gt.shape and gj.n_dofs == gt.n_dofs
        assert gj.jxw_scalar == gt.jxw_scalar and gj.h == gt.h
        for a, b in zip(gj.axis_nodes, gt.axis_nodes):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(gj.axis_quads, gt.axis_quads):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(gj.node_coords(), gt.node_coords()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(gj.boundary_mask(), gt.boundary_mask())
        np.testing.assert_array_equal(
            tmasks.interior_mask(gt.shape).numpy(), ~gj.boundary_mask())


def test_zero_boundary_matches_mask():
    g = tbrick.DofGrid(MESHES["aniso"](tbrick), 0, 3)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(g.shape))
    want = torch.where(tmasks.interior_mask(g.shape), x, 0)
    assert torch.equal(tmasks.zero_boundary_(x.clone()), want)


@pytest.mark.parametrize("window,cells", [(5, (3, 4, 5)), (9, (2, 1, 3)),
                                          (3, (4, 4, 2))])
def test_gather_scatter_cells_match_jax(window, cells):
    shape = tuple(c * (window - 1) + 1 for c in cells)
    rng = np.random.default_rng(window)
    u = rng.standard_normal(shape)
    wj = np.asarray(jwin.gather_cells(jnp.asarray(u), window))
    # JAX interleaved [C0, w, C1, w, C2, w] -> blocked [C0, C1, C2, w, w, w]
    wj = wj.transpose(0, 2, 4, 1, 3, 5)
    wt = twin.gather_cells(torch.as_tensor(u), window)
    np.testing.assert_array_equal(wt.numpy(), wj)
    y = rng.standard_normal(cells + (window,) * 3)
    sj = np.asarray(jwin.scatter_cells(
        jnp.asarray(y.transpose(0, 3, 1, 4, 2, 5)), window))
    st = twin.scatter_cells(torch.as_tensor(y))
    np.testing.assert_array_equal(st.numpy(), sj)
