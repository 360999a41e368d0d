"""The port's z-slab operator (``multigrid_tpu_torch.parallel.halo``) on 2
and 4 ranks of ``torch.distributed`` (gloo, the CPU), against the JAX
``HaloLaplace`` on the virtual device mesh and the port's single-device
``BrickLaplace``.

The grid is tests/test_halo.py:16-22's (16 x 6 x 6 cells, FE_Q(2), 5577
dofs).  Bars: the collected ``vmult`` equals both at 1e-12; the owned-plane
dot ``x . A x`` to 1e-12 relative; five unpreconditioned CG iterations in
the distributed layout equal the single-device CG to 1e-10 (the JAX test's
bar); the exchange split of the ``vmult`` is consistent; a rank process
loads nothing of JAX or the JAX package.  The slab layout
itself (owned planes tile the grid, ghosts 2p planes wide on the residue of
the level, the cuts of the multigrid levels nested) is checked without
ranks.  Each world size is one launch of ``parallel.programs.halo_program``
(module-scoped).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.mesh.brick import BrickMesh as JBrickMesh
from multigrid_tpu.mesh.brick import DofGrid as JDofGrid
from multigrid_tpu.ops.laplace import LaplaceOperator as JLaplaceOperator
from multigrid_tpu.parallel.halo import HaloLaplace as JHaloLaplace
from multigrid_tpu.parallel.sharding import make_mesh
from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid, \
    poisson_cube_mesh
from multigrid_tpu_torch.ops.laplace_kernel import BrickLaplace
from multigrid_tpu_torch.parallel.distributed import level_bounds
from multigrid_tpu_torch.parallel.halo import GHOST_CELLS, Slabs, split_cells
from multigrid_tpu_torch.parallel.programs import halo_program
from multigrid_tpu_torch.parallel.sharding import Ranks, launch

WORLDS = (2, 4)
N_CG = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _geo(cls):
    return cls(coarse_cells=(8, 3, 3), origin=(-0.9,) * 3,
               lengths=(1.9,) * 3, n_levels=2)


GRID = DofGrid(_geo(BrickMesh), 1, 2)


def _x():
    return np.random.default_rng(0).standard_normal(GRID.shape)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def ranks_run(request):
    n = request.param
    return n, launch(halo_program, n, "gloo", "cpu",
                     args=(GRID, _x(), torch.float64, N_CG, 3))


@pytest.fixture(scope="module")
def jax_op():
    return JLaplaceOperator(JDofGrid(_geo(JBrickMesh), 1, 2), jnp.float64)


@pytest.fixture(scope="module")
def single():
    """The port's single-device vmult and CG on the whole grid."""
    op = BrickLaplace(GRID, torch.float64, "cpu")
    x = torch.as_tensor(_x())
    b = torch.where(op.interior, x, 0)
    u = torch.zeros_like(b)
    r, p = b.clone(), b.clone()
    rz = torch.dot(r.reshape(-1), r.reshape(-1))
    for _ in range(N_CG):
        q = op.vmult(p)
        alpha = rz / torch.dot(p.reshape(-1), q.reshape(-1))
        u += alpha * p
        r -= alpha * q
        rz2 = torch.dot(r.reshape(-1), r.reshape(-1))
        p = r + (rz2 / rz) * p
        rz = rz2
    return op.vmult(x).numpy(), u.numpy()


def test_vmult_matches_jax_halo(ranks_run, jax_op):
    n, out = ranks_run
    halo = JHaloLaplace(jax_op, make_mesh(n, ("z",)))
    vmult, masks = halo.vmult_distributed()
    want = np.asarray(halo.collect(vmult(halo.distribute(jnp.asarray(_x())),
                                         masks)))
    np.testing.assert_allclose(out["vmult"], want, rtol=0, atol=1e-12)


def test_vmult_matches_single_device(ranks_run, single):
    n, out = ranks_run
    assert out["levels"] == split_cells(GRID.cells[0], n)
    np.testing.assert_allclose(out["vmult"], single[0], rtol=0, atol=1e-12)


def test_owned_dot(ranks_run, single, jax_op):
    n, out = ranks_run
    x = _x()
    assert out["x_ax"] == pytest.approx(float(np.vdot(x, single[0])),
                                        rel=1e-12)
    halo = JHaloLaplace(jax_op, make_mesh(n, ("z",)))
    vmult, masks = halo.vmult_distributed()
    xd = halo.distribute(jnp.asarray(x))
    got = float(np.asarray(halo.dot_distributed()(xd, vmult(xd, masks)))[0])
    assert out["x_ax"] == pytest.approx(got, rel=1e-12)


def test_cg_iterations_match_single_device(ranks_run, single):
    _, out = ranks_run
    np.testing.assert_allclose(out["cg"], single[1], rtol=0, atol=1e-10)


def test_rank_processes_load_no_jax(ranks_run):
    _, out = ranks_run
    assert out["foreign"] == []


def test_comm_split_report(ranks_run):
    _, out = ranks_run
    rep = out["comm"]
    assert rep["total"] > 0 and rep["cell_loop"] > 0
    assert 0.0 <= rep["comm_fraction"] < 1.0


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("degree", [2, 4])
def test_slab_layout(world, degree):
    """Owned planes tile the grid; each slab reaches 2p planes past its
    cuts and starts on a multiple of p; the refresh pairs match."""
    g = DofGrid(BrickMesh((13, 2, 3), (0.0,) * 3, (1.0,) * 3), 0, degree)
    bounds = split_cells(g.cells[0], world)
    slabs = [Slabs(g, Ranks(world, r, torch.device("cpu"), "gloo"), bounds)
             for r in range(world)]
    owned = np.concatenate([np.arange(g.shape[0])[s.owned_rows()]
                            for s in slabs])
    np.testing.assert_array_equal(owned, np.arange(g.shape[0]))
    for r, s in enumerate(slabs):
        assert s.lo % degree == 0 and s.shape[0] == s.hi - s.lo
        assert s.shape == tuple(s.local.shape)
        if r > 0:
            assert s.own0 == GHOST_CELLS * degree
            up = slabs[r - 1]
            # what r sends down lands where r - 1 receives from above
            (peer, sent), = [t for t in s._sends if t[0] == r - 1]
            (_, got), = [t for t in up._recvs if t[0] == r]
            assert (s.lo + sent.start, s.lo + sent.stop) == \
                (up.lo + got.start, up.lo + got.stop)
        if r < world - 1:
            assert s.hi - s.lo - s.own1 == GHOST_CELLS * degree + 1


def test_level_bounds_nest():
    """A level splits when every rank gets GHOST_CELLS z cells; the cuts of
    a split level are every other cut of the next finer one."""
    mesh = poisson_cube_mesh(64)
    for world in (2, 3, 4):
        b = level_bounds(mesh, world)
        for l, cuts in enumerate(b):
            split = mesh.cells(l)[0] >= GHOST_CELLS * world
            assert (cuts is not None) == split
            if cuts is not None:
                assert min(np.diff(cuts)) >= GHOST_CELLS
                if l + 1 < len(b):
                    assert [c * 2 for c in cuts] == b[l + 1]
                if l > 0 and b[l - 1] is None:
                    assert all(c % 2 == 0 for c in cuts)
    assert level_bounds(mesh, 1) == [None] * mesh.n_levels


def test_slab_grid_is_the_levels():
    """A ZSlab's coordinates and cell size are its level's, sliced."""
    g = DofGrid(poisson_cube_mesh(12), 2, 3)
    s = g.z_slab(2, 7)
    assert s.cells == (5,) + g.cells[1:] and s.h == g.h
    np.testing.assert_array_equal(s.axis_nodes[0],
                                  g.axis_nodes[0][2 * 3: 7 * 3 + 1])
    np.testing.assert_array_equal(s.axis_quads[0], g.axis_quads[0][2:7])
    with pytest.raises(ValueError):
        g.z_slab(3, 3)
