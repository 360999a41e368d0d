"""The port's ('z', 'y') box operator (``multigrid_tpu_torch.parallel.halo.
HaloLaplace2D``) on a 4 x 2 grid of ``torch.distributed`` ranks (gloo, the
CPU), against the JAX ``HaloLaplace2D`` on the virtual device mesh and the
port's single-device ``BrickLaplace``.

The mesh is tests/test_halo2d.py:21-29's (coarse (4, 4, 3), level 1,
FE_Q(2): 8 x 8 x 6 cells, 3757 dofs), the JAX test's case with interior
corners: the port runs it on 4 x 2 ranks (z x y: the interior z ranks
have a corner at each end of their y cut), the JAX reference over
``make_mesh(8, ("z", "y"))``, which factors 8 devices as 2 x 4 (a
collected ``vmult`` does not depend on the grid).  Bars: the collected ``vmult``
equals the JAX one at 1e-12 (the JAX test's); its owned nodes equal the
whole grid's apply bit for bit on every rank, corner nodes included; the
owned-node dot ``x . A x`` to 1e-12 relative (the JAX test's); five
unpreconditioned CG iterations in the distributed layout equal the
single-device CG to 1e-10 (the JAX test's); the bytes a refresh sends by
stage are those of the box layout; a rank process loads nothing of JAX or
the JAX package.  One launch of ``parallel.programs.halo_program``
(module-scoped).  The box layout itself (owned nodes tile the grid, the
two stages' sends land where their peers receive, the cuts of the
multigrid levels nest on both axes, the rank grid factors as JAX's) is
checked without ranks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.mesh.brick import BrickMesh as JBrickMesh
from multigrid_tpu.mesh.brick import DofGrid as JDofGrid
from multigrid_tpu.ops.laplace import LaplaceOperator as JLaplaceOperator
from multigrid_tpu.parallel.halo import HaloLaplace2D as JHaloLaplace2D
from multigrid_tpu.parallel.sharding import make_mesh
from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid, \
    poisson_cube_mesh
from multigrid_tpu_torch.ops.laplace_kernel import BrickLaplace
from multigrid_tpu_torch.parallel.distributed import dg_level_bounds, \
    level_bounds
from multigrid_tpu_torch.parallel.halo import GHOST_CELLS, Slabs, split_cells
from multigrid_tpu_torch.parallel.programs import halo_program
from multigrid_tpu_torch.parallel.sharding import (Ranks, default_grid, launch,
                                                   parse_grid,
                                                   rank_grid_shape)

SHAPE = (4, 2)
N_CG = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _geo(cls):
    return cls(coarse_cells=(4, 4, 3), origin=(-0.9,) * 3,
               lengths=(1.9,) * 3, n_levels=2)


GRID = DofGrid(_geo(BrickMesh), 1, 2)


def _x():
    return np.random.default_rng(0).standard_normal(GRID.shape)


@pytest.fixture(scope="module")
def ranks_run():
    return launch(halo_program, int(np.prod(SHAPE)), "gloo", "cpu",
                  args=(GRID, _x(), torch.float64, N_CG, 2),
                  kwargs=dict(shape=SHAPE, whole=True))


@pytest.fixture(scope="module")
def jax_halo():
    op = JLaplaceOperator(JDofGrid(_geo(JBrickMesh), 1, 2), jnp.float64)
    dmesh = make_mesh(8, ("z", "y"))
    assert dmesh.shape["z"] > 1 and dmesh.shape["y"] > 1
    return op, JHaloLaplace2D(op, dmesh)


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


def test_vmult_matches_jax_halo2d(ranks_run, jax_halo):
    _, halo = jax_halo
    vmult, masks = halo.vmult_distributed()
    want = np.asarray(halo.collect(vmult(halo.distribute(jnp.asarray(_x())),
                                         masks)))
    np.testing.assert_allclose(ranks_run["vmult"], want, rtol=0, atol=1e-12)


def test_owned_nodes_are_the_whole_grids_bits(ranks_run, single):
    """Every rank's owned nodes, the corners near both cuts included, are
    BrickLaplace on the whole grid bit for bit; so is the collected
    vmult."""
    assert ranks_run["levels"] == [split_cells(GRID.cells[0], SHAPE[0]),
                                   split_cells(GRID.cells[1], SHAPE[1])]
    assert ranks_run["whole"]["equal"], ranks_run["whole"]
    np.testing.assert_array_equal(ranks_run["vmult"], single[0])


def test_owned_dot(ranks_run, single, jax_halo):
    x = _x()
    assert ranks_run["x_ax"] == pytest.approx(float(np.vdot(x, single[0])),
                                              rel=1e-12)
    _, halo = jax_halo
    vmult, masks = halo.vmult_distributed()
    xd = halo.distribute(jnp.asarray(x))
    got = float(np.asarray(halo.dot_distributed()(xd, vmult(xd, masks)))
                [0, 0])
    assert ranks_run["x_ax"] == pytest.approx(got, rel=1e-12)


def test_cg_iterations_match_single_device(ranks_run, single):
    np.testing.assert_allclose(ranks_run["cg"], single[1], rtol=0,
                               atol=1e-10)


def test_refresh_bytes_by_stage(ranks_run):
    """Rank 0 (z 0, y 0) sends its 2p y rows of its owned z planes to its
    y neighbour, then its 2p z planes over its stored y width (y ghosts
    included) to its z neighbour."""
    p, w = GRID.degree, GHOST_CELLS * GRID.degree
    own_z = split_cells(GRID.cells[0], SHAPE[0])[1] * p
    stored_y = (split_cells(GRID.cells[1], SHAPE[1])[1] + GHOST_CELLS) * p + 1
    X = GRID.shape[2]
    assert ranks_run["bytes"] == {"y": 8 * own_z * w * X,
                                  "z": 8 * w * stored_y * X}
    comm = ranks_run["comm"]
    assert comm["bytes_by_stage"] == ranks_run["bytes"]
    assert comm["bytes"] == sum(ranks_run["bytes"].values())
    assert {k.split()[0] for k in comm["steps"]} == {"y", "z"}
    assert 0.0 <= comm["comm_fraction"] < 1.0


def test_rank_processes_load_no_jax(ranks_run):
    assert ranks_run["foreign"] == []


# -------------------------------------------------------------- no ranks
@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (2, 3), (3, 1)])
@pytest.mark.parametrize("degree", [2, 4])
def test_box_layout(shape, degree):
    """Owned nodes tile the grid; a box reaches 2p planes past each cut
    along both axes and starts on multiples of p; each stage's sends land
    where the peer receives, the z stage over the whole stored y width."""
    g = DofGrid(BrickMesh((9, 6, 3), (0.0,) * 3, (1.0,) * 3), 0, degree)
    world = int(np.prod(shape))
    bounds = [split_cells(g.cells[0], shape[0]),
              split_cells(g.cells[1], shape[1])]
    boxes = [Slabs(g, Ranks(world, r, torch.device("cpu"), "gloo"), bounds)
             for r in range(world)]
    count = np.zeros(g.shape, int)
    for s in boxes:
        count[s.owned_index()] += 1
        assert s.shape == tuple(s.local.shape)
        for (lo, hi), (o0, o1), (c0, c1) in zip(s.stored, s.owned, s.cells):
            assert lo % degree == 0 and o0 in (0, GHOST_CELLS * degree)
    np.testing.assert_array_equal(count, 1)

    def stages(s):
        return {a: (sends, recvs) for a, sends, recvs in s._stages}

    for r, s in enumerate(boxes):
        for a, (sends, _) in stages(s).items():
            for peer, idx in sends:
                other = boxes[peer]
                (got,) = [i for q, i in stages(other)[a][1] if q == r]
                assert len(idx) == len(got) == a + 1
                for d, (mine, theirs) in enumerate(zip(idx, got)):
                    m = range(*mine.indices(s.shape[d]))
                    t = range(*theirs.indices(other.shape[d]))
                    lo, plo = s.stored[d][0], other.stored[d][0]
                    assert (lo + m.start, lo + m.stop) == \
                        (plo + t.start, plo + t.stop), (r, peer, a, d)
                # the y stage moves the owned z planes; the z stage, last,
                # the whole stored y width (the corners)
                if a == 1:
                    assert idx[0] == slice(*s.owned[0])
        assert [a for a, _, _ in s._stages] == sorted(stages(s), reverse=True)


def test_level_bounds_nest_on_two_axes():
    """A level splits on both axes when every rank gets GHOST_CELLS cells
    along each (a pair when a level lies below), or is replicated whole;
    the cuts of a split level are every other cut of the next finer one
    along each axis; the z split is the flat F-1 form."""
    mesh = poisson_cube_mesh(48)
    for shape in ((2, 2), (2, 4), (3, 2)):
        b = level_bounds(mesh, shape)
        for l, cuts in enumerate(b):
            need = max(GHOST_CELLS, 2 if l else 1)
            split = all(mesh.cells(l)[a] >= need * n
                        for a, n in enumerate(shape))
            assert (cuts is not None) == split, (shape, l)
            if cuts is None:
                continue
            assert [len(c) - 1 for c in cuts] == list(shape)
            for a, c in enumerate(cuts):
                assert c[0] == 0 and c[-1] == mesh.cells(l)[a]
                assert min(np.diff(c)) >= GHOST_CELLS
                if l + 1 < len(b):
                    assert [2 * v for v in c] == b[l + 1][a]
                if l > 0:
                    assert all(v % 2 == 0 for v in c)
    assert level_bounds(mesh, 4) == [None if c is None else c[0]
                                      for c in level_bounds(mesh, (4,))]
    # DG-plain splits where each rank gets a cell (a pair above the
    # coarsest level): the coarse 3^3 cells too
    assert level_bounds(mesh, (2, 2))[0] is None
    assert dg_level_bounds(mesh, (2, 2))[0] == [[0, 1, 3], [0, 1, 3]]
    assert dg_level_bounds(mesh, (2, 2))[1:] == level_bounds(mesh, (2, 2))[1:]


@pytest.mark.parametrize("world", [1, 2, 3, 4, 6, 8, 9, 12])
def test_rank_grid_is_jax_make_mesh(world):
    """The port's factoring of a world is JAX make_mesh's (its own copy);
    the experiments split z below 4 ranks and z, y from 4 on."""
    if world <= 8:
        jm = make_mesh(world, ("z", "y"))
        assert rank_grid_shape(world, 2) == (jm.shape["z"], jm.shape["y"])
    nz, ny = rank_grid_shape(world, 2)
    assert nz * ny == world and nz <= ny
    assert rank_grid_shape(world) == (world,)
    assert default_grid(world) == (rank_grid_shape(world, 2) if world >= 4
                                  else (world,))
    assert parse_grid(f"{nz}x{ny}") == (nz, ny)
    with pytest.raises(ValueError):
        parse_grid("2x")


def test_cell_box_is_the_levels():
    """A CellBox's coordinates and cell size are its level's, sliced along
    both axes; z_slab is the box over z alone."""
    g = DofGrid(poisson_cube_mesh(12), 2, 3)
    s = g.box(((2, 7), (1, 4)))
    assert s.cells == (5, 3) + g.cells[2:] and s.h == g.h
    np.testing.assert_array_equal(s.axis_nodes[1],
                                  g.axis_nodes[1][1 * 3: 4 * 3 + 1])
    np.testing.assert_array_equal(s.axis_quads[0], g.axis_quads[0][2:7])
    assert g.z_slab(2, 7) == g.box(((2, 7),))
    with pytest.raises(ValueError):
        g.box(((0, 2), (3, 3)))
