"""The exchange/compute overlap of the port's FE_Q halo operators
(``multigrid_tpu_torch.parallel.halo.SplitPlan`` / ``SplitApply``, run by
``HaloLaplace`` and ``HaloLaplace2D``) and its report
(``multigrid_tpu_torch.utils.overlap``), against the JAX ``HaloLaplace`` /
``HaloLaplace2D`` and ``utils/overlap.py``.

The JAX classes split their apply so that the first exchange waits only for
the first cell layer (tests/test_overlap.py); the port splits each rank's
box into sub-boxes (the send regions first, the interior while the planes
travel).  Bars:

* bits, on gloo ranks of the CPU, at meshes of p = 2 where every rank owns
  at least ``SPLIT_MIN_CELLS`` cells: 12 x 3 x 3 cells on 2 z ranks, 15 x 3
  x 3 on 3, 10 x 10 x 3 on 2 x 2.  In float32 and float64 the split
  ``vmult``'s box equals the apply-then-refresh box bit for bit, every
  node, and its owned nodes the single-device ``BrickLaplace``; the
  collected ``vmult`` equals the JAX operator's to 1e-12 (the bar of
  tests/test_torch_halo.py);
* the same bits without ranks (``comm=False``: the owned nodes need no
  exchange) at p = 2 and 3 on 2, 3 and 2 x 2 boxes;
* the overlappable fraction, read from the plan alone (no rank launched),
  at the JAX tests' cell counts at p = 4: 32 x 4 x 4 on 2 z ranks at least
  0.6 (the port reads 0.709 / 0.756 on ranks 0 / 1; JAX's report on its 8
  devices, 4 local cells: 0.75), 16 x 16 x 4 on 2 x 2 at least 0.5 (the
  port 0.720-0.740; JAX on 2 x 4 devices: 0.875).

One launch a world size (module-scoped).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.mesh.brick import BrickMesh as JBrickMesh
from multigrid_tpu.mesh.brick import DofGrid as JDofGrid
from multigrid_tpu.ops.laplace import LaplaceOperator as JLaplaceOperator
from multigrid_tpu.parallel.halo import HaloLaplace as JHaloLaplace
from multigrid_tpu.parallel.halo import HaloLaplace2D as JHaloLaplace2D
from multigrid_tpu.parallel.sharding import make_mesh
from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid
from multigrid_tpu_torch.ops.laplace_kernel import BrickLaplace
from multigrid_tpu_torch.parallel.halo import (SPLIT_MIN_CELLS, HaloLaplace,
                                               SplitApply, Slabs, split_cells)
from multigrid_tpu_torch.parallel.programs import overlap_program
from multigrid_tpu_torch.parallel.sharding import Ranks, launch
from multigrid_tpu_torch.utils.overlap import collective_overlap_report

CASES = {"2ranks": ((12, 3, 3), None), "3ranks": ((15, 3, 3), None),
         "2x2": ((10, 10, 3), (2, 2))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _geo(cls, cells, n_levels=1):
    return cls(coarse_cells=cells, origin=(-0.9,) * 3, lengths=(1.9,) * 3,
               n_levels=n_levels)


def _grid(cells, degree=2):
    return DofGrid(_geo(BrickMesh, cells), 0, degree)


WORLDS = {"2ranks": 2, "3ranks": 3, "2x2": 4}


@functools.lru_cache(maxsize=None)
def _launch(name):
    """One launch a case: ``overlap_program``."""
    cells, shape = CASES[name]
    return launch(overlap_program, WORLDS[name], "gloo", "cpu",
                  args=(_grid(cells),),
                  kwargs=dict(shape=shape, comm_reps=2))


@pytest.fixture(scope="module", params=list(CASES))
def ranks_run(request):
    return request.param, _launch(request.param)


def test_split_bits(ranks_run):
    """Both dtypes: the split vmult's box is the apply-then-refresh box
    (ghosts included) and its owned nodes the single-device
    BrickLaplace's, bit for bit on every rank."""
    _, out = ranks_run
    assert set(out["checks"]) == {"f32", "f64"}
    for key, c in out["checks"].items():
        assert c["whole_box"] and c["single"], (key, c)
        assert c["max_diff"] == 0.0


def test_vmult_matches_jax(ranks_run):
    name, out = ranks_run
    cells, shape = CASES[name]
    op = JLaplaceOperator(JDofGrid(_geo(JBrickMesh, cells), 0, 2),
                          jnp.float64)
    x = np.random.default_rng(0).standard_normal(op.grid.shape)
    if shape is None:
        halo = JHaloLaplace(op, make_mesh(WORLDS[name], ("z",)))
    else:
        halo = JHaloLaplace2D(op, make_mesh(4, ("z", "y")))
    vmult, masks = halo.vmult_distributed()
    want = np.asarray(halo.collect(vmult(halo.distribute(jnp.asarray(x)),
                                         masks)))
    np.testing.assert_allclose(out["vmult"], want, rtol=0, atol=1e-12)


def test_rank_plan_and_report(ranks_run):
    """Rank 0's sub-boxes (y strips, z slabs, the interior) and its
    overlap report; the exchange split's readings."""
    name, out = ranks_run
    roles = [r for r, _ in out["boxes"]]
    assert roles == (["y", "z", "interior"] if name == "2x2"
                     else ["z", "interior"])
    rep = out["overlap"]
    assert rep["split"] and 0.0 < rep["overlappable_fraction"] < 1.0
    assert rep["flops_in_cone"] < rep["flops_total"]
    comm = out["comm"]
    assert comm["total"] > 0 and comm["steps"]
    sc = comm["overlap"]
    assert sc["split"] and sc["equal"]
    assert sc["total"] > 0 and sc["refresh"] > 0
    assert np.isfinite(sc["hidden"])
    assert out["foreign"] == []


def _slabs(g, shape, rank):
    world = int(np.prod(shape))
    bounds = [split_cells(g.cells[a], n) for a, n in enumerate(shape)]
    return Slabs(g, Ranks(world, rank, torch.device("cpu"), "gloo"),
                 bounds[0] if len(shape) == 1 else bounds)


@pytest.mark.parametrize("degree", [2, 3])
@pytest.mark.parametrize("cells,shape", [((10, 2, 3), (2,)),
                                         ((15, 2, 2), (3,)),
                                         ((10, 10, 2), (2, 2))])
def test_split_owned_nodes_without_ranks(cells, shape, degree):
    """The owned nodes of every rank's split vmult need no exchange: with
    ``comm=False`` they are the whole grid's bits."""
    g = _grid(cells, degree)
    x = torch.as_tensor(np.random.default_rng(degree).standard_normal(
        g.shape))
    want = BrickLaplace(g, torch.float64, "cpu").vmult(x)
    for r in range(int(np.prod(shape))):
        s = _slabs(g, shape, r)
        sp = SplitApply(BrickLaplace(s.local, torch.float64, "cpu"), s)
        got = sp.run(x[s.stored_index()].clone(), comm=False)
        assert torch.equal(s.own(got), want[s.owned_index()]), r


@pytest.mark.parametrize("rank", [0, 1])
def test_overlap_fraction_z(rank):
    """32 x 4 x 4 cells at p = 4 on 2 z ranks (the JAX test's cells):
    the first exchange waits for one boundary box."""
    g = DofGrid(BrickMesh((32, 4, 4), (0.0,) * 3, (1.0,) * 3), 0, 4)
    rep = collective_overlap_report(_slabs(g, (2,), rank))
    assert rep["split"] and rep["applies"] == 2
    assert rep["overlappable_fraction"] >= 0.6, rep


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_overlap_fraction_2d(rank):
    """16 x 16 x 4 cells at p = 4 on 2 x 2 ranks (the JAX test's cells):
    the first exchange (y) waits for one y strip."""
    g = DofGrid(BrickMesh((16, 16, 4), (0.0,) * 3, (1.0,) * 3), 0, 4)
    rep = collective_overlap_report(_slabs(g, (2, 2), rank))
    assert rep["split"] and rep["applies"] == 3
    assert rep["overlappable_fraction"] >= 0.5, rep


def test_split_threshold():
    """A level runs the schedule only when every split axis owns at least
    SPLIT_MIN_CELLS cells on every rank; a world of one never splits."""
    assert SPLIT_MIN_CELLS == 5
    g = DofGrid(BrickMesh((9, 3, 3), (0.0,) * 3, (1.0,) * 3), 0, 2)
    assert not _slabs(g, (2,), 0).plan.split          # 4 + 5 cells
    g = DofGrid(BrickMesh((10, 3, 3), (0.0,) * 3, (1.0,) * 3), 0, 2)
    assert _slabs(g, (2,), 1).plan.split
    g = DofGrid(BrickMesh((10, 8, 3), (0.0,) * 3, (1.0,) * 3), 0, 2)
    assert not _slabs(g, (2, 2), 0).plan.split        # 4 y cells a rank
    one = HaloLaplace(g, Ranks(1, 0, torch.device("cpu"), "gloo"))
    assert one.split is None
    assert collective_overlap_report(one)["overlappable_fraction"] == 0.0


def test_sub_boxes_reach_two_cells_down_one_up():
    """A sub-box reaches two cells below its first kept plane and one
    above its last (the upper boundary box up to the stored top); the
    kept regions and the receives tile the box along z."""
    g = DofGrid(BrickMesh((18, 2, 2), (0.0,) * 3, (1.0,) * 3), 0, 3)
    s = _slabs(g, (3,), 1)                           # cells [6, 12)
    p = 3
    boxes = {(b.role, b.side): b for b in s.plan.boxes}
    assert boxes["z", 0].cells == ((4, 9),)
    assert boxes["z", 0].keep == [((6 * p, 8 * p),)]
    assert boxes["z", 1].cells == ((8, 14),)
    assert boxes["z", 1].keep == [((10 * p, 12 * p),),
                                  ((14 * p, 14 * p + 1),)]
    assert boxes["interior", -1].cells == ((6, 11),)
    assert boxes["interior", -1].keep == [((8 * p, 10 * p),)]
    (_, recvs), = s.plan.recvs
    planes = sorted([k for b in s.plan.boxes for reg in b.keep for k in reg]
                    + [reg[0] for _, reg in recvs])
    assert planes[0][0] == s.lo and planes[-1][1] == s.hi
    assert all(a[1] == b[0] for a, b in zip(planes, planes[1:]))
