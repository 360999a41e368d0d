"""The port's rank-decomposed multigrid on a z x y grid of ranks, and 2-D
bricks and ``--output`` on ranks (``multigrid_tpu_torch.parallel.
distributed.DistributedMultigrid``, gloo on the CPU).

* 3-D on 2 x 2 ranks: tests/test_distributed.py:19-30's mesh (2 x 2 x 2
  coarse cells, three levels, FE_Q(4), 35,937 dofs) against the JAX
  ``DistributedMultigrid`` over ``make_mesh(4, ("z", "y"))`` and against
  the port's single device, at the JAX test's bars: FMG to atol 1e-6, its
  L2 error to 1e-3 relative; CG its equal, reduction within 1e-4,
  solution to atol 1e-9.  Two CG solves are bit for bit equal, and the
  owned nodes of the box apply (float and double, the corners included)
  are ``BrickLaplace`` on the whole grid bit for bit.
* 2-D at size 8 (257^2 nodes, p = 4, seven levels) on 2 x 2 ranks and,
  through the command line (``poisson_cube --dim 2 --devices 2
  --output``), on 2 ranks: 8 CG iterations and reduction 0.068588 (the
  JAX package's on 1, 2 and 4 devices) to 5e-7, and the port's single
  device at the bars above.
* ``--output`` on 2 ranks: the file is the one-device file, its XML and
  coordinates byte for byte, the solution and error fields within the
  FMG bar (1e-6; the ranks' FMG adds its dots in another order).

The 4-rank runs share one launch of ``parallel.programs.programs``
(module-scoped).
"""

import base64
import re

import numpy as np
import pytest
import torch

from experiments.poisson_cube import exact_fn as j_exact
from experiments.poisson_cube import rhs_fn as j_rhs
from multigrid_tpu.mesh.brick import BrickMesh as JBrickMesh
from multigrid_tpu.parallel.distributed import \
    DistributedMultigrid as JDistributedMultigrid
from multigrid_tpu.parallel.sharding import make_mesh
from multigrid_tpu.solvers.multigrid import MultigridSolver as JMultigridSolver
from multigrid_tpu_torch.experiments import poisson_cube
from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid, \
    poisson_cube_mesh
from multigrid_tpu_torch.parallel.programs import cube_program, programs
from multigrid_tpu_torch.parallel.sharding import launch
from multigrid_tpu_torch.utils.vtk import write_solution

GRID = (2, 2)
SIZE_2D = 8
REDUCTION_2D = 0.068588      # the JAX package's, 1, 2 and 4 devices


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _geo(cls):
    return cls(coarse_cells=(2, 2, 2), origin=(-0.9,) * 3, lengths=(1.9,) * 3,
               n_levels=3)


def _one(mesh):
    s = poisson_cube.build_solver(mesh, 4, n_cycles=2, device="cpu")
    sol = s.solve()
    cg, its, red = s.solve_cg()
    return dict(fmg=sol.numpy(), fmg_L2error=s.l2_error(s.maxlevel, sol),
                cg=cg.numpy(), cg_its=its, cg_reduction=red)


@pytest.fixture(scope="module")
def single():
    """The port's single-device rows: 3-D and 2-D."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {"3d": _one(_geo(BrickMesh)),
                "2d": _one(poisson_cube_mesh(SIZE_2D, dim=2))}
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX DistributedMultigrid over a ('z', 'y') mesh of 4 devices."""
    s = JMultigridSolver(_geo(JBrickMesh), 4, j_exact, j_rhs, n_pre=2,
                         n_post=2, n_cycles=2)
    dm = JDistributedMultigrid(s, make_mesh(4, ("z", "y")))
    assert dm.distributed_levels()[-1]
    sol = dm.solve()
    cg, its, red = dm.solve_cg()
    return dict(fmg=np.asarray(sol), fmg_L2error=s.l2_error(s.maxlevel, sol),
                cg=np.asarray(cg), cg_its=its, cg_reduction=red)


@pytest.fixture(scope="module")
def grid_runs():
    """3-D and 2-D on 2 x 2 ranks, one launch."""
    calls = [(cube_program, (_geo(BrickMesh),),
              dict(shape=GRID, reps=2, collect=True, apply_seed=1)),
             (cube_program, (poisson_cube_mesh(SIZE_2D, dim=2),),
              dict(shape=GRID, collect=True))]
    return dict(zip(("3d", "2d"), launch(programs, 4, "gloo", "cpu",
                                         args=(calls,))))


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``poisson_cube 4 60000 70000 --dim 2 --devices 2 --output DIR`` on
    gloo ranks on the CPU (the size-8 row alone)."""
    out = tmp_path_factory.mktemp("ranks")
    (row,) = poisson_cube.main(["4", "60000", "70000", "--dim", "2",
                                "--devices", "2", "--backend", "gloo",
                                "--device", "cpu", "--output", str(out)])
    return row, out


@pytest.mark.parametrize("against", ["single", "jax"])
def test_fmg_matches_on_a_rank_grid(grid_runs, single, jax_run, against):
    out = grid_runs["3d"]
    ref = single["3d"] if against == "single" else jax_run
    np.testing.assert_allclose(out["fmg"], ref["fmg"], rtol=0, atol=1e-6)
    assert abs(out["fmg_L2error"] - ref["fmg_L2error"]) \
        <= 1e-3 * abs(ref["fmg_L2error"])


@pytest.mark.parametrize("against", ["single", "jax"])
def test_cg_matches_on_a_rank_grid(grid_runs, single, jax_run, against):
    out = grid_runs["3d"]
    ref = single["3d"] if against == "single" else jax_run
    assert out["cg_its"] == ref["cg_its"]
    assert abs(out["cg_reduction"] - ref["cg_reduction"]) < 1e-4
    np.testing.assert_allclose(out["cg"], ref["cg"], rtol=0, atol=1e-9)


def test_grid_levels_split_on_both_axes(grid_runs):
    out = grid_runs["3d"]
    assert out["grid"] == GRID
    assert out["levels"] == [False, True, True]
    assert out["bounds"][-1] == [[0, 4, 8], [0, 4, 8]]
    assert out["cg_repeat_equal"]


def test_rank_processes_load_no_jax(grid_runs, cli_run):
    for out in (*grid_runs.values(), cli_run[0]):
        assert out["foreign"] == []


def test_box_apply_is_the_whole_grids_bits(grid_runs):
    apply = grid_runs["3d"]["apply"]
    assert set(apply) == {"vmult f32", "apply f32", "vmult f64", "apply f64"}
    for name, c in apply.items():
        assert c["equal"], (name, c)


@pytest.mark.parametrize("run", ["2x2", "2 ranks, command line"])
def test_2d_on_ranks(grid_runs, cli_run, single, run):
    out = grid_runs["2d"] if run == "2x2" else cli_run[0]
    ref = single["2d"]
    assert out["cg_its"] == ref["cg_its"] == 8
    assert abs(out["cg_reduction"] - REDUCTION_2D) < 5e-7
    assert abs(out["cg_reduction"] - ref["cg_reduction"]) < 1e-4
    assert abs(out["fmg_L2error"] - ref["fmg_L2error"]) \
        <= 1e-3 * abs(ref["fmg_L2error"])
    assert out["levels"][-1] and not out["levels"][0]
    if run == "2x2":
        np.testing.assert_allclose(out["fmg"], ref["fmg"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(out["cg"], ref["cg"], rtol=0, atol=1e-9)


def _vtr(path):
    """(the XML with the data arrays cut out, {name: values})."""
    text = path.read_text()
    arrays = {}
    for name, fmt, body in re.findall(
            r'<DataArray type="Float64" Name="(\w+)" format="(\w+)">'
            r'([^<]*)</DataArray>', text):
        if fmt == "binary":
            arrays[name] = np.frombuffer(base64.b64decode(body)[8:], "<f8")
        else:
            arrays[name] = np.array([float(v) for v in body.split()])
    return re.sub(r'(<DataArray[^>]*>)[^<]*', r'\1', text), arrays


def test_output_on_ranks_is_the_one_device_file(cli_run, single,
                                                tmp_path):
    _, out_dir = cli_run
    mesh = poisson_cube_mesh(SIZE_2D, dim=2)
    grid = DofGrid(mesh, mesh.max_level, 4)
    (got,) = list(out_dir.glob("*.vtr"))
    assert got.name == f"solution_{grid.n_dofs}.vtr"
    want = tmp_path / got.name
    assert write_solution(str(want), grid, single["2d"]["fmg"],
                          poisson_cube.exact_fn)
    xml_got, a_got = _vtr(got)
    xml_want, a_want = _vtr(want)
    assert xml_got == xml_want
    assert set(a_got) == {"x", "y", "z", "solution", "error"}
    for name in ("x", "y", "z"):
        np.testing.assert_array_equal(a_got[name], a_want[name])
    for name in ("solution", "error"):
        np.testing.assert_allclose(a_got[name], a_want[name], rtol=0,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def cube8():
    return poisson_cube.build_solver(poisson_cube_mesh(8), 4, device="cpu")


@pytest.mark.parametrize("box", [((4, 21),), ((0, 17), (8, 33)),
                                 ((12, 33), (0, 9))])
def test_separable_rhs_of_a_box_is_the_whole_grids(cube8, box):
    """The device rhs assembly of the large levels (separable factors, the
    boundary correction's face slabs cut to the box) gives a box the whole
    grid's values, bit for bit (its outer faces are Dirichlet rows, 0)."""
    from multigrid_tpu_torch.solvers.multigrid import _bc_faces_host

    s = cube8
    l = s.maxlevel
    g = s.grids[l]
    faces = _bc_faces_host(g, poisson_cube.exact_fn)
    sep = poisson_cube.rhs_fn.separable_1d(g.dim)
    whole = s._rhs_separable_device(l, g, sep, faces)
    got = s._rhs_separable_device(l, g, sep, faces, box=box)
    want = whole[tuple(slice(lo, hi) for lo, hi in box)]
    assert torch.equal(got[tuple(slice(1, -1) for _ in box)],
                       want[tuple(slice(1, -1) for _ in box)])
