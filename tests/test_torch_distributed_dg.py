"""The port's rank-decomposed DG solvers (``multigrid_tpu_torch.parallel.
distributed.DistributedMultigridDG``) on ranks of ``torch.distributed``
(gloo, the CPU), against the port's single-device solvers and the JAX
``DistributedMultigridDG`` over a ``("z",)`` mesh.

The problem is tests/test_distributed_dg.py:18-27's (sin(3 pi x) on the
unit cube, ``cube(2, 0, 1, 2)``: 8^3 cells, p = 2, tolerance 1e-10):
DG-plain (gauss) on 2 and 4 z-slab ranks and on a 2 x 2 grid, DG-over-CG
(hermite, the FE_Q hierarchy on ``DistributedMultigrid``) on 2 z-slab
ranks and on 2 x 2.  The JAX references run over ``make_mesh(8,
("z",))`` for the z-slab runs and ``make_mesh(4, ("z", "y"))`` for the
grid runs; the JAX DG-over-CG solver is built with ``dp_impl="native"``
(the f64 operator the port applies: the JAX default, an Ozaki-emulated
f64 apply, parts from it by 3.8e-12 of max|y|).  Bars, the JAX test's:
frac its within 5%, rate to 1e-6 relative, L2 error to 1e-10 relative.
The 4-rank DG-plain runs and the DG-over-CG runs install the JAX solver's
state first (``convert.load_state``: every rank the same smoother state,
its box of the rhs and of the inverse diagonals), and are held against
the port's single-device solver with that state.  Two CG solves are bit for
bit equal; one rank is the single-device solver bit for bit; the owned
cells of the slab kernels (their plain versions here) are the whole
grid's bits; ``DGTransfer`` between nested cuts and the CG <-> DG
coupling between the slab pair make no exchange beyond the refresh of
their output.  Each world size is one launch of
``parallel.programs.dg_programs`` (module-scoped).
"""

import numpy as np
import pytest
import torch

from multigrid_tpu.mesh.brick import cube as j_cube
from multigrid_tpu.parallel.distributed import \
    DistributedMultigridDG as JDistributedDG
from multigrid_tpu.parallel.sharding import make_mesh
from multigrid_tpu.solvers.multigrid_dg import MultigridSolverDG as JDG
from multigrid_tpu.solvers.multigrid_dg import MultigridSolverDGPlain as JPlain
from multigrid_tpu_torch import convert
from multigrid_tpu_torch.mesh.brick import cube
from multigrid_tpu_torch.ops.dg import DGGrid
from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed
from multigrid_tpu_torch.ops.dg_transfer import CGDGCoupling
from multigrid_tpu_torch.mesh.brick import DofGrid
from multigrid_tpu_torch.parallel.dg_halo import DGSlabs
from multigrid_tpu_torch.parallel.distributed import (DistributedMultigridDG,
                                                      dg_level_bounds,
                                                      level_bounds)
from multigrid_tpu_torch.parallel.programs import (dg_programs, sine_exact,
                                                   sine_rhs)
from multigrid_tpu_torch.parallel.sharding import Ranks, launch
from multigrid_tpu_torch.solvers.multigrid_dg import (MultigridSolverDG,
                                                      MultigridSolverDGPlain)

TOL = 1e-10
KIND = {"dg-plain": "gauss", "dg": "hermite"}
GRID = (2, 2)
# (world, path, with the JAX state, rank grid: None is the z split)
RUNS = [(2, "dg-plain", False, None), (4, "dg-plain", True, None),
        (2, "dg", True, None), (4, "dg-plain", True, GRID),
        (4, "dg", True, GRID)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(run):
    """A run's key in ``rank_runs``: (world, path), and the grid."""
    return run[:2] if run[3] is None else run[:2] + (run[3],)


def _mesh():
    return cube(2, 0.0, 1.0, 2)


def _cheb(sm):
    return (float(sm.theta), float(sm.delta), int(sm.degree),
            float(sm.max_eig), float(sm.min_eig))


@pytest.fixture(scope="module")
def jax_runs():
    """Per path: the JAX DistributedMultigridDG's frac its, rate and L2
    error over the ("z",) mesh, the same over the ("z", "y") mesh
    (``"zy"``), and its solver's state in the form ``load_state`` takes
    (built before either mesh wraps the solver)."""
    out = {}
    mesh = j_cube(2, 0.0, 1.0, 2, dim=3)
    for path, cls in (("dg-plain", JPlain), ("dg", JDG)):
        s = cls(mesh, 2, sine_exact, sine_rhs, kind=KIND[path],
                **({} if path == "dg-plain" else dict(dp_impl="native")))
        x, its, rate = JDistributedDG(s, make_mesh(8, ("z",))).solve_cg(
            tolerance=TOL)
        if path == "dg-plain":
            state = {"rhs": np.asarray(s.rhs),
                     "chebyshev": [_cheb(sm) for sm in s.smoothers],
                     "inv_diag": [np.asarray(sm.precond.__self__.inv_diag)
                                  for sm in s.smoothers]}
        else:
            c = s.cg
            state = {"rhs": np.asarray(s.rhs), "chebyshev": _cheb(s.smooth_dg),
                     "inv_diag": np.asarray(s.jacobi.inv_diag),
                     "cg": {"rhs": [np.asarray(r) for r in c.rhs],
                            "u_bc": [[np.asarray(f) for f in faces]
                                     for faces in c.u_bc],
                            "chebyshev": [_cheb(sm) for sm in c.smoothers]}}
        out[path] = dict(frac_its=float(its), rate=float(rate),
                         L2=float(s.l2_error(x, s.exact_quad)), state=state)
        x, its, rate = JDistributedDG(s, make_mesh(4, ("z", "y"))).solve_cg(
            tolerance=TOL)
        out[path]["zy"] = dict(frac_its=float(its), rate=float(rate),
                               L2=float(s.l2_error(x, s.exact_quad)))
    return out


@pytest.fixture(scope="module")
def singles(jax_runs):
    """The port's single-device rows (run, with or without the JAX state
    as the run is)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for _, path, with_state, _ in RUNS:
            cls = MultigridSolverDGPlain if path == "dg-plain" \
                else MultigridSolverDG
            s = cls(_mesh(), 2, sine_exact, sine_rhs, kind=KIND[path],
                    device="cpu")
            if with_state:
                convert.load_state(s, jax_runs[path]["state"])
            x, its, rate = s.solve_cg(tolerance=TOL)
            out[path, with_state] = dict(frac_its=its, rate=rate,
                                         L2=s.l2_error(x, s.exact_quad),
                                         cg=x.numpy())
    finally:
        torch.set_num_threads(n)
    return out


@pytest.fixture(scope="module")
def rank_runs(jax_runs):
    """One launch a world size: the runs of ``RUNS`` (two CG solves each,
    the solution collected, the slab kernels and the transfers checked),
    and on one rank both solvers against the single-device ones."""
    out = {}
    for world in (1, 2, 4):
        runs = [dict(path=path, degree=2, kind=KIND[path], tolerance=TOL,
                     problem="sine", reps=2, collect=True, apply_seed=1,
                     transfer_seed=2, shape=shape,
                     state=jax_runs[path]["state"] if with_state else None)
                for w, path, with_state, shape in RUNS if w == world]
        keys = [_key(r) for r in RUNS if r[0] == world]
        if world == 1:
            runs = [dict(path=path, degree=2, kind=KIND[path], tolerance=TOL,
                         problem="sine", single=True) for path in KIND]
            keys = [(1, path) for path in KIND]
        res = launch(dg_programs, world, "gloo", "cpu",
                     args=(_mesh(), runs))
        out.update(zip(keys, res))
    return out


def _run_id(r):
    ranks = f"{r[0]}ranks" if r[3] is None else "x".join(map(str, r[3]))
    return f"{ranks}-{r[1]}" + ("-jax_state" if r[2] else "")


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
@pytest.mark.parametrize("against", ["single", "jax"])
def test_solve_matches(rank_runs, singles, jax_runs, run, against):
    _, path, with_state, shape = run
    out = rank_runs[_key(run)]
    if against == "single":
        ref = singles[path, with_state]
    else:
        ref = jax_runs[path] if shape is None else jax_runs[path]["zy"]
    assert abs(out["frac_its"] - ref["frac_its"]) < 0.05 * ref["frac_its"]
    assert out["rate"] == pytest.approx(ref["rate"], rel=1e-6)
    assert abs(out["L2"] - ref["L2"]) <= 1e-10 * ref["L2"]
    if against == "single":
        np.testing.assert_allclose(out["cg"], ref["cg"], rtol=0,
                                   atol=1e-8 * np.abs(ref["cg"]).max())


def test_levels_split_and_replicate(rank_runs):
    assert rank_runs[2, "dg-plain"]["levels"] == [True, True, True]
    assert rank_runs[2, "dg-plain"]["bounds"] == [0, 4, 8]
    assert rank_runs[4, "dg-plain"]["levels"] == [False, False, True]
    assert rank_runs[4, "dg-plain"]["bounds"] == [0, 2, 4, 6, 8]
    # the DG level on the FE_Q finest level's cuts; its coarsest FE_Q
    # level (2 cells) replicated
    assert rank_runs[2, "dg"]["levels"] == [True, False, True, True]
    # on 2 x 2: DG-plain splits every level (a cell a rank along z and y,
    # a pair above the coarsest); DG-over-CG as on the z split
    grid = rank_runs[4, "dg-plain", GRID]
    assert grid["levels"] == [True, True, True]
    assert grid["bounds"] == [[0, 4, 8], [0, 4, 8]]
    assert rank_runs[4, "dg", GRID]["levels"] == [True, False, True, True]
    for key, out in rank_runs.items():
        assert out["foreign"] == [], key


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_cg_solves_repeat_bit_for_bit(rank_runs, run):
    assert rank_runs[_key(run)]["cg_repeat_equal"]


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_slab_kernels_are_the_whole_grids(rank_runs, run):
    """The owned cells of the slab's dg_apply<double>, dg_residual<float>
    and dg_cheb<float> (inputs' ghosts through the traces wire) are those
    of DGOperator on the whole grid, and of the plain JAX algorithm."""
    checks = rank_runs[_key(run)]["apply"]
    assert set(checks) == {"dg_apply<double>", "dg_residual<float>",
                           "dg_cheb<float>",
                           "dg_apply<double> vs vmult_plain"}
    for name, c in checks.items():
        assert c["equal"], (name, c)


def test_transfers_need_no_exchange(rank_runs):
    """On nested cuts a restriction maps owned fine cells to owned coarse
    cells (its one exchange is the coarse slab's refresh, none into a
    replicated level) and a prolongation fills the whole fine slab from
    the coarse slab's ghosts: no exchange; both the whole grids' bits."""
    for world, n_levels in ((2, 2), (4, 1)):
        rows = rank_runs[world, "dg-plain"]["transfers"]
        assert len(rows) == n_levels
        for row in rows:
            assert row["restrict"]["equal"] and row["prolongate"]["equal"]
            assert row["restrict_exchanges"] == int(row["coarse_split"])
            assert row["prolongate_exchanges"] == 0


def test_coupling_needs_no_exchange(rank_runs):
    """``cg_to_dg`` of the FE_Q slab is cell-local; ``dg_to_cg`` reads the
    DG slab's first ghost layer for the cut planes and makes one exchange,
    the FE_Q refresh; both the whole grids' bits."""
    (row,) = rank_runs[2, "dg"]["transfers"]
    assert row["cg_to_dg"]["equal"] and row["dg_to_cg"]["equal"]
    assert row["cg_to_dg_exchanges"] == 0 and row["dg_to_cg_exchanges"] == 1


def test_grid_transfers_and_coupling(rank_runs):
    """On 2 x 2 the same: a DG-plain restriction refreshes its coarse box
    in one exchange (faces only: the ghost corners are not read), a
    prolongation makes none; the DG-over-CG ``dg_to_cg`` refreshes its
    FE_Q box in two, the y rows then the z planes (the corners)."""
    rows = rank_runs[4, "dg-plain", GRID]["transfers"]
    assert len(rows) == 2
    for row in rows:
        assert row["restrict"]["equal"] and row["prolongate"]["equal"]
        assert row["restrict_exchanges"] == 1
        assert row["prolongate_exchanges"] == 0
    (row,) = rank_runs[4, "dg", GRID]["transfers"]
    assert row["cg_to_dg"]["equal"] and row["dg_to_cg"]["equal"]
    assert row["cg_to_dg_exchanges"] == 0 and row["dg_to_cg_exchanges"] == 2


@pytest.mark.parametrize("path", list(KIND))
def test_one_rank_is_the_single_device_solver(rank_runs, path):
    out = rank_runs[1, path]
    assert not any(out["levels"])
    assert out["single"]["cg_equal"] and out["single"]["L2_equal"]


# -------------------------------------------------------------- no ranks
def test_dg_level_bounds():
    """A DG-plain level splits when every rank gets a cell (a pair when a
    level lies below), the cuts nest on coarse-cell boundaries; the FE_Q
    cuts (two cells a rank) are F-1's."""
    mesh = _mesh()
    assert dg_level_bounds(mesh, 2) == [[0, 1, 2], [0, 2, 4], [0, 4, 8]]
    assert dg_level_bounds(mesh, 4) == [None, None, [0, 2, 4, 6, 8]]
    assert dg_level_bounds(mesh, 1) == [None, None, None]
    assert level_bounds(mesh, 2) == [None, [0, 2, 4], [0, 4, 8]]


@pytest.mark.parametrize("kind", ["hermite", "gauss"])
def test_jacobi_of_a_slab_is_the_whole_grids(kind):
    """A rank's slab (owned cells and ghost layers) with the whole grid's
    cell categories gives every stored cell the whole grid's
    transformed-Jacobi inverse diagonal bit for bit.  Built on the slab's
    own grid, the owned cells keep it but a ghost cell gets a slab edge's,
    which the pointwise Chebyshev step would carry into the owned cells'
    A x (the 2-rank DG-plain solve then converges at another rate)."""
    g = DGGrid(cells=(8, 3, 4), jacobian=((0.25, 0.03, 0.0),
                                          (0.02, 0.31, 0.04),
                                          (0.0, 0.05, 0.21)),
               degree=3, kind=kind)
    whole = JacobiTransformed(g, torch.float32, "cpu").inv_diag
    edges = 0
    for world, ghost in ((2, 1), (4, 1), (8, 1), (2, 2), (4, 2)):
        cuts = [8 * r // world for r in range(world + 1)]
        for r in range(world):
            s = DGSlabs(g, Ranks(world, r, torch.device("cpu"), "gloo"),
                        [cuts], ghost=ghost)
            want = whole[s.stored_cells()]
            got = JacobiTransformed(s.local, torch.float32, "cpu",
                                    whole=(g.cells, (s.stored[0][0], 0, 0)))
            assert torch.equal(got.inv_diag, want), (world, ghost, r)
            own = JacobiTransformed(s.local, torch.float32, "cpu").inv_diag
            assert torch.equal(s.own(own), s.own(want)), (world, ghost, r)
            edges += not torch.equal(own, want)
    assert edges > 0


def test_coupling_zeroes_only_true_faces():
    mesh = _mesh()
    grid = DofGrid(mesh, 2, 2).z_slab(2, 6)
    dg = DGGrid(cells=grid.cells, jacobian=((0.125, 0, 0), (0, 0.125, 0),
                                            (0, 0, 0.125)), degree=2,
                kind="hermite")
    r = torch.ones(dg.shape, dtype=torch.float64)
    full = CGDGCoupling(grid, dg, torch.float64, "cpu").dg_to_cg(r)
    cut = CGDGCoupling(grid, dg, torch.float64, "cpu",
                       faces=[(False, True)]).dg_to_cg(r)
    assert torch.all(full[0] == 0) and torch.all(cut[0, 1:-1, 1:-1] != 0)
    assert torch.all(cut[-1] == 0) and torch.all(cut[:, 0] == 0)
    assert torch.equal(cut[1:], full[1:])


def test_load_state_installs_the_slabs(jax_runs):
    """On a world of one the slabs are the whole levels: ``load_state``
    installs the JAX state unchanged, and refuses a level of the wrong
    shape before installing anything."""
    state = jax_runs["dg-plain"]["state"]
    dm = DistributedMultigridDG(_mesh(), 2, sine_exact, sine_rhs,
                                Ranks(1, 0, torch.device("cpu"), "gloo"),
                                solver="dg-plain", kind="gauss")
    convert.load_state(dm, state)
    np.testing.assert_array_equal(dm.rhs.numpy(), state["rhs"])
    for l, jac in enumerate(dm.solver.jacobis):
        np.testing.assert_array_equal(
            jac.inv_diag.numpy(), np.asarray(state["inv_diag"][l], np.float32))
    bad = dict(state, rhs=state["rhs"][:4])
    with pytest.raises(ValueError, match="rhs"):
        convert.load_state(dm, bad)
    with pytest.raises(ValueError, match="solver"):
        DistributedMultigridDG(_mesh(), 2, sine_exact, sine_rhs,
                               Ranks(1, 0, torch.device("cpu"), "gloo"),
                               solver="dg-over-cg")
