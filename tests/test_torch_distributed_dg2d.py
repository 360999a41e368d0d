"""The port's rank-decomposed DG solvers on a 2-D brick
(``parallel.distributed.DistributedMultigridDG``), on ranks of
``torch.distributed`` (gloo, the CPU), against the port's single-device
solvers and the JAX ``DistributedMultigridDG`` on 8 virtual devices.

The problem: sin(3 pi x) sin(3 pi y) on the unit square,
``cube(2, 0, 1, 3, dim=2)`` (16^2 cells), p = 2, tolerance 1e-10:
DG-plain (gauss) on 2 z-slab ranks and on a 2 x 2 grid, DG-over-CG
(hermite, the 2-D FE_Q hierarchy on ``DistributedMultigrid``) on 2 x 2;
the JAX references over ``make_mesh(8, ("z",))`` and ``make_mesh(8, ("z",
"y"))`` (DG-over-CG with ``dp_impl="native"``, the f64 operator the port
applies).  Bars, the JAX test's (tests/test_distributed_dg.py) with the
iterations held closer: frac its and rate to 1e-6 relative, L2 error to
1e-10 relative.  A 2-D DG level runs the plain operators on every device
(``dg_kernel.covers``): the slab passes against the whole grid's are held
at ``time_ranks.apply_ok`` (bit for bit, or within the plain route's
rounding bar), two CG solves bit for bit, the transfers and the coupling
as in 3-D.  Each world size is one launch of ``parallel.programs.
dg_programs`` (module-scoped).
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
from multigrid_tpu_torch.experiments import time_ranks
from multigrid_tpu_torch.mesh.brick import cube
from multigrid_tpu_torch.parallel.programs import (dg_programs, sine_exact,
                                                   sine_rhs)
from multigrid_tpu_torch.parallel.sharding import launch
from multigrid_tpu_torch.solvers.multigrid_dg import (MultigridSolverDG,
                                                      MultigridSolverDGPlain)

TOL = 1e-10
KIND = {"dg-plain": "gauss", "dg": "hermite"}
# (world, path, rank grid: None is the z split)
RUNS = [(2, "dg-plain", None), (4, "dg-plain", (2, 2)), (4, "dg", (2, 2))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh():
    return cube(2, 0.0, 1.0, 3, dim=2)


def _run_id(r):
    ranks = f"{r[0]}ranks" if r[2] is None else "x".join(map(str, r[2]))
    return f"{ranks}-{r[1]}"


@pytest.fixture(scope="module")
def jax_runs():
    """Per run: the JAX DistributedMultigridDG's frac its, rate and L2 (one
    JAX solver a path, wrapped for each mesh)."""
    out, solvers = {}, {}
    for run in RUNS:
        _, path, shape = run
        if path not in solvers:
            cls = JPlain if path == "dg-plain" else JDG
            solvers[path] = cls(
                j_cube(2, 0.0, 1.0, 3, dim=2), 2, sine_exact, sine_rhs,
                kind=KIND[path],
                **({} if path == "dg-plain" else dict(dp_impl="native")))
        s = solvers[path]
        axes = ("z",) if shape is None else ("z", "y")
        x, its, rate = JDistributedDG(s, make_mesh(8, axes)).solve_cg(
            tolerance=TOL)
        out[run] = dict(frac_its=float(its), rate=float(rate),
                        L2=float(s.l2_error(x, s.exact_quad)))
    return out


@pytest.fixture(scope="module")
def singles():
    """The port's single-device rows of both solvers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for path in KIND:
            cls = MultigridSolverDGPlain if path == "dg-plain" \
                else MultigridSolverDG
            s = cls(_mesh(), 2, sine_exact, sine_rhs, kind=KIND[path],
                    device="cpu")
            x, its, rate = s.solve_cg(tolerance=TOL)
            out[path] = dict(frac_its=its, rate=rate,
                             L2=s.l2_error(x, s.exact_quad), cg=x.numpy(),
                             plain_route=s.plain_route)
    finally:
        torch.set_num_threads(n)
    return out


@pytest.fixture(scope="module")
def rank_runs():
    """One launch a world size: the runs of ``RUNS`` (two CG solves each,
    the solution collected, the slab passes and the transfers checked)."""
    out = {}
    for world in (2, 4):
        runs = [r for r in RUNS if r[0] == world]
        kws = [dict(path=path, degree=2, kind=KIND[path], tolerance=TOL,
                    problem="sine", reps=2, collect=True, apply_seed=1,
                    transfer_seed=2, shape=shape) for _, path, shape in runs]
        out.update(zip(runs, launch(dg_programs, world, "gloo", "cpu",
                                    args=(_mesh(), kws))))
    return out


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
@pytest.mark.parametrize("against", ["single", "jax"])
def test_solve_matches(rank_runs, singles, jax_runs, run, against):
    out = rank_runs[run]
    ref = singles[run[1]] if against == "single" else jax_runs[run]
    assert out["frac_its"] == pytest.approx(ref["frac_its"], rel=1e-6)
    assert out["rate"] == pytest.approx(ref["rate"], rel=1e-6)
    assert abs(out["L2"] - ref["L2"]) <= 1e-10 * ref["L2"]
    if against == "single":
        np.testing.assert_allclose(out["cg"], ref["cg"], rtol=0,
                                   atol=1e-8 * np.abs(ref["cg"]).max())


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_cg_solves_repeat_bit_for_bit(rank_runs, run):
    assert rank_runs[run]["cg_repeat_equal"]


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_slab_passes_are_the_whole_grids(rank_runs, singles, run):
    """2-D levels take the plain route on ranks as on one device; the
    owned cells of the slab's f64 apply, f32 residual and Chebyshev step
    are the whole grid's (``time_ranks.apply_ok``), the f64 apply the
    plain JAX algorithm's to 1e-12."""
    out = rank_runs[run]
    assert out["plain_route"] and singles[run[1]]["plain_route"]
    checks = out["apply"]
    assert set(checks) == {"dg_apply<double>", "dg_residual<float>",
                           "dg_cheb<float>",
                           "dg_apply<double> vs vmult_plain"}
    for name, c in checks.items():
        assert time_ranks.apply_ok(name, c, True), (name, c)
    assert checks["dg_apply<double>"]["equal"]


def test_levels_split(rank_runs):
    """DG-plain splits every level on 2 z ranks and on 2 x 2 (a cell a
    rank along each split axis, a pair above the coarsest); DG-over-CG
    splits its DG level and all FE_Q levels but the coarsest (2^2 cells,
    one a rank)."""
    z, grid = rank_runs[RUNS[0]], rank_runs[RUNS[1]]
    assert z["levels"] == [True] * 4 and z["bounds"] == [0, 8, 16]
    assert grid["levels"] == [True] * 4
    assert grid["bounds"] == [[0, 8, 16], [0, 8, 16]]
    assert rank_runs[RUNS[2]]["levels"] == [True, False, True, True, True]
    for key, out in rank_runs.items():
        assert out["foreign"] == [], key


@pytest.mark.parametrize("run", RUNS[:2], ids=_run_id)
def test_transfers_need_no_exchange(rank_runs, run):
    """A DG-plain restriction maps owned fine cells to owned coarse cells
    and refreshes the coarse box (one exchange), a prolongation fills the
    fine box from the coarse box's ghosts (none): the prolongation the
    whole grid's bits, the f32 restriction within its rounding (a box and
    the whole grid are contractions of other shapes)."""
    rows = rank_runs[run]["transfers"]
    assert len(rows) == 3
    for row in rows:
        r = row["restrict"]
        assert r["equal"] or r["max_diff"] <= 1e-6 * r["scale"], row
        assert row["prolongate"]["equal"]
        assert row["restrict_exchanges"] == 1
        assert row["prolongate_exchanges"] == 0


def test_coupling_on_the_grid(rank_runs):
    """DG-over-CG on 2 x 2: ``cg_to_dg`` cell-local, ``dg_to_cg`` one
    refresh of the FE_Q box in two stages; both the whole grids' bits."""
    (row,) = rank_runs[RUNS[2]]["transfers"]
    assert row["cg_to_dg"]["equal"] and row["dg_to_cg"]["equal"]
    assert row["cg_to_dg_exchanges"] == 0 and row["dg_to_cg_exchanges"] == 2


def test_apply_ok_holds_kernels_bit_for_bit():
    """A 3-D row's slab kernels pass only bit for bit; a 2-D row's plain
    passes within the route's bar of max|y|, by value type."""
    near = dict(equal=False, max_diff=5e-7, scale=1.0)
    assert not time_ranks.apply_ok("dg_residual<float>", near, False)
    assert time_ranks.apply_ok("dg_residual<float>", near, True)
    assert not time_ranks.apply_ok("dg_apply<double>", near, True)
    assert time_ranks.apply_ok("dg_apply<double>",
                               dict(equal=True, max_diff=0.0, scale=1.0),
                               False)


def test_time_ranks_dim_takes_a_dg_path():
    with pytest.raises(SystemExit, match="--path dg"):
        time_ranks.main(["8", "--dim", "2", "--device", "cpu"])
