"""The port's local-smoothing multigrid (``solvers/multigrid_local.py``,
the reference poisson_l's preconditioner) against the JAX package, on the
CPU.

Twins of tests/test_local_smoothing.py, with the same meshes and bars,
plus, on the same forest (``convert.adaptive_forest``):

* the level meshes, the refinement-edge and boundary masks and the copy
  tables equal the JAX ones exactly;
* one V-cycle in float64 at 1e-12 of the JAX one's, the state carried
  across, on a residual drawn from a numpy seed;
* with the JAX state carried across, the same CG iterations and L2 error
  to 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import experiments.poisson_l as JL
from multigrid_tpu.mesh.adaptive import AdaptiveGrid as JGrid
from multigrid_tpu.solvers.multigrid_local import (
    LocalSmoothingMultigrid as JLocal)
from multigrid_tpu_torch import convert
from multigrid_tpu_torch.experiments import poisson_l as TL
from multigrid_tpu_torch.mesh.adaptive import AdaptiveGrid
from multigrid_tpu_torch.solvers.multigrid_adaptive import (
    AdaptiveMultigridSolver)
from multigrid_tpu_torch.solvers.multigrid_local import (
    LocalSmoothingMultigrid, level_forest)

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def corner_forest(cycles=2, dim=2, initial=2):
    """A few deterministic refinements of the L near the reentrant corner
    (a port forest)."""
    f = TL.l_forest(initial, dim)
    for _ in range(cycles):
        marks = [c for c in f.active
                 if max(abs(f.cell_corner(c)[0] + f.h(c.level) / 2),
                        abs(f.cell_corner(c)[1] + f.h(c.level) / 2)) < 0.3]
        f = f.refine(marks)
    return f


def local(forest, **kw):
    return LocalSmoothingMultigrid(AdaptiveGrid(forest, 2, TL.boundary_fn),
                                   TL.exact_fn, TL.rhs_fn, device="cpu", **kw)


def test_level_forest_partition_and_nesting():
    f = corner_forest(2)
    areas = []
    for l in range(f.max_active_level + 1):
        lf = level_forest(f, l)
        assert all(c.level == l for c in lf.active)
        areas.append(sum(lf.h(c.level) ** 2 for c in lf.active))
    assert areas[0] == pytest.approx(3.0, rel=1e-12)   # the L's area
    assert all(a2 <= a1 + 1e-12 for a1, a2 in zip(areas, areas[1:]))


def test_edge_masks_and_copy_partition():
    s = local(corner_forest(2))
    assert not s.levels[0].edge.any()
    assert s.levels[-1].edge.any()
    counts = np.zeros(s.grid.n_dofs, int)
    for gl in s.copy_glb:
        counts[gl.numpy()] += 1
    assert (counts == 1).all()


@pytest.fixture(scope="module")
def jax_and_port_local():
    """The local-smoothing solver on one corner-refined L in both packages,
    with f64 V-cycles and mixed, the JAX states carried into the port's
    (the Chebyshev intervals come from Lanczos runs that round
    differently)."""
    tf = corner_forest(2)
    jf = JL.l_forest(2)
    for _ in range(2):
        marks = [c for c in jf.active
                 if max(abs(jf.cell_corner(c)[0] + jf.h(c.level) / 2),
                        abs(jf.cell_corner(c)[1] + jf.h(c.level) / 2)) < 0.3]
        jf = jf.refine(marks)
    assert sorted(convert.adaptive_forest(jf).active,
                  key=lambda c: (c.level,) + c.coords) == \
        sorted(tf.active, key=lambda c: (c.level,) + c.coords)
    jg = JGrid(jf, 2, JL.boundary_fn)
    sj64 = JLocal(jg, JL.exact_fn, JL.rhs_fn, v_dtype=jnp.float64)
    st64 = local(tf, v_dtype=torch.float64)
    convert.load_state(st64, convert.adaptive_state(sj64))
    sj = JLocal(jg, JL.exact_fn, JL.rhs_fn)
    st = local(tf)
    convert.load_state(st, convert.adaptive_state(sj))
    return sj64, st64, sj, st


def test_levels_and_copies_match_jax(jax_and_port_local):
    sj, st, _, _ = jax_and_port_local
    assert len(st.levels) == len(sj.levels)
    for lt, lj in zip(st.levels, sj.levels):
        np.testing.assert_array_equal(lt.grid.gidx, lj.grid.gidx)
        np.testing.assert_array_equal(lt.edge, lj.edge)
        np.testing.assert_array_equal(lt.boundary, lj.boundary)
    for a, b in zip(st.copy_glb + st.copy_lvl, sj.copy_glb + sj.copy_lvl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_v_cycle_matches_jax_and_is_symmetric(jax_and_port_local):
    """One f64 V-cycle at 1e-12 of JAX's; the preconditioner is symmetric
    (the JAX test's bar)."""
    sj, st, _, _ = jax_and_port_local
    g = st.grid
    rng = np.random.default_rng(5)
    interior = ~g.boundary
    r1 = np.where(interior, rng.standard_normal(g.n_dofs), 0.0)
    r2 = np.where(interior, rng.standard_normal(g.n_dofs), 0.0)
    b1 = st.v_cycle(torch.as_tensor(r1))
    want = np.asarray(jax.jit(sj.v_cycle)(jnp.asarray(r1)))
    assert np.abs(b1.numpy() - want).max() < 1e-12 * np.abs(want).max()
    b2 = st.v_cycle(torch.as_tensor(r2))
    assert float(b1 @ torch.as_tensor(r2)) == pytest.approx(
        float(torch.as_tensor(r1) @ b2), rel=1e-12)


def test_local_state_transfer_solve_matches_jax(jax_and_port_local):
    _, _, sj, st = jax_and_port_local
    sol_j, its_j, red_j = sj.solve_cg()
    sol, its, red = st.solve_cg()
    assert its == its_j
    assert st.l2_error(sol) == pytest.approx(sj.l2_error(sol_j), rel=1e-8)
    assert red == pytest.approx(red_j, rel=1e-4)


def test_uniform_forest_reduces_to_global_coarsening():
    """On a uniformly refined forest the level meshes are the
    global-coarsening ladder and every dof is copied to the finest level:
    both solvers run the same V-cycle (range 20 for both)."""
    f = TL.l_forest(2, 2)
    grids = TL.mg_ladder(f, 2)
    gc = AdaptiveMultigridSolver(grids, TL.exact_fn, TL.rhs_fn, device="cpu")
    ls = LocalSmoothingMultigrid(grids[-1], TL.exact_fn, TL.rhs_fn,
                                 device="cpu", smoothing_range=20.0)
    for lv in ls.levels:
        assert not lv.edge.any()
    sol_gc, its_gc, red_gc = gc.solve_cg()
    sol_ls, its_ls, red_ls = ls.solve_cg()
    assert its_ls == its_gc
    assert red_ls == pytest.approx(red_gc, rel=0.05)
    np.testing.assert_allclose(sol_ls.numpy(), sol_gc.numpy(), atol=1e-9)


@pytest.mark.parametrize("cycles", [1, 3])
def test_adaptive_solve_matches_global_coarsening(cycles):
    f = corner_forest(cycles)
    ls = local(f)
    assert ls.grid.n_constraints > 0
    sol, its, red = ls.solve_cg()
    gc = AdaptiveMultigridSolver(TL.mg_ladder(f, 2), TL.exact_fn, TL.rhs_fn,
                                 device="cpu")
    sol_gc, its_gc, _ = gc.solve_cg()
    np.testing.assert_allclose(sol.numpy(), sol_gc.numpy(), atol=2e-7)
    assert ls.l2_error(sol) == pytest.approx(gc.l2_error(sol_gc), rel=1e-4)
    assert its <= its_gc + 3
    assert red < 0.35


def test_kelly_driven_amr_iterations_stay_bounded():
    """poisson_l's AMR loop with local smoothing: flat iteration counts
    across cycles (program.cc:572-601)."""
    f = TL.l_forest(2, 2)
    its_hist = []
    for _ in range(3):
        row, sol, eta2, s = TL.run_cycle(f, 2, local_smoothing=True,
                                         device="cpu")
        its_hist.append(row["solver_its"])
        f = TL.refine_and_coarsen_fixed_number(f, eta2, 0.15, 0.03)
    assert max(its_hist) <= min(its_hist) + 2
    assert max(its_hist) <= 12


def test_local_smoothing_3d_extruded_l():
    f = TL.l_forest(1, 3)
    marks = [c for c in f.active
             if abs(f.cell_corner(c)[0] + f.h(c.level) / 2) < 0.55
             and abs(f.cell_corner(c)[1] + f.h(c.level) / 2) < 0.55]
    f = f.refine(marks)
    ls = local(f)
    assert ls.grid.n_constraints > 0
    sol, its, red = ls.solve_cg()
    assert its <= 14
    gc = AdaptiveMultigridSolver(TL.mg_ladder(f, 2), TL.exact_fn, TL.rhs_fn,
                                 device="cpu")
    sol_gc, _, _ = gc.solve_cg()
    np.testing.assert_allclose(sol.numpy(), sol_gc.numpy(), atol=5e-7)
