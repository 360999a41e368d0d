"""The port's adaptive-mesh slice (hanging nodes, global coarsening,
poisson_l) against the JAX package, on the CPU, in 2-D and 3-D.

Twins of tests/test_adaptive.py and tests/test_adaptive3d.py, with the
same meshes and bars, plus, on the same forest carried across by
``convert.adaptive_forest``:

* the tables equal exactly: active cells, ``gidx``, ``boundary``, the
  constraint count, the dof coordinates, the nested point-evaluation
  tables; ``gw`` to 1e-14;
* the operator apply at 1e-12 (f64) and 1e-5 (f32) of the largest value,
  the diagonal, right-hand side and error norms at 1e-12, on inputs drawn
  from a numpy seed; the transfers at 1e-12;
* the Kelly ``eta2`` at 1e-10 relative;
* with the JAX solver's state carried across (``convert.adaptive_state``,
  ``convert.load_state``): the same CG iterations and L2 error to 1e-8;
* the first four cycles of ``poisson_l 4 --initial 5`` (the JAX driver's
  rows: dofs, constraints and iterations exactly, reductions and val_L2
  to 0.5%); ``--dim 3``, ``--uniform`` and ``--local-smoothing`` run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import experiments.poisson_l as JL
from multigrid_tpu.mesh import adaptive as ja
from multigrid_tpu.ops.laplace_adaptive import (AdaptiveLaplace as JOp,
                                                KellyEstimator as JKelly)
from multigrid_tpu.solvers.multigrid_adaptive import (
    AdaptiveMultigridSolver as JSolver, NestedTransfer as JTransfer)
from multigrid_tpu_torch import convert
from multigrid_tpu_torch.experiments import poisson_l as TL
from multigrid_tpu_torch.mesh.adaptive import (AdaptiveGrid, OctForest,
                                               QuadForest)
from multigrid_tpu_torch.ops.laplace_adaptive import (AdaptiveLaplace,
                                                      KellyEstimator)
from multigrid_tpu_torch.ops.laplace_general import NodeScatter
from multigrid_tpu_torch.solvers.multigrid_adaptive import (
    AdaptiveMultigridSolver, NestedTransfer)

jax.config.update("jax_enable_x64", True)

CPU = torch.device("cpu")
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def square_boundary(xy):
    tol = 1e-9
    out = np.zeros(xy.shape[0], bool)
    for d in range(xy.shape[1]):
        out |= (np.abs(xy[:, d] + 1) < tol) | (np.abs(xy[:, d] - 1) < tol)
    return out


def hanging_forest(extra=1, dim=2, jax_forest=False):
    """The full square (cube), the (-1, ..., -1) corner region refined
    ``extra`` more times (tests/test_adaptive.py, test_adaptive3d.py)."""
    mod = ja if jax_forest else None
    if dim == 2:
        f = (mod.QuadForest if mod else QuadForest)(2, -1.0, 2.0)
        f = f.uniform_refine()
    else:
        f = (mod.OctForest if mod else OctForest)(2, -1.0, 2.0)
    for _ in range(extra):
        marks = [c for c in f.active
                 if all(x < -0.49 for x in f.cell_corner(c))]
        f = f.refine(marks)
    return f


def corner_forest(cycles=2, dim=2, initial=2):
    """A JAX L-domain forest refined near the reentrant corner."""
    f = JL.l_forest(initial, dim)
    for _ in range(cycles):
        marks = [c for c in f.active
                 if max(abs(f.cell_corner(c)[0] + f.h(c.level) / 2),
                        abs(f.cell_corner(c)[1] + f.h(c.level) / 2)) < 0.3]
        f = f.refine(marks)
    return f


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def cells_of(f):
    return sorted((c.level,) + c.coords for c in f.active)


# ---------------------------------------------------------------- forests
@pytest.mark.parametrize("dim", [2, 3])
def test_forest_balance_and_coverage(dim):
    f = hanging_forest(3, dim)
    vol = sum(f.h(c.level) ** dim for c in f.active)
    assert vol == pytest.approx(2.0**dim, rel=1e-12)
    for c in f.active:
        for d in range(dim):
            for s in (0, 1):
                f.find_active_neighbor(c, d, s)  # raises if unbalanced
    assert cells_of(f) == cells_of(hanging_forest(3, dim, jax_forest=True))


@pytest.mark.parametrize("dim", [2, 3])
def test_coarsen_global_nested_partition(dim):
    f = hanging_forest(2, dim)
    c = f.coarsen_global()
    vol = sum(c.h(q.level) ** dim for q in c.active)
    assert vol == pytest.approx(2.0**dim, rel=1e-12)
    assert max(q.level for q in c.active) <= max(q.level for q in f.active)
    for q in f.active:      # nested: every fine cell inside a coarse one
        while q.level >= 0 and q not in c.active:
            q = q.parent
        assert q.level >= 0
    jf = hanging_forest(2, dim, jax_forest=True)
    assert cells_of(c) == cells_of(jf.coarsen_global())


def test_l_forest_refinement_matches_jax():
    """Refinement with coarsening marks, balance and the global-coarsening
    ladder give the JAX forests, cell for cell."""
    jf = corner_forest(2)
    tf = convert.adaptive_forest(jf)
    assert cells_of(tf) == cells_of(jf)
    order_j, order_t = jf.sorted_cells(), tf.sorted_cells()
    assert [(c.level,) + c.coords for c in order_j] == \
        [(c.level,) + c.coords for c in order_t]
    eta = np.random.default_rng(3).random(len(order_j))
    jr = JL.refine_and_coarsen_fixed_number(jf, eta, 0.15, 0.1)
    tr = TL.refine_and_coarsen_fixed_number(tf, eta, 0.15, 0.1)
    assert cells_of(tr) == cells_of(jr)
    ladder_j = JL.mg_ladder(jr, 2)
    ladder_t = TL.mg_ladder(tr, 2)
    assert [cells_of(g.forest) for g in ladder_t] == \
        [cells_of(g.forest) for g in ladder_j]


# ------------------------------------------------------------------ grids
GRID_CASES = {
    "2d-hanging-p1": (lambda j: hanging_forest(1, 2, j), 1, square_boundary),
    "2d-hanging-p2": (lambda j: hanging_forest(2, 2, j), 2, square_boundary),
    "2d-hanging-p3": (lambda j: hanging_forest(1, 2, j), 3, square_boundary),
    "3d-hanging-p1": (lambda j: hanging_forest(1, 3, j), 1, square_boundary),
    "3d-hanging-p2": (lambda j: hanging_forest(2, 3, j), 2, square_boundary),
}


def grid_pair(case):
    make, degree, bfn = GRID_CASES[case]
    return (ja.AdaptiveGrid(make(True), degree, bfn),
            AdaptiveGrid(make(False), degree, bfn))


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_tables_match_jax(case):
    gj, gt = grid_pair(case)
    assert gt.n_constraints == gj.n_constraints > 0
    assert (gt.n_dofs, gt.K) == (gj.n_dofs, gj.K)
    np.testing.assert_array_equal(gt.gidx, gj.gidx)
    np.testing.assert_array_equal(gt.boundary, gj.boundary)
    np.testing.assert_array_equal(gt.dof_xy, gj.dof_xy)
    np.testing.assert_allclose(gt.gw, gj.gw, rtol=0, atol=1e-14)


@pytest.mark.parametrize("dim", [2, 3])
def test_point_eval_tables_match_jax(dim):
    """The vectorized nested point evaluation gives the JAX table, entry
    order and weights, on refinement pairs and a global-coarsening pair."""
    jf = corner_forest(1, dim, initial=2 if dim == 2 else 1)
    pairs = [(JL.l_forest(2 if dim == 2 else 1, dim), jf),
             (jf.coarsen_global(), jf)]
    for jc, jfine in pairs:
        gj_c = ja.AdaptiveGrid(jc, 2, JL.boundary_fn)
        gj_f = ja.AdaptiveGrid(jfine, 2, JL.boundary_fn)
        gt_c = AdaptiveGrid(convert.adaptive_forest(jc), 2, TL.boundary_fn)
        gt_f = AdaptiveGrid(convert.adaptive_forest(jfine), 2,
                            TL.boundary_fn)
        idx_j, w_j = gj_f.point_eval_table(gj_c)
        idx_t, w_t = gt_f.point_eval_table(gt_c, chunk=100)
        np.testing.assert_array_equal(idx_t, idx_j)
        np.testing.assert_array_equal(w_t, w_j)


# --------------------------------------------------------------- operator
@pytest.mark.parametrize("case", ["2d-hanging-p2", "3d-hanging-p2"])
def test_operator_matches_jax(case):
    gj, gt = grid_pair(case)
    x = np.random.default_rng(7).standard_normal(gt.n_dofs)
    for tdt, jdt, tol in ((F64, jnp.float64, 1e-12),
                          (torch.float32, jnp.float32, 1e-5)):
        opj, opt = JOp(gj, jdt), AdaptiveLaplace(gt, tdt, CPU)
        xt = torch.as_tensor(x, dtype=tdt)
        for name in ("apply_cells", "vmult"):
            got = getattr(opt, name)(xt).numpy()
            want = np.asarray(getattr(opj, name)(jnp.asarray(x, jdt)))
            assert rel_err(got, want) < tol, name
        got = opt.vmult_residual(xt, 0.5 * xt).numpy()
        want = opj.vmult_residual(jnp.asarray(x, jdt),
                                  0.5 * jnp.asarray(x, jdt))
        assert rel_err(got, want) < tol
    opj, opt = JOp(gj, jnp.float64), AdaptiveLaplace(gt, F64, CPU)
    assert rel_err(opt.inverse_diagonal().numpy(),
                   opj.inverse_diagonal()) < 1e-12
    u_bc = np.where(gt.boundary, x, 0.0)
    f = np.random.default_rng(8).standard_normal((gt.n_cells, opt.N))
    got = opt.compute_rhs(torch.as_tensor(f), torch.as_tensor(u_bc))
    want = opj.compute_rhs(jnp.asarray(f), jnp.asarray(u_bc))
    assert rel_err(got.numpy(), want) < 1e-12
    ex = np.random.default_rng(9).standard_normal((gt.n_cells, opt.N))
    assert float(opt.l2_error(torch.as_tensor(x), torch.as_tensor(ex))) == \
        pytest.approx(float(opj.l2_error(jnp.asarray(x), jnp.asarray(ex))),
                      rel=1e-12)
    np.testing.assert_array_equal(opt.quad_points(), opj.quad_points())


@pytest.mark.parametrize("case", ["2d-hanging-p1", "2d-hanging-p2",
                                  "2d-hanging-p3", "3d-hanging-p1",
                                  "3d-hanging-p2"])
def test_hanging_operator_symmetric_pd_and_diag(case):
    _, g = grid_pair(case)
    op = AdaptiveLaplace(g, F64, CPU)
    cols = torch.stack([op.apply_cells(e) for e in torch.eye(g.n_dofs,
                                                             dtype=F64)],
                       dim=1).numpy()
    interior = ~g.boundary
    A = cols[np.ix_(interior, interior)]
    assert np.abs(A - A.T).max() < 1e-12 * np.abs(A).max()
    assert np.linalg.eigvalsh(0.5 * (A + A.T)).min() > 0
    d_exact = np.diag(cols).copy()
    d_exact[g.boundary] = 1.0
    d_ours = 1.0 / op.inverse_diagonal().numpy()
    assert np.abs(d_exact - d_ours).max() < 1e-12 * np.abs(d_exact).max()


@pytest.mark.parametrize("dim,energy", [(2, 8.0), (3, 24.0)])
def test_hanging_interpolation_exactness(dim, energy):
    """A global polynomial of degree p lies in the constrained space: its
    discrete energy is the analytic one (u = x^2 + x y (+ z))."""
    for extra in (1, 2):
        g = AdaptiveGrid(hanging_forest(extra, dim), 2, square_boundary)
        assert g.n_constraints > 0
        op = AdaptiveLaplace(g, F64, CPU)
        xy = g.dof_xy
        u = xy[:, 0] ** 2 + xy[:, 0] * xy[:, 1]
        if dim == 3:
            u = u + xy[:, 2]
        u = torch.as_tensor(u)
        assert float(torch.dot(u, op.apply_cells(u))) == pytest.approx(
            energy, rel=1e-12)


def test_node_scatter_gives_zero_to_nodes_without_entries():
    table = np.array([[0, 2], [2, 0]])
    y = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=F64)
    with pytest.raises(ValueError, match="every node"):
        NodeScatter(table, 4, CPU)
    got = NodeScatter(table, 4, CPU, allow_empty=True)(y)
    np.testing.assert_array_equal(got.numpy(), [5.0, 0.0, 5.0, 0.0])


# -------------------------------------------------------------- transfers
def test_nested_transfer_preserves_polynomials_and_matches_jax():
    gc = AdaptiveGrid(hanging_forest(0), 2, square_boundary)
    gf = AdaptiveGrid(hanging_forest(1), 2, square_boundary)
    tr = NestedTransfer(gf, gc, F64, CPU)
    xyc, xyf = gc.dof_xy, gf.dof_xy
    uf = tr.interpolate(torch.as_tensor(xyc[:, 0] ** 2 + 0.3 * xyc[:, 1]))
    assert np.abs(uf.numpy() - (xyf[:, 0] ** 2 + 0.3 * xyf[:, 1])).max() \
        < 1e-12
    trj = JTransfer(ja.AdaptiveGrid(hanging_forest(1, 2, True), 2,
                                    square_boundary),
                    ja.AdaptiveGrid(hanging_forest(0, 2, True), 2,
                                    square_boundary), jnp.float64)
    rng = np.random.default_rng(11)
    xc, xf = rng.standard_normal(gc.n_dofs), rng.standard_normal(gf.n_dofs)
    assert rel_err(tr.prolongate(torch.as_tensor(xc)).numpy(),
                   trj.prolongate(jnp.asarray(xc))) < 1e-12
    assert rel_err(tr.restrict(torch.as_tensor(xf)).numpy(),
                   trj.restrict(jnp.asarray(xf))) < 1e-12


# ---------------------------------------------------------------- solvers
def _mms(dim):
    def exact(c):
        out = 1.0
        for x in c[:dim]:
            out = out * np.sin(np.pi * np.asarray(x))
        return out

    return exact, lambda c: dim * np.pi**2 * exact(c)


@pytest.mark.parametrize("dim,max_its", [(2, 10), (3, 12)])
def test_adaptive_multigrid_mms(dim, max_its):
    """Smooth MMS on a hanging-node hierarchy: bounded iterations, the
    error falls with refinement."""
    exact, rhs = _mms(dim)
    forests = [hanging_forest(k, dim) for k in range(3)]
    errs = []
    for upto in (2, 3):
        grids = [AdaptiveGrid(f, 2, square_boundary) for f in forests[:upto]]
        s = AdaptiveMultigridSolver(grids, exact, rhs, device="cpu")
        sol, its, red = s.solve_cg()
        assert its <= max_its
        errs.append(s.l2_error(sol))
    assert errs[1] < errs[0]


@pytest.fixture(scope="module")
def jax_and_port_l():
    """One global-coarsening solve on the corner-refined L, in both
    packages on the same forest, the JAX state carried into the port."""
    jf = corner_forest(2)
    sj = JSolver(JL.mg_ladder(jf, 2), JL.exact_fn, JL.rhs_fn)
    st = TL.build_solver(convert.adaptive_forest(jf), 2, device="cpu")
    own = (st.rhs.clone(), [op.inv_diag.clone() for op in st.ops],
           st.solve_cg())
    state = convert.adaptive_state(sj)
    convert.load_state(st, state)
    return sj, st, state, own, sj.solve_cg()


def test_adaptive_set_up_matches_jax(jax_and_port_l):
    sj, st, state, (rhs, inv, _), _ = jax_and_port_l
    assert rel_err(rhs.numpy(), state["rhs"]) < 1e-12
    for got, want in zip(inv, state["inv_diag"]):
        assert rel_err(got.numpy(), want) < 1e-6
    for (got, want) in zip([sm.max_eig for sm in st.smoothers],
                           [c[3] for c in state["chebyshev"]]):
        assert got == pytest.approx(want, rel=1e-9)


def test_adaptive_solves_match_jax(jax_and_port_l):
    """The port's own set-up gives the JAX iterations; with the state
    carried across, the same iterations and L2 error to 1e-8."""
    sj, st, _, (_, _, own), (sol_j, its_j, red_j) = jax_and_port_l
    err_j = sj.l2_error(sol_j)
    assert own[1] == its_j
    assert st.l2_error(own[0]) == pytest.approx(err_j, rel=1e-6)
    sol, its, red = st.solve_cg()
    assert its == its_j
    assert st.l2_error(sol) == pytest.approx(err_j, rel=1e-8)
    assert red == pytest.approx(red_j, rel=1e-4)
    np.testing.assert_allclose(sol.numpy(), np.asarray(sol_j), rtol=0,
                               atol=1e-9)


def test_adaptive_state_refuses_another_numbering(jax_and_port_l):
    _, st, state, _, _ = jax_and_port_l
    bad = dict(state, gidx=[g[::-1] for g in state["gidx"]],
               rhs=2 * state["rhs"])
    with pytest.raises(ValueError, match="gidx"):
        convert.load_state(st, bad)
    bad = dict(state, gw=[1.5 * g for g in state["gw"]])
    with pytest.raises(ValueError, match="gw"):
        convert.load_state(st, bad)
    np.testing.assert_array_equal(st.rhs.numpy(), state["rhs"])


def test_kelly_matches_jax_and_marks_the_singular_corner(jax_and_port_l):
    """eta2 of the same solution to 1e-10 relative (same-level and 2:1
    faces); the top-marked cell touches the reentrant corner
    (program.cc:527-533)."""
    sj, st, _, _, (sol_j, _, _) = jax_and_port_l
    eta_j = JKelly(sj.op_dp)(sol_j)
    kelly = KellyEstimator(st.op_dp)
    assert kelly.cf.size and kelly.same.size
    eta_t = kelly(torch.as_tensor(np.array(sol_j)))
    assert rel_err(eta_t, eta_j) < 1e-10
    g = st.grids[-1]
    top = g.cells[int(np.argmax(eta_t))]
    x0, y0 = g.forest.cell_corner(top)
    h = g.forest.h(top.level)
    assert min(abs(x0), abs(x0 + h)) < 1e-9
    assert min(abs(y0), abs(y0 + h)) < 1e-9


def test_kelly_3d_matches_jax():
    jf = corner_forest(1, 3, initial=1)
    gj = ja.AdaptiveGrid(jf, 2, JL.boundary_fn)
    gt = AdaptiveGrid(convert.adaptive_forest(jf), 2, TL.boundary_fn)
    x = np.random.default_rng(4).standard_normal(gt.n_dofs)
    eta_j = JKelly(JOp(gj, jnp.float64))(jnp.asarray(x))
    kelly = KellyEstimator(AdaptiveLaplace(gt, F64, CPU))
    assert kelly.cf.size
    assert rel_err(kelly(torch.as_tensor(x)), eta_j) < 1e-10


def test_adaptive_beats_uniform():
    """At equal dofs the adaptive hierarchy reaches a lower H1 error than
    uniform refinement on the corner singularity (the poisson_l
    criterion)."""
    forest = TL.l_forest(1)
    rows = []
    for _ in range(5):
        row, sol, eta2, s = TL.run_cycle(forest, 2, device="cpu")
        rows.append(row)
        forest = TL.refine_and_coarsen_fixed_number(forest, eta2, 0.15, 0.03)
    urow, *_ = TL.run_cycle(TL.l_forest(2), 2, device="cpu")
    best = min((r for r in rows if r["dofs"] <= urow["dofs"]),
               key=lambda r: r["grad_L2"])
    assert best["grad_L2"] < urow["grad_L2"]


def test_poisson_l_3d_adaptive_cycle():
    """Two cycles of the 3-D extruded L: Kelly marks the reentrant edge,
    the iterations stay bounded, the L2 error falls."""
    forest = TL.l_forest(1, dim=3)
    row0, sol0, eta2, s0 = TL.run_cycle(forest, 2, device="cpu")
    assert row0["solver_its"] <= 10
    g = s0.grids[-1]
    top = g.cells[int(np.argmax(eta2))]
    corner = g.forest.cell_corner(top)
    h = g.forest.h(top.level)
    assert min(abs(corner[0]), abs(corner[0] + h)) < 1e-9
    assert min(abs(corner[1]), abs(corner[1] + h)) < 1e-9
    forest = TL.refine_and_coarsen_fixed_number(forest, eta2, 0.15, 0.03)
    row1, *_ = TL.run_cycle(forest, 2, device="cpu")
    assert row1["solver_its"] <= 10
    assert row1["val_L2"] < row0["val_L2"]
    assert row1["constraints"] > 0


# ------------------------------------------------------------ experiment
# the JAX driver's first four cycles of poisson_l 6 --initial 5 on the CPU:
# (dofs, constraints, its, reduction, val_L2)
L_ANCHORS = [(12545, 0, 8, 0.06868, 1.1102e-4),
             (17865, 288, 8, 0.06927, 4.3601e-5),
             (24975, 1632, 8, 0.06922, 1.7189e-5),
             (35161, 3764, 8, 0.06910, 6.7952e-6)]


def test_poisson_l_driver_reproduces_the_jax_anchors(capsys):
    rows = TL.main(["4", "--initial", "5", "--device", "cpu"])
    assert len(rows) == len(L_ANCHORS)
    for row, (dofs, cons, its, red, l2) in zip(rows, L_ANCHORS):
        assert (row["dofs"], row["constraints"], row["solver_its"]) == \
            (dofs, cons, its)
        assert row["reduction"] == pytest.approx(red, rel=5e-3)
        assert row["val_L2"] == pytest.approx(l2, rel=5e-3)
    assert all(r["transfer_rel_diff"] < 1e-3 for r in rows[1:])
    assert "solver_its" in capsys.readouterr().out


@pytest.mark.parametrize("args,its_bar", [
    (["2", "--dim", "3"], 10),
    (["2", "--initial", "2", "--uniform"], 10),
    (["3", "--initial", "2", "--local-smoothing"], 12)])
def test_poisson_l_driver_options_run(args, its_bar):
    rows = TL.main(args + ["--device", "cpu"])
    assert len(rows) == int(args[0])
    assert all(r["solver_its"] <= its_bar for r in rows)
    assert all(r["val_L2"] < 1e-2 for r in rows)
    assert rows[1]["dofs"] > rows[0]["dofs"]


def test_poisson_l_driver_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        TL.main([])


def test_adaptive_modules_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = AdaptiveGrid(hanging_forest(0), 1, square_boundary)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdaptiveLaplace(g)


@pytest.mark.parametrize("path", ["l", "dg-curved"])
def test_profile_ranges_wrap_and_restore(path, tmp_path):
    """``profile_solve --path l`` and ``--path dg-curved`` open their
    record_function ranges around the operator and transfer methods for
    the profiled run only (same results, methods put back)."""
    from torch.profiler import ProfilerActivity, profile

    from multigrid_tpu_torch.experiments import profile_solve as ps

    if path == "l":
        s = TL.build_solver(TL.l_forest(1), 2, device="cpu")
        run = lambda: s.solve_cg()[0]
        want = {"op gather", "op scatter", "op matmul", "transfer"}
    else:
        from multigrid_tpu_torch.experiments.poisson_dg_plain import (
            deform_chart)
        from multigrid_tpu_torch.experiments.poisson_cube import (exact_fn,
                                                                  rhs_fn)
        from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh
        from multigrid_tpu_torch.solvers.multigrid_dg import (
            MultigridSolverDGPlain)

        mesh = poisson_cube_mesh(2)
        s = MultigridSolverDGPlain(mesh, 2, exact_fn, rhs_fn, kind="hermite",
                                   device="cpu",
                                   mapping=deform_chart(mesh, 0.05))
        run = lambda: s.solve_cg(tolerance=1e-6)[0]
        want = {"op gather", "op scatter", "op matmul", "op quad-point",
                "jacobi", "transfer"}
    before = [getattr(o, a) for o, a, _ in ps.RANGES[path]]
    ref = run()
    with ps.path_ranges(path), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        got = run()
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert [getattr(o, a) for o, a, _ in ps.RANGES[path]] == before
    trace = tmp_path / "t.json"
    prof.export_chrome_trace(str(trace))
    import json

    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert want <= names
