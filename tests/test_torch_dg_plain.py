"""The port's pure-DG h-multigrid slice against the JAX package, on the CPU.

* ``DGTransfer``: prolongation and restriction against the JAX twin in 2-D
  and 3-D, float64 to 1e-13 and float32 to 1e-6 of the largest value.
* ``solvers/fused``: both compositions against JAX at 1e-12 (f64).
* ``DGLaplaceVarCoeff.apply`` and the exact per-cell
  ``JacobiTransformed.inv_diag`` against JAX at 1e-11 (f64).
* ``MultigridSolverDGPlain``: the 3-D anchors of
  tests/test_dg_multigrid.py:80-82 (its to 2%, rates to 5%, L2 to 1e-4);
  the 2-D gauss run of tests/test_dg_multigrid.py:41-50 and the
  variable-coefficient run of tests/test_dg_varcoeff.py:133-164 at their
  bars, with the JAX iterations to 2%; the JAX set-up carried over by
  ``convert.load_state`` gives the JAX solution to 1e-6 of its largest
  value and its iterations to 2%.
* The four drivers print their tables with ``--device cpu`` and refuse to
  run without CUDA otherwise; ``VarCoeffLevel`` refuses a
  constant-coefficient level that the DG kernels cover on the card.
* The route of a constant-coefficient level follows ``dg_kernel.covers``
  (3-D, the JAX gate): the DG kernels' ``DGOperator`` where it holds, the
  plain ``DGLaplace`` everywhere else (2-D), on the card too; above the
  kernels' degree (p = 9) the card refuses a 3-D level.  ``poisson_dg_plain`` defaults to the reference's 2-D setting: its
  4096-dof rows print "(plain)", hermite's its and L2 those of the JAX
  solver (2%, 1e-6).  Above p = 9 ``matvec_dg`` on the card (monkeypatched)
  builds the plain operator and prints "(plain)" rows that meet the f64
  bar against the face-based operator; ``matvec_dg_cheby`` and
  ``solver_dg`` run p = 10 on the plain operator at their bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.mesh.brick import cube as j_cube
from multigrid_tpu.ops import dg as j_dg
from multigrid_tpu.ops.dg_precond import JacobiTransformed as JJacobi
from multigrid_tpu.ops.dg_transfer import DGTransfer as JTransfer
from multigrid_tpu.solvers import fused as j_fused
from multigrid_tpu.solvers.multigrid_dg import MultigridSolverDGPlain as JPlain
from multigrid_tpu_torch import convert
from multigrid_tpu_torch.experiments import (matvec_dg, matvec_dg_cheby,
                                             poisson_dg_plain, solver_dg)
from multigrid_tpu_torch.mesh.brick import cube
from multigrid_tpu_torch.ops import dg as t_dg
from multigrid_tpu_torch.ops import dg_kernel as dk
from multigrid_tpu_torch.ops.dg_precond import (JacobiTransformed,
                                                 _transformed_diagonals)
from multigrid_tpu_torch.ops.dg_transfer import DGTransfer
from multigrid_tpu_torch.solvers import fused
from multigrid_tpu_torch.solvers.multigrid_dg import (MultigridSolverDGPlain,
                                                      VarCoeffLevel)

jax.config.update("jax_enable_x64", True)

KINDS = ["hermite", "gll", "gauss"]
K = 3.0   # on [0, 1]^dim sin(3 pi x) vanishes on the boundary


def exact_fn(coords):
    out = 1.0
    for c in coords:
        out = out * np.sin(np.pi * K * c)
    return out


def rhs_fn(coords):
    return len(coords) * (np.pi * K) ** 2 * exact_fn(coords)


# -div(c grad u) = f on [0, 1]^2, tests/test_dg_varcoeff.py:133-153
def vc_exact(q):
    return np.sin(np.pi * q[0]) * np.sin(np.pi * q[1])


def vc_coeff(q):
    return 1.0 + 0.5 * vc_exact(q)


def vc_rhs(q):
    pi, u = np.pi, vc_exact(q)
    cx = 0.5 * pi * np.cos(pi * q[0]) * np.sin(pi * q[1])
    cy = 0.5 * pi * np.sin(pi * q[0]) * np.cos(pi * q[1])
    ux = pi * np.cos(pi * q[0]) * np.sin(pi * q[1])
    uy = pi * np.sin(pi * q[0]) * np.cos(pi * q[1])
    return -(cx * ux + cy * uy + vc_coeff(q) * (-2 * pi**2 * u))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def grids(cells, p, kind, seed=0):
    """A sheared affine grid of any dimension, as a JAX and a port DGGrid."""
    dim = len(cells)
    rng = np.random.default_rng(seed)
    J = np.diag(1.0 / np.array(cells)) @ (np.eye(dim)
                                          + 0.08 * rng.random((dim, dim)))
    jac = tuple(map(tuple, J))
    return (j_dg.DGGrid(cells=cells, jacobian=jac, degree=p, kind=kind),
            t_dg.DGGrid(cells=cells, jacobian=jac, degree=p, kind=kind))


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def rel_err(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max()


def coefficient(grid, seed):
    """A smooth-ish positive coefficient at the quadrature points."""
    return 1.0 + 0.5 * np.random.default_rng(seed).random(grid.shape)


# ------------------------------------------------------------- DGTransfer
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-6)])
@pytest.mark.parametrize("coarse", [(2, 3), (1, 2, 2)])
@pytest.mark.parametrize("kind", KINDS)
def test_dg_transfer_matches_jax(kind, coarse, dtype, tol):
    fine = tuple(2 * c for c in coarse)
    p = 3 if len(coarse) == 3 else 4
    (jf, tf), (jc, tc) = grids(fine, p, kind), grids(coarse, p, kind)
    jt = JTransfer(jf, jc, jnp.float64)
    tt = DGTransfer(tf, tc, dtype, "cpu")
    u, v = rand(tc.shape, 1), rand(tf.shape, 2)
    want = np.asarray(jt.prolongate(jnp.asarray(u)))
    got = tt.prolongate(torch.as_tensor(u, dtype=dtype))
    assert got.is_contiguous() and rel_err(got.double().numpy(), want) < tol
    want = np.asarray(jt.restrict(jnp.asarray(v)))
    got = tt.restrict(torch.as_tensor(v, dtype=dtype))
    assert got.is_contiguous() and rel_err(got.double().numpy(), want) < tol


def test_dg_transfer_refuses_grids_not_two_to_one():
    _, tf = grids((4, 4, 2), 2, "gauss")
    _, tc = grids((2, 2, 2), 2, "gauss")
    with pytest.raises(ValueError, match="not twice"):
        DGTransfer(tf, tc, torch.float64, "cpu")


# ------------------------------------------------------------------ fused
@pytest.fixture(scope="module")
def ops_3d():
    gj, gt = grids((2, 3, 2), 3, "gll")
    return (j_dg.DGLaplace(gj, jnp.float64), JJacobi(j_dg.DGLaplace(
        gj, jnp.float64)), t_dg.DGLaplace(gt, torch.float64, "cpu"),
        JacobiTransformed(gt, torch.float64, "cpu"), gt)


@pytest.mark.parametrize("alpha", [0.0, 0.37])
def test_vmult_with_cg_update_matches_jax(ops_3d, alpha):
    opj, _, opt, _, g = ops_3d
    r, q, p, x = (rand(g.shape, s) for s in range(4))
    want = j_fused.vmult_with_cg_update(opj.vmult, alpha, 0.61,
                                        *map(jnp.asarray, (r, q, p, x)))
    got = fused.vmult_with_cg_update(opt.vmult, alpha, 0.61,
                                     *map(torch.as_tensor, (r, q, p, x)))
    for a, b in zip(got, want):
        assert rel_err(a.numpy(), b) < 1e-12


def test_vmult_with_chebyshev_update_matches_jax(ops_3d):
    opj, jacj, opt, jact, g = ops_3d
    b, x, x_old = (rand(g.shape, s) for s in range(4, 7))
    want = j_fused.vmult_with_chebyshev_update(
        opj.vmult, jacj.vmult, *map(jnp.asarray, (b,)), 0.3, 0.7,
        jnp.asarray(x), jnp.asarray(x_old))
    got = fused.vmult_with_chebyshev_update(
        opt.vmult, jact.vmult, torch.as_tensor(b), 0.3, 0.7,
        torch.as_tensor(x), torch.as_tensor(x_old))
    assert rel_err(got[0].numpy(), want[0]) < 1e-12
    np.testing.assert_array_equal(got[1].numpy(), x)


# ------------------------------------------------- variable coefficient
@pytest.mark.parametrize("cells,p", [((3, 2), 2), ((2, 2, 2), 3),
                                     ((3, 1, 2), 2)])
@pytest.mark.parametrize("kind", KINDS)
def test_varcoeff_apply_matches_jax(kind, cells, p):
    gj, gt = grids(cells, p, kind)
    c = coefficient(gt, 3)
    u = rand(gt.shape, 4)
    want = np.asarray(j_dg.DGLaplaceVarCoeff(gj, c, jnp.float64).apply(
        jnp.asarray(u)))
    op = t_dg.DGLaplaceVarCoeff(gt, c, torch.float64, "cpu")
    assert rel_err(op.apply(torch.as_tensor(u)).numpy(), want) < 1e-11


def test_unit_coefficient_is_the_constant_operator():
    _, gt = grids((2, 3, 2), 3, "hermite")
    u = torch.as_tensor(rand(gt.shape, 5))
    op1 = t_dg.DGLaplaceVarCoeff(gt, np.ones(gt.shape), torch.float64, "cpu")
    want = t_dg.DGLaplace(gt, torch.float64, "cpu").apply(u)
    torch.testing.assert_close(op1.apply(u), want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("cells,p", [((3, 3), 2), ((2, 3, 2), 2)])
@pytest.mark.parametrize("kind", KINDS)
def test_general_jacobi_matches_jax(kind, cells, p):
    gj, gt = grids(cells, p, kind)
    c = coefficient(gt, 6)
    jj = JJacobi(j_dg.DGLaplaceVarCoeff(gj, c, jnp.float64))
    op = t_dg.DGLaplaceVarCoeff(gt, c, torch.float64, "cpu")
    jt = JacobiTransformed(gt, torch.float64, "cpu", op=op)
    assert rel_err(jt.inv_diag.numpy(), np.asarray(jj.inv_diag)) < 1e-11


def test_general_jacobi_of_constant_operator_is_the_category_one():
    """The exact probe of the whole mesh, on the constant operator, gives
    the category path's inverse diagonal (1e-12)."""
    _, gt = grids((4, 3, 2), 3, "gauss")
    cat = JacobiTransformed(gt, torch.float64, "cpu")
    T3 = np.array([[1.0]])
    for _ in range(gt.dim):
        T3 = np.kron(T3, gt.basis.T)
    full = _transformed_diagonals(t_dg.DGLaplace(gt, torch.float64, "cpu"), T3)
    gen = (1.0 / full).reshape(gt.shape)
    assert rel_err(gen.numpy(), cat.inv_diag.numpy()) < 1e-12


def test_varcoeff_level_refuses_constant_coefficient_on_the_card(monkeypatch):
    """A constant-coefficient level on the card is DGOperator's (K7, K8):
    the plain wrapper refuses it there, and takes a var-coeff one."""
    _, gt = grids((2, 2, 2), 3, "hermite")
    jac = JacobiTransformed(gt, torch.float32, "cpu")
    const = t_dg.DGLaplace(gt, torch.float32, "cpu")
    var = t_dg.DGLaplaceVarCoeff(gt, coefficient(gt, 7), torch.float32, "cpu")
    for op in (const, var):
        monkeypatch.setattr(op, "device", torch.device("cuda", 0))
    with pytest.raises(ValueError, match="DGOperator"):
        VarCoeffLevel(const, jac.vmult)
    assert VarCoeffLevel(var, jac.vmult).device.type == "cuda"


@pytest.mark.parametrize("with_x", [False, True])
def test_varcoeff_level_step_is_the_chebyshev_step(with_x):
    """``VarCoeffLevel.cheb_step`` at c = 1 against ``dg_cheb``'s plain
    step (1e-12 of max|out|), x = None reading as zero."""
    _, gt = grids((2, 3, 2), 3, "gll")
    f64 = torch.float64
    jac = JacobiTransformed(gt, f64, "cpu")
    level = VarCoeffLevel(t_dg.DGLaplaceVarCoeff(gt, np.ones(gt.shape), f64,
                                                 "cpu"), jac.vmult)
    op = dk.DGOperator(gt, f64, "cpu")
    op.install_jacobi(jac)
    b, x, x_old = (torch.as_tensor(rand(gt.shape, s)) for s in (8, 9, 10))
    args = (b, x, x_old, 0.3, 0.8) if with_x else (b, None, None, 0.0, 0.8)
    want = dk.dg_cheb_plain(*args[:3], op, *args[3:])
    out = torch.empty_like(b)
    got = level.cheb_step(*args, out=out)
    assert got is out and rel_err(got.numpy(), want.numpy()) < 1e-12


# ---------------------------------------------------- the DGPlain solver
# n_ref -> (frac its, rate, L2 error), tests/test_dg_multigrid.py:80-82
ANCHORS = {1: (10.449, 0.1104, 2.785766e-3), 2: (10.793, 0.1184, 2.622445e-4)}


@pytest.mark.parametrize("n_ref", sorted(ANCHORS))
def test_dg_plain_anchors(n_ref):
    its_a, rate_a, err_a = ANCHORS[n_ref]
    s = MultigridSolverDGPlain(cube(2, 0.0, 1.0, n_ref, dim=3), 3, exact_fn,
                               rhs_fn, kind="hermite", device="cpu")
    sol, frac_its, rate = s.solve_cg(tolerance=1e-10)
    assert frac_its == pytest.approx(its_a, rel=0.02)
    assert rate == pytest.approx(rate_a, rel=0.05)
    assert s.l2_error(sol, s.exact_quad) == pytest.approx(err_a, rel=1e-4)


@pytest.mark.parametrize("problem", ["gauss 2-D", "var-coeff 2-D"])
def test_dg_plain_2d_matches_jax(problem):
    """tests/test_dg_multigrid.py:41-50 (gauss, p = 3: rate < 0.35, L2 order
    > 3.4) and tests/test_dg_varcoeff.py:133-164 (c = 1 + u / 2, p = 2: rate
    < 0.5, L2 order > 2.6) with the port; its within 2% of the JAX run's
    on the coarser mesh (the JAX solve of the finer one alone took longer
    than the rest of the test)."""
    if problem == "gauss 2-D":
        p, fns, extra, rate_bar, order_bar = 3, (exact_fn, rhs_fn), {}, 0.35, 3.4
    else:
        p, fns, extra = 2, (vc_exact, vc_rhs), dict(coeff_fn=vc_coeff)
        rate_bar, order_bar = 0.5, 2.6
    errs = []
    for n_ref in (1, 2):
        s = MultigridSolverDGPlain(cube(2, 0.0, 1.0, n_ref, dim=2), p, *fns,
                                   kind="gauss", device="cpu", **extra)
        sol, frac_its, rate = s.solve_cg(tolerance=1e-10)
        assert rate < rate_bar
        errs.append(s.l2_error(sol, s.exact_quad))
        if n_ref == 1:
            sj = JPlain(j_cube(2, 0.0, 1.0, n_ref, dim=2), p, *fns,
                        kind="gauss", **extra)
            its_j = float(sj.solve_cg(tolerance=1e-10)[1])
            assert frac_its == pytest.approx(its_j, rel=0.02)
    assert np.log2(errs[0] / errs[1]) > order_bar


@pytest.fixture(scope="module")
def jax_and_port_plain():
    sj = JPlain(j_cube(2, 0.0, 1.0, 1, dim=3), 3, exact_fn, rhs_fn,
                kind="hermite")
    state = {
        "rhs": np.asarray(sj.rhs),
        "chebyshev": [(s.theta, s.delta, s.degree, s.max_eig, s.min_eig)
                      for s in sj.smoothers],
        "inv_diag": [np.asarray(JJacobi(op).inv_diag) for op in sj.ops],
    }
    st = MultigridSolverDGPlain(cube(2, 0.0, 1.0, 1, dim=3), 3, exact_fn,
                                rhs_fn, kind="hermite", device="cpu")
    convert.load_state(st, state)
    return sj, st, state


def test_dg_plain_state_transfer_solve_matches_jax(jax_and_port_plain):
    sj, st, _ = jax_and_port_plain
    x_j, its_j, _ = sj.solve_cg(tolerance=1e-10)
    x_t, its_t, _ = st.solve_cg(tolerance=1e-10)
    x_j = np.asarray(x_j)
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=0,
                               atol=1e-6 * np.abs(x_j).max())
    assert its_t == pytest.approx(float(its_j), rel=0.02)


def test_dg_plain_state_roundtrip(jax_and_port_plain):
    """load_state installs every level's state unchanged, and refuses a
    state with a level of the wrong shape, or a Chebyshev tuple of the
    wrong arity or degree at the last level, before installing anything."""
    _, st, state = jax_and_port_plain
    np.testing.assert_array_equal(st.rhs.numpy(), state["rhs"])
    for l, jac in enumerate(st.jacobis):
        np.testing.assert_array_equal(
            jac.inv_diag.numpy(), np.asarray(state["inv_diag"][l], np.float32))
        sm = st.smoothers[l]
        assert (sm.theta, sm.delta, sm.degree, sm.max_eig, sm.min_eig) == \
            tuple(float(v) if i != 2 else int(v)
                  for i, v in enumerate(state["chebyshev"][l]))
    bad = dict(state, rhs=2 * state["rhs"],
               inv_diag=state["inv_diag"][:-1] + [state["inv_diag"][0]])
    with pytest.raises(ValueError, match="inv_diag"):
        convert.load_state(st, bad)
    np.testing.assert_array_equal(st.rhs.numpy(), state["rhs"])
    cheb = [tuple(c) for c in state["chebyshev"]]
    last = len(cheb) - 1
    assert last >= 1
    first = (2 * cheb[0][0],) + cheb[0][1:]
    for wrong in (cheb[last][:4], (0.5, 0.4, 0, 2.0, 0.1)):
        bad = dict(state, rhs=2 * state["rhs"],
                   chebyshev=[first] + cheb[1:last] + [wrong])
        with pytest.raises(ValueError, match=f"chebyshev\\[{last}\\]"):
            convert.load_state(st, bad)
        np.testing.assert_array_equal(st.rhs.numpy(), state["rhs"])
        assert st.smoothers[0].theta == float(cheb[0][0])


def test_dg_plain_curved_geometry_solves():
    """``mapping`` makes every level a curved operator; the identity chart
    of the unit cube solves the affine problem (L2 to 1e-8 of it)."""
    from multigrid_tpu_torch.ops.dg_curved import DGLaplaceCurved

    kw = dict(kind="hermite", device="cpu")
    s = MultigridSolverDGPlain(cube(2, 0.0, 1.0, 1, dim=3), 3, exact_fn,
                               rhs_fn, mapping=lambda p: p, **kw)
    assert all(isinstance(lv.op, DGLaplaceCurved) for lv in s.ops)
    assert isinstance(s.op_dp, DGLaplaceCurved)
    sol, frac_its, rate = s.solve_cg(tolerance=1e-10)
    affine = MultigridSolverDGPlain(cube(2, 0.0, 1.0, 1, dim=3), 3, exact_fn,
                                    rhs_fn, **kw)
    sol_a, its_a, _ = affine.solve_cg(tolerance=1e-10)
    assert frac_its == pytest.approx(its_a, rel=0.02)
    assert s.l2_error(sol, s.exact_quad) == pytest.approx(
        affine.l2_error(sol_a, affine.exact_quad), rel=1e-8)


# ---------------------------------------------------------------- drivers
def test_dg_plain_experiment_prints_convergence_tables(capsys):
    tables = poisson_dg_plain.main(["3", "0", "600", "3", "1e-10",
                                    "--dim", "3", "--device", "cpu"])
    assert list(tables) == KINDS
    for rows in tables.values():
        assert [r["dofs"] for r in rows] == [512]
        assert 9 < rows[0]["cg_its"] < 13
    out = capsys.readouterr().out
    assert "=== element type: gauss" in out and "cg_reduction" in out


def test_dg_plain_experiment_var_coeff():
    """--var-coeff at size 2 (512 dofs, p = 3): converges, and the error of
    the manufactured solution, zero on the boundary, is small."""
    tables = poisson_dg_plain.main(["3", "0", "600", "3", "1e-10",
                                    "--var-coeff", "--dim", "3", "--device",
                                    "cpu"])
    for rows in tables.values():
        assert rows[0]["cg_reduction"] < 0.5 and rows[0]["cg_L2error"] < 1e-2


@pytest.mark.parametrize("driver", ["matvec_dg", "matvec_dg_cheby",
                                    "solver_dg"])
def test_dg_benchmark_drivers_run_on_the_cpu(driver, capsys):
    main, args = {
        "matvec_dg": (matvec_dg.main, ["--max-degree", "1", "--steps", "3"]),
        "matvec_dg_cheby": (matvec_dg_cheby.main, ["--degrees", "2", "3",
                                                   "--steps", "3"]),
        "solver_dg": (solver_dg.main, ["--degrees", "2", "--steps", "4",
                                       "--kinds", "gauss", "hermite"]),
    }[driver]
    rows = main(args + ["--device", "cpu"])
    assert rows and all(r["verify"] < 1e-6 for r in rows)
    out = capsys.readouterr().out
    assert "(plain)" in out and "verif" in out


@pytest.mark.parametrize("driver", ["poisson_dg_plain", "matvec_dg",
                                    "matvec_dg_cheby", "solver_dg"])
def test_dg_drivers_need_cuda_unless_told_cpu(monkeypatch, driver):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"poisson_dg_plain": poisson_dg_plain.main,
            "matvec_dg": matvec_dg.main,
            "matvec_dg_cheby": matvec_dg_cheby.main,
            "solver_dg": solver_dg.main}[driver]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([])


@pytest.mark.parametrize("driver,args", [
    (poisson_dg_plain.main, ["--deform", "--dim", "3", "--device", "cpu"]),
    (matvec_dg.main, ["--impl", "curved", "--device", "cpu"])])
def test_dg_drivers_curved_geometry_run(driver, args, capsys):
    """``poisson_dg_plain --deform`` and ``matvec_dg --impl curved`` run on
    the CPU and print their rows (at small sizes)."""
    if driver is poisson_dg_plain.main:
        tables = driver(["3", "0", "600", "3", "1e-10"] + args)
        for rows in tables.values():
            assert [r["dofs"] for r in rows] == [512]
            assert 9 < rows[0]["cg_its"] < 13
        assert "=== element type: gauss" in capsys.readouterr().out
    else:
        rows = driver(["--max-degree", "2", "--steps", "3"] + args)
        assert len(rows) == 12 and all(r["impl"] == "curved" for r in rows)
        assert all(r["verify"] < (1e-6 if "32" in r["dtype"] else 1e-11)
                   for r in rows)
        assert "(curved, plain)" in capsys.readouterr().out



def _unit_probe(monkeypatch):
    """The transformed Jacobi's diagonal probe (``_transformed_diagonals``:
    n^3 applies of the operator, minutes on the CPU at the kernels' top
    degree and above it) replaced by ones, for the tests of routes and of
    the benchmark programs' composition above the kernels' degree; the
    diagonal itself is held to JAX in tests/test_torch_dg_ops.py."""
    from multigrid_tpu_torch.ops import dg_precond

    monkeypatch.setattr(
        dg_precond, "_transformed_diagonals",
        lambda op, T3: torch.ones(op.grid.cells + (T3.shape[0],),
                                  dtype=torch.float64, device=op.device))


def test_matvec_dg_above_the_kernels_degree_runs_plain_on_the_card(
        monkeypatch, capsys):
    """On the card a row above dg_kernel.MAX_DEGREE runs the plain
    ``DGLaplace`` (no DGOperator is built), says "(plain)" and is verified
    against the face-based operator at the f64 bar.  The card is
    monkeypatched: the driver sees a CUDA device, and the plain operator
    it builds is placed on the CPU."""
    monkeypatch.setattr(matvec_dg, "driver_device",
                        lambda device: torch.device("cuda", 0))
    built = []

    def plain_on_cpu(grid, dtype, device):
        built.append(torch.device(device).type)
        return t_dg.DGLaplace(grid, dtype, "cpu")

    def no_kernels(*args, **kw):
        raise AssertionError("a DGOperator was built above its degree")

    from multigrid_tpu_torch.solvers import multigrid_dg

    monkeypatch.setattr(multigrid_dg, "DGLaplace", plain_on_cpu)
    monkeypatch.setattr(multigrid_dg, "DGOperator", no_kernels)
    p = dk.MAX_DEGREE + 1
    rows = matvec_dg.main(["--min-degree", str(p), "--max-degree", str(p),
                           "--steps", "0", "--dtype", "float64"])
    assert [r["degree"] for r in rows] == [p] * 3 and built == ["cuda"] * 3
    assert all(r["route"] == "plain" and r["verify"] < 1e-11 for r in rows)
    out = capsys.readouterr().out
    assert out.count(f"(plain) p={p}") == 3 and "stopping" not in out


@pytest.mark.parametrize("cells,p,covered", [((2, 2, 2), 3, True),
                                             ((2, 2, 2), dk.MAX_DEGREE, True),
                                             ((3, 2), 3, False),
                                             ((2, 1, 1), dk.MAX_DEGREE + 1,
                                              True)])
def test_constant_level_route_follows_dim_and_degree(cells, p, covered,
                                                     monkeypatch):
    """A constant-coefficient level takes the kernels' DGOperator exactly
    when ``dg_kernel.covers`` its grid (3-D, the JAX gate); a 2-D one is
    the plain DGLaplace in a PlainLevel (not the var-coeff class); the
    outer CG's operator follows the same rule.  Above the kernels' degree
    a 3-D level has no kernel, and DGOperator refuses it on the card
    (device monkeypatched).  The levels' transformed Jacobi takes a unit
    diagonal (:func:`_unit_probe`)."""
    from multigrid_tpu_torch.solvers.fused import PlainLevel
    from multigrid_tpu_torch.solvers.multigrid_dg import constant_level

    _unit_probe(monkeypatch)
    _, gt = grids(cells, p, "hermite")
    assert dk.covers(gt) is covered
    assert dk.has_kernel(gt) is (covered and p <= dk.MAX_DEGREE)
    jac = JacobiTransformed(gt, torch.float32, "cpu")
    level = constant_level(gt, torch.float32, "cpu", jac)
    outer = constant_level(gt, torch.float64, "cpu")
    if covered:
        assert isinstance(level, dk.DGOperator) and level.jacobi is jac
        assert isinstance(outer, dk.DGOperator)
    else:
        assert type(level) is PlainLevel and type(level.op) is t_dg.DGLaplace
        assert level.precond == jac.vmult and type(outer) is t_dg.DGLaplace
    if covered and p > dk.MAX_DEGREE:
        monkeypatch.setattr(dk, "resolve",
                            lambda device: torch.device("cuda", 0))
        with pytest.raises(ValueError, match="no DG kernel"):
            constant_level(gt, torch.float32, "cuda", jac)


def test_dg_plain_experiment_defaults_to_2d(capsys):
    """The driver's default is the reference's 2-D setting: the 4096-dof
    row (16^2 cells, p = 3) of every kind, on the plain route, its
    iterations and L2 those of the JAX solver on the same mesh (its to
    2%, L2 to 1e-6 relative)."""
    from multigrid_tpu.mesh.brick import poisson_cube_mesh as j_pcm

    from experiments.poisson_cube import exact_fn as j_exact
    from experiments.poisson_cube import rhs_fn as j_rhs

    tables = poisson_dg_plain.main(["3", "0", "5000", "3", "1e-10",
                                    "--device", "cpu"])
    assert list(tables) == KINDS
    out = capsys.readouterr().out
    assert out.count("(plain)") == 3
    sj = JPlain(j_pcm(2, 2), 3, j_exact, j_rhs, kind="hermite")
    u, its_j, _ = sj.solve_cg(tolerance=1e-10)
    err_j = float(sj.l2_error(u, sj.exact_quad))
    row, = tables["hermite"]
    assert row["dofs"] == 4096
    assert row["cg_its"] == pytest.approx(float(its_j), rel=0.02)
    assert row["cg_L2error"] == pytest.approx(err_j, rel=1e-6)


@pytest.mark.parametrize("driver", ["matvec_dg_cheby", "solver_dg"])
def test_dg_benchmark_drivers_above_the_kernels_degree(driver, capsys,
                                                       monkeypatch):
    """p = 17, above the DG kernels: the Chebyshev step and the cell-based
    CG run over the plain operator ("(plain)") and meet their bars (the
    step's transformed Jacobi with a unit diagonal, :func:`_unit_probe`;
    the CG compares two operators over 50 iterations, which needs the true
    preconditioner)."""
    if driver == "matvec_dg_cheby":
        _unit_probe(monkeypatch)
    main = {"matvec_dg_cheby": matvec_dg_cheby.main,
            "solver_dg": solver_dg.main}[driver]
    p = str(dk.MAX_DEGREE + 1)
    rows = main(["--degrees", p, "--steps", "0", "--device", "cpu"])
    tol = {"matvec_dg_cheby": matvec_dg_cheby.VERIFY_TOL,
           "solver_dg": solver_dg.VERIFY_TOL}[driver]
    assert len(rows) == 1 and rows[0]["verify"] < tol
    assert "(plain)" in capsys.readouterr().out
