"""The port's ``GeneralMultigridSolver`` and its drivers, against the JAX
package's.

* The six shell anchors of tests/test_shell_anchors.py:26-33 (degree 3,
  n_pre = n_post = 3), held as there: cg_its exactly, reductions to 2%,
  FMG L2 to 1e-3, CG L2 to 1e-5.
* One V-cycle with the JAX solver's state carried across by
  ``convert.general_state`` / ``convert.load_state``: 1e-10 (relative to
  max) in pure double, 1e-5 in mixed precision.
* Twins of tests/test_shell_minimal_surface.py's
  ``test_shell_pure_double_fourth_kind`` and
  ``test_deformed_cube_manifold``, with the same assertions.
* ``poisson_shell --cycles 3 --device cpu`` and ``poisson_cube --deform
  --device cpu`` run end to end; without ``--device cpu`` they need CUDA.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu_torch import convert
from multigrid_tpu_torch.experiments import poisson_shell as ps
from multigrid_tpu_torch.mesh.shapes import (deformed_cube, hyper_shell,
                                             hyper_shell_12)
from multigrid_tpu_torch.solvers.chebyshev import FOURTH_KIND
from multigrid_tpu_torch.solvers.multigrid_general import GeneralMultigridSolver

# (mesh, n_levels, pure_double) -> expected
# (dofs, fmg_L2, cg_its, cg_reduction, cg_L2): tests/test_shell_anchors.py
ANCHORS = {
    ("shell6", 2, False): (1526, 2.346556e-01, 15, 0.232046, 1.823688e-01),
    ("shell6", 2, True): (1526, 3.355221e-01, 22, 0.377363, 1.823688e-01),
    ("shell12", 2, False): (3038, 2.150496e-01, 13, 0.191005, 1.319676e-01),
    ("shell12", 2, True): (3038, 2.436254e-01, 20, 0.342541, 1.319676e-01),
    ("shell6", 3, False): (11258, 7.347376e-02, 16, 0.264773, 3.525010e-02),
    ("shell6", 3, True): (11258, 1.607104e-01, 26, 0.445591, 3.525010e-02),
}
_MESHES = {"shell6": hyper_shell, "shell12": hyper_shell_12}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shell_solver(name="shell6", n_levels=2, pure_double=False, degree=3,
                 **kw):
    return GeneralMultigridSolver(_MESHES[name](0.5, 1.0, n_levels=n_levels),
                                  degree, ps.exact_fn, ps.rhs_fn,
                                  coef_fn=ps.coef_fn, n_pre=3, n_post=3,
                                  pure_double=pure_double, device="cpu", **kw)


@pytest.mark.parametrize("key", sorted(ANCHORS), ids=lambda k: f"{k[0]}-l{k[1]}-{'pd' if k[2] else 'mixed'}")
def test_shell_anchor(key):
    name, n_levels, pure_double = key
    dofs, fmg_l2, its_exp, red_exp, cg_l2 = ANCHORS[key]
    s = shell_solver(name, n_levels, pure_double)
    assert s.grids[s.maxlevel].n_dofs == dofs
    got_fmg = s.l2_error(s.maxlevel, s.solve())
    assert abs(got_fmg - fmg_l2) / fmg_l2 < 1e-3, got_fmg
    sol_cg, its, red = s.solve_cg()
    assert its == its_exp, (its, its_exp)
    assert abs(red - red_exp) / red_exp < 0.02, (red, red_exp)
    got_cg = s.l2_error(s.maxlevel, sol_cg)
    assert abs(got_cg - cg_l2) / cg_l2 < 1e-5, got_cg


@pytest.fixture(scope="module", params=[False, True], ids=["mixed", "pd"])
def jax_and_port_shell(request):
    from experiments.poisson_shell import coef_fn, exact_fn, rhs_fn
    from multigrid_tpu.mesh.shapes import hyper_shell as j_shell
    from multigrid_tpu.solvers.chebyshev import FOURTH_KIND as J4
    from multigrid_tpu.solvers.multigrid_general import (
        GeneralMultigridSolver as JSolver)

    pd = request.param
    kind = dict(pure_double=True, chebyshev_kind=J4) if pd else {}
    sj = JSolver(j_shell(0.5, 1.0, n_levels=2), 3, exact_fn, rhs_fn,
                 coef_fn=coef_fn, n_pre=3, n_post=3, **kind)
    st = shell_solver(pure_double=pd)
    state = convert.general_state(sj)
    convert.load_state(st, state)
    return sj, st, state, pd


def test_state_transfer_v_cycle_matches_jax(jax_and_port_shell):
    sj, st, _, pd = jax_and_port_shell
    L = st.maxlevel
    d = np.asarray(sj.rhs[L]).astype(np.float64 if pd else np.float32)
    vj = np.asarray(sj.v_cycle(L, jnp.asarray(d), 1))
    vt = st.v_cycle(L, torch.tensor(d), 1).numpy()
    np.testing.assert_allclose(vt, vj, rtol=0,
                               atol=(1e-10 if pd else 1e-5) * np.abs(vj).max())


def test_state_roundtrip(jax_and_port_shell):
    """load_state installs every array and number unchanged, and refuses a
    state built on another numbering."""
    _, st, state, pd = jax_and_port_shell
    for l, (op, dp) in enumerate(zip(st.ops, st.ops_dp)):
        np.testing.assert_array_equal(dp.C.numpy(), state["C_dp"][l])
        np.testing.assert_array_equal(op.C.numpy(), state["C_sp"][l])
        np.testing.assert_array_equal(op.inv_diag.numpy(), state["inv_diag"][l])
        np.testing.assert_array_equal(st.rhs[l].numpy(), state["rhs"][l])
        np.testing.assert_array_equal(st.u_bc[l].numpy(), state["u_bc"][l])
        sm = st.smoothers[l]
        assert (sm.theta, sm.delta, sm.degree, sm.max_eig, sm.min_eig) == \
            tuple(state["chebyshev"][l])
        assert op.dtype == (torch.float64 if pd else torch.float32)
    bad = dict(state, cell_nodes=[c[::-1] for c in state["cell_nodes"]])
    with pytest.raises(ValueError, match="cell_nodes"):
        convert.load_state(st, bad)
    bad = dict(state, jxw=[1.01 * j for j in state["jxw"]])
    with pytest.raises(ValueError, match="jxw"):
        convert.load_state(st, bad)


def test_shell_pure_double_fourth_kind():
    """The reference poisson_shell solver specialization: all-double
    V-cycle + fourth-kind Chebyshev converges to the same solution;
    first-kind mixed stays the default."""
    s0 = shell_solver()
    sol0, its0, _ = s0.solve_cg()
    e0 = s0.l2_error(s0.maxlevel, sol0)
    s1 = shell_solver(pure_double=True)
    assert s1.v_dtype == torch.float64
    assert s1.smoothers[1].kind == FOURTH_KIND
    assert s1.smoothers[0].kind == s0.smoothers[1].kind == "first_kind"
    sol1, its1, _ = s1.solve_cg()
    e1 = s1.l2_error(s1.maxlevel, sol1)
    assert e1 == pytest.approx(e0, rel=1e-9)
    assert its1 <= 2 * its0


def test_update_coefficients_refreshes_the_smoothers():
    """New coefficients give a new diagonal and a new interval; unlike the
    JAX twin the fourth kind's max_eig is refreshed too, and the same
    coefficients give the same smoothers back."""
    s = shell_solver(pure_double=True)
    before = [(sm.theta, sm.max_eig, sm.degree) for sm in s.smoothers]
    C = [op.C.clone() for op in s.ops_dp]
    s.update_coefficients([2.0 * c for c in C])
    for (th, me, deg), sm in zip(before, s.smoothers):
        assert sm.max_eig == pytest.approx(me, rel=1e-6)   # A and D scale alike
        assert sm.degree == deg
    d0 = s.ops[1].inv_diag.clone()
    s.update_coefficients([4.0 * c for c in C])
    inner = s.ops[1].interior.numpy()       # Dirichlet rows stay 1
    np.testing.assert_allclose(s.ops[1].inv_diag.numpy()[inner],
                               0.5 * d0.numpy()[inner], rtol=1e-14)
    s.update_coefficients(C)
    for (th, me, deg), sm in zip(before, s.smoothers):
        assert (sm.theta, sm.max_eig, sm.degree) == pytest.approx((th, me, deg),
                                                                 rel=1e-12)
    rng = np.random.default_rng(0)
    s.update_coefficients([
        c * torch.tensor(1.0 + 50.0 * rng.random((c.shape[0],) + (1,) * (c.ndim - 1)))
        for c in C])
    fine = s.smoothers[1]
    assert fine.kind == FOURTH_KIND
    assert abs(fine.max_eig / before[1][1] - 1) > 1e-3


def test_deformed_cube_manifold():
    """--deform: the reference MyManifold chart on the general path
    (reference poisson_cube/program.cc:405-484) converges at ~p+1 with
    mesh-independent iterations."""
    import math

    from multigrid_tpu_torch.experiments.poisson_cube import exact_fn, rhs_fn

    errs, itss = [], []
    for nl in (2, 3):
        s = GeneralMultigridSolver(deformed_cube(2, n_levels=nl), 3, exact_fn,
                                   rhs_fn, device="cpu")
        sol, its, red = s.solve_cg()
        errs.append(s.l2_error(s.maxlevel, sol))
        itss.append(its)
    assert max(itss) <= 9 and abs(itss[0] - itss[1]) <= 1
    assert math.log2(errs[0] / errs[1]) > 3.2   # optimal would be 4


def test_poisson_shell_driver_runs(capsys):
    rows = ps.main(["3", "2000000", "--cycles", "3", "--device", "cpu"])
    assert [r["dofs"] for r in rows] == [ps.shell_dofs(c, 3) for c in range(3)]
    assert [r["dofs"] for r in rows] == [224, 440, 1526]
    assert rows[2]["cg_its"] == 15
    out = capsys.readouterr().out
    assert "cg_reduction" in out and "set-up" in out and "L2" in out


def test_poisson_shell_pure_double_driver_stops_at_maxsize(capsys):
    rows = ps.main(["2", "400", "--cycles", "3", "--pure-double",
                    "--device", "cpu"])
    assert [r["dofs"] for r in rows] == [ps.shell_dofs(c, 2) for c in range(2)]
    assert "Max size reached" in capsys.readouterr().out


def test_deform_driver_runs():
    from multigrid_tpu_torch.experiments.poisson_cube import main

    rows = main(["3", "0", "20000", "--deform", "--device", "cpu"])
    assert [r["dofs"] for r in rows] == [2197]
    rows = main(["2", "0", "2000", "--deform", "--dim", "2", "--device", "cpu"])
    assert [r["dofs"] for r in rows] == [81, 289]


@pytest.mark.parametrize("argv", [
    ["4", "2000000"],
    ["4", "0", "20000", "--deform"],
])
def test_drivers_need_cuda_unless_told_cpu(monkeypatch, argv):
    from multigrid_tpu_torch.experiments.poisson_cube import main as cube_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = ps.main if len(argv) == 2 else cube_main
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GeneralMultigridSolver(hyper_shell(0.5, 1.0, n_levels=1), 2,
                               ps.exact_fn, ps.rhs_fn)
