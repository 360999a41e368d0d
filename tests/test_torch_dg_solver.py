"""The port's poisson_dg slice as a whole, on the CPU.

* The pinned anchors of tests/test_dg_multigrid.py:70-117: on
  ``cube(2, 0, 1, n_ref)``, p = 3, hermite, tol 1e-10, fractional
  iterations within 2%, rates within 5%, L2 errors within 1e-4 relative;
  on ``poisson_cube_mesh(4)``, p = 4, n_pre 3, tol 1e-9, the reference-parity
  L2 plateau 0.10024 +- 5e-4 in 4.5 to 6.5 iterations.
* The JAX ``MultigridSolverDG`` with the f64 ``DGLaplace`` as its outer
  operator (``dp_impl="native"``) and the port, with the JAX set-up carried
  over by ``convert.load_state``: the solutions agree to 1e-6·max|u| (both
  stop at rtol 1e-10; f32 smoothers summing in another order).
* The ``poisson_dg`` driver prints its table with ``--device cpu`` and
  refuses to run without CUDA otherwise; a solver built without a device
  raises when there is no card.
"""

import numpy as np
import pytest
import torch

from multigrid_tpu_torch import convert
from multigrid_tpu_torch.experiments import poisson_cube as cube_problem
from multigrid_tpu_torch.experiments.poisson_dg import main
from multigrid_tpu_torch.mesh.brick import cube, poisson_cube_mesh
from multigrid_tpu_torch.solvers.multigrid import MultigridSolver
from multigrid_tpu_torch.solvers.multigrid_dg import (MultigridSolverDG,
                                                      MultigridSolverDGPlain)

K = 3.0   # on [0, 1]^3 sin(3 pi x) vanishes on the boundary


def exact_fn(coords):
    out = 1.0
    for c in coords:
        out = out * np.sin(np.pi * K * c)
    return out


def rhs_fn(coords):
    return len(coords) * (np.pi * K) ** 2 * exact_fn(coords)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# n_ref -> (frac its, rate, L2 error), tests/test_dg_multigrid.py:79-82
ANCHORS = {1: (8.398, 0.0644, 2.785766e-3), 2: (8.139, 0.0591, 2.622445e-4)}


@pytest.mark.parametrize("n_ref", sorted(ANCHORS))
def test_dg_solver_anchors(n_ref):
    its_a, rate_a, err_a = ANCHORS[n_ref]
    s = MultigridSolverDG(cube(2, 0.0, 1.0, n_ref, dim=3), 3, exact_fn,
                          rhs_fn, kind="hermite", device="cpu")
    sol, frac_its, rate = s.solve_cg(tolerance=1e-10)
    assert frac_its == pytest.approx(its_a, rel=0.02)
    assert rate == pytest.approx(rate_a, rel=0.05)
    assert s.l2_error(sol, s.exact_quad) == pytest.approx(err_a, rel=1e-4)


def test_dg_solver_boundary_plateau():
    """The driver's configuration at size 4: the rhs carries no weak
    Dirichlet data, so the L2 error sits on the 0.1 plateau by construction
    (tests/test_dg_multigrid.py:99-117)."""
    s = MultigridSolverDG(poisson_cube_mesh(4), 4, cube_problem.exact_fn,
                          cube_problem.rhs_fn, n_pre=3, n_post=3, device="cpu")
    sol, frac_its, _ = s.solve_cg(tolerance=1e-9)
    assert abs(s.l2_error(sol, s.exact_quad) - 0.10024) < 5e-4
    assert 4.5 < frac_its < 6.5


@pytest.fixture(scope="module")
def jax_and_port_dg():
    import jax

    from multigrid_tpu.mesh.brick import cube as j_cube
    from multigrid_tpu.solvers.multigrid_dg import MultigridSolverDG as JSolver

    jax.config.update("jax_enable_x64", True)
    sj = JSolver(j_cube(2, 0.0, 1.0, 1, dim=3), 3, exact_fn, rhs_fn,
                 kind="hermite", dp_impl="native")
    sm = sj.smooth_dg
    c = sj.cg
    state = {
        "rhs": np.asarray(sj.rhs),
        "chebyshev": (sm.theta, sm.delta, sm.degree, sm.max_eig, sm.min_eig),
        "inv_diag": np.asarray(sj.jacobi.inv_diag),
        "cg": {
            "rhs": [np.asarray(r) for r in c.rhs],
            "u_bc": [[np.asarray(f) for f in faces] for faces in c.u_bc],
            "chebyshev": [(s.theta, s.delta, s.degree, s.max_eig, s.min_eig)
                          for s in c.smoothers],
            "element_matrix": [np.asarray(op.K) for op in c.sp_ops],
        },
    }
    st = MultigridSolverDG(cube(2, 0.0, 1.0, 1, dim=3), 3, exact_fn, rhs_fn,
                           kind="hermite", device="cpu")
    convert.load_state(st, state)
    return sj, st, state


def test_dg_state_transfer_solve_matches_jax(jax_and_port_dg):
    sj, st, _ = jax_and_port_dg
    x_j, its_j, rate_j = sj.solve_cg(tolerance=1e-10)
    x_t, its_t, rate_t = st.solve_cg(tolerance=1e-10)
    x_j = np.asarray(x_j)
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=0,
                               atol=1e-6 * np.abs(x_j).max())
    assert its_t == pytest.approx(float(its_j), rel=0.02)
    assert rate_t == pytest.approx(float(rate_j), rel=0.05)


def test_dg_state_roundtrip(jax_and_port_dg):
    """load_state installs the DG state unchanged, the FE_Q part included,
    and refuses a DG array of the wrong shape before installing anything."""
    _, st, state = jax_and_port_dg
    np.testing.assert_array_equal(st.rhs.numpy(), state["rhs"])
    np.testing.assert_array_equal(
        st.jacobi.inv_diag.numpy(),
        np.asarray(state["inv_diag"], st.jacobi.inv_diag.numpy().dtype))
    sm = st.smooth_dg
    assert (sm.theta, sm.delta, sm.degree, sm.max_eig, sm.min_eig) == tuple(
        float(v) if i != 2 else int(v) for i, v in enumerate(state["chebyshev"]))
    for l in range(len(st.cg.grids)):
        np.testing.assert_array_equal(st.cg.rhs[l].numpy(), state["cg"]["rhs"][l])
    bad = dict(state, inv_diag=state["inv_diag"][:1], rhs=2 * state["rhs"])
    with pytest.raises(ValueError, match="inv_diag"):
        convert.load_state(st, bad)
    np.testing.assert_array_equal(st.rhs.numpy(), state["rhs"])


def test_dg_experiment_prints_convergence_table(capsys):
    rows = main(["4", "900", "1100", "1", "3", "3", "square", "1e-9",
                 "--device", "cpu"])
    assert [r["dofs"] for r in rows] == [1000]
    assert 3 < rows[0]["cg_its"] < 8
    out = capsys.readouterr().out
    assert "matvec:hermite" in out and "cg_reduction" in out


def test_dg_experiment_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["4", "900", "1100"])


@pytest.mark.parametrize("solver", ["fe_q", "dg", "dg_plain"])
def test_solver_without_device_needs_cuda(monkeypatch, solver):
    """The entry points run on the card unless the caller passes
    ``device="cpu"``: with no CUDA device, a solver built without one
    raises at once."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = poisson_cube_mesh(2)
    cls = {"fe_q": MultigridSolver, "dg": MultigridSolverDG,
           "dg_plain": MultigridSolverDGPlain}[solver]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(mesh, 4, cube_problem.exact_fn, cube_problem.rhs_fn)
