"""The DG solvers at p = 8, above the degrees the port's DG kernels had
before they reached p = 9, on the CPU against the JAX package.

3-D ``MultigridSolverDG`` (DG over the FE_Q(8) hierarchy) and
``MultigridSolverDGPlain`` (pure-DG h-multigrid, every level a
``DGOperator``) on 2^3 cells (5,832 DG dofs), hermite, n_pre = n_post =
3, rtol 1e-9, as ``poisson_dg`` / ``poisson_dg_plain`` run them: the port
on the CPU and the JAX solver on the CPU from the same problem (the JAX
DG solver with its f64 ``DGLaplace`` as the outer operator,
``dp_impl="native"``: ``PallasDGOzaki`` stops at p = 4).  The iteration
counts are equal, the fractional counts and rates agree to 1e-3, the L2
errors to 1e-6 and the solutions to 1e-6 of max|u| (f32 smoothers that
sum in another order); each solver's levels are the kernels' route
(``DGOperator``).
"""

import math

import jax
import numpy as np
import pytest
import torch

from experiments.poisson_cube import exact_fn as j_exact
from experiments.poisson_cube import rhs_fn as j_rhs
from multigrid_tpu.mesh.brick import poisson_cube_mesh as j_mesh
from multigrid_tpu.solvers import multigrid_dg as j_mg
from multigrid_tpu_torch.experiments.poisson_cube import exact_fn, rhs_fn
from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh
from multigrid_tpu_torch.ops.dg_kernel import DGOperator
from multigrid_tpu_torch.solvers import multigrid_dg

jax.config.update("jax_enable_x64", True)

DEGREE, SIZE, RTOL = 8, 2, 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("plain", [False, True])
def test_dg_solver_at_p8_matches_jax(plain):
    if plain:
        sj = j_mg.MultigridSolverDGPlain(j_mesh(SIZE), DEGREE, j_exact, j_rhs,
                                         kind="hermite", n_pre=3, n_post=3)
        st = multigrid_dg.MultigridSolverDGPlain(
            poisson_cube_mesh(SIZE), DEGREE, exact_fn, rhs_fn, kind="hermite",
            n_pre=3, n_post=3, device="cpu")
        assert all(isinstance(op, DGOperator) for op in st.ops + [st.op_dp])
    else:
        sj = j_mg.MultigridSolverDG(j_mesh(SIZE), DEGREE, j_exact, j_rhs,
                                    kind="hermite", n_pre=3, n_post=3,
                                    dp_impl="native")
        st = multigrid_dg.MultigridSolverDG(
            poisson_cube_mesh(SIZE), DEGREE, exact_fn, rhs_fn, kind="hermite",
            n_pre=3, n_post=3, device="cpu")
        assert all(isinstance(op, DGOperator) for op in (st.op, st.op_dp))
    u_j, its_j, rate_j = sj.solve_cg(tolerance=RTOL)
    u_t, its_t, rate_t = st.solve_cg(tolerance=RTOL)
    u_j = np.asarray(u_j)
    assert u_t.shape == u_j.shape == (SIZE,) * 3 + (DEGREE + 1,) * 3
    assert math.ceil(its_t) == math.ceil(float(its_j))
    assert its_t == pytest.approx(float(its_j), rel=1e-3)
    assert rate_t == pytest.approx(float(rate_j), rel=1e-3)
    err_j = float(sj.l2_error(u_j, sj.exact_quad))
    assert st.l2_error(u_t, st.exact_quad) == pytest.approx(err_j, rel=1e-6)
    np.testing.assert_allclose(u_t.numpy(), u_j, rtol=0,
                               atol=1e-6 * np.abs(u_j).max())
