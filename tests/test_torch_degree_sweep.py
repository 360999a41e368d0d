"""The port's poisson_cube degree sweep against the JAX package's, on the
CPU: tests/test_degree_sweep.py's sweep (FE_Q(p), p = 1..9, on the 4^3
mesh of ``poisson_cube_mesh(4)``, n_pre = n_post = 2, 2 V-cycles; V-cycle
preconditioned CG to rtol 1e-9) run by both packages.  The port's CG
takes the JAX solver's iterations and at most 13 (that test's bar), and
its L2 error is the JAX one's to 1e-3 relative; across the sweep the
error drops by 0.7 a degree and ends below 1e-6, as there.  On the card
the same degrees run ``brick_kron`` (p = 1..9), held in
tests/test_torch_cuda.py and chip_smoke.py."""

import pytest
import torch

from experiments.poisson_cube import exact_fn, rhs_fn
from multigrid_tpu.mesh.brick import poisson_cube_mesh as j_pcm
from multigrid_tpu.solvers.multigrid import MultigridSolver as JSolver
from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh
from multigrid_tpu_torch.solvers.multigrid import MultigridSolver

ERRORS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("degree", range(1, 10))
def test_degree_sweep_matches_jax(degree):
    sj = JSolver(j_pcm(4), degree, exact_fn, rhs_fn, n_pre=2, n_post=2,
                 n_cycles=2)
    u_j, its_j, _ = sj.solve_cg()
    err_j = float(sj.l2_error(sj.maxlevel, u_j))
    st = MultigridSolver(poisson_cube_mesh(4), degree, exact_fn, rhs_fn,
                         n_pre=2, n_post=2, n_cycles=2, device="cpu")
    u_t, its_t, _ = st.solve_cg()
    err_t = st.l2_error(st.maxlevel, u_t)
    assert its_t == its_j and its_t <= 13, (its_t, its_j)
    assert err_t == pytest.approx(err_j, rel=1e-3)
    ERRORS[degree] = err_t
    if len(ERRORS) == 9:
        errs = [ERRORS[p] for p in range(1, 10)]
        assert all(b < 0.7 * a for a, b in zip(errs, errs[1:])), errs
        assert errs[-1] < 1e-6, errs


@pytest.mark.parametrize("smoothing_range", [1e-3, 2e-3])
@pytest.mark.parametrize("degree", [8, 9])
def test_coarse_chebyshev_degree_matches_jax(degree, smoothing_range):
    """The coarse solve's Chebyshev at p = 8, 9 on the 3^3-cell coarse mesh
    (25^3 / 28^3 nodes, the coarse level of poisson_dg's FE_Q(p) hierarchy
    at size 24) has the JAX solver's degree, theta and delta, at the cube's
    coarse range (1e-3) and poisson_dg's (2e-3); theta and delta to 1e-5,
    as the two Lanczos runs round apart.  The degree sets how many
    brick_kron steps a V-cycle spends on that grid: 95 at p = 9 and 2e-3,
    so 94 operator applications a coarse solve of the p = 9 poisson_dg
    row."""
    sj = JSolver(j_pcm(3), degree, exact_fn, rhs_fn,
                 coarse_smoothing_range=smoothing_range)
    st = MultigridSolver(poisson_cube_mesh(3), degree, exact_fn, rhs_fn,
                         coarse_smoothing_range=smoothing_range, device="cpu")
    assert st.grids[0].shape == (3 * degree + 1,) * 3
    got, want = st.smoothers[0], sj.smoothers[0]
    assert got.degree == want.degree
    assert got.theta == pytest.approx(want.theta, rel=1e-5)
    assert got.delta == pytest.approx(want.delta, rel=1e-5)
