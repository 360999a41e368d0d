"""Port vs JAX twin: the 2:1 transfers and the Chebyshev smoother set-up.

Bars: f64 transfers agree with an independent numpy fp64 oracle (the
separable 1-D transfer matrices) to 1e-14·max, and with the JAX twin to
1e-13·max (its f64 transfer runs compensated df64 sweeps, ~2^-47 per
operation over four passes); f32 transfers agree with the JAX twin to
1e-6·max (f32 roundoff of a 9-term contraction per axis).  Lanczos
estimates that set the interval (the top eigenvalue; on the coarse level
also the bottom one) agree to 1e-6 relative (f32 CG coefficients summed in
another order); the bottom Ritz value of a 15-step fine-level estimate,
which no smoothing interval reads, to 1e-4.  The single-level coarse solve
pins the reference row (3 its, reduction 3.157e-4 ± 5%)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.mesh.brick import DofGrid as JDofGrid
from multigrid_tpu.mesh.brick import poisson_cube_mesh as j_cube
from multigrid_tpu.ops import laplace as jl
from multigrid_tpu.ops.laplace_dense import DenseLaplaceF32
from multigrid_tpu.ops.transfer import Transfer as JTransfer
from multigrid_tpu.solvers.chebyshev import Chebyshev as JChebyshev
from multigrid_tpu_torch.experiments.poisson_cube import build_solver
from multigrid_tpu_torch.mesh.brick import DofGrid, poisson_cube_mesh
from multigrid_tpu_torch.ops import laplace as tl
from multigrid_tpu_torch.ops.laplace_kernel import BrickLaplace
from multigrid_tpu_torch.ops.transfer import Transfer
from multigrid_tpu_torch.solvers.chebyshev import Chebyshev


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def level_pair(mesh_fn, level, degree=4):
    from multigrid_tpu.mesh import brick as jb
    from multigrid_tpu_torch.mesh import brick as tb

    mj, mt = mesh_fn(jb), mesh_fn(tb)
    return ((JDofGrid(mj, level, degree), JDofGrid(mj, level - 1, degree)),
            (DofGrid(mt, level, degree), DofGrid(mt, level - 1, degree)))


MESHES = {"cube4": lambda m: m.poisson_cube_mesh(4),
          "aniso": lambda m: m.BrickMesh((1, 2, 3), (-0.9,) * 3,
                                         (1.9, 1.3, 1.1), 2)}
PREC = {"f64": (torch.float64, jnp.float64, 1e-13),
        "f32": (torch.float32, jnp.float32, 1e-6)}


def transfer_matrices(fine, coarse, constrained):
    """Dense 1-D prolongation per axis, touch-count weights and Dirichlet
    masks included (numpy fp64): prolongation = T_z (x) T_y (x) T_x."""
    P = fine.basis.P
    p = fine.degree
    out = []
    for d in range(3):
        nc = coarse.cells[d]
        T = np.zeros((fine.shape[d], coarse.shape[d]))
        for c in range(nc):
            T[2 * p * c: 2 * p * c + 2 * p + 1, p * c: p * c + p + 1] += P
        w = np.ones(fine.shape[d])
        if nc > 1:
            w[2 * p: -1: 2 * p] = 0.5
        T = w[:, None] * T
        if constrained:
            T[[0, -1], :] = 0
            T[:, [0, -1]] = 0
        out.append(T)
    return out


@pytest.mark.parametrize("constrained", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_f64_transfer_matches_numpy_oracle(mesh, constrained):
    _, (ft, ct) = level_pair(MESHES[mesh], 1)
    Tz, Ty, Tx = transfer_matrices(ft, ct, constrained)
    tt = Transfer(ft, ct, torch.float64, "cpu", constrained=constrained)
    rng = np.random.default_rng(4)
    uc = rng.standard_normal(ct.shape)
    uf = rng.standard_normal(ft.shape)
    for got, want in (
            (tt.prolongate(torch.as_tensor(uc)),
             np.einsum("ai,bj,ck,ijk->abc", Tz, Ty, Tx, uc)),
            (tt.restrict(torch.as_tensor(uf)),
             np.einsum("ai,bj,ck,abc->ijk", Tz, Ty, Tx, uf))):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-14 * np.abs(want).max())


@pytest.mark.parametrize("constrained", [True, False])
@pytest.mark.parametrize("prec", sorted(PREC))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_transfer_matches_jax(mesh, prec, constrained):
    tdt, jdt, tol = PREC[prec]
    (fj, cj), (ft, ct) = level_pair(MESHES[mesh], 1)
    jt = JTransfer(fj, cj, jdt, constrained=constrained)
    tt = Transfer(ft, ct, tdt, "cpu", constrained=constrained)
    rng = np.random.default_rng(3)
    uc = rng.standard_normal(ct.shape)
    uf = rng.standard_normal(ft.shape)
    for got, want in (
            (tt.prolongate(torch.as_tensor(uc, dtype=tdt)),
             jt.prolongate(jnp.asarray(uc, jdt))),
            (tt.restrict(torch.as_tensor(uf, dtype=tdt)),
             jt.restrict(jnp.asarray(uf, jdt)))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max())


def test_transfer_restrict_is_adjoint():
    _, (ft, ct) = level_pair(MESHES["aniso"], 1)
    tt = Transfer(ft, ct, torch.float64, "cpu", constrained=True)
    rng = np.random.default_rng(5)
    uc = torch.as_tensor(rng.standard_normal(ct.shape))
    uf = torch.as_tensor(rng.standard_normal(ft.shape))
    lhs = torch.sum(tt.prolongate(uc) * uf)
    rhs = torch.sum(uc * tt.restrict(uf))
    assert float(lhs) == pytest.approx(float(rhs), rel=1e-13)


def _jax_smoother(g, smoothing_range, degree, n_it):
    lap = jl.LaplaceOperator(g, jnp.float32, jl.make_diag_coef(g))
    return JChebyshev.create(
        DenseLaplaceF32(g, jl.make_diag_coef(g)).vmult, None,
        smoothing_range=smoothing_range, degree=degree,
        eig_cg_n_iterations=n_it,
        precond=lambda r: lap.inverse_diagonal() * r,
        example=jnp.zeros(g.shape, jnp.float32))


def _torch_smoother(g, smoothing_range, degree, n_it):
    inv = tl.LaplaceOperator(g, torch.float32, device="cpu").inverse_diagonal()
    return Chebyshev.create(BrickLaplace(g, torch.float32, "cpu"), inv.mul,
                            smoothing_range, degree, n_it)


@pytest.mark.parametrize("level,smoothing_range,degree,n_it", [
    (1, 20.0, 2, 15),          # fine-level smoother (deal.II degree = n_pre)
    (2, 20.0, 2, 15),
    (0, 1e-3, None, 125),      # coarse solver: estimate to the matrix size
])
def test_eigenvalue_estimates_match_jax(level, smoothing_range, degree, n_it):
    gj = JDofGrid(j_cube(4), level, 4)
    gt = DofGrid(poisson_cube_mesh(4), level, 4)
    sj = _jax_smoother(gj, smoothing_range, degree, n_it)
    st = _torch_smoother(gt, smoothing_range, degree, n_it)
    assert st.max_eig == pytest.approx(sj.max_eig, rel=1e-6)
    assert st.min_eig == pytest.approx(sj.min_eig,
                                       rel=1e-6 if degree is None else 1e-4)
    assert st.theta == pytest.approx(sj.theta, rel=1e-6)
    assert st.delta == pytest.approx(sj.delta, rel=1e-6)
    assert st.degree == sj.degree


def test_chebyshev_interval_conventions():
    """deal.II: 1.2 boost first, interval ratio == smoothing_range,
    degree n_pre -> n_pre + 1 preconditioner applications."""
    gt = DofGrid(poisson_cube_mesh(4), 1, 4)
    st = _torch_smoother(gt, 20.0, 2, 15)
    upper, lower = st.theta + st.delta, st.theta - st.delta
    assert upper == pytest.approx(1.2 * st.max_eig, rel=1e-14)
    assert upper / lower == pytest.approx(20.0, rel=1e-12)
    assert st.degree == 3


def test_chebyshev_matches_jax_recurrence():
    """vmult and step on one level, the same interval fed to both."""
    gj = JDofGrid(j_cube(4), 1, 4)
    gt = DofGrid(poisson_cube_mesh(4), 1, 4)
    sj = _jax_smoother(gj, 20.0, 2, 15)
    st = _torch_smoother(gt, 20.0, 2, 15)
    st.theta, st.delta, st.degree = sj.theta, sj.delta, sj.degree
    rng = np.random.default_rng(11)
    m = ~gt.boundary_mask()
    b = np.where(m, rng.standard_normal(gt.shape), 0).astype(np.float32)
    x0 = np.where(m, rng.standard_normal(gt.shape), 0).astype(np.float32)
    for got, want in (
            (st.vmult(torch.as_tensor(b)), sj.vmult(jnp.asarray(b))),
            (st.step(torch.as_tensor(x0), torch.as_tensor(b)),
             sj.step(jnp.asarray(x0), jnp.asarray(b)))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=3e-6 * np.abs(want).max())


def test_single_level_coarse_solver():
    """size 3 is one level: CG preconditioned by the Chebyshev coarse
    solver; reference row: 3 its, reduction 3.157e-4."""
    s = build_solver(poisson_cube_mesh(3), 4, n_cycles=2, device="cpu")
    _, its, red = s.solve_cg()
    assert its == 3
    assert red == pytest.approx(3.157e-4, rel=0.05)
