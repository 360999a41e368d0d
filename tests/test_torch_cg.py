"""Port vs JAX twin and numpy: the CG vector kernels' plain versions and
the CG loop.

Bars: the plain cg_update / cg_dot / cg_xpay agree with numpy fp64 to 1e-15
(vectors: relative to max|v|, one rounding per entry; dots: relative to
sum|a_i b_i|, summation order only).  ``cg_solve`` matches the JAX
``cg_solve`` on the same operator in iteration count, and in x to
1e-12·max|x| (the f32 V-cycle preconditioners differ by roundoff; the JAX
dots run through ops/df64.dot_f64, ~1e-6 relative, which the final
residual ratio shows at 1e-4)."""

import jax
import numpy as np
import pytest
import torch

from multigrid_tpu.solvers.cg import cg_solve as j_cg_solve
from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid
from multigrid_tpu_torch.ops import cg_kernel as ck
from multigrid_tpu_torch.ops.laplace import LaplaceOperator
from multigrid_tpu_torch.ops.laplace_kernel import BrickLaplace
from multigrid_tpu_torch.solvers.cg import cg_solve


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def vecs(n, k, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n) for _ in range(k)]


@pytest.mark.parametrize("n", [1, 1000, 35937])
def test_cg_update_plain_matches_numpy(n):
    x, r, p, q = vecs(n, 4, n)
    alpha = 0.7234912384001122
    xt, rt = torch.tensor(x), torch.tensor(r)
    rr = ck.cg_update(xt, rt, torch.tensor(p), torch.tensor(q), alpha)
    x_ref, r_ref = x + alpha * p, r - alpha * q
    np.testing.assert_allclose(xt.numpy(), x_ref, rtol=0,
                               atol=1e-15 * np.abs(x_ref).max())
    np.testing.assert_allclose(rt.numpy(), r_ref, rtol=0,
                               atol=1e-15 * np.abs(r_ref).max())
    assert float(rr) == pytest.approx(float(r_ref @ r_ref), rel=1e-15)


@pytest.mark.parametrize("n", [1, 1000, 35937])
def test_cg_dot_plain_matches_numpy(n):
    a, b = vecs(n, 2, n + 1)
    d = ck.cg_dot(torch.tensor(a), torch.tensor(b))
    assert d.dim() == 0 and d.dtype == torch.float64
    assert abs(float(d) - float(a @ b)) <= 1e-15 * float(np.abs(a * b).sum())


@pytest.mark.parametrize("n", [1, 1000, 35937])
def test_cg_xpay_plain_matches_numpy(n):
    p, z = vecs(n, 2, n + 2)
    beta = 0.3141592653589793
    pt = torch.tensor(p)
    assert ck.cg_xpay(pt, torch.tensor(z), beta) is pt
    p_ref = z + beta * p
    np.testing.assert_allclose(pt.numpy(), p_ref, rtol=0,
                               atol=1e-15 * np.abs(p_ref).max())
    ck.cg_xpay(pt, torch.tensor(z), 0.0)
    np.testing.assert_array_equal(pt.numpy(), z)


def test_cg_kernels_refuse_other_devices():
    x = torch.zeros(8, dtype=torch.float64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ck.cg_update(x, x, x, x, 1.0)
    with pytest.raises(RuntimeError, match="no kernel"):
        ck.cg_dot(x, x)
    with pytest.raises(RuntimeError, match="no kernel"):
        ck.cg_xpay(x, x, 1.0)
    assert all(v == 0 for v in ck.LAUNCHES.values())


def _problem(cells):
    gt = DofGrid(BrickMesh(cells, (-0.9,) * 3, (1.9, 1.3, 1.1), 1), 0, 4)
    m = ~gt.boundary_mask()
    b = np.where(m, np.random.default_rng(9).standard_normal(gt.shape), 0.0)
    return gt, b


@pytest.mark.parametrize("size", [2, 4])
def test_cg_solve_matches_jax(size):
    """V-cycle-preconditioned CG at rtol 1e-9 on the poisson_cube problem:
    the JAX twin on its dp operator and V-cycle, the port on its own; the
    operators are the same, the f32 V-cycles differ by roundoff."""
    from experiments.poisson_cube import build_solver as j_build
    from multigrid_tpu.mesh.brick import poisson_cube_mesh as j_cube
    from multigrid_tpu_torch.experiments.poisson_cube import build_solver
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh

    sj = j_build(j_cube(size), 4, n_cycles=2)
    st = build_solver(poisson_cube_mesh(size), 4, device="cpu")
    L = sj.maxlevel
    res_j = jax.jit(lambda bb: j_cg_solve(
        sj.dp_ops[L].vmult, bb, precond=sj._precond, rtol=1e-9))(sj.rhs[L])
    res = cg_solve(st.dp_ops[L].vmult, st.rhs[L], precond=st._precond,
                   rtol=1e-9)
    assert res.iterations == int(res_j.iterations)
    xj = np.asarray(res_j.x)
    np.testing.assert_allclose(res.x.numpy(), xj, rtol=0,
                               atol=1e-12 * np.abs(xj).max())
    assert res.final_norm / res.initial_norm == pytest.approx(
        float(res_j.final_norm / res_j.initial_norm), rel=1e-4)


def test_cg_solve_leaves_rhs_and_stops_at_tolerance():
    gt, b = _problem((2, 2, 2))
    op = BrickLaplace(gt, torch.float64, "cpu")
    inv = LaplaceOperator(gt, torch.float64, device="cpu").inverse_diagonal()
    bt = torch.tensor(b)
    res = cg_solve(op.vmult, bt, precond=lambda r: inv * r, rtol=1e-9)
    assert torch.equal(bt, torch.tensor(b))
    assert res.final_norm <= 1e-9 * res.initial_norm
    resid = float(torch.linalg.vector_norm(bt - op.vmult(res.x)))
    assert resid == pytest.approx(res.final_norm, rel=1e-3)
