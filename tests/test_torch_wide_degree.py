"""The port's operators at p = 10..16, the degrees the brick and DG kernels
took on beyond p = 9, on the CPU against the JAX package, and the routes
that send those degrees to the kernels.

* The SIP-DG operator at p = 10, 13, 16 on 2^3 sheared cells: the port's
  f64 ``dg_apply`` and ``dg_residual`` (their plain versions here) against
  the JAX ``DGLaplace`` in f64 (``multigrid_tpu/ops/dg.py``, the operator
  the JAX solvers run above p = 4) to 1e-12 of max|y|; the f32 Chebyshev
  step (``dg_cheb``) against the step composed in f64 from the JAX
  ``DGLaplace`` and basis (a seeded transformed-Jacobi diagonal) to 1e-5
  of max|out|, on random inputs and on the smoother's iterates, the bar of
  the p = 8, 9 test in tests/test_torch_dg_ops.py.
* The brick at p = 10 and 16: the kernel's taps equal the JAX banded
  diagonals exactly, and ``brick_kron_plain`` agrees with the JAX
  ``LaplaceOperator`` in f64 at 1e-13 and in f32 at 2e-6 of max|y|.
* The routes at every p = 1..17: the pencil kernels cover p = 1..16 and
  the fused CG's p = 1..9; ``brick_form`` gives the z-slab march at p >=
  10 in both types; a DG level at p = 17 is refused on the card (device
  monkeypatched); solver_dg at p = 10 runs its fused row plain and its
  unfused row on ``dg_apply``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.mesh.brick import BrickMesh as JBrickMesh
from multigrid_tpu.mesh.brick import DofGrid as JDofGrid
from multigrid_tpu.ops import dg as j_dg
from multigrid_tpu.ops import laplace as jl
from multigrid_tpu.ops import laplace_kron as jk
from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid
from multigrid_tpu_torch.ops import dg as t_dg
from multigrid_tpu_torch.ops import dg_kernel as dk
from multigrid_tpu_torch.ops import laplace_kernel as lk
from multigrid_tpu_torch.ops import laplace_kron as tk
from multigrid_tpu_torch.ops.laplace import make_diag_coef

jax.config.update("jax_enable_x64", True)

DG_DEGREES = (10, 13, 16)
BRICK_DEGREES = (10, 16)
CELLS = (2, 2, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dg_grids(cells, p, kind, seed=0):
    """The sheared affine grid of tests/test_pallas_dg.py:20-25, as a JAX
    and a port DGGrid."""
    rng = np.random.default_rng(seed)
    J = np.diag(1.0 / np.array(cells)) @ (np.eye(3)
                                          + 0.08 * rng.random((3, 3)))
    jac = tuple(map(tuple, J))
    return (j_dg.DGGrid(cells=cells, jacobian=jac, degree=p, kind=kind),
            t_dg.DGGrid(cells=cells, jacobian=jac, degree=p, kind=kind))


def brick_grids(cells, p):
    args = (cells, (-0.9,) * 3, (1.9, 1.3, 1.1), 1)
    return (JDofGrid(JBrickMesh(*args), 0, p), DofGrid(BrickMesh(*args), 0, p))


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("kind", ["hermite", "gll", "gauss"])
@pytest.mark.parametrize("p", DG_DEGREES)
def test_dg_apply_f64_matches_jax(p, kind):
    gj, gt = dg_grids(CELLS, p, kind)
    u, b = rand(gt.shape, 1), rand(gt.shape, 2)
    y_j = np.asarray(j_dg.DGLaplace(gj, jnp.float64).vmult(jnp.asarray(u)))
    op = dk.DGOperator(gt, torch.float64, "cpu")
    t = torch.as_tensor
    scale = np.abs(y_j).max()
    np.testing.assert_allclose(dk.dg_apply(t(u), op).numpy(), y_j, rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(dk.dg_residual(t(b), t(u), op).numpy(),
                               b - y_j, rtol=0, atol=1e-12 * scale)


def tensor_apply(u, M):
    """``M`` applied along each of the last three axes of ``u`` (numpy)."""
    for axis in (-3, -2, -1):
        u = np.moveaxis(np.tensordot(M, u, axes=([1], [axis])), 0, axis)
    return u


@pytest.mark.parametrize("p", DG_DEGREES)
def test_dg_cheb_f32_matches_the_step_jax_composes(p):
    """The port's f32 step (A x in float32, the transformed Jacobi, the
    update) against x + f1 (x - x_old) + f2 T3 D^-1 T3^T (b - A x) composed
    in float64 from the JAX ``DGLaplace`` and basis, for one seeded
    diagonal D (at the operator's scale): the operator's own transformed
    diagonal takes n^3 probes to build at these degrees (JacobiTransformed
    is held to JAX in tests/test_torch_dg_ops.py).  Random inputs, and the
    smoother's iterates x = P^-1 z, x_old = P^-1 z' (every term of the
    step at the output's scale)."""
    from multigrid_tpu_torch.ops.dg import sweep

    gj, gt = dg_grids(CELLS, p, "hermite")
    A_j = j_dg.DGLaplace(gj, jnp.float64)
    z = [rand(gt.shape, s) for s in (4, 5, 6)]
    az = np.asarray(A_j.vmult(jnp.asarray(z[0])))
    inv = (np.linalg.norm(z[0]) / np.linalg.norm(az)
           * (0.5 + np.random.default_rng(7).random(gt.shape)))
    inv = inv.astype(np.float32).astype(np.float64)
    T = np.asarray(gj.basis.T, np.float64)
    pinv = lambda r: tensor_apply(tensor_apply(r, T.T) * inv, T)
    t32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float32)
    T32, Tt32, inv32 = t32(gt.basis.T), t32(gt.basis.T.T), t32(inv)
    op = dk.DGOperator(gt, torch.float32, "cpu")
    op.jacobi = types.SimpleNamespace(
        grid=gt, inv_diag=inv32,
        vmult=lambda u: sweep(sweep(u, Tt32, 3) * inv32, T32, 3))
    f1, f2 = 0.37, 0.81
    iterates = [z[0]] + [pinv(v) for v in z[1:]]
    for inputs in (z, iterates):
        b, x, xo = (a.astype(np.float32) for a in inputs)
        x64, xo64 = x.astype(np.float64), xo.astype(np.float64)
        r = b - np.asarray(A_j.vmult(jnp.asarray(x64)))
        want = x64 + f1 * (x64 - xo64) + f2 * pinv(r)
        t = torch.as_tensor
        got = dk.dg_cheb(t(b), t(x), t(xo), op, f1, f2).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("p", BRICK_DEGREES)
def test_brick_taps_equal_jax_diagonals(p):
    gj, gt = brick_grids((3, 2, 1), p)
    coef = make_diag_coef(gt).values
    taps = tk.kron_taps(gt, coef)
    assert taps.shape == (4, p, 2 * p + 1)
    for axis in range(3):
        M, L = jk.assembled_1d(gj, axis)
        DM, DL = jk._diagonals(M, p), jk._diagonals(L, p)
        for i in range(1, M.shape[0] - 1):
            for k in range(2 * p + 1):
                assert taps[0, i % p, k] == DM[k][i]
                assert taps[1 + axis, i % p, k] == coef[axis] * DL[k][i]


@pytest.mark.parametrize("p", BRICK_DEGREES)
def test_brick_kron_plain_matches_jax(p):
    """The kernel's separable arithmetic with its taps against the JAX
    ``LaplaceOperator`` (sum-factorised, f64): in f64 at 1e-13 of max|y|
    (summation order only), in f32 at 2e-6 (f32 roundoff of the banded
    sweeps, the bar of tests/test_kron.py); Dirichlet rows x, the residual
    b - x there."""
    gj, gt = brick_grids((2, 1, 3), p)
    x, b = rand(gt.shape, 0), rand(gt.shape, 1)
    want = np.asarray(jl.LaplaceOperator(gj, jnp.float64).vmult(
        jnp.asarray(x)))
    scale = np.abs(want).max()
    for dtype, tol in ((torch.float64, 1e-13), (torch.float32, 2e-6)):
        op = lk.BrickLaplace(gt, dtype, "cpu")
        xt, bt = (torch.as_tensor(a, dtype=dtype) for a in (x, b))
        y = tk.brick_kron_plain(xt, op.taps)
        got = torch.where(op.interior, y, xt).double().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)
        res = lk.cheb_epilogue_plain(bt, y, x=xt, residual_only=True)
        np.testing.assert_allclose(res.double().numpy(),
                                   bt.double().numpy() - want, rtol=0,
                                   atol=tol * scale)


@pytest.mark.parametrize("p", range(1, 18))
def test_routes_by_degree(p):
    """The pencil kernels at p = 1..16, the fused CG's at 1..9; the brick's
    form: the z-slab march below p = 8 and from p = 10 on, in both types;
    the p = 8, 9 forms are tests/test_torch_brick_kron.py's."""
    _, gt = dg_grids((1, 1, 1), p, "hermite")
    assert dk.has_kernel(gt) is (p <= 16)
    assert dk.has_cg_kernel(gt) is (p <= 9)
    assert (p in dk.WIDE_DEGREES) is (10 <= p <= 16)
    if p < 8 or 10 <= p <= 16:
        shape = (2 * p + 1, p + 1, 3 * p + 1)
        assert lk.brick_form(shape, p, torch.float32) == "march"
        assert lk.brick_form(shape, p, torch.float64) == "march"
    assert lk.MAX_DEGREE == dk.MAX_DEGREE == 16


def test_dg_level_above_the_top_degree_is_refused_on_the_card(monkeypatch):
    """p = 16 builds a DGOperator on the card's route (device
    monkeypatched); p = 17 raises "no DG kernel"."""
    _, top = dg_grids((1, 1, 1), dk.MAX_DEGREE, "hermite")
    _, above = dg_grids((1, 1, 1), dk.MAX_DEGREE + 1, "hermite")
    monkeypatch.setattr(dk, "resolve", lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(t_dg, "resolve", lambda device: torch.device("cpu"),
                        raising=False)
    with pytest.raises(ValueError, match="no DG kernel"):
        dk.DGOperator(above, torch.float32, "cuda")
    assert dk.has_kernel(top)


def test_solver_dg_at_p10_runs_the_fused_row_plain(capsys):
    """Above the fused CG's top degree the fused row is the plain
    composition ("(plain)"), the unfused row the DG operator's kernel route
    (no mark), both within solver_dg's bar of the face row."""
    from multigrid_tpu_torch.experiments import solver_dg

    rows = solver_dg.main(["--degrees", "10", "--steps", "0", "--device",
                           "cpu"])
    assert len(rows) == 1 and rows[0]["verify"] < solver_dg.VERIFY_TOL
    out = capsys.readouterr().out
    assert "cell-based (fused) (plain)" in out
    assert "unfused (plain)" not in out and "unfused " in out
