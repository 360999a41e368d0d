"""Port vs JAX twin: the brick operator (plain versions of the brick_apply
and cheb_epilogue kernels), the sum-factorized oracle and the host helpers.

Bars: float64 applies agree to 1e-13·max|y| (summation order only, the bar
of tests/test_pallas_windowed.py:33); float32 to 2e-6·max|y| (f32 roundoff
of a 125-term sum, tests/test_pallas_windowed_sp.py:42); the Chebyshev
epilogue to 3e-6·scale (tests/test_pallas_windowed_sp.py:158); setup
helpers to 1e-13 (same fp64 formulas).  The Pallas kernels run in
interpret mode, as the JAX package's own tests run them on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.mesh.brick import BrickMesh as JBrickMesh
from multigrid_tpu.mesh.brick import DofGrid as JDofGrid
from multigrid_tpu.ops import laplace as jl
from multigrid_tpu.ops.laplace_dense import element_matrix as j_element_matrix
from multigrid_tpu.ops.pallas_windowed import PallasWindowedOzaki
from multigrid_tpu.ops.pallas_windowed_sp import PallasWindowedSP
from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid
from multigrid_tpu_torch.ops import laplace as tl
from multigrid_tpu_torch.ops import laplace_kernel as lk
from multigrid_tpu_torch.ops.laplace_dense import element_matrix


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def grids(cells, degree=4):
    args = (cells, (-0.9,) * 3, (1.9, 1.3, 1.1), 1)
    return JDofGrid(JBrickMesh(*args), 0, degree), DofGrid(BrickMesh(*args), 0, degree)


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


DTYPES = {"f64": (torch.float64, jnp.float64, 1e-13),
          "f32": (torch.float32, jnp.float32, 2e-6)}
CELLS = [(2, 2, 2), (3, 4, 4), (2, 3, 5)]


@pytest.mark.parametrize("prec", sorted(DTYPES))
@pytest.mark.parametrize("cells", CELLS)
def test_brick_vmult_matches_laplace_operator(cells, prec):
    tdt, jdt, tol = DTYPES[prec]
    gj, gt = grids(cells)
    x = rand(gt.shape, 0)
    ref = jl.LaplaceOperator(gj, jdt, jl.make_diag_coef(gj))
    op = lk.BrickLaplace(gt, tdt, "cpu")
    y_ref = np.asarray(ref.vmult(jnp.asarray(x, jdt)))
    y = op.vmult(torch.as_tensor(x, dtype=tdt)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=tol * np.abs(y_ref).max())
    b = rand(gt.shape, 1)
    r_ref = np.asarray(ref.vmult_residual(jnp.asarray(b, jdt), jnp.asarray(x, jdt)))
    r = op.vmult_residual(torch.as_tensor(b, dtype=tdt),
                          torch.as_tensor(x, dtype=tdt)).numpy()
    np.testing.assert_allclose(r, r_ref, rtol=0, atol=tol * np.abs(r_ref).max())


@pytest.mark.parametrize("prec", sorted(DTYPES))
def test_brick_apply_plain_zero_boundary(prec):
    """Plain brick_apply reads Dirichlet nodes of x as 0 and writes 0 there;
    on interior nodes it is the JAX LaplaceOperator's A applied to x with
    its Dirichlet nodes zeroed."""
    tdt, jdt, tol = DTYPES[prec]
    gj, gt = grids((2, 3, 4))
    x = rand(gt.shape, 2)
    op = lk.BrickLaplace(gt, tdt, "cpu")
    y = lk.brick_apply(torch.as_tensor(x, dtype=tdt), op).numpy()
    m = np.broadcast_to(op.interior.numpy(), y.shape)
    assert np.all(y[~m] == 0)
    ref = jl.LaplaceOperator(gj, jdt, jl.make_diag_coef(gj))
    y_ref = np.asarray(ref.vmult(jnp.asarray(np.where(m, x, 0.0), jdt)))
    np.testing.assert_allclose(y[m], y_ref[m], rtol=0,
                               atol=tol * np.abs(y_ref[m]).max())


@pytest.mark.parametrize("cells", CELLS)
def test_sum_factorized_operator_matches_jax(cells):
    gj, gt = grids(cells)
    x = rand(gt.shape, 3)
    y_ref = np.asarray(jl.LaplaceOperator(gj, jnp.float64).vmult(jnp.asarray(x)))
    y = tl.LaplaceOperator(gt, torch.float64, device="cpu").vmult(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-13 * np.abs(y_ref).max())


def test_brick_matches_pallas_windowed_dp():
    """f64 plain brick_apply vs the TPU dp kernel (K1) in interpret mode."""
    gj, gt = grids((3, 4, 4))
    x = rand(gt.shape, 0)
    y_ref = np.asarray(PallasWindowedOzaki(gj, cy_chunk=4, interpret=True)
                       .vmult(jnp.asarray(x)))
    y = lk.BrickLaplace(gt, torch.float64, "cpu").vmult(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-13 * np.abs(y_ref).max())


def test_brick_matches_pallas_windowed_sp():
    """f32 plain brick_apply vs the TPU sp kernel (K2) in interpret mode."""
    gj, gt = grids((3, 4, 4))
    x = rand(gt.shape, 0).astype(np.float32)
    y_ref = np.asarray(PallasWindowedSP(gj, cy_chunk=4, interpret=True)
                       .vmult(jnp.asarray(x)))
    y = lk.BrickLaplace(gt, torch.float32, "cpu").vmult(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=2e-6 * np.abs(y_ref).max())


@pytest.mark.parametrize("kernel", ["K5", "K6"])
def test_brick_matches_older_dp_kernels(kernel):
    """K5 (``PallasFusedOzaki``) and K6 (``PallasOzakiLaplace``) compute the
    same f64 FE_Q(4) A·u as K1 in older TPU layouts: the port's plain
    brick_apply against each in interpret mode, at the bar of
    tests/test_pallas_matvec.py:24 (relative 2-norm 5e-11)."""
    from multigrid_tpu.mesh.brick import poisson_cube_mesh as j_cube
    from multigrid_tpu.ops.pallas_fused import PallasFusedOzaki
    from multigrid_tpu.ops.pallas_matvec import PallasOzakiLaplace
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh

    cls = {"K5": PallasFusedOzaki, "K6": PallasOzakiLaplace}[kernel]
    mj, mt = j_cube(8), poisson_cube_mesh(8)
    gj, gt = JDofGrid(mj, mj.max_level, 4), DofGrid(mt, mt.max_level, 4)
    x = rand(gt.shape, 0)
    y_ref = np.asarray(cls(gj, interpret=True).vmult(jnp.asarray(x)))
    y = lk.BrickLaplace(gt, torch.float64, "cpu").vmult(torch.as_tensor(x)).numpy()
    assert np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref) < 5e-11


@pytest.mark.parametrize("f1,f2", [(0.37, 0.81), (0.0, 1.3)])
def test_cheb_epilogue_matches_pallas_cheb_fused(f1, f2):
    """Plain cheb_epilogue vs PallasWindowedSP.cheb_fused (K2's fused
    Chebyshev pass) on boundary-zero vectors.  The epilogue is fed the
    kernel's own A x (its 3-limb product differs from a plain f32 product
    by ~2e-6·max|A x|, which f2/diag amplifies), so the comparison isolates
    the epilogue: the update and the in-kernel diagonal."""
    gj, gt = grids((2, 4, 4))
    opw = PallasWindowedSP(gj, cy_chunk=2, interpret=True)
    lap = jl.LaplaceOperator(gj, jnp.float32, jl.make_diag_coef(gj))
    opw.install_diag_factors(lap)
    op = lk.BrickLaplace(gt, torch.float32, "cpu")
    vecs = [np.where(np.asarray(opw.interior), rand(gt.shape, s), 0.0)
            .astype(np.float32) for s in (1, 2, 3)]
    x, x_old, b = vecs
    want = np.asarray(opw.from_windowed(opw.cheb_fused(
        *(opw.to_windowed(jnp.asarray(v)) for v in (x, x_old, b)), f1, f2)))
    xt, xot, bt = (torch.as_tensor(v) for v in vecs)
    y = torch.tensor(np.asarray(opw.vmult(jnp.asarray(x))))
    got = lk.cheb_epilogue(bt, y, xt, xot, op.lines, f1, f2).numpy()
    m = np.asarray(opw.interior)
    np.testing.assert_allclose(got[m], want[m], rtol=0,
                               atol=3e-6 * np.abs(want).max())
    assert np.all(got[~np.broadcast_to(m, got.shape)] == 0)


def test_cheb_epilogue_matches_node_chebyshev_step():
    """The epilogue equals the node path's x + f1 (x - x_old) + f2 P^-1 (b - A x)
    with the JAX operator's inverse diagonal, boundary rows included."""
    gj, gt = grids((2, 3, 4))
    lap = jl.LaplaceOperator(gj, jnp.float64, jl.make_diag_coef(gj))
    x, x_old, b = (rand(gt.shape, s) for s in (4, 5, 6))
    f1, f2 = 0.21, 0.66
    r = np.asarray(b) - np.asarray(lap.vmult(jnp.asarray(x)))
    want = x + f1 * (x - x_old) + f2 * np.asarray(lap.inverse_diagonal()) * r
    op = lk.BrickLaplace(gt, torch.float64, "cpu")
    xt, xot, bt = (torch.as_tensor(v) for v in (x, x_old, b))
    got = op.cheb_step(bt, xt, xot, f1, f2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max())
    res = lk.cheb_epilogue(bt, op.apply(xt), x=xt, residual_only=True).numpy()
    np.testing.assert_allclose(res, r, rtol=0, atol=1e-13 * np.abs(r).max())


@pytest.mark.parametrize("cells", CELLS)
def test_inverse_diagonal_matches_jax(cells):
    gj, gt = grids(cells)
    want = np.asarray(jl.LaplaceOperator(gj, jnp.float64).inverse_diagonal())
    got = tl.LaplaceOperator(gt, torch.float64, device="cpu").inverse_diagonal().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


@pytest.mark.parametrize("cells", CELLS)
def test_element_matrix_equal(cells):
    gj, gt = grids(cells)
    np.testing.assert_array_equal(element_matrix(gt), j_element_matrix(gj))


def _exact(coords):
    out = 1.0
    for c in coords:
        out = out * np.sin(3 * np.pi * c)
    return out


def _rhs(coords):
    return 27 * np.pi**2 * _exact(coords)


def test_host_helpers_match_jax():
    gj, gt = grids((3, 4, 5))
    from multigrid_tpu.solvers.multigrid import _bc_faces_host, _dense_bc_host

    faces = _bc_faces_host(gj, _exact)
    ubc = _dense_bc_host(gj, faces)
    want = jl.compute_rhs_host(gj, _rhs, ubc, jl.make_diag_coef(gj))
    got = tl.compute_rhs_host(gt, _rhs, ubc, tl.make_diag_coef(gt))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max())
    sj, aj = jl.compute_bc_slab_correction_host(gj, faces)
    st, at = tl.compute_bc_slab_correction_host(gt, faces)
    assert sj == st
    for a, b in zip(aj, at):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-13 * np.abs(a).max())
    u = want + ubc
    assert tl.l2_error_host(gt, u, _exact) == pytest.approx(
        jl.l2_error_host(gj, u, _exact), rel=1e-13)


def test_device_rhs_and_l2_error_match_jax():
    """compute_rhs and l2_error of the torch oracle (blocked quadrature
    layout) against the JAX twin (interleaved layout)."""
    gj, gt = grids((2, 3, 4))
    from multigrid_tpu.solvers.multigrid import _bc_faces_host, _dense_bc_host

    ubc = _dense_bc_host(gj, _bc_faces_host(gj, _exact))
    fq_j = _rhs(gj.quad_coords_interleaved())
    fq_t = _rhs(tl.quad_coords_blocked(gt))
    opj = jl.LaplaceOperator(gj, jnp.float64)
    opt = tl.LaplaceOperator(gt, torch.float64, device="cpu")
    want = np.asarray(opj.compute_rhs(jnp.asarray(fq_j), jnp.asarray(ubc)))
    got = opt.compute_rhs(torch.as_tensor(fq_t), torch.as_tensor(ubc)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max())
    u = rand(gt.shape, 7)
    e_j = float(opj.l2_error(jnp.asarray(u), jnp.asarray(_exact(
        gj.quad_coords_interleaved()))))
    e_t = float(opt.l2_error(torch.as_tensor(u), torch.as_tensor(_exact(
        tl.quad_coords_blocked(gt)))))
    # the JAX f64 error sums through ops/df64.sum_f64 (~1e-6 relative);
    # the host fp64 form is the exact oracle
    assert e_t == pytest.approx(tl.l2_error_host(gt, u, _exact), rel=1e-12)
    assert e_t == pytest.approx(e_j, rel=1e-6)


def test_wrappers_refuse_other_devices():
    """A wrapper runs the plain version only for CPU tensors; for any other
    device it launches a kernel or raises -- never falls back."""
    _, gt = grids((2, 2, 2))
    op = lk.BrickLaplace(gt, torch.float64, "cpu")
    x = torch.zeros(gt.shape, dtype=torch.float64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        lk.brick_apply(x, op)
    with pytest.raises(RuntimeError, match="no kernel"):
        lk.cheb_epilogue(x, residual_only=True)
    assert all(v == 0 for v in lk.LAUNCHES.values())
