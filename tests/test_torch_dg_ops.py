"""The port's SIP-DG operator layer against the JAX package, on the CPU.

* ``core/dg_basis``: every table equal to the JAX one (three kinds, p 1..7).
* ``DGLaplace``: f64 to 1e-13·max|y|, f32 to 2e-6·max|y|, on the sheared
  grids and the five ``CASES`` of tests/test_pallas_dg.py:28-34.
* The kernels' plain versions (``ops/dg_kernel.py``) against the JAX Pallas
  kernels in interpret mode, at the JAX bars: ``dg_apply`` f32 and the
  ``PallasDGSP`` kernel both within 3e-6 of the f64 oracle, ``dg_apply`` f64
  and ``PallasDGOzaki`` within 5e-11 of each other; one ``dg_cheb`` step
  against ``FusedChebyshevDG``'s fused pass at 1e-5·max|out|; the
  smoother's iterates, on which the card checks ``dg_cheb``, show every
  term of the step above that bar.
* ``JacobiTransformed`` (1e-12) and ``CGDGCoupling`` (1e-13) against JAX.
* The DG smoother's Lanczos estimate with the transformed-Jacobi
  preconditioner against JAX ``Chebyshev.create`` (f32 runs, 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.core import dg_basis as j_basis
from multigrid_tpu.mesh.brick import DofGrid as JDofGrid
from multigrid_tpu.mesh.brick import cube as j_cube
from multigrid_tpu.ops import dg as j_dg
from multigrid_tpu.ops.dg_precond import JacobiTransformed as JJacobi
from multigrid_tpu.ops.dg_transfer import CGDGCoupling as JCoupling
from multigrid_tpu_torch.core import dg_basis as t_basis
from multigrid_tpu_torch.mesh.brick import DofGrid, cube
from multigrid_tpu_torch.ops import dg as t_dg
from multigrid_tpu_torch.ops import dg_kernel as dk
from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed
from multigrid_tpu_torch.ops.dg_transfer import CGDGCoupling
from multigrid_tpu_torch.solvers.chebyshev import Chebyshev

jax.config.update("jax_enable_x64", True)

KINDS = ["hermite", "gll", "gauss"]
# tests/test_pallas_dg.py:28-34
CASES = [((3, 2, 4), 3), ((2, 3, 2), 4), ((1, 1, 1), 3), ((1, 2, 1), 4),
         ((4, 1, 3), 3)]
PREC = {"f64": (torch.float64, jnp.float64, 1e-13),
        "f32": (torch.float32, jnp.float32, 2e-6)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def grids(cells, p, kind, seed=0):
    """The sheared affine grid of tests/test_pallas_dg.py:20-25, as a JAX
    and a port DGGrid."""
    rng = np.random.default_rng(seed)
    J = np.diag(1.0 / np.array(cells)) @ (np.eye(3) + 0.08 * rng.random((3, 3)))
    jac = tuple(map(tuple, J))
    return (j_dg.DGGrid(cells=cells, jacobian=jac, degree=p, kind=kind),
            t_dg.DGGrid(cells=cells, jacobian=jac, degree=p, kind=kind))


def rand(shape, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def rel_err(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max()


@pytest.mark.parametrize("degree", range(1, 8))
@pytest.mark.parametrize("kind", KINDS)
def test_dg_basis_tables_match_jax(kind, degree):
    bj = j_basis.make_dg_basis(degree, kind)
    bt = t_basis.make_dg_basis(degree, kind)
    for f in dataclasses.fields(bj):
        np.testing.assert_array_equal(getattr(bt, f.name), getattr(bj, f.name),
                                      err_msg=f.name)


@pytest.mark.parametrize("prec", sorted(PREC))
@pytest.mark.parametrize("cells,p", CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_dg_laplace_matches_jax(kind, cells, p, prec):
    tdt, jdt, tol = PREC[prec]
    gj, gt = grids(cells, p, kind)
    u = rand(gt.shape, 1)
    y_ref = np.asarray(j_dg.DGLaplace(gj, jdt).vmult(jnp.asarray(u, jdt)))
    op = t_dg.DGLaplace(gt, tdt, "cpu")
    y = op.apply(torch.as_tensor(u, dtype=tdt)).numpy()
    assert rel_err(y, y_ref) < tol
    b = rand(gt.shape, 2)
    r = op.vmult_residual(torch.as_tensor(b, dtype=tdt),
                          torch.as_tensor(u, dtype=tdt)).numpy()
    np.testing.assert_allclose(r, b - y_ref, rtol=0,
                               atol=tol * np.abs(y_ref).max())


@pytest.mark.parametrize("kind,cells,p", [("hermite", (3, 2, 4), 3),
                                          ("gauss", (1, 2, 1), 4)])
def test_dg_apply_f32_matches_pallas_dgsp(kind, cells, p):
    """K7's plain version and the JAX kernel (interpret) both sit within
    the JAX bar of the f64 oracle (tests/test_pallas_dg.py:82)."""
    from multigrid_tpu.ops.pallas_dg import PallasDGSP

    gj, gt = grids(cells, p, kind)
    u = rand(gt.shape, 2)
    y0 = np.asarray(j_dg.DGLaplace(gj, jnp.float64).vmult(jnp.asarray(u)))
    y_j = np.asarray(PallasDGSP(gj, interpret=True).vmult(
        jnp.asarray(u, jnp.float32)))
    op = dk.DGOperator(gt, torch.float32, "cpu")
    y_t = dk.dg_apply(torch.as_tensor(u, dtype=torch.float32), op).numpy()
    assert rel_err(y_j, y0) < 3e-6
    assert rel_err(y_t, y0) < 3e-6


def test_dg_apply_f64_matches_pallas_dgozaki():
    """K9's plain version against the JAX kernel (interpret) at the JAX
    bar of tests/test_pallas_dg.py:96."""
    from multigrid_tpu.ops.pallas_dg import PallasDGOzaki

    gj, gt = grids((1, 2, 1), 4, "gll")
    u = rand(gt.shape, 3)
    y_j = np.asarray(PallasDGOzaki(gj, interpret=True).vmult(jnp.asarray(u)))
    op = dk.DGOperator(gt, torch.float64, "cpu")
    y_t = dk.dg_apply(torch.as_tensor(u), op).numpy()
    assert rel_err(y_t, y_j) < 5e-11


def test_dg_cheb_matches_fused_chebyshev_pass():
    """K8's plain version: one step x + f1 (x - x_old) + f2 P^-1 (b - A x)
    against PallasDGSP.cheb_fused in interpret mode, on the setup of
    tests/test_pallas_dg.py:180-239 (bar of its :146)."""
    from multigrid_tpu.ops.pallas_dg import PallasDGSP

    gj, gt = grids((3, 2, 3), 3, "hermite")
    jac_j = JJacobi(j_dg.DGLaplace(gj, jnp.float32))
    spk = PallasDGSP(gj, interpret=True)
    b_ = gj.basis
    T3 = np.kron(np.kron(np.asarray(b_.T), np.asarray(b_.T)), np.asarray(b_.T))
    spk.install_jacobi(T3, spk.to_kernel(jac_j.inv_diag))
    b, x, x_old = (rand(gt.shape, s, np.float32) for s in (4, 5, 6))
    f1, f2 = 0.37, 0.81
    k = lambda a: spk.to_kernel(jnp.asarray(a))
    want = np.asarray(spk.from_kernel(
        spk.cheb_fused(k(x), k(x_old), k(b), f1, f2)[:-1]))

    op = dk.DGOperator(gt, torch.float32, "cpu")
    op.install_jacobi(JacobiTransformed(gt, torch.float32, "cpu"))
    t = lambda a: torch.as_tensor(a)
    got = dk.dg_cheb(t(b), t(x), t(x_old), op, f1, f2).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # x = None: the first application P^-1 b / theta (pallas_dg.py:716-718)
    first = dk.dg_cheb(t(b), None, None, op, 0.0, f2).numpy()
    want0 = f2 * np.asarray(jac_j.vmult(jnp.asarray(b)))
    np.testing.assert_allclose(first, want0, rtol=0,
                               atol=1e-5 * np.abs(want0).max())


@pytest.mark.parametrize("cells,p", [((3, 2, 4), 3), ((1, 1, 1), 4),
                                     ((4, 1, 3), 6)])
@pytest.mark.parametrize("kind", KINDS)
def test_dg_cheb_check_sees_every_term(kind, cells, p):
    """The inputs on which the card holds dg_cheb<float> to its plain f64
    version (``smoother_iterates``): float32 arithmetic meets the bar of
    1e-5·max|out| there, and a step that left out A x, x_old or x would
    miss it by more than a thousandfold."""
    _, gt = grids(cells, p, kind)
    ops = {}
    for dt in (torch.float32, torch.float64):
        ops[dt] = dk.DGOperator(gt, dt, "cpu")
        ops[dt].install_jacobi(JacobiTransformed(gt, dt, "cpu"))
    b, x, xo = dk.smoother_iterates(ops[torch.float64].jacobi, 3)
    b64, x64, xo64 = b.double(), x.double(), xo.double()
    f1, f2 = 0.37, 0.81
    want = dk.dg_cheb_plain(b64, x64, xo64, ops[torch.float64], f1, f2)
    bar = 1e-5 * float(want.abs().max())
    got = dk.dg_cheb(b, x, xo, ops[torch.float32], f1, f2).double()
    assert float((got - want).abs().max()) <= bar
    jac = ops[torch.float64].jacobi.vmult
    wrong = {"no A x": x64 + f1 * (x64 - xo64) + f2 * jac(b64),
             "no x_old": dk.dg_cheb_plain(b64, x64, None, ops[torch.float64],
                                          f1, f2),
             "no x": f2 * jac(b64)}
    for what, w in wrong.items():
        assert float((w - want).abs().max()) > 1e3 * bar, what


def test_dg_cheb_out_may_alias_x_old():
    _, gt = grids((2, 3, 2), 3, "gll")
    op = dk.DGOperator(gt, torch.float64, "cpu")
    op.install_jacobi(JacobiTransformed(gt, torch.float64, "cpu"))
    b, x, x_old = (torch.as_tensor(rand(gt.shape, s)) for s in (7, 8, 9))
    want = dk.dg_cheb(b, x, x_old, op, 0.2, 0.6)
    out = dk.dg_cheb(b, x, x_old, op, 0.2, 0.6, out=x_old)
    assert out is x_old
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("kind,cells,p", [("hermite", (3, 2, 4), 3),
                                          ("gll", (1, 2, 1), 4),
                                          ("gauss", (4, 1, 3), 3)])
def test_jacobi_transformed_matches_jax(kind, cells, p):
    gj, gt = grids(cells, p, kind)
    jj = JJacobi(j_dg.DGLaplace(gj, jnp.float64))
    jt = JacobiTransformed(gt, torch.float64, "cpu")
    assert rel_err(jt.inv_diag.numpy(), np.asarray(jj.inv_diag)) < 1e-12
    u = rand(gt.shape, 10)
    want = np.asarray(jj.vmult(jnp.asarray(u)))
    assert rel_err(jt.vmult(torch.as_tensor(u)).numpy(), want) < 1e-12


@pytest.mark.parametrize("kind", KINDS)
def test_cg_dg_coupling_matches_jax(kind):
    mj, mt = j_cube(2, -0.9, 1.0, 1, dim=3), cube(2, -0.9, 1.0, 1, dim=3)
    cgj, cgt = JDofGrid(mj, 1, 3), DofGrid(mt, 1, 3)
    J = tuple(tuple(r) for r in np.diag(mt.h(1)))
    gj = j_dg.DGGrid(cells=cgt.cells, jacobian=J, degree=3, kind=kind)
    gt = t_dg.DGGrid(cells=cgt.cells, jacobian=J, degree=3, kind=kind)
    cj = JCoupling(cgj, gj, jnp.float64)
    ct = CGDGCoupling(cgt, gt, torch.float64, "cpu")
    u = rand(cgt.shape, 11)
    r = rand(gt.shape, 12)
    want = np.asarray(cj.cg_to_dg(jnp.asarray(u)))
    assert rel_err(ct.cg_to_dg(torch.as_tensor(u)).numpy(), want) < 1e-13
    want = np.asarray(cj.dg_to_cg(jnp.asarray(r)))
    assert rel_err(ct.dg_to_cg(torch.as_tensor(r)).numpy(), want) < 1e-13


def test_dg_smoother_interval_matches_jax():
    """Chebyshev.create with a callable preconditioner (the DG smoother,
    multigrid_dg.py:165-174): the same Lanczos estimate as the JAX twin."""
    from multigrid_tpu.solvers.chebyshev import FIRST_KIND
    from multigrid_tpu.solvers.chebyshev import Chebyshev as JCheb

    gj, gt = grids((3, 2, 3), 3, "hermite")
    opj = j_dg.DGLaplace(gj, jnp.float32)
    ref = JCheb.create(opj.vmult, None, smoothing_range=20.0, degree=3,
                       eig_cg_n_iterations=15, kind=FIRST_KIND,
                       precond=JJacobi(opj).vmult,
                       example=jnp.zeros(gj.shape, jnp.float32))
    op = dk.DGOperator(gt, torch.float32, "cpu")
    jac = JacobiTransformed(gt, torch.float32, "cpu")
    sm = Chebyshev.create(op, jac.vmult, smoothing_range=20.0, degree=3,
                          eig_cg_n_iterations=15)
    assert sm.degree == ref.degree
    for a in ("theta", "delta", "max_eig"):
        assert getattr(sm, a) == pytest.approx(float(getattr(ref, a)), rel=1e-4)


def test_dg_wrappers_refuse_other_devices():
    """On a tensor that is neither on the CPU nor on the card a wrapper
    raises: there is no fallback to the plain version."""
    _, gt = grids((2, 2, 2), 3, "gll")
    op = dk.DGOperator(gt, torch.float32, "cpu")
    op.install_jacobi(JacobiTransformed(gt, torch.float32, "cpu"))
    x = torch.zeros(gt.shape, dtype=torch.float32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        dk.dg_apply(x, op)
    with pytest.raises(RuntimeError, match="no kernel"):
        dk.dg_cheb(x, None, None, op, 0.0, 1.0)
    with pytest.raises(ValueError, match="install_jacobi"):
        dk.dg_cheb(x, None, None, dk.DGOperator(gt, torch.float32, "cpu"),
                   0.0, 1.0)


@pytest.mark.parametrize("kind", KINDS)
def test_dg_matvec_model_matches_jax(kind):
    """The matvec telemetry's model is the JAX one (about 201 flop per dof
    at p = 4, hermite), and its operation count is what chip_smoke.py
    bounds the DG kernels with."""
    from multigrid_tpu.utils.perf_model import dg_matvec_model as j_model
    from multigrid_tpu_torch.utils.perf_model import (dg_matvec_model,
                                                      dg_matvec_ops)

    args = (3, 4, 110_592, kind, 8, 13_824_000, 1.2e-3)
    assert dg_matvec_model(*args) == j_model(*args)
    assert dg_matvec_ops(*args[:4]) == pytest.approx(
        j_model(*args)["ops_per_dof"] * args[5])


def test_dg_tables_layout():
    """The kernel's table is the concatenation its Tab<N> struct reads."""
    _, gt = grids((2, 2, 2), 4, "hermite")
    n = gt.n
    tab = dk.dg_tables(gt)
    assert tab.shape == (4 * n * n + 7 * n + 24,)
    b = gt.basis
    np.testing.assert_array_equal(tab[:n * n], b.S.ravel())
    np.testing.assert_array_equal(tab[3 * n * n:4 * n * n], b.T.ravel())
    geo = t_dg.dg_geometry(gt)
    assert tab[-6:-3].tolist() == [f["sigma"] for f in geo["face"]]
