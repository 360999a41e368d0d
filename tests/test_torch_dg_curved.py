"""The port's curved SIP-DG operator (``ops/dg_curved.py``) and the curved
``MultigridSolverDGPlain`` against the JAX package, on the CPU.

Twins of tests/test_dg_curved.py, with the same sizes and bars, plus:

* the geometry tables (measures, the merged tensor, face measures,
  conormals, penalties, coordinates) against the JAX grid to 1e-13
  relative;
* the apply against the JAX operator at 1e-12 (f64) and 1e-5 (f32) of the
  largest value, on inputs drawn from a numpy seed; the weak Dirichlet
  right-hand side at 1e-12; the exact per-cell transformed-Jacobi
  diagonal at 1e-11;
* the curved h-multigrid solve with the JAX solver's state carried across
  (``convert.load_state``, whose DG-plain branch takes a curved solver as
  it is): the same CG iterations, the L2 error to 1e-8 and frac its to
  1e-4 (the f32 V-cycle rounds differently in the two packages);
* the anchors of ``poisson_dg_plain 3 0 5000 3 1e-10 --deform --dim 3``
  (the JAX driver's, at 512 and 4096 DG dofs) from the port's driver.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.ops import dg_curved as j_curved
from multigrid_tpu.ops.dg_precond import JacobiTransformed as JJacobi
from multigrid_tpu_torch import convert
from multigrid_tpu_torch.experiments import poisson_dg_plain
from multigrid_tpu_torch.mesh.brick import BrickMesh
from multigrid_tpu_torch.ops import dg as t_dg
from multigrid_tpu_torch.ops.dg_curved import DGCurvedGrid, DGLaplaceCurved
from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed
from multigrid_tpu_torch.solvers.cg import cg_solve
from multigrid_tpu_torch.solvers.multigrid_dg import MultigridSolverDGPlain

KINDS = ["gauss", "gll", "hermite"]
FACTOR = 0.08
CPU = torch.device("cpu")
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _deform(p):
    s = FACTOR * np.prod(np.sin(np.pi * p), axis=1)
    return p + s[:, None]


def _exact(xs):
    u = 1.0
    for x in xs:
        u = u * np.sin(np.pi * x)
    return u


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def solve(op, rhs, max_iterations):
    jac = JacobiTransformed(op.grid, F64, CPU, op=op)
    return cg_solve(op.vmult, rhs, jac.vmult, max_iterations=max_iterations,
                    abs_tol=1e-14, rtol=1e-12).x


# --------------------------------------------------------------- geometry
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dim,cells", [(2, (4, 3)), (3, (2, 3, 2))])
def test_geometry_matches_jax(kind, dim, cells):
    gj = j_curved.DGCurvedGrid(cells, _deform, 3, kind)
    gt = DGCurvedGrid(cells, _deform, 3, kind)
    pairs = [(gt.jxw_vol, gj.jxw_vol)]
    pairs += [(gt.Gw[a][e], gj.Gw[a][e]) for a in range(dim)
              for e in range(dim)]
    pairs += list(zip(gt.quad_phys, gj.quad_phys))
    for d in range(dim):
        pairs += [(gt.face_jxw[d], gj.face_jxw[d]),
                  (gt.face_sigma[d], gj.face_sigma[d])]
        pairs += list(zip(gt.face_gvec[d], gj.face_gvec[d]))
        pairs += list(zip(gt.face_phys[d], gj.face_phys[d]))
    for got, want in pairs:
        assert got.shape == want.shape
        assert rel_err(got, want) < 1e-13


def test_geometry_chunks_give_the_same_tables(monkeypatch):
    """The set-up evaluates the geometry in chunks of points; any chunk
    size gives the same tables, bit for bit."""
    from multigrid_tpu_torch.ops import dg_curved

    whole = DGCurvedGrid((3, 2, 2), _deform, 2, "hermite")
    monkeypatch.setattr(dg_curved, "_GEOM_CHUNK", 7)
    chunked = DGCurvedGrid((3, 2, 2), _deform, 2, "hermite")
    for a, b in [(whole.jxw_vol, chunked.jxw_vol),
                 (whole.Gw[0][2], chunked.Gw[0][2]),
                 (whole.face_sigma[1], chunked.face_sigma[1]),
                 (whole.face_gvec[2][0], chunked.face_gvec[2][0])]:
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- apply
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dim,cells", [(2, (4, 3)), (3, (2, 3, 2))])
def test_affine_reduction_and_symmetry(kind, dim, cells):
    """A linear chart gives the affine operator (1e-13), the form is
    symmetric (1e-12), and the apply is the JAX one's (1e-12 in f64, 1e-5
    in f32)."""
    rng = np.random.default_rng(0)
    A = np.eye(dim) + 0.1 * rng.standard_normal((dim, dim))
    h = 1.0 / np.asarray(cells)
    ga = t_dg.DGGrid(cells=cells, jacobian=tuple(tuple(r) for r in
                                                 (A @ np.diag(h))),
                     degree=3, kind=kind)
    oa = t_dg.DGLaplace(ga, F64, CPU)
    gc = DGCurvedGrid(cells, lambda p: p @ A.T, 3, kind)
    oc = DGLaplaceCurved(gc, F64, CPU)
    u = t64(rng.standard_normal(ga.shape))
    w = t64(rng.standard_normal(ga.shape))
    ya, yc = oa.apply(u), oc.apply(u)
    scale = float(ya.abs().max())
    assert float((ya - yc).abs().max()) < 1e-13 * scale
    sym = float(torch.vdot(oc.apply(u).reshape(-1), w.reshape(-1))
                - torch.vdot(u.reshape(-1), oc.apply(w).reshape(-1)))
    assert abs(sym) < 1e-12 * scale

    gd = DGCurvedGrid(cells, _deform, 3, kind)
    jd = j_curved.DGCurvedGrid(cells, _deform, 3, kind)
    x = rng.standard_normal(gd.shape)
    for tdt, jdt, tol in ((F64, jnp.float64, 1e-12),
                          (torch.float32, jnp.float32, 1e-5)):
        got = DGLaplaceCurved(gd, tdt, CPU).apply(
            torch.as_tensor(x, dtype=tdt))
        want = j_curved.DGLaplaceCurved(jd, jdt).apply(jnp.asarray(x, jdt))
        assert rel_err(got.numpy(), want) < tol


def test_astype_and_batched_apply():
    """``astype`` gives the operator in another dtype, and a leading batch
    axis (the transformed-Jacobi probe's) applies per slice."""
    g = DGCurvedGrid((2, 3), _deform, 2, "gll")
    op = DGLaplaceCurved(g, torch.float32, CPU)
    assert op.astype(torch.float32) is op
    op64 = op.astype(F64)
    assert op64.dtype == F64 and op64.grid is g
    x = t64(np.random.default_rng(1).standard_normal((2,) + g.shape))
    y = op64.apply(x)
    for i in range(2):
        torch.testing.assert_close(y[i], op64.apply(x[i]), rtol=1e-14,
                                   atol=1e-14)


@pytest.mark.parametrize("dim,cells", [(2, (3, 3)), (3, (2, 3, 2))])
def test_exact_jacobi_matches_jax(dim, cells):
    gj = j_curved.DGCurvedGrid(cells, _deform, 2, "hermite")
    gt = DGCurvedGrid(cells, _deform, 2, "hermite")
    jj = JJacobi(j_curved.DGLaplaceCurved(gj, jnp.float64))
    op = DGLaplaceCurved(gt, F64, CPU)
    jt = JacobiTransformed(gt, F64, CPU, op=op)
    assert rel_err(jt.inv_diag.numpy(), np.asarray(jj.inv_diag)) < 1e-11


# -------------------------------------------------------- convergence
def test_mms_convergence_2d():
    errs = []
    for C in (4, 8, 16):
        g = DGCurvedGrid((C, C), _deform, 3)
        op = DGLaplaceCurved(g, F64, CPU)
        rhs = op.compute_rhs(t64(2 * np.pi**2 * _exact(g.quad_phys)))
        x = solve(op, rhs, 2000)
        errs.append(float(op.l2_error(x, t64(_exact(g.quad_phys)))))
    rates = [np.log2(errs[i] / errs[i + 1]) for i in range(2)]
    assert min(rates) > 3.4, (errs, rates)


def test_mms_convergence_3d():
    errs = []
    for C in (2, 4, 8):
        g = DGCurvedGrid((C,) * 3, _deform, 3)
        op = DGLaplaceCurved(g, F64, CPU)
        rhs = op.compute_rhs(t64(3 * np.pi**2 * _exact(g.quad_phys)))
        x = solve(op, rhs, 2000)
        errs.append(float(op.l2_error(x, t64(_exact(g.quad_phys)))))
    rates = [np.log2(errs[i] / errs[i + 1]) for i in range(2)]
    assert min(rates) > 3.3, (errs, rates)


def _shifted(p):
    return 0.15 + 0.7 * _deform(p)


def _weak_bc(g):
    return {(d, s): _exact(g.boundary_quad_coords(d, s))
            for d in range(g.dim) for s in (0, 1)}


def test_weak_dirichlet_rhs_matches_jax():
    """compute_rhs with weak Nitsche data is the JAX one's (1e-12)."""
    gt = DGCurvedGrid((3, 4), _shifted, 3)
    gj = j_curved.DGCurvedGrid((3, 4), _shifted, 3)
    f = 2 * np.pi**2 * _exact(gt.quad_phys)
    got = DGLaplaceCurved(gt, F64, CPU).compute_rhs(t64(f), _weak_bc(gt))
    want = j_curved.DGLaplaceCurved(gj, jnp.float64).compute_rhs(
        jnp.asarray(f), {k: jnp.asarray(v) for k, v in _weak_bc(gj).items()})
    assert rel_err(got.numpy(), want) < 1e-12


def test_weak_dirichlet_inhomogeneous():
    """A chart on which u = prod sin(pi x_d) is nonzero on the boundary:
    weak Nitsche data at the face quadrature points keep p+1
    convergence."""
    errs = []
    for C in (4, 8, 16):
        g = DGCurvedGrid((C, C), _shifted, 3)
        op = DGLaplaceCurved(g, F64, CPU)
        rhs = op.compute_rhs(t64(2 * np.pi**2 * _exact(g.quad_phys)),
                             g_bc=_weak_bc(g))
        x = solve(op, rhs, 2000)
        errs.append(float(op.l2_error(x, t64(_exact(g.quad_phys)))))
    rates = [np.log2(errs[i] / errs[i + 1]) for i in range(2)]
    assert min(rates) > 3.4, (errs, rates)


def _vc_coeff(xs):
    return 1.0 + 0.5 * _exact(xs)


def _vc_rhs(xs):
    # f = -(grad c . grad u + c lap u), c = 1 + u/2 => grad c = grad u/2
    gd = 0.0
    for d in range(len(xs)):
        du = np.pi
        for e, x in enumerate(xs):
            du = du * (np.cos(np.pi * x) if e == d else np.sin(np.pi * x))
        gd = gd + 0.5 * du * du
    u = _exact(xs)
    return -(gd + (1.0 + 0.5 * u) * (-len(xs) * np.pi**2 * u))


def test_curved_varcoeff_composition():
    """coeff_fn folded into the per-point tables: MMS for -div(c grad u) =
    f on the curved chart, c = 1 + u / 2 (tables to 1e-13 of JAX's)."""
    errs = []
    for C in (4, 8, 16):
        g = DGCurvedGrid((C, C), _deform, 3, coeff_fn=_vc_coeff)
        if C == 4:
            gj = j_curved.DGCurvedGrid((C, C), _deform, 3,
                                       coeff_fn=_vc_coeff)
            assert rel_err(g.Gw[0][1], gj.Gw[0][1]) < 1e-13
            assert rel_err(g.face_sigma[0], gj.face_sigma[0]) < 1e-13
        op = DGLaplaceCurved(g, F64, CPU)
        rhs = op.compute_rhs(t64(_vc_rhs(g.quad_phys)))
        x = solve(op, rhs, 3000)
        errs.append(float(op.l2_error(x, t64(_exact(g.quad_phys)))))
    rates = [np.log2(errs[i] / errs[i + 1]) for i in range(2)]
    assert min(rates) > 3.4, (errs, rates)


# ---------------------------------------------------- h-multigrid solver
def _rhs_fn(xs):
    return len(xs) * np.pi**2 * _exact(xs)


def _square(n_levels):
    return BrickMesh(coarse_cells=(4, 4), origin=(0.0, 0.0),
                     lengths=(1.0, 1.0), n_levels=n_levels)


@pytest.mark.parametrize("kind", ["gauss", "hermite"])
def test_curved_hmg_solver(kind):
    """Pure-DG h-multigrid on the curved hierarchy: near mesh-independent
    frac its, rate < 0.35, the L2 error bar of the JAX test."""
    its = []
    for n_levels in (2, 3):
        s = MultigridSolverDGPlain(_square(n_levels), 3, _exact, _rhs_fn,
                                   kind=kind, mapping=_deform, device="cpu")
        assert all(isinstance(g, DGCurvedGrid) for g in s.grids)
        sol, frac_its, rate = s.solve_cg(tolerance=1e-3)
        its.append(frac_its)
        assert rate < 0.35, rate
        err = s.l2_error(sol, s.exact_quad)
        assert err < 2e-4 / (4 ** (n_levels - 2)), err
    assert abs(its[0] - its[1]) < 2.0, its


@pytest.fixture(scope="module")
def jax_and_port_curved():
    """The curved solver (2 levels, hermite p = 3, with a coefficient) in
    both packages, the JAX set-up carried into the port."""
    from multigrid_tpu.mesh.brick import BrickMesh as JBrick
    from multigrid_tpu.solvers.multigrid_dg import (
        MultigridSolverDGPlain as JPlain)

    kw = dict(kind="hermite", mapping=_deform, coeff_fn=_vc_coeff)
    sj = JPlain(JBrick(coarse_cells=(4, 4), origin=(0.0, 0.0),
                       lengths=(1.0, 1.0), n_levels=2), 3, _exact, _vc_rhs,
                **kw)
    state = {
        "rhs": np.asarray(sj.rhs),
        "chebyshev": [(s.theta, s.delta, s.degree, s.max_eig, s.min_eig)
                      for s in sj.smoothers],
        "inv_diag": [np.asarray(JJacobi(op).inv_diag) for op in sj.ops],
    }
    st = MultigridSolverDGPlain(_square(2), 3, _exact, _vc_rhs, device="cpu",
                                **kw)
    fresh = (st.rhs.clone(), [j.inv_diag.clone() for j in st.jacobis])
    convert.load_state(st, state)
    return sj, st, state, fresh


def test_curved_set_up_matches_jax(jax_and_port_curved):
    """The port's own right-hand side and inverse diagonals are the JAX
    ones (1e-12, 1e-6 in f32)."""
    _, _, state, (rhs, inv) = jax_and_port_curved
    assert rel_err(rhs.numpy(), state["rhs"]) < 1e-12
    for got, want in zip(inv, state["inv_diag"]):
        assert rel_err(got.numpy(), want) < 1e-6


def test_curved_state_transfer_solve_matches_jax(jax_and_port_curved):
    """With the state carried across (load_state's DG-plain branch, as it
    is): the same iterations, the L2 error to 1e-8, frac its to 1e-4."""
    sj, st, state, _ = jax_and_port_curved
    for l, jac in enumerate(st.jacobis):
        np.testing.assert_array_equal(
            jac.inv_diag.numpy(), np.asarray(state["inv_diag"][l], np.float32))
    x_j, its_j, rate_j = sj.solve_cg(tolerance=1e-10)
    x_t, its_t, rate_t = st.solve_cg(tolerance=1e-10)
    n_j = int(np.ceil(its_j))
    assert int(np.ceil(its_t)) == n_j
    assert its_t == pytest.approx(float(its_j), rel=1e-4)
    assert st.l2_error(x_t, st.exact_quad) == pytest.approx(
        sj.l2_error(x_j, sj.exact_quad), rel=1e-8)


# -------------------------------------------------------- the experiment
# kind -> (frac its, rate, L2) at 512 and 4096 DG dofs: the JAX driver's
# poisson_dg_plain 3 0 5000 3 1e-10 --deform --dim 3 on the CPU
DEFORM_ANCHORS = {
    "hermite": ((11.3659, 0.13188, 1.5964e-1), (11.1031, 0.12570, 1.0396e-1)),
    "gll": ((10.8137, None, 1.5964e-1), (10.8945, None, 1.0396e-1)),
    "gauss": ((10.4466, None, 1.5964e-1), (11.1137, None, 1.0396e-1)),
}


def test_deform_driver_reproduces_the_jax_anchors():
    tables = poisson_dg_plain.main(["3", "0", "5000", "3", "1e-10",
                                    "--deform", "--dim", "3", "--device",
                                    "cpu"])
    assert list(tables) == list(DEFORM_ANCHORS)
    for kind, rows in tables.items():
        assert [r["dofs"] for r in rows] == [512, 4096]
        for row, (its, rate, l2) in zip(rows, DEFORM_ANCHORS[kind]):
            assert row["cg_its"] == pytest.approx(its, abs=1e-4)
            assert int(np.ceil(row["cg_its"])) == int(np.ceil(its))
            if rate is not None:
                assert row["cg_reduction"] == pytest.approx(rate, rel=5e-3)
            assert row["cg_L2error"] == pytest.approx(l2, rel=5e-3)
