"""The port's general-geometry operators against the JAX package's.

The same inputs, made from a seed with numpy, go through the JAX
``GeneralLaplace`` / ``GeneralTransfer`` / fourth-kind ``Chebyshev`` and
their counterparts in the port, at degree 2-4, in 2-D (the disc of
minimal_surface) and 3-D (the shell with poisson_shell's coefficient):

* ``GeneralLaplace``: ``vmult``, ``vmult_residual``, ``compute_rhs``,
  ``inverse_diagonal`` and ``l2_error`` to 1e-12 relative in f64, 1e-5 of
  max|y| in f32;
* ``GeneralTransfer``: ``prolongate`` and ``restrict`` (constrained and
  not) and ``restrict_solution``, to 1e-12 in f64 and 1e-5 in f32;
* the fourth-kind ``vmult`` and ``step`` on a shell level and on a brick
  level (the ``BrickLaplace`` plain path) to 1e-12 in f64;
* ``NodeScatter`` against ``np.add.at`` and ``cheb_step`` against its
  formula.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu_torch.experiments.poisson_shell import coef_fn
from multigrid_tpu_torch.mesh import shapes as t_shapes
from multigrid_tpu_torch.mesh.mapped import GeneralGrid
from multigrid_tpu_torch.ops.laplace_general import GeneralLaplace, NodeScatter
from multigrid_tpu_torch.ops.transfer_general import GeneralTransfer

# (function of mesh/shapes.py, kwargs, degree): the finest level and the
# one below
CASES = {
    "shell_p2": ("hyper_shell", dict(r_in=0.5, r_out=1.0, n_levels=2), 2),
    "shell_p3": ("hyper_shell_12", dict(r_in=0.5, r_out=1.0, n_levels=2), 3),
    "shell_p4": ("hyper_shell", dict(r_in=0.5, r_out=1.0, n_levels=2), 4),
    "ball_p2": ("hyper_ball_2d", dict(radius=1.0, n_levels=3), 2),
    "ball_p4": ("hyper_ball_2d", dict(radius=1.0, n_levels=2), 4),
}
DTYPES = {"f64": (torch.float64, jnp.float64, 1e-12),
          "f32": (torch.float32, jnp.float32, 1e-5)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(CASES))
def levels(request):
    from multigrid_tpu.mesh import mapped as j_mapped
    from multigrid_tpu.mesh import shapes as j_shapes

    make, kw, degree = CASES[request.param]
    mj = getattr(j_shapes, make)(**kw)
    mt = getattr(t_shapes, make)(**kw)
    L = mj.max_level
    return ([j_mapped.GeneralGrid(mj, l, degree) for l in (L - 1, L)],
            [GeneralGrid(mt, l, degree) for l in (L - 1, L)])


def close(got, want, tol):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def rand(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


@pytest.mark.parametrize("prec", sorted(DTYPES))
def test_general_laplace_matches_jax(levels, prec):
    from multigrid_tpu.ops.laplace_general import GeneralLaplace as JLaplace

    tdt, jdt, tol = DTYPES[prec]
    gj, gt = levels[0][1], levels[1][1]
    coef = gt.merged_coefficient(coef_fn)
    oj = JLaplace(gj, jdt, coef=coef)
    ot = GeneralLaplace(gt, tdt, coef=coef, device="cpu")
    x, b = rand(gt.n_dofs, 1), rand(gt.n_dofs, 2)
    xj, bj = jnp.asarray(x, jdt), jnp.asarray(b, jdt)
    xt, bt = torch.tensor(x, dtype=tdt), torch.tensor(b, dtype=tdt)
    close(ot.vmult(xt), oj.vmult(xj), tol)
    close(ot.vmult_residual(bt, xt), oj.vmult_residual(bj, xj), tol)
    close(ot.inverse_diagonal(), oj.inverse_diagonal(), tol)
    shape = ot.cell_shape
    fq = np.random.default_rng(3).standard_normal(shape)
    ubc = np.where(gt.boundary, x, 0.0)
    close(ot.compute_rhs(torch.tensor(fq, dtype=tdt), torch.tensor(ubc, dtype=tdt)),
          oj.compute_rhs(jnp.asarray(fq, jdt), jnp.asarray(ubc, jdt)), tol)
    eq = np.random.default_rng(4).standard_normal(shape)
    close(ot.l2_error(xt, torch.tensor(eq, dtype=tdt)),
          oj.l2_error(xj, jnp.asarray(eq, jdt)), tol)
    # the C= override (Newton's coefficient) goes through unchanged
    C2 = 0.5 * np.asarray(ot.C)
    close(ot.vmult(xt, C=torch.tensor(C2, dtype=tdt)),
          oj.vmult(xj, C=jnp.asarray(C2, jdt)), tol)


@pytest.mark.parametrize("constrained", [True, False])
@pytest.mark.parametrize("prec", sorted(DTYPES))
def test_general_transfer_matches_jax(levels, prec, constrained):
    from multigrid_tpu.ops.transfer_general import GeneralTransfer as JTransfer

    tdt, jdt, tol = DTYPES[prec]
    (cj, fj), (ct, ft) = levels
    trj = JTransfer(fj, cj, jdt, constrained)
    trt = GeneralTransfer(ft, ct, tdt, constrained, "cpu")
    xf, xc = rand(ft.n_dofs, 5), rand(ct.n_dofs, 6)
    close(trt.prolongate(torch.tensor(xc, dtype=tdt)),
          trj.prolongate(jnp.asarray(xc, jdt)), tol)
    close(trt.restrict(torch.tensor(xf, dtype=tdt)),
          trj.restrict(jnp.asarray(xf, jdt)), tol)
    close(trt.restrict_solution(torch.tensor(xf, dtype=tdt)),
          trj.restrict_solution(jnp.asarray(xf, jdt)), tol)


def test_restrict_solution_inverts_prolongate(levels):
    """Evaluating the prolongated coarse function at the coarse nodes gives
    the coarse function back."""
    (_, _), (ct, ft) = levels
    tr = GeneralTransfer(ft, ct, torch.float64, False, "cpu")
    xc = torch.tensor(rand(ct.n_dofs, 7))
    close(tr.restrict_solution(tr.prolongate(xc)), xc, 1e-12)


def _fourth_pair(op_t, op_j, precond_j, max_eig, degree):
    from multigrid_tpu.solvers.chebyshev import FOURTH_KIND as J4
    from multigrid_tpu.solvers.chebyshev import Chebyshev as JCheb
    from multigrid_tpu_torch.solvers.chebyshev import FOURTH_KIND, Chebyshev

    smj = JCheb(vmult_op=op_j.vmult, precond=precond_j, theta=1.0, delta=0.5,
                degree=degree, max_eig=max_eig, min_eig=0.1, kind=J4)
    smt = Chebyshev(op_t, 1.0, 0.5, degree, max_eig, 0.1, FOURTH_KIND)
    return smt, smj


@pytest.mark.parametrize("degree", [1, 3, 5])
def test_fourth_kind_on_a_shell_level(levels, degree):
    from multigrid_tpu.ops.laplace_general import GeneralLaplace as JLaplace

    gj, gt = levels[0][1], levels[1][1]
    coef = gt.merged_coefficient(coef_fn)
    oj = JLaplace(gj, jnp.float64, coef=coef)
    ot = GeneralLaplace(gt, torch.float64, coef=coef, device="cpu")
    ot.inv_diag = ot.inverse_diagonal()
    dj = oj.inverse_diagonal()
    smt, smj = _fourth_pair(ot, oj, lambda r: dj * r, 2.3, degree)
    b, x0 = rand(gt.n_dofs, 8), rand(gt.n_dofs, 9)
    close(smt.vmult(torch.tensor(b)), smj.vmult(jnp.asarray(b)), 1e-12)
    x0t = torch.tensor(x0)
    close(smt.step(x0t, torch.tensor(b)),
          smj.step(jnp.asarray(x0), jnp.asarray(b)), 1e-12)
    np.testing.assert_array_equal(x0t.numpy(), x0)   # step leaves x0 alone


@pytest.mark.parametrize("degree", [2, 4])
def test_fourth_kind_on_a_brick_level(degree):
    from multigrid_tpu.mesh.brick import DofGrid as JGrid
    from multigrid_tpu.mesh.brick import poisson_cube_mesh as j_cube
    from multigrid_tpu.ops.laplace import LaplaceOperator as JLap
    from multigrid_tpu_torch.mesh.brick import DofGrid, poisson_cube_mesh
    from multigrid_tpu_torch.ops.laplace import LaplaceOperator
    from multigrid_tpu_torch.ops.laplace_kernel import BrickLaplace

    gt, gj = DofGrid(poisson_cube_mesh(2), 1, 3), JGrid(j_cube(2), 1, 3)
    ot = BrickLaplace(gt, torch.float64, "cpu")
    oj = JLap(gj, jnp.float64)
    dj = oj.inverse_diagonal()
    np.testing.assert_allclose(
        LaplaceOperator(gt, torch.float64, device="cpu").inverse_diagonal().numpy(),
        np.asarray(dj), rtol=1e-13)
    smt, smj = _fourth_pair(ot, oj, lambda r: dj * r, 1.7, degree)
    b, x0 = rand(gt.n_dofs, 10).reshape(gt.shape), rand(gt.n_dofs, 11).reshape(gt.shape)
    close(smt.vmult(torch.tensor(b)), smj.vmult(jnp.asarray(b)), 1e-12)
    close(smt.step(torch.tensor(x0), torch.tensor(b)),
          smj.step(jnp.asarray(x0), jnp.asarray(b)), 1e-12)


def test_node_scatter_matches_add_at():
    rng = np.random.default_rng(12)
    table = rng.integers(0, 50, size=400)
    table[:50] = np.arange(50)                 # every node gets an entry
    y = rng.standard_normal(400)
    want = np.zeros(50)
    np.add.at(want, table, y)
    got = NodeScatter(table, 50, torch.device("cpu"))(torch.tensor(y))
    close(got, want, 1e-14)
    with pytest.raises(ValueError, match="every node"):
        NodeScatter(table, 51, torch.device("cpu"))


def test_cheb_step_formula(levels):
    gt = levels[1][1]
    op = GeneralLaplace(gt, torch.float64, device="cpu")
    op.inv_diag = op.inverse_diagonal()
    b, x, xo = (torch.tensor(rand(gt.n_dofs, s)) for s in (13, 14, 15))
    f1, f2 = 0.3, 0.7
    want = x + f1 * (x - xo) + f2 * op.inv_diag * (b - op.vmult(x))
    close(op.cheb_step(b, x, xo, f1, f2), want, 1e-14)
    close(op.cheb_step(b, None, xo, f1, f2),
          -f1 * xo + f2 * op.inv_diag * b, 1e-14)
    out = torch.empty_like(b)
    assert op.cheb_step(b, x, None, 0.0, f2, out=out) is out
    close(out, x + f2 * op.inv_diag * (b - op.vmult(x)), 1e-14)
