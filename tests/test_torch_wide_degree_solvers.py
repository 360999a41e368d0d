"""The solvers at p = 10, the first degree the brick and DG kernels took
on beyond p = 9, on the CPU against the JAX package.

3-D ``MultigridSolverDGPlain`` (pure-DG h-multigrid, every level a
``DGOperator``) and ``MultigridSolverDG`` (DG over the FE_Q(10)
hierarchy; the JAX solver with its f64 ``DGLaplace`` as the outer
operator, ``dp_impl="native"``) on 2^3 cells (10,648 DG dofs), hermite,
n_pre = n_post = 3, rtol 1e-9, as ``poisson_dg_plain`` / ``poisson_dg``
run them, and poisson_cube's ``MultigridSolver`` (FE_Q(10), 2^3 cells,
9,261 dofs) with poisson_cube's smoothing, its V-cycle-preconditioned CG:
the port on the CPU against the JAX solver on the CPU from the same
problem.  The iteration counts are equal, the fractional counts agree
to 1e-3, the rates to 2e-3 (``RATE_TOL``) and the L2 errors to 1e-6
(each package's transformed-Jacobi probe of a grid runs once in the
module, ``_probe_once``); each solver's levels are the
kernels' route (``DGOperator``, ``BrickLaplace``), which on the card run
``dg_apply``, ``dg_cheb`` and ``brick_kron`` at p = 10.  Above p = 10 the
solvers at this size take minutes on the CPU (the JAX DG-plain solve
alone about two at p = 16): the card runs them (chip_smoke.py, held to
the JAX rows pinned there).
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
from multigrid_tpu.solvers.multigrid import MultigridSolver as JSolver
from multigrid_tpu_torch.experiments.poisson_cube import exact_fn, rhs_fn
from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh
from multigrid_tpu_torch.ops.dg_kernel import DGOperator
from multigrid_tpu_torch.solvers import multigrid_dg
from multigrid_tpu_torch.solvers.multigrid import MultigridSolver

jax.config.update("jax_enable_x64", True)

DEGREE, SIZE, RTOL = 10, 2, 1e-9
# the rates' bar: the f32 smoothers round apart from JAX's (sums in another
# order), and the DG-over-FE_Q rate read 1.07e-3 from JAX's on one torch
# thread and 5.3e-4 on two (the port's own rate moves by 5.4e-4 with the
# thread count); the frac its and L2 stay at 1e-3 and 1e-6
RATE_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _probe_once():
    """Each package's transformed-Jacobi probe (``_transformed_diagonals``
    of its ``ops/dg_precond.py``: n^3 applies of the DG operator on the
    probe mesh, most of a solver's set-up at p = 10) runs once for each
    probe grid in this module: the DG and DG-plain solvers share their
    finest level's, a pure function of the grid."""
    from multigrid_tpu.ops import dg_precond as j_precond
    from multigrid_tpu_torch.ops import dg_precond as t_precond

    saved = []
    for mod, key in ((t_precond, lambda op: (op.grid, op.dtype)),
                     (j_precond, lambda op: (op.grid, str(op.dtype)))):
        fn, cache = mod._transformed_diagonals, {}

        def once(op, T3, fn=fn, cache=cache, key=key):
            k = key(op)
            if k not in cache:
                cache[k] = fn(op, T3)
            return cache[k]
        saved.append((mod, fn))
        mod._transformed_diagonals = once
    yield
    for mod, fn in saved:
        mod._transformed_diagonals = fn


@pytest.mark.parametrize("plain", [False, True])
def test_dg_solver_at_p10_matches_jax(plain):
    kw = dict(kind="hermite", n_pre=3, n_post=3)
    if plain:
        sj = j_mg.MultigridSolverDGPlain(j_mesh(SIZE), DEGREE, j_exact, j_rhs,
                                         **kw)
        st = multigrid_dg.MultigridSolverDGPlain(
            poisson_cube_mesh(SIZE), DEGREE, exact_fn, rhs_fn, device="cpu",
            **kw)
        assert all(isinstance(op, DGOperator) for op in st.ops + [st.op_dp])
    else:
        sj = j_mg.MultigridSolverDG(j_mesh(SIZE), DEGREE, j_exact, j_rhs,
                                    dp_impl="native", **kw)
        st = multigrid_dg.MultigridSolverDG(
            poisson_cube_mesh(SIZE), DEGREE, exact_fn, rhs_fn, device="cpu",
            **kw)
        assert all(isinstance(op, DGOperator) for op in (st.op, st.op_dp))
    u_j, its_j, rate_j = sj.solve_cg(tolerance=RTOL)
    u_t, its_t, rate_t = st.solve_cg(tolerance=RTOL)
    assert u_t.shape == np.shape(u_j) == (SIZE,) * 3 + (DEGREE + 1,) * 3
    assert math.ceil(its_t) == math.ceil(float(its_j))
    assert its_t == pytest.approx(float(its_j), rel=1e-3)
    assert rate_t == pytest.approx(float(rate_j), rel=RATE_TOL)
    err_j = float(sj.l2_error(np.asarray(u_j), sj.exact_quad))
    assert st.l2_error(u_t, st.exact_quad) == pytest.approx(err_j, rel=1e-6)


def test_cube_solver_at_p10_matches_jax():
    from multigrid_tpu_torch.ops.laplace_kernel import BrickLaplace

    kw = dict(n_pre=2, n_post=2, n_cycles=2)
    sj = JSolver(j_mesh(SIZE), DEGREE, j_exact, j_rhs, **kw)
    st = MultigridSolver(poisson_cube_mesh(SIZE), DEGREE, exact_fn, rhs_fn,
                         device="cpu", **kw)
    u_j, its_j, red_j = sj.solve_cg()
    u_t, its_t, red_t = st.solve_cg()
    assert its_t == its_j
    assert red_t == pytest.approx(float(red_j), rel=1e-3)
    err_j = float(sj.l2_error(sj.maxlevel, u_j))
    assert st.l2_error(st.maxlevel, u_t) == pytest.approx(err_j, rel=1e-6)
    assert all(isinstance(op, BrickLaplace) for op in st.sp_ops + st.dp_ops)
