"""solver_dg's fused CG row of the port against the JAX package, on the CPU.

* The fused iteration (``ops/dg_kernel.dg_cg`` and ``dg_jacobi_cg``: here
  their plain versions, ``solvers/fused.vmult_with_cg_update`` and
  ``JacobiTransformed.vmult``, reached through the wrappers on a CPU
  ``DGOperator`` and composed directly over the plain ``DGLaplace``)
  against the same loop composed from the JAX package's
  ``DGLaplace.apply``, ``JacobiTransformed.vmult`` and
  ``vmult_with_cg_update``, on solver_dg's grid (``bench_grid``, 3-4
  steps, p = 2, 3, gauss and hermite, one seeded b): after 10 iterations
  x agrees to 1e-10 of max|x| (f64; the sums are taken in another order).
* The fused row against the port's unfused row (``cg_fixed``) to 1e-12 of
  max|x|: the same CG in exact arithmetic.
* The device scalars after the first pass: beta = 0, rz = r . P^-1 r.
* solver_dg's three rows on the CPU, each cell-based solution against
  the face-based one at ``VERIFY_TOL``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.ops.dg import DGGrid as JGrid
from multigrid_tpu.ops.dg import DGLaplace as JLaplace
from multigrid_tpu.ops.dg_precond import JacobiTransformed as JJacobi
from multigrid_tpu.solvers.fused import vmult_with_cg_update as j_cg_update
from multigrid_tpu_torch.experiments import solver_dg
from multigrid_tpu_torch.experiments.matvec_dg import bench_grid
from multigrid_tpu_torch.ops import dg_kernel as dk
from multigrid_tpu_torch.ops.dg import DGLaplace
from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed

CASES = [(2, 4, "gauss"), (2, 4, "hermite"), (3, 3, "gauss"),
         (3, 3, "hermite")]
N_IT = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _b(grid):
    return np.random.default_rng(7).standard_normal(grid.shape)


def jax_fused(grid, b: np.ndarray, n_iterations: int) -> np.ndarray:
    """The JAX fused loop: the first ``vmult_with_cg_update`` (alpha = 0)
    takes p = z, each later one folds the previous x update in."""
    jg = JGrid(cells=grid.cells, jacobian=grid.jacobian, degree=grid.degree,
               kind=grid.kind)
    op = JLaplace(jg, jnp.float64)
    jac = JJacobi(op, jnp.float64)
    x = jnp.zeros(grid.shape)
    r = jnp.asarray(b)
    z = jac.vmult(r)
    rz = jnp.vdot(r, z)
    p = jnp.zeros_like(r)
    alpha = beta = 0.0
    for _ in range(n_iterations):
        x, p, q, sums = j_cg_update(op.apply, alpha, beta, r, z, p, x)
        alpha = rz / sums[0]
        r = r - alpha * q
        z = jac.vmult(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / rz
        rz = rz_new
    return np.asarray(x + alpha * p)


@pytest.fixture(scope="module")
def jax_solutions():
    out = {}
    for degree, steps, kind in CASES:
        grid = bench_grid(degree, kind, steps, shear=False)
        out[degree, kind] = jax_fused(grid, _b(grid), N_IT)
    return out


def _passes(grid, route: str):
    """The fused loop's passes on the CPU: through the kernels' wrappers
    on a ``DGOperator`` (their plain versions run), or composed over the
    plain ``DGLaplace``."""
    f64 = torch.float64
    jac = JacobiTransformed(grid, f64, "cpu")
    if route == "wrappers":
        op = dk.DGOperator(grid, f64, "cpu")
        op.install_jacobi(jac)
        return solver_dg.fused_passes(op, jac, grid, kernel=True)
    return solver_dg.fused_passes(DGLaplace(grid, f64, "cpu"), jac, grid,
                                  kernel=False)


@pytest.mark.parametrize("route", ["wrappers", "plain"])
@pytest.mark.parametrize("degree,steps,kind", CASES)
def test_fused_iteration_matches_jax(jax_solutions, degree, steps, kind,
                                     route):
    grid = bench_grid(degree, kind, steps, shear=False)
    b = torch.as_tensor(_b(grid))
    x, rn = solver_dg.cg_fused(*_passes(grid, route), b, N_IT)
    want = jax_solutions[degree, kind]
    scale = np.abs(want).max()
    assert np.abs(x.numpy() - want).max() <= 1e-10 * scale
    assert rn.ndim == 0 and float(rn) > 0


@pytest.mark.parametrize("degree,steps,kind", CASES[:2])
def test_fused_row_matches_the_unfused_row(degree, steps, kind):
    grid = bench_grid(degree, kind, steps, shear=False)
    b = torch.as_tensor(_b(grid))
    f64 = torch.float64
    op = DGLaplace(grid, f64, "cpu")
    jac = JacobiTransformed(grid, f64, "cpu")
    x_f, rn_f = solver_dg.cg_fused(*_passes(grid, "wrappers"), b, N_IT)
    x_u, rn_u = solver_dg.cg_fixed(op.vmult, jac.vmult, b, N_IT)
    scale = float(x_u.abs().max())
    assert float((x_f - x_u).abs().max()) <= 1e-12 * scale
    assert float(rn_f) == pytest.approx(rn_u, rel=1e-9)


def test_first_pass_sets_the_scalars():
    """Before the loop: r unchanged, z = P^-1 r, beta = 0, rz = r . z,
    rr = r . r."""
    grid = bench_grid(2, "hermite", 3, shear=False)
    op = dk.DGOperator(grid, torch.float64, "cpu")
    jac = JacobiTransformed(grid, torch.float64, "cpu")
    op.install_jacobi(jac)
    r = torch.as_tensor(_b(grid))
    r0 = r.clone()
    z = torch.empty_like(r)
    scal = dk.cg_scalars("cpu")
    scal[dk.BETA] = 5.0
    dk.dg_jacobi_cg(r, None, scal, z, op, first=True)
    assert torch.equal(r, r0)
    assert torch.allclose(z, jac.vmult(r0), rtol=0, atol=0)
    assert float(scal[dk.BETA]) == 0.0
    assert float(scal[dk.RZ]) == pytest.approx(float((r0 * z).sum()),
                                               rel=1e-14)
    assert float(scal[dk.RR]) == pytest.approx(float((r0 * r0).sum()),
                                               rel=1e-14)


def test_wrappers_refuse_the_card_without_a_kernel():
    """A CUDA tensor launches the kernel or raises: on a CPU operator the
    wrappers do not run their plain versions for it (here there is no
    card, so the check fires on the device)."""
    grid = bench_grid(2, "gauss", 3, shear=False)
    op = dk.DGOperator(grid, torch.float64, "cpu")
    meta = torch.empty(grid.shape, dtype=torch.float64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        dk.dg_cg(meta, meta, meta, dk.cg_scalars("cpu"), meta, meta, op)
    op.install_jacobi(JacobiTransformed(grid, torch.float64, "cpu"))
    with pytest.raises(RuntimeError, match="no kernel"):
        dk.dg_jacobi_cg(meta, meta, dk.cg_scalars("cpu"), meta, op)


def test_driver_prints_three_rows(capsys):
    rows = solver_dg.main(["--degrees", "2", "--steps", "4", "--kinds",
                           "gauss", "--device", "cpu"])
    out = capsys.readouterr().out
    for name in ("cell-based (fused)", "face (plain)", "unfused",
                 "fusion speedup (unfused / fused cell-based)"):
        assert name in out, name
    (row,) = rows
    assert row["verify_fused"] < solver_dg.VERIFY_TOL
    assert row["verify_unfused"] < solver_dg.VERIFY_TOL
    for key in ("fused_s_per_it", "face_s_per_it", "unfused_s_per_it"):
        assert row[key] > 0
