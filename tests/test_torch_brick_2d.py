"""The port's 2-D brick path against the JAX package, on the CPU.

The brick kernels are 3-D, so a 2-D level of ``MultigridSolver`` runs the
plain ``LaplaceOperator`` (a ``solvers.fused.PlainLevel``) on every device,
as the JAX package runs XLA there.

* ``MultigridSolver`` in 2-D at the poisson_cube sizes 2, 4 and 8 (16^2,
  32^2 and 64^2 cells, FE_Q(4)) against the JAX solver on the same mesh:
  cg_its exactly, the V-cycle and CG reductions and the FMG L2 error to
  2% (the bars of tests/test_multigrid_solver.py).
* The host helpers in 2-D (``compute_rhs_host``,
  ``compute_bc_slab_correction_host``, ``l2_error_host``) against the JAX
  ``LaplaceOperator``'s ``compute_rhs`` and its interpolation to the
  quadrature points (the JAX host helpers are 3-D only) to 1e-12
  relative.
* ``poisson_dg --dim 2`` (2-D SIP-DG over the 2-D brick) at two small
  sizes against the JAX ``MultigridSolverDG``: fractional iterations to
  2%, rate to 2%, L2 error to 1e-6 relative.
* ``poisson_cube --dim 2 --output``: the driver's rows and their ``.vtr``
  files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments.poisson_cube import build_solver as j_build
from experiments.poisson_cube import exact_fn, rhs_fn
from multigrid_tpu.mesh.brick import DofGrid as JDofGrid
from multigrid_tpu.mesh.brick import poisson_cube_mesh as j_pcm
from multigrid_tpu.ops.laplace import LaplaceOperator as JLaplace
from multigrid_tpu.solvers.multigrid_dg import MultigridSolverDG as JSolverDG
from multigrid_tpu_torch.experiments import poisson_cube, poisson_dg
from multigrid_tpu_torch.mesh.brick import DofGrid, poisson_cube_mesh
from multigrid_tpu_torch.ops import laplace as tl
from multigrid_tpu_torch.solvers.fused import PlainLevel
from multigrid_tpu_torch.solvers.multigrid import (_bc_faces_host,
                                                   _dense_bc_host)

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("size", [2, 4, 8])
def test_2d_solver_matches_jax(size):
    sj = j_build(j_pcm(size, 2), 4, n_cycles=2)
    st = poisson_cube.build_solver(poisson_cube_mesh(size, 2), 4, n_cycles=2,
                                   device="cpu")
    assert all(isinstance(op, PlainLevel) for op in st.sp_ops)
    assert st.dp_ops is st.ops_dp
    u_j, _, red_j = sj.solve_analyze()
    u_t, _, red_t = st.solve_analyze()
    assert red_t == pytest.approx(red_j, rel=0.02)
    assert st.l2_error(st.maxlevel, st.solve()) == pytest.approx(
        sj.l2_error(sj.maxlevel, sj.solve()), rel=0.02)
    _, its_j, cgred_j = sj.solve_cg()
    _, its_t, cgred_t = st.solve_cg()
    assert its_t == its_j
    assert cgred_t == pytest.approx(cgred_j, rel=0.02)


@pytest.mark.parametrize("size", [1, 2])
def test_2d_host_helpers_match_jax(size):
    """The rhs ``M f - A u_bc`` (with boundary data shifted off zero, so the
    correction has work to do), the boundary correction alone and the L2
    error, against the JAX operator in f64."""
    mj, mt = j_pcm(size, 2), poisson_cube_mesh(size, 2)
    gj, gt = JDofGrid(mj, mj.max_level, 3), DofGrid(mt, mt.max_level, 3)
    shifted = lambda c: exact_fn(c) + 0.25 + 0.1 * c[0]
    faces = _bc_faces_host(gt, shifted)
    u_bc = _dense_bc_host(gt, faces)
    op = JLaplace(gj, jnp.float64)
    f_quad = jnp.asarray(np.asarray(rhs_fn(gj.quad_coords_interleaved())))
    want = np.asarray(op.compute_rhs(f_quad, jnp.asarray(u_bc)))
    assert rel(tl.compute_rhs_host(gt, rhs_fn, u_bc), want) < 1e-12

    want_bc = np.asarray(op.compute_rhs(jnp.zeros_like(f_quad),
                                        jnp.asarray(u_bc)))
    got_bc = np.zeros(gt.shape)
    for sl, a in zip(*tl.compute_bc_slab_correction_host(gt, faces)):
        got_bc[sl] += a
    got_bc = np.where(np.asarray(gt.boundary_mask()), 0.0, got_bc)
    assert rel(got_bc, want_bc) < 1e-12

    # the L2 error from the JAX operator's interpolation to the quadrature
    # points, summed in f64 here: JAX's own l2_error sums through its TPU
    # f64 emulation (ops/df64.sum_f64), good to about 1e-8
    u = np.random.default_rng(size).standard_normal(gt.shape)
    uq = np.asarray(op.interpolate_to_quad(jnp.asarray(u)))
    exact_q = np.broadcast_to(exact_fn(gj.quad_coords_interleaved()), uq.shape)
    w = np.broadcast_to(np.asarray(op.w3d) * gj.jxw_scalar, uq.shape)
    want_l2 = np.sqrt(np.sum((uq - exact_q) ** 2 * w) / np.sum(w))
    assert tl.l2_error_host(gt, u, exact_fn) == pytest.approx(want_l2,
                                                              rel=1e-12)


@pytest.mark.parametrize("size", [1, 2])
def test_poisson_dg_2d_rows_match_jax(size):
    rows = poisson_dg.main(["4", "0", str(25 * 64 * size ** 2 + 1), "1", "3",
                            "3", "square", "1e-9", "--dim", "2", "--device",
                            "cpu"])
    row = rows[-1]
    assert row["dofs"] == (8 * size) ** 2 * 25
    sj = JSolverDG(j_pcm(size, 2), 4, exact_fn, rhs_fn, kind="hermite",
                   n_pre=3, n_post=3)
    u, its_j, rate_j = sj.solve_cg(tolerance=1e-9)
    assert row["cg_its"] == pytest.approx(float(its_j), rel=0.02)
    assert row["cg_reduction"] == pytest.approx(float(rate_j), rel=0.02)
    assert row["cg_L2error"] == pytest.approx(
        float(sj.l2_error(u, sj.exact_quad)), rel=1e-6)


def test_poisson_cube_2d_driver_writes_vtr_files(tmp_path):
    """``--dim 2 --output``: the 4225-, 9409- and 16641-dof rows (8 its,
    as the JAX 2-D rows), one ``.vtr`` a row on the rectilinear grid of the
    row's nodes, its ``solution`` field the analytic solution to the FMG
    row's accuracy and its ``error`` field that difference (the writer
    itself is held byte for byte to JAX's in tests/test_torch_utils.py)."""
    rows = poisson_cube.main(["4", "4000", "20000", "--dim", "2", "--device",
                              "cpu", "--output", str(tmp_path)])
    assert [r["dofs"] for r in rows] == [4225, 9409, 16641]
    assert all(r["cg_its"] == 8 for r in rows)
    for size, row in zip((2, 3, 4), rows):
        mesh = poisson_cube_mesh(size, 2)
        g = DofGrid(mesh, mesh.max_level, 4)
        text = (tmp_path / f"solution_{row['dofs']}.vtr").read_text()
        n = g.shape[0] - 1
        assert f'WholeExtent="0 {n} 0 {n} 0 0"' in text
        sol = _read_point_data(text, "solution", g.shape)
        err = _read_point_data(text, "error", g.shape)
        exact = np.broadcast_to(exact_fn(g.node_coords()), g.shape)
        np.testing.assert_allclose(sol - exact, err, rtol=0, atol=1e-15)
        assert 0 < np.abs(err).max() < 20 * row["fmg_L2error"]


def _read_point_data(text: str, name: str, shape) -> np.ndarray:
    """A field of an ASCII or binary .vtr back as an array."""
    import base64
    import re

    m = re.search(rf'Name="{name}" format="(\w+)">([^<]*)<', text)
    if m[1] == "ascii":
        a = np.array(m[2].split(), np.float64)
    else:
        raw = base64.b64decode(m[2])
        a = np.frombuffer(raw[8:], "<f8")
    return a.reshape(shape)
