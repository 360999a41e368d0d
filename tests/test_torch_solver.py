"""The port's main path as a whole: poisson_cube FMG and V-cycle-PCG.

* ``REFERENCE_ROWS`` (tests/test_multigrid_solver.py:25-29, the reference
  transcript): V-cycle reduction and FMG L2 error within 2%, cg_its == 8,
  CG reduction within 2% -- the bars the JAX package is held to.
* State transfer: the JAX solver's set-up carried over by
  ``multigrid_tpu_torch.convert``, after which both packages compute the
  same thing; FMG agrees to 1e-5·max|u| (f32 V-cycle roundoff in another
  summation order) and cg_its is identical.
* ``import multigrid_tpu_torch`` loads no JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multigrid_tpu_torch import convert
from multigrid_tpu_torch.experiments.poisson_cube import build_solver, main
from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh

# size -> (reduction, fmg_L2error, cg_its, cg_reduction, cg_L2error)
REFERENCE_ROWS = {
    2: (1.092e-1, 1.737e-1, 8, 5.677e-2, 1.725e-1),
    4: (1.613e-1, 1.166e-2, 8, 6.789e-2, 1.027e-2),
    8: (1.319e-1, 4.037e-4, 8, 6.689e-2, 3.822e-4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("size", sorted(REFERENCE_ROWS))
def test_reference_rows(size):
    ref_red, ref_fmg, ref_its, ref_cgred, ref_cgerr = REFERENCE_ROWS[size]
    s = build_solver(poisson_cube_mesh(size), 4, n_cycles=2, device="cpu")
    sol, report, red = s.solve_analyze()
    assert red == pytest.approx(ref_red, rel=0.02)
    assert len(report) == s.maxlevel
    assert s.l2_error(s.maxlevel, sol) == pytest.approx(ref_fmg, rel=0.02)
    assert s.l2_error(s.maxlevel, s.solve()) == pytest.approx(ref_fmg, rel=0.02)
    sol_cg, its, cgred = s.solve_cg()
    assert its == ref_its
    assert cgred == pytest.approx(ref_cgred, rel=0.02)
    assert s.l2_error(s.maxlevel, sol_cg) == pytest.approx(ref_cgerr, rel=0.1)


@pytest.fixture(scope="module")
def jax_and_port_size4():
    from experiments.poisson_cube import build_solver as j_build
    from multigrid_tpu.mesh.brick import poisson_cube_mesh as j_cube

    sj = j_build(j_cube(4), 4, n_cycles=2)
    state = {
        "rhs": [np.asarray(r) for r in sj.rhs],
        "u_bc": [[np.asarray(f) for f in faces] for faces in sj.u_bc],
        "chebyshev": [(s.theta, s.delta, s.degree, s.max_eig, s.min_eig)
                      for s in sj.smoothers],
        "element_matrix": [np.asarray(op.K) for op in sj.sp_ops],
    }
    st = build_solver(poisson_cube_mesh(4), 4, n_cycles=2, device="cpu")
    convert.load_state(st, state)
    return sj, st, state


def test_state_transfer_fmg_matches_jax(jax_and_port_size4):
    sj, st, _ = jax_and_port_size4
    u_j = np.asarray(sj.solve())
    u_t = st.solve().numpy()
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=1e-5 * np.abs(u_j).max())


def test_state_transfer_cg_matches_jax(jax_and_port_size4):
    sj, st, _ = jax_and_port_size4
    x_j, its_j, red_j = sj.solve_cg()
    x_t, its_t, red_t = st.solve_cg()
    assert its_t == its_j
    assert red_t == pytest.approx(red_j, rel=1e-3)
    x_j = np.asarray(x_j)
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=0,
                               atol=1e-9 * np.abs(x_j).max())


def test_state_roundtrip(jax_and_port_size4):
    """load_state installs every array and number unchanged and refuses an
    element matrix the kernels do not apply."""
    _, st, state = jax_and_port_size4
    for l in range(len(st.grids)):
        np.testing.assert_array_equal(st.rhs[l].numpy(), state["rhs"][l])
        for a, b in zip(st.u_bc[l], state["u_bc"][l]):
            np.testing.assert_array_equal(a.numpy(), b)
        for op in (st.dp_ops[l], st.sp_ops[l]):
            np.testing.assert_array_equal(
                op.K.numpy(), np.asarray(state["element_matrix"][l], op.K.numpy().dtype))
        sm = st.smoothers[l]
        theta, delta, degree, max_eig, min_eig = state["chebyshev"][l]
        assert (sm.theta, sm.delta, sm.max_eig, sm.min_eig) == (
            float(theta), float(delta), float(max_eig), float(min_eig))
        assert sm.degree == int(degree) and isinstance(sm.degree, int)
    bad = dict(state, element_matrix=[2 * k for k in state["element_matrix"]])
    with pytest.raises(ValueError, match="element_matrix"):
        convert.load_state(st, bad)


def test_experiment_prints_convergence_table(capsys):
    rows = main(["4", "700", "800", "--device", "cpu"])
    assert [r["dofs"] for r in rows] == [729]
    assert rows[0]["cg_its"] == 8
    out = capsys.readouterr().out
    assert "cg_reduction" in out and "729" in out


def test_experiment_needs_cuda_unless_told_cpu(monkeypatch):
    """The driver measures on the card: with no CUDA device it stops rather
    than run on the CPU, unless ``--device cpu`` asks for that."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["4", "700", "800"])


def test_profile_breakdown_of_a_trace():
    """profile_solve's busy time is the union of device intervals, its
    shares split the summed device time by kernel class."""
    from multigrid_tpu_torch.experiments.profile_solve import (breakdown,
                                                               kernel_class)

    k = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name,
                               "ts": ts, "dur": dur}
    events = [
        k("void (anonymous namespace)::brick_apply_kernel<float>(float const*)",
          0.0, 40.0),
        k("void (anonymous namespace)::brick_apply_kernel<double>(double const*)",
          30.0, 20.0),     # overlaps the first: busy 0..50
        k("void (anonymous namespace)::dot_kernel(double const*)", 100.0, 10.0),
        k("ampere_sgemm_32x32_sliced1x4_nn", 200.0, 10.0),
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "ts": 300.0, "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0,
         "dur": 999.0},   # host event: not device time
    ]
    got = breakdown(events, wall_s=1e-3)
    assert got["device_busy_s"] == pytest.approx(90e-6)
    assert got["idle_share"] == pytest.approx(0.91)
    assert got["device_events"] == 5
    assert got["share"] == pytest.approx({
        "brick_apply<float>": 0.4, "brick_apply<double>": 0.2,
        "fill/copy": 0.2, "cg kernels": 0.1, "matmul": 0.1})
    assert list(got["share"])[0] == "brick_apply<float>"
    assert kernel_class("void at::native::vectorized_elementwise_kernel<4>"
                        ) == "other torch"
    assert kernel_class("void dot_kernel<double, 128, 0>") == "other torch"


def test_profile_classes_of_dg_kernels():
    from multigrid_tpu_torch.experiments.profile_solve import kernel_class

    pre = "void (anonymous namespace)::dg_kernel"
    args = "(float const*, float const*, float*, int, int, int, int)"
    assert kernel_class(f"{pre}<double, 5, false>{args}") == "dg_apply<double>"
    assert kernel_class(f"{pre}<float, 5, false>{args}") == "dg_apply<float>"
    assert kernel_class(f"{pre}<float, 8, true>{args}") == "dg_cheb<float>"


def test_import_loads_no_jax():
    code = ("import sys, multigrid_tpu_torch.solvers.multigrid, "
            "multigrid_tpu_torch.experiments.poisson_cube, "
            "multigrid_tpu_torch.experiments.profile_solve, "
            "multigrid_tpu_torch.experiments.poisson_dg, "
            "multigrid_tpu_torch.solvers.multigrid_dg, "
            "multigrid_tpu_torch.ops.dg_kernel, "
            "multigrid_tpu_torch.utils.perf_model, "
            "multigrid_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'multigrid_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
