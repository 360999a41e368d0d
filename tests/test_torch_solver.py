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
        k("void (anonymous namespace)::brick_kron_kernel<float, 4, 3>("
          "float const*)", 0.0, 40.0),
        k("void (anonymous namespace)::brick_kron_kernel<double, 4, 2>("
          "double const*)", 30.0, 20.0),     # overlaps the first: busy 0..50
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
        "brick_kron<float>": 0.4, "brick_kron<double>": 0.2,
        "fill/copy": 0.2, "cg kernels": 0.1, "matmul": 0.1})
    assert list(got["share"])[0] == "brick_kron<float>"
    assert kernel_class("void at::native::vectorized_elementwise_kernel<4>"
                        ) == "other torch"
    assert kernel_class("void dot_kernel<double, 128, 0>") == "other torch"


@pytest.mark.parametrize("mode", range(4))
@pytest.mark.parametrize("p", [1, 4, 7])
def test_profile_classes_of_brick_kernels(p, mode):
    """The one brick template falls in the class of its value type: a
    double instantiation in brick_kron<double>, a float one in
    brick_kron<float>, whatever its degree and mode."""
    from multigrid_tpu_torch.experiments.profile_solve import kernel_class

    pre = "void (anonymous namespace)::brick_kron_kernel"
    for t in ("float", "double"):
        name = (f"{pre}<{t}, {p}, {mode}>({t} const*, {t} const*, {t} const*, "
                f"{t}*, (anonymous namespace)::Taps<{t}, {p}>, {t}, {t}, int, "
                f"int, int, int)")
        assert kernel_class(name) == f"brick_kron<{t}>"


@pytest.mark.parametrize("mode", range(4))
@pytest.mark.parametrize("p", [8, 9])
def test_profile_classes_of_brick_cell_kernels(p, mode):
    """brick_kron's cell form (p >= 8) falls in the class of its value
    type, as the march does."""
    from multigrid_tpu_torch.experiments.profile_solve import kernel_class

    pre = "void (anonymous namespace)::brick_cell_kernel"
    for t in ("float", "double"):
        name = (f"{pre}<{t}, {p}, {mode}>({t} const*, {t} const*, {t} const*, "
                f"{t}*, (anonymous namespace)::Taps<{t}, {p}>, {t}, {t}, int, "
                f"int, int)")
        assert kernel_class(name) == f"brick_kron<{t}>"


@pytest.mark.parametrize("mode", range(4))
@pytest.mark.parametrize("p", [8, 9])
def test_profile_classes_of_brick_layer_kernels(p, mode):
    """brick_kron's layer march (float, p = 8, 9) falls in the class of
    its value type, as the other forms do, also inside a grid range."""
    from multigrid_tpu_torch.experiments.profile_solve import (
        OWN_CLASSES, kernel_class)

    name = (f"void (anonymous namespace)::brick_layer_kernel<float, {p}, "
            f"{mode}>(float const*, float const*, float const*, float*, "
            f"(anonymous namespace)::Taps<float, {p}>, float, float, int, "
            f"int, int, int, int, int)")
    assert kernel_class(name) == "brick_kron<float>"
    assert kernel_class(name).startswith(OWN_CLASSES)


def test_profile_breakdown_by_level():
    """With --levels a brick kernel launched inside a node-grid range
    counts under its class and grid in ``brick_levels``; its class share
    stays the kernel's, and other kernels in the range are not counted
    there."""
    from multigrid_tpu_torch.experiments.profile_solve import (LEVEL_RANGE,
                                                               breakdown)

    def launch(ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1.0, "args": {"correlation": corr}}

    def kernel(name, ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur, "args": {"correlation": corr}}

    def rng(label, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": label, "ts": ts,
                "dur": dur}

    cell = "void (anonymous namespace)::brick_cell_kernel<float, 9, 3>(float)"
    march = "void (anonymous namespace)::brick_kron_kernel<float, 4, 3>(float)"
    events = [
        rng(LEVEL_RANGE + "64x64x64", 0.0, 10.0), launch(1.0, 1),
        rng(LEVEL_RANGE + "64x64x64", 20.0, 10.0), launch(21.0, 2),
        rng(LEVEL_RANGE + "253x253x253", 40.0, 10.0), launch(41.0, 3),
        launch(60.0, 4),
        kernel(cell, 100.0, 8.0, 1), kernel(cell, 110.0, 6.0, 2),
        kernel(cell, 120.0, 300.0, 3), kernel(march, 500.0, 20.0, 4),
    ]
    got = breakdown(events, wall_s=1e-3)
    assert got["share"] == pytest.approx({"brick_kron<float>": 1.0})
    assert got["brick_levels"] == {
        "brick_kron<float> 253x253x253": {"seconds": pytest.approx(300e-6),
                                          "launches": 1},
        "brick_kron<float> 64x64x64": {"seconds": pytest.approx(14e-6),
                                       "launches": 2}}
    assert "brick_levels" not in breakdown(events[-1:], wall_s=1e-3)


@pytest.mark.parametrize("resid", ["false", "true"])
@pytest.mark.parametrize("p", [1, 4, 7])
def test_profile_classes_of_dg_kernels(p, resid):
    """The DG pencil kernels fall in the class of their function and value
    type, whatever the degree and mode: dg_apply_kernel<double, ...> in
    dg_apply<double>, dg_apply_kernel<float, ...> in dg_apply<float>,
    dg_cheb_kernel<...> in dg_cheb<float>."""
    from multigrid_tpu_torch.experiments.profile_solve import kernel_class

    pre = "void (anonymous namespace)::dg_apply_kernel"
    n = p + 1
    for t in ("float", "double"):
        name = (f"{pre}<{t}, {n}, {resid}>((anonymous namespace)::TabArg<{t}, "
                f"{n}>, {t} const*, {t}*, {t} const*, int, int, int, int)")
        assert kernel_class(name) == f"dg_apply<{t}>"
    cheb = (f"void (anonymous namespace)::dg_cheb_kernel<{n}>((anonymous "
            f"namespace)::TabArg<float, {n}>, float const*, float*, float "
            "const*, float const*, float const*, float, float, int, int, "
            "int, int)")
    assert kernel_class(cheb) == "dg_cheb<float>"


@pytest.mark.parametrize("p", [8, 9])
def test_profile_classes_of_dg_high_kernels(p):
    """The DG pencil kernels of csrc/dg_pencil_high.cu (p = 8, 9) fall in
    the class of the function they compute: dg_high_apply_kernel (double)
    in dg_apply<double>, dg_high_cheb_kernel in dg_cheb<float>."""
    from multigrid_tpu_torch.experiments.profile_solve import (
        OWN_CLASSES, kernel_class)

    n = p + 1
    for resid in ("false", "true"):
        name = (f"void (anonymous namespace)::dg_high_apply_kernel<{n}, "
                f"{resid}>((anonymous namespace)::TabArg<double, {n}>, "
                "double const*, double*, double const*, int, int, int, int)")
        assert kernel_class(name) == "dg_apply<double>"
    cheb = (f"void (anonymous namespace)::dg_high_cheb_kernel<{n}>((anonymous "
            f"namespace)::TabArg<float, {n}>, float const*, float*, float "
            "const*, float const*, float const*, float, float, int, int, "
            "int, int)")
    assert kernel_class(cheb) == "dg_cheb<float>"
    assert kernel_class(cheb).startswith(OWN_CLASSES)


def test_import_loads_no_jax():
    code = ("import sys, multigrid_tpu_torch.solvers.multigrid, "
            "multigrid_tpu_torch.experiments.poisson_cube, "
            "multigrid_tpu_torch.experiments.profile_solve, "
            "multigrid_tpu_torch.experiments.poisson_dg, "
            "multigrid_tpu_torch.solvers.multigrid_dg, "
            "multigrid_tpu_torch.ops.dg_kernel, "
            "multigrid_tpu_torch.ops.dg_face, "
            "multigrid_tpu_torch.experiments.time_dg_cheb, "
            "multigrid_tpu_torch.experiments.time_brick, "
            "multigrid_tpu_torch.utils.perf_model, "
            "multigrid_tpu_torch.experiments.poisson_dg_plain, "
            "multigrid_tpu_torch.experiments.matvec_dg, "
            "multigrid_tpu_torch.experiments.matvec_dg_cheby, "
            "multigrid_tpu_torch.experiments.solver_dg, "
            "multigrid_tpu_torch.solvers.fused, "
            "multigrid_tpu_torch.ops.dg_transfer, "
            "multigrid_tpu_torch.ops.dg_precond, "
            "multigrid_tpu_torch.convert, "
            "multigrid_tpu_torch.parallel.programs, "
            "multigrid_tpu_torch.parallel.dg_halo, "
            "multigrid_tpu_torch.experiments.time_ranks; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'multigrid_tpu', 'experiments')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
