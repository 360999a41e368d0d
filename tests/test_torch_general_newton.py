"""The port's minimal_surface (Newton's method on the general path)
against the JAX package's, and the shell profile's range classes.

* ``MinimalSurfaceNewton(2, 2)``: the same number of Newton steps and CG
  iterations as the JAX twin, each residual norm within 1e-6 of the JAX
  one relative to the larger of that norm and the Newton tolerance 1e-9
  (the last norm, ~7e-13, sits at rounding level); the solutions agree to
  1e-10.  The assertions of tests/test_shell_minimal_surface.py's
  ``test_minimal_surface_newton`` hold too (the JAX test's compile-once
  check has no counterpart: the port compiles nothing).
* Twin of ``test_minimal_surface_refinement_cycles``.
* ``profile_solve``'s trace breakdown puts a device event launched inside
  a ``record_function`` range in that range's class.
"""

import numpy as np
import pytest
import torch

from multigrid_tpu_torch.experiments import minimal_surface as ms

TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cold_port():
    n = ms.MinimalSurfaceNewton(2, 2, device="cpu")
    u, res, cg_total = n.solve(tol=TOL, max_newton=25, verbose=False)
    return n, u, res, cg_total


def test_minimal_surface_newton_matches_jax(cold_port):
    from experiments.minimal_surface import MinimalSurfaceNewton as JNewton

    _, u, res, cg_total = cold_port
    j = JNewton(n_levels=2, degree=2)
    u_j, res_j, cg_j = j.solve(tol=TOL, max_newton=25, verbose=False)
    assert len(res) == len(res_j) and cg_total == cg_j
    res, res_j = np.array(res), np.array(res_j)
    np.testing.assert_array_less(np.abs(res - res_j),
                                 1e-6 * np.maximum(res_j, TOL))
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=0, atol=1e-10)


def test_minimal_surface_newton(cold_port):
    _, _, res, _ = cold_port
    assert res[-1] < 1e-6, res
    # quadratic tail: the last step contracts strongly
    assert res[-1] < 0.1 * res[-2]


def test_minimal_surface_refinement_cycles(cold_port):
    """Global refinement + solution interpolation between Newton solves
    (reference minimal_surface/program.cc:623-647): the warm-started cycle
    needs fewer Newton iterations than the cold solve at the same size."""
    results = ms.run_refinement_cycles(n_cycles=2, first_levels=1, degree=2,
                                       tol=1e-9, verbose=False, device="cpu")
    assert results[1]["dofs"] > results[0]["dofs"]
    assert results[1]["final_residual"] < 1e-9
    _, _, res_cold, _ = cold_port
    assert results[1]["newton_its"] <= len(res_cold) - 1


def test_minimal_surface_driver(capsys, monkeypatch):
    res = ms.main(["--levels", "1", "--degree", "2", "--device", "cpu"])
    assert res[-1] < 1e-12
    assert "converged in" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ms.main(["--levels", "1", "--degree", "2"])


def test_profile_breakdown_by_range():
    """A kernel launched (runtime or driver API) inside a record_function
    range falls in the range's class; the port's own kernels keep theirs;
    a kernel launched outside every range keeps its name's class."""
    from multigrid_tpu_torch.experiments.profile_solve import breakdown

    def kernel(name, ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur, "args": {"correlation": corr}}

    def launch(cat, ts, corr):
        return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts,
                "dur": 1.0, "args": {"correlation": corr}}

    def rng(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
                "dur": dur}

    events = [
        rng("transfer", 0.0, 100.0), rng("op scatter", 10.0, 20.0),
        launch("cuda_runtime", 12.0, 1), launch("cuda_runtime", 40.0, 2),
        launch("cuda_driver", 50.0, 3), launch("cuda_runtime", 200.0, 4),
        launch("cuda_runtime", 60.0, 5),
        kernel("void at::native::index_elementwise_kernel", 300.0, 10.0, 1),
        kernel("void at::native::vectorized_elementwise_kernel", 310.0, 20.0, 2),
        kernel("sm90_xmma_gemm_f32f32", 330.0, 30.0, 3),
        kernel("sm90_xmma_gemm_f64f64", 360.0, 40.0, 4),
        kernel("void (anonymous namespace)::dot_kernel(double const*)",
               400.0, 100.0, 5),
    ]
    got = breakdown(events, wall_s=1e-3)
    assert got["share"] == pytest.approx({
        "op scatter": 0.05, "transfer": 0.25, "matmul": 0.2,
        "cg kernels": 0.5})
    assert got["events"] == {"cg kernels": 1, "transfer": 2, "matmul": 1,
                             "op scatter": 1}
