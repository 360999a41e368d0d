"""Port vs JAX twin: the plain version of ``brick_kron<double>`` (K1's CUDA
twin, ``multigrid_tpu_torch/csrc/brick_kron_f64.cu``).

The kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here its plain version ``brick_kron_reference`` in
float64 is held
* to the JAX twin of K1, ``PallasWindowedOzaki`` in interpret mode, in its
  vmult and vmult_residual forms at 1e-13·max|y| (both f64: only the
  summation order differs);
* to the dense element path (``brick_apply_plain`` + ``cheb_epilogue_plain``)
  in all four modes at every compiled degree: 1e-13·max|y| for apply and
  vmult, 1e-13·max|A x| for residual, 1e-12·max|out| for the Chebyshev
  step on the smoother's iterates.  The step gets the looser bar because
  f2 / diag amplifies the rounding of A x: an error of e·max|A x| moves
  the step by up to e·max|A x| / (min diag · max|out|) of its scale, a
  factor of 0.3-3 on these grids that grows with the grid (the bar is
  shared with the card check at 257^3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.mesh.brick import BrickMesh as JBrickMesh
from multigrid_tpu.mesh.brick import DofGrid as JDofGrid
from multigrid_tpu.ops.pallas_windowed import PallasWindowedOzaki
from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid
from multigrid_tpu_torch.ops import laplace_kernel as lk

DEGREES = range(1, 10)   # every compiled degree of brick_kron
CELLS = [(2, 3, 5), (1, 4, 3)]   # anisotropic; a one-cell axis


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def grids(cells, degree):
    args = (cells, (-0.9,) * 3, (1.9, 1.3, 1.1), 1)
    return (JDofGrid(JBrickMesh(*args), 0, degree),
            DofGrid(BrickMesh(*args), 0, degree))


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("mode", ["vmult", "residual"])
def test_brick_kron_f64_matches_pallas_windowed_dp(mode):
    """The f64 plain version against K1 (interpret mode) on the (3, 4, 4)
    p = 4 grid of tests/test_torch_laplace.py."""
    gj, gt = grids((3, 4, 4), 4)
    x, b = rand(gt.shape, 0), rand(gt.shape, 1)
    ref = PallasWindowedOzaki(gj, cy_chunk=4, interpret=True)
    if mode == "vmult":
        want = np.asarray(ref.vmult(jnp.asarray(x)))
    else:
        want = np.asarray(ref.vmult_residual(jnp.asarray(b), jnp.asarray(x)))
    op = lk.BrickLaplace(gt, torch.float64, "cpu")
    got = lk.brick_kron_reference(torch.as_tensor(x), op, mode,
                                  b=torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize("mode", sorted(lk.KRON_MODES))
@pytest.mark.parametrize("cells", CELLS)
@pytest.mark.parametrize("p", DEGREES)
def test_brick_kron_f64_reference_matches_dense(p, cells, mode):
    """The separable f64 arithmetic with the kernel's taps and epilogues
    against the dense element path, in the mode's bar (module note)."""
    _, gt = grids(cells, p)
    op = lk.BrickLaplace(gt, torch.float64, "cpu")
    if mode == "cheb":
        b, x, xo = lk.smoother_iterates(op, 5)
    else:
        x, b, xo = (torch.as_tensor(rand(gt.shape, s)) for s in (2, 3, 4))
    y = lk.brick_apply_plain(x, op.K)
    f1, f2 = 0.37, 0.81
    want, scale, tol = {
        "apply": lambda: (y, y, 1e-13),
        "vmult": lambda: (torch.where(op.interior, y, x),
                          torch.where(op.interior, y, x), 1e-13),
        "residual": lambda: (lk.cheb_epilogue_plain(b, y, x=x,
                                                    residual_only=True),
                             y, 1e-13),
        "cheb": lambda: (lk.cheb_epilogue_plain(b, y, x, xo, op.lines, f1,
                                                f2), None, 1e-12),
    }[mode]()
    got = lk.brick_kron_reference(x, op, mode, b=b, x_old=xo, f1=f1, f2=f2)
    scale = float((want if scale is None else scale).abs().max())
    assert float((got - want).abs().max()) <= tol * scale


def test_build_compiles_the_double_unit_beside_the_float_one():
    """The double instantiations are a source of their own (built in
    parallel with the float one), with the float entry's arguments; the
    shared template is hashed into the library's name; the cell-scatter
    entry is gone."""
    from multigrid_tpu_torch import _build

    names = [s.name for s in _build.SOURCES]
    assert "brick_kron.cu" in names and "brick_kron_f64.cu" in names
    assert "brick_kron.cuh" in [h.name for h in _build.HEADERS]
    assert all(s.exists() for s in _build.SOURCES + _build.HEADERS)
    assert _build.SIGNATURES["brick_kron_f64"] == _build.SIGNATURES["brick_kron_f32"]
    assert "brick_apply_f64" not in _build.SIGNATURES


def test_ptxas_report_reads_registers_and_spills():
    """chip_smoke.py's spill check reads ptxas -v output per kernel entry
    and source."""
    from multigrid_tpu_torch import _build

    log = "\n".join([
        "/usr/local/cuda/bin/nvcc -O3 -c -o /b/brick_kron_f64.o /s/brick_kron_f64.cu",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_117brick_kron_kernelIdLi4ELi2EEEvPKT_' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_117brick",
        "    0 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 3416 bytes cmem[0]",
        "/usr/local/cuda/bin/nvcc -O3 -c -o /b/cg_vec.o /s/cg_vec.cu",
        "ptxas info    : Compiling entry function '_Z3dotPKd' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 30 registers",
    ])
    rows = _build.ptxas_report(log)
    assert rows == [
        dict(source="brick_kron_f64.cu",
             kernel="_ZN12_GLOBAL__N_117brick_kron_kernelIdLi4ELi2EEEvPKT_",
             registers=128, spill_stores=8, spill_loads=16),
        dict(source="cg_vec.cu", kernel="_Z3dotPKd", registers=30,
             spill_stores=0, spill_loads=0)]


def test_compile_sources_times_each_nvcc(tmp_path, monkeypatch):
    """The build starts one nvcc a source together and times each to its
    own end (a stand-in compiler here: the slow source's time is the
    longer), then the link; a failed source is named and nothing is
    linked."""
    from multigrid_tpu_torch import _build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "out=''; prev=''\n"
        "for a in \"$@\"; do [ \"$prev\" = -o ] && out=\"$a\"; prev=\"$a\"; "
        "done\n"
        "case \"$*\" in *slow.cu*) sleep 0.4;; *bad.cu*) exit 1;; esac\n"
        "echo 'ptxas info    : Used 9 registers'\n"
        "echo built > \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    srcs = [tmp_path / f"{s}.cu" for s in ("fast", "slow", "bad")]
    for s in srcs:
        s.write_text("")
    work = tmp_path / "work"
    work.mkdir()
    log, failed, seconds = _build.compile_sources(srcs[:2], work)
    assert failed == [] and (work / "lib.so").read_text() == "built\n"
    assert set(seconds) == {"fast.cu", "slow.cu", "link"}
    assert seconds["slow.cu"] >= 0.4 > seconds["fast.cu"]
    assert log.count("Used 9 registers") == 3 and " -c " in log
    log, failed, seconds = _build.compile_sources(srcs, work)
    assert len(failed) == 1 and failed[0].endswith("bad.cu")
    assert "link" not in seconds and len(seconds) == 3
