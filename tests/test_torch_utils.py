"""The port's single-device utils against their JAX twins, on the CPU.

* ``utils/vtk``: ``write_vtr`` and ``write_solution`` write files byte for
  byte the JAX module's for the same arrays, in ASCII and in base64
  binary, in 2-D and 3-D; the size guard is the same.
* ``utils/checkpoint``: a file the port writes (tensors nested in dicts,
  lists and tuples, with metadata) reads back in JAX under the same
  ``"outer/cg/x"`` keys, bit for bit, and a file JAX writes reads back in
  the port (the port's npz stored, JAX's compressed, both with
  ``__metadata__``); the reserved key is refused as in JAX.
* ``utils/memory``: ``solver_memory_report`` gives the JAX report's
  levels and dofs for the same poisson_cube mesh, nonzero bytes, and the
  allocator view ``{}`` on the CPU, as JAX's there.
* ``utils/profiling``: ``device_trace`` writes a Chrome trace holding the
  traced ops; ``profile_fn`` returns the best of its runs.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments.poisson_cube import build_solver as j_build
from multigrid_tpu.mesh.brick import BrickMesh as JBrickMesh
from multigrid_tpu.mesh.brick import DofGrid as JDofGrid
from multigrid_tpu.mesh.brick import poisson_cube_mesh as j_pcm
from multigrid_tpu.utils import checkpoint as j_ckpt
from multigrid_tpu.utils import memory as j_memory
from multigrid_tpu.utils import vtk as j_vtk
from multigrid_tpu_torch.experiments.poisson_cube import build_solver
from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid, poisson_cube_mesh
from multigrid_tpu_torch.utils import checkpoint, memory, profiling, vtk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids(cells, degree):
    args = (cells, (-1.0,) * len(cells), (2.0, 1.5, 1.2)[:len(cells)], 1)
    return (JDofGrid(JBrickMesh(*args), 0, degree),
            DofGrid(BrickMesh(*args), 0, degree))


@pytest.mark.parametrize("cells,degree", [((2, 2, 2), 2), ((3, 2), 3)])
@pytest.mark.parametrize("ascii_max", [32_768, 0])
def test_vtk_files_equal_jax(tmp_path, cells, degree, ascii_max):
    """The same arrays give the same bytes: ``write_vtr`` with two fields
    (``ascii_max`` 0: base64 binary) and ``write_solution`` with the
    pointwise error."""
    gj, gt = _grids(cells, degree)
    rng = np.random.default_rng(len(cells))
    sol = rng.standard_normal(gt.shape)
    other = rng.standard_normal(gt.shape)
    axes = [gt.axis_nodes[d] for d in range(gt.dim)]
    pj, pt = tmp_path / "j.vtr", tmp_path / "t.vtr"
    assert j_vtk.write_vtr(str(pj), axes, {"u": sol, "v": other},
                           ascii_max=ascii_max)
    assert vtk.write_vtr(str(pt), axes, {"u": sol, "v": other},
                         ascii_max=ascii_max)
    assert pt.read_bytes() == pj.read_bytes()
    fmt = 'format="ascii"' if ascii_max else 'format="binary"'
    assert fmt in pt.read_text()
    exact = lambda c: np.sin(c[0]) + sum(c[1:])
    assert j_vtk.write_solution(str(pj), gj, sol, exact)
    assert vtk.write_solution(str(pt), gt, torch.as_tensor(sol).numpy(),
                              exact)
    assert pt.read_bytes() == pj.read_bytes()


def test_vtk_size_guard(tmp_path):
    assert vtk.SIZE_GUARD == j_vtk.SIZE_GUARD
    axes = [np.arange(n, dtype=float) for n in (50, 50, 50)]
    path = tmp_path / "big.vtr"
    assert not vtk.write_vtr(str(path), axes, {"f": np.zeros((50,) * 3)})
    assert not path.exists()
    assert vtk.write_vtr(str(path), axes, {"f": np.zeros((50,) * 3)},
                         force=True, ascii_max=0)


def _state(rng):
    return {"outer": {"cg": {"x": torch.as_tensor(rng.standard_normal(7)),
                             "alpha": 0.25},
                      "levels": [torch.arange(6, dtype=torch.float32)
                                 .reshape(2, 3), None,
                                 (torch.ones(2, dtype=torch.int64),)]},
            "rhs": rng.standard_normal((3, 4))}


@pytest.mark.parametrize("seed", [1, 3])
def test_checkpoint_port_file_reads_in_jax(tmp_path, seed):
    rng = np.random.default_rng(seed)
    state = _state(rng)
    path = str(tmp_path / "port.npz")
    checkpoint.save_state(path, state, {"iteration": 4, "rtol": 1e-9})
    for load in (j_ckpt.load_state, checkpoint.load_state):
        got, meta = load(path)
        assert meta == {"iteration": 4, "rtol": 1e-9}
        assert sorted(got) == ["outer/cg/alpha", "outer/cg/x",
                               "outer/levels/0", "outer/levels/2/0", "rhs"]
        assert np.array_equal(got["outer/cg/x"], state["outer"]["cg"]["x"])
        assert got["outer/levels/0"].dtype == np.float32
        assert got["outer/levels/2/0"].dtype == np.int64
        assert got["outer/cg/alpha"] == 0.25
        assert np.array_equal(got["rhs"], state["rhs"])


def test_checkpoint_jax_file_reads_in_port(tmp_path):
    rng = np.random.default_rng(2)
    state = {"outer": {"cg": {"x": jnp.asarray(rng.standard_normal(5))}},
             "levels": [jnp.asarray(np.float32([1, 2])),
                        jnp.asarray(rng.standard_normal((2, 2)))]}
    path = str(tmp_path / "jax.npz")
    j_ckpt.save_state(path, state, {"cycle": 3})
    got, meta = checkpoint.load_state(path)
    want, _ = j_ckpt.load_state(path)
    assert meta == {"cycle": 3} and sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k])
    assert sorted(got) == ["levels/0", "levels/1", "outer/cg/x"]


def test_checkpoint_reserved_key(tmp_path):
    for save in (j_ckpt.save_state, checkpoint.save_state):
        with pytest.raises(ValueError, match="reserved"):
            save(str(tmp_path / "bad.npz"), {"__metadata__": np.zeros(2)})


def test_memory_report_matches_jax():
    sj = j_build(j_pcm(4), 4, n_cycles=2)
    st = build_solver(poisson_cube_mesh(4), 4, n_cycles=2, device="cpu")
    rj, rt = j_memory.solver_memory_report(sj), memory.solver_memory_report(st)
    assert [(r["level"], r["dofs"]) for r in rt["levels"]] \
        == [(r["level"], r["dofs"]) for r in rj["levels"]]
    for r in rt["levels"]:
        assert r["vectors"] >= 8 * r["dofs"] and r["operator"] > 0
    assert rt["total_bytes"] == sum(r["vectors"] + r["operator"]
                                    for r in rt["levels"])
    assert rt["allocator"] == {} == memory.device_memory_stats("cpu")
    assert j_memory.device_memory_stats() == {}


def test_print_memory_report(capsys):
    st = build_solver(poisson_cube_mesh(2), 2, device="cpu")
    rep = memory.print_memory_report(st)
    out = capsys.readouterr().out
    assert out.startswith("Memory usage (MB):")
    assert out.count("  level ") == len(rep["levels"]) == len(st.grids)
    assert "device:" not in out


def test_device_trace_writes_a_trace(tmp_path, capsys):
    path = tmp_path / "sub" / "trace.json"
    with profiling.device_trace(str(path)):
        torch.ones(64).mul(3.0).sum()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::mul" in e.get("name", "") for e in events)
    assert str(path) in capsys.readouterr().out


def test_profile_fn_best_of_runs():
    calls, walls = [], []
    best = profiling.profile_fn(lambda a: calls.append(a), 7, n_warmup=2,
                                n_runs=3, walls=walls)
    assert calls == [7] * 5 and len(walls) == 3 and best == min(walls) > 0
    assert profiling.profile_fn(torch.ones(8).add, 1.0, n_runs=2) > 0
