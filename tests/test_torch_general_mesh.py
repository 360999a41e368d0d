"""The port's general-geometry mesh layer against the JAX package's.

* ``mesh/native.py``: ``unique_nodes`` and ``block_cell_nodes`` equal the
  JAX twin's and the numpy oracles; a failed ``g++`` build raises.
* ``GeneralGrid`` on the 6- and 12-block shells, the 2-D ball and the
  deformed cube (2-D and 3-D): ``cell_nodes``, ``boundary`` and
  ``child_cells`` exactly equal, ``node_coords``, ``jxw`` and
  ``merged_coefficient`` to 1e-13 (relative to the array's max).
* The new modules import neither JAX nor the JAX package.
"""

import subprocess
import sys

import numpy as np
import pytest

from multigrid_tpu_torch.mesh import native
from multigrid_tpu_torch.mesh import shapes as t_shapes
from multigrid_tpu_torch.mesh.mapped import GeneralGrid

# name -> (function of mesh/shapes.py, kwargs, level, degree)
GRIDS = {
    "shell6": ("hyper_shell", dict(r_in=0.5, r_out=1.0, n_levels=3), 2, 3),
    "shell6_p4": ("hyper_shell", dict(r_in=0.5, r_out=1.0, n_levels=2), 1, 4),
    "shell12": ("hyper_shell_12", dict(r_in=0.5, r_out=1.0, n_levels=2), 1, 3),
    "ball2d": ("hyper_ball_2d", dict(radius=1.0, n_levels=3), 2, 4),
    "deformed3d": ("deformed_cube", dict(size=2, n_levels=2), 1, 3),
    "deformed2d": ("deformed_cube", dict(size=2, n_levels=3, dim=2), 2, 2),
}


def _coef(coords):
    out = 1.0
    for e, c in enumerate(coords):
        out = out + 0.5 * np.cos(2.0 * c + e) ** 2
    return out


@pytest.fixture(scope="module", params=sorted(GRIDS))
def grids(request):
    from multigrid_tpu.mesh import mapped as j_mapped
    from multigrid_tpu.mesh import shapes as j_shapes

    make, kw, level, degree = GRIDS[request.param]
    gj = j_mapped.GeneralGrid(getattr(j_shapes, make)(**kw), level, degree)
    gt = GeneralGrid(getattr(t_shapes, make)(**kw), level, degree)
    return gj, gt


def test_grid_tables_equal_jax(grids):
    gj, gt = grids
    assert (gt.n_dofs, gt.n_cells) == (gj.n_dofs, gj.n_cells)
    np.testing.assert_array_equal(gt.cell_nodes, gj.cell_nodes)
    np.testing.assert_array_equal(gt.boundary, gj.boundary)
    np.testing.assert_array_equal(gt.child_cells(), gj.child_cells())
    assert gt.boundary.any() and not gt.boundary.all()


def test_grid_geometry_matches_jax(grids):
    gj, gt = grids
    for a, b in ((gt.node_coords, gj.node_coords), (gt.jxw, gj.jxw),
                 (gt.quad_coords, gj.quad_coords),
                 (gt.merged_coefficient(), gj.merged_coefficient()),
                 (gt.merged_coefficient(_coef), gj.merged_coefficient(_coef))):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-13 * np.abs(b).max())


@pytest.mark.parametrize("cells,degree", [((2, 3), 1), ((3, 1), 4),
                                          ((2, 2, 3), 2), ((1, 2, 1), 4),
                                          ((3, 2, 2), 5)])
def test_block_cell_nodes_matches_jax_and_numpy(cells, degree):
    from multigrid_tpu.mesh import native as j_native

    got = native.block_cell_nodes(cells, degree)
    np.testing.assert_array_equal(got, j_native.block_cell_nodes(cells, degree))
    np.testing.assert_array_equal(got,
                                  native.block_cell_nodes_numpy(cells, degree))


@pytest.mark.parametrize("dim", [2, 3])
def test_unique_nodes_matches_jax_and_numpy(dim):
    """Points on a lattice, each present up to three times with
    perturbations of 1e-13 (which straddle the rounding boundary of the
    second, half-offset grid) and some shifted by a fifth of the quantum
    (which may straddle the first's)."""
    from multigrid_tpu.mesh import native as j_native

    rng = np.random.default_rng(dim)
    base = rng.integers(0, 7, size=(400, dim)) * 0.125
    base = np.unique(base, axis=0)
    idx = rng.integers(0, base.shape[0], size=3 * base.shape[0])
    pts = base[idx] + rng.uniform(-1e-13, 1e-13, size=(idx.size, dim))
    pts[::7] += 0.2e-9
    tol = 1e-9
    n, inv = native.unique_nodes(pts, tol)
    n_j, inv_j = j_native.unique_nodes(pts, tol)
    n_np, inv_np = native.unique_nodes(pts, tol,
                                       quantize=native.quantize_labels_numpy)
    assert n == n_j == n_np == np.unique(idx).size
    np.testing.assert_array_equal(inv, inv_j.reshape(-1))
    np.testing.assert_array_equal(inv, inv_np)
    # the grouping is the lattice point each copy came from
    assert len(set(zip(idx.tolist(), inv.tolist()))) == n


def test_failed_build_raises(monkeypatch, tmp_path):
    """A source that does not compile raises; there is no numpy fallback."""
    bad = tmp_path / "meshgen.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.block_cell_nodes((2, 2), 2)
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_is_keyed_by_the_source():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libmeshgen_") and path.suffix == ".so"
    native.load()
    assert path.exists()


def test_time_setup_builds_the_same_grids_both_ways():
    """The set-up timer's numpy build gives the native build's tables, and
    the helper is put back afterwards."""
    from multigrid_tpu_torch.experiments import time_setup

    before = native._quantize_labels, native.block_cell_nodes
    rows = time_setup.main(["2", "3", "--repeat", "1"])
    assert [(r["cycle"], r["helper"]) for r in rows] == [
        (2, "native"), (2, "numpy"), (3, "native"), (3, "numpy")]
    assert [r["dofs"] for r in rows] == [3474, 3474, 6930, 6930]
    assert all(r["same_as_first"] for r in rows)
    assert all(r["in_helper_s"] > 0 for r in rows)
    assert (native._quantize_labels, native.block_cell_nodes) == before


def test_general_modules_load_no_jax():
    mods = ["multigrid_tpu_torch.mesh.native", "multigrid_tpu_torch.mesh.mapped",
            "multigrid_tpu_torch.mesh.shapes",
            "multigrid_tpu_torch.ops.laplace_general",
            "multigrid_tpu_torch.ops.transfer_general",
            "multigrid_tpu_torch.solvers.multigrid_general",
            "multigrid_tpu_torch.experiments.poisson_shell",
            "multigrid_tpu_torch.experiments.minimal_surface",
            "multigrid_tpu_torch.experiments.poisson_cube",
            "multigrid_tpu_torch.experiments.profile_solve",
            "multigrid_tpu_torch.experiments.time_setup",
            "multigrid_tpu_torch.ops.dg_curved",
            "multigrid_tpu_torch.mesh.adaptive",
            "multigrid_tpu_torch.ops.laplace_adaptive",
            "multigrid_tpu_torch.solvers.multigrid_adaptive",
            "multigrid_tpu_torch.solvers.multigrid_local",
            "multigrid_tpu_torch.experiments.poisson_l",
            "multigrid_tpu_torch.experiments.poisson_dg_plain",
            "multigrid_tpu_torch.experiments.matvec_dg",
            "multigrid_tpu_torch.utils.memory",
            "multigrid_tpu_torch.utils.vtk",
            "multigrid_tpu_torch.utils.checkpoint",
            "multigrid_tpu_torch.utils.profiling",
            "multigrid_tpu_torch.convert"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'multigrid_tpu.')) or m == 'multigrid_tpu']\n"
            "print(bad)\nassert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(native.SOURCE.parents[2]))
    assert out.returncode == 0, out.stdout + out.stderr
