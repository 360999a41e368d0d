"""The port's distributed SIP-DG operator (``multigrid_tpu_torch.parallel.
dg_halo``) and its trace wire (``ops/dg.py``), against the JAX package's.

The wire twins (``boundary_traces``, ``boundary_coeff_planes``,
``traces_from_coeff_planes``, ``apply(u, ext=...)``) are held against JAX
for every kind and axis on tests/test_dg_halo_wire.py:20's sheared map
(atol 1e-12, the gradient traces 1e-11: JAX's bars).  ``HaloDGLaplace``
runs on 2 and 4 ranks of ``torch.distributed`` (gloo, the CPU), both
wires, gauss and hermite, at cells (16, 4, 4), p = 3, and
``HaloDGLaplace2D`` on a 2 x 2 rank grid at (8, 4, 4): the slab route
(``DGOperator`` on ghost cell layers filled through the wire) and
``vmult_plain`` (the JAX algorithm) are held against JAX ``HaloDGLaplace``
/ ``HaloDGLaplace2D`` on the virtual device mesh and against the
single-device apply, atol 1e-11 as JAX.  The traces wire's owned cells are
the single-device bits; the hermite wire's agree to rounding (a second
apply, reading the first's refreshed ghosts, within 1e-13 of max|y|).
Each world size is one launch of ``parallel.programs.dg_halo_program``
(module-scoped).  The slab layout itself is checked without ranks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.ops.dg import DGGrid as JDGGrid
from multigrid_tpu.ops.dg import DGLaplace as JDGLaplace
from multigrid_tpu.parallel.dg_halo import HaloDGLaplace as JHalo
from multigrid_tpu.parallel.dg_halo import HaloDGLaplace2D as JHalo2D
from multigrid_tpu.parallel.sharding import make_mesh
from multigrid_tpu_torch.ops.dg import DGGrid, DGLaplace, DGLaplaceVarCoeff
from multigrid_tpu_torch.parallel.dg_halo import WIRE_FORMATS, DGSlabs
from multigrid_tpu_torch.parallel.programs import dg_halo_program
from multigrid_tpu_torch.parallel.sharding import RankGrid, Ranks, launch

SHEAR = ((0.25, 0.03, 0.0), (0.02, 0.31, 0.04), (0.0, 0.05, 0.21))
KINDS = ("gauss", "hermite")
Z_CELLS, ZY_CELLS = (16, 4, 4), (8, 4, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids(kind, cells=(8, 4, 4), degree=3):
    return (JDGGrid(cells=cells, jacobian=SHEAR, degree=degree, kind=kind),
            DGGrid(cells=cells, jacobian=SHEAR, degree=degree, kind=kind))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _ops(kind, cells=(8, 4, 4), degree=3):
    jg, tg = _grids(kind, cells, degree)
    return JDGLaplace(jg, jnp.float64), DGLaplace(tg, torch.float64, "cpu")


# ------------------------------------------------------------ the wire twins
@pytest.mark.parametrize("kind", ["hermite", "gauss", "gll"])
@pytest.mark.parametrize("d", [0, 1, 2])
def test_wire_payloads_match_jax(kind, d):
    jop, op = _ops(kind)
    x = _x(op.grid.shape, 3)
    jt = jop.boundary_traces(jnp.asarray(x), d=d)
    tt = op.boundary_traces(torch.as_tensor(x), d=d)
    jp = jop.boundary_coeff_planes(jnp.asarray(x), d=d)
    tp = op.boundary_coeff_planes(torch.as_tensor(x), d=d)
    for s in (0, 1):
        for i, tol in ((0, 1e-12), (1, 1e-11)):
            np.testing.assert_allclose(tt[s][i].numpy(), np.asarray(jt[s][i]),
                                       rtol=0, atol=tol)
            np.testing.assert_allclose(tp[s][i].numpy(), np.asarray(jp[s][i]),
                                       rtol=0, atol=1e-12)
        jtr = jop.traces_from_coeff_planes(jp[s], d)
        ttr = op.traces_from_coeff_planes(tp[s], d)
        for i, tol in ((0, 1e-12), (1, 1e-11)):
            np.testing.assert_allclose(ttr[i].numpy(), np.asarray(jtr[i]),
                                       rtol=0, atol=tol)
            np.testing.assert_allclose(ttr[i].numpy(), tt[s][i].numpy(),
                                       rtol=0, atol=tol)


@pytest.mark.parametrize("kind", ["hermite", "gauss", "gll"])
def test_apply_with_ghost_traces_matches_jax(kind):
    """``apply(u, ext=...)``: the ghost traces replace the mirror at both
    z edges, as in JAX; no ``ext`` is the plain apply, bit for bit."""
    jop, op = _ops(kind)
    x, g = _x(op.grid.shape, 4), _x(op.grid.shape, 5)
    tr = op.boundary_traces(torch.as_tensor(g), d=0)
    ext = {(0, 1): tr[0], (0, 0): tr[1]}
    jext = {k: tuple(jnp.asarray(t.numpy()) for t in v)
            for k, v in ext.items()}
    np.testing.assert_allclose(
        op.apply(torch.as_tensor(x), ext=ext).numpy(),
        np.asarray(jop.apply(jnp.asarray(x), ext=jext)), rtol=0, atol=1e-11)
    assert torch.equal(op.apply(torch.as_tensor(x)),
                       op.apply(torch.as_tensor(x), ext={}))


def test_hermite_kind_pack_is_a_slice():
    _, op = _ops("hermite")
    assert op._hermite_from_self is None
    x = torch.as_tensor(_x(op.grid.shape, 5))
    planes = op.boundary_coeff_planes(x, d=0)
    n = op.n
    assert torch.equal(planes[0][0], x[:1, ..., 0, :, :])
    assert torch.equal(planes[1][1], x[-1:, ..., n - 2, :, :])
    ranks = Ranks(1, 0, torch.device("cpu"), "gloo")
    slabs = DGSlabs(op.grid, ranks, [[0, 8]], wire="hermite")
    assert torch.equal(slabs.pack_planes(x[:1], 0, 0), x[:1, ..., 0:2, :, :])


def test_low_degree_is_refused():
    _, op = _ops("hermite", degree=2)
    with pytest.raises(ValueError, match="degree >= 3"):
        op.boundary_coeff_planes(torch.zeros(op.grid.shape), d=0)
    ranks = Ranks(2, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="degree >= 3"):
        DGSlabs(op.grid, ranks, [[0, 4, 8]], wire="hermite")
    with pytest.raises(ValueError, match="one ghost layer"):
        DGSlabs(_ops("hermite")[1].grid, ranks, [[0, 4, 8]], ghost=2,
                wire="hermite")


def test_var_coeff_operator_refuses_ghost_traces():
    _, op = _ops("gauss")
    vc = DGLaplaceVarCoeff(op.grid, np.ones(op.grid.shape), torch.float64,
                           "cpu")
    z = torch.zeros(op.grid.shape, dtype=torch.float64)
    tr = op.boundary_traces(z, d=0)
    with pytest.raises(ValueError, match="variable-coefficient"):
        vc.apply(z, ext={(0, 1): tr[0]})


@pytest.mark.parametrize("kind", ["hermite", "gauss", "gll"])
@pytest.mark.parametrize("a", [0, 1])
def test_expanded_hermite_ghost_has_the_neighbours_face_traces(kind, a):
    """The hermite wire's ghost cell: packed from the neighbour's boundary
    layer, expanded into a cell whose traces on the shared face are the
    neighbour's (value 1e-12, gradient 1e-11, of traces of order 10)."""
    _, op = _ops(kind)
    ranks = Ranks(1, 0, torch.device("cpu"), "gloo")
    slabs = DGSlabs(op.grid, ranks, [[0, 8]], wire="hermite")
    x = torch.as_tensor(_x(op.grid.shape, 6))
    ax = a - 6
    for side in (0, 1):
        layer = x.narrow(ax, 0 if side == 0 else x.shape[ax] - 1, 1)
        ghost = torch.full_like(layer, np.nan)
        slabs.expand_planes(ghost, slabs.pack_planes(layer, a, side), a,
                            side)
        got = op.boundary_traces(ghost, d=a)[side]
        want = op.boundary_traces(layer, d=a)[side]
        for i, tol in ((0, 1e-12), (1, 1e-11)):
            np.testing.assert_allclose(got[i].numpy(), want[i].numpy(),
                                       rtol=0, atol=tol)


# ------------------------------------------------------ layout, no ranks
def test_slab_layout():
    """Owned cells tile the grid; a slab stores ``ghost`` layers on each
    side with a neighbour; the rank grid is row-major with its
    neighbours; a refresh of the traces wire sends ghost x n^3 per face."""
    _, op = _ops("gauss", cells=(16, 4, 4))
    for world in (2, 4):
        cuts = [0, *(16 * r // world for r in range(1, world)), 16]
        covered = []
        for r in range(world):
            s = DGSlabs(op.grid, Ranks(world, r, torch.device("cpu"),
                                       "gloo"), [cuts])
            c0, c1 = s.owned[0]
            covered += list(range(c0, c1))
            assert s.stored[0] == (c0 - (r > 0), c1 + (r < world - 1))
            assert s.shape[0] == s.stored[0][1] - s.stored[0][0]
            faces = (r > 0) + (r < world - 1)
            assert s.bytes_per_refresh(torch.float64) == \
                faces * 4 * 4 * 4 ** 3 * 8
        assert covered == list(range(16))
    g = RankGrid((2, 2), 3)
    assert g.coords == (1, 1)
    assert [g.neighbor(0, 0), g.neighbor(0, 1), g.neighbor(1, 0),
            g.neighbor(1, 1)] == [1, None, 2, None]
    s = DGSlabs(op.grid, Ranks(4, 1, torch.device("cpu"), "gloo"),
                [[0, 8, 16], [0, 2, 4]])
    assert s.owned == [(0, 8), (2, 4)] and s.stored == [(0, 9), (1, 4)]
    with pytest.raises(ValueError, match="rank grid"):
        DGSlabs(op.grid, Ranks(3, 0, torch.device("cpu"), "gloo"),
                [[0, 8, 16]])
    with pytest.raises(ValueError, match="wire"):
        DGSlabs(op.grid, Ranks(2, 0, torch.device("cpu"), "gloo"),
                [[0, 8, 16]], wire="coeffs")


# ---------------------------------------------------------------- ranks
def _cases(world):
    out = [("z", kind, wire) for kind in KINDS for wire in WIRE_FORMATS]
    if world == 4:
        out += [("zy", kind, wire) for kind in KINDS for wire in WIRE_FORMATS]
    return out


RUNS = [(n, case) for n in (2, 4) for case in _cases(n)]


def _case_grid(split, kind):
    return _grids(kind, Z_CELLS if split == "z" else ZY_CELLS)


@pytest.fixture(scope="module")
def ranks_runs():
    """One launch a world size: every case of :func:`_cases`."""
    out = {}
    for n in (2, 4):
        cases = [(_case_grid(split, kind)[1],
                  _x(_case_grid(split, kind)[1].shape), wire,
                  None if split == "z" else (2, 2))
                 for split, kind, wire in _cases(n)]
        outs = launch(dg_halo_program, n, "gloo", "cpu", args=(cases,),
                      kwargs=dict(whole=True, comm_reps=2))
        out.update({(n, case): o for case, o in zip(_cases(n), outs)})
    return out


@pytest.fixture(scope="module")
def references():
    """Per (split, kind, wire): JAX's distributed apply on the virtual
    mesh, and the port's single-device A x and A A x."""
    out = {}
    for split, kind, wire in _cases(4):
        jg, tg = _case_grid(split, kind)
        x = _x(tg.shape)
        jop = JDGLaplace(jg, jnp.float64)
        cls, axes = (JHalo, ("z",)) if split == "z" else (JHalo2D, ("z", "y"))
        halo = cls(jop, make_mesh(8, axes), wire=wire)
        jy = np.asarray(halo.vmult_distributed()(halo.distribute(
            jnp.asarray(x))))
        op = DGLaplace(tg, torch.float64, "cpu")
        y = op.apply(torch.as_tensor(x))
        out[split, kind, wire] = dict(
            jax=jy, one=y.numpy(), two=op.apply(y).numpy(),
            x_ax=float((torch.as_tensor(x) * y).sum()))
    return out


@pytest.mark.parametrize("run", RUNS,
                         ids=lambda r: f"{r[0]}ranks-{'-'.join(r[1])}")
def test_halo_dg_matches_jax_and_one_device(ranks_runs, references, run):
    out, ref = ranks_runs[run], references[run[1]]
    for key in ("vmult", "vmult_plain"):
        np.testing.assert_allclose(out[key], ref["jax"], rtol=0, atol=1e-11)
        np.testing.assert_allclose(out[key], ref["one"], rtol=0, atol=1e-11)
    scale = np.abs(ref["two"]).max()
    np.testing.assert_allclose(out["vmult2"], ref["two"], rtol=0,
                               atol=1e-13 * scale)
    assert abs(out["x_ax"] - ref["x_ax"]) <= 1e-12 * abs(ref["x_ax"])
    assert out["foreign"] == []
    if run[1][2] == "traces":
        # the kernels' input is the neighbour's cells: one device's bits
        assert np.array_equal(out["vmult"], ref["one"])
        assert np.array_equal(out["vmult2"], ref["two"])
        assert out["vmult_whole"]["equal"]
    else:
        assert out["vmult_whole"]["max_diff"] <= \
            1e-13 * out["vmult_whole"]["scale"]


@pytest.mark.parametrize("world", [2, 4])
def test_hermite_wire_ships_two_planes_a_face(ranks_runs, world):
    """Rank 0 of a z split has one neighbour: n^3 values a face cell on
    the traces wire, 2 n^2 on the hermite wire (p = 3: 64 and 32); the
    exchange split reads both wires."""
    for kind in KINDS:
        assert ranks_runs[world, ("z", kind, "traces")]["bytes"] == \
            4 * 4 * 4 ** 3 * 8
        assert ranks_runs[world, ("z", kind, "hermite")]["bytes"] == \
            4 * 4 * 2 * 4 ** 2 * 8
        for wire in WIRE_FORMATS:
            comm = ranks_runs[world, ("z", kind, wire)]["comm"]
            assert comm["total"] > 0 and 0 <= comm["comm_fraction"] <= 1
            assert "wire" in comm["steps"]
        assert "pack" in ranks_runs[world, ("z", kind, "hermite")]["comm"][
            "steps"]
