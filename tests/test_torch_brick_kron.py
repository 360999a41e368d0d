"""Port vs JAX twin: the tap tables and the separable arithmetic of the
``brick_kron`` kernel (``multigrid_tpu_torch/ops/laplace_kron.py``).

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here its tables and its plain version are held to the
JAX package: ``assembled_1d`` and the per-residue taps equal
``multigrid_tpu/ops/laplace_kron.py``'s ``assembled_1d`` / ``_diagonals``
exactly in f64; ``brick_kron_plain`` in f32 agrees with ``KronLaplaceF32``
at 2e-6·max|y| (f32 roundoff of the banded sweeps, the bar of
tests/test_kron.py) and in f64 with the dense element path at 1e-13·max|y|
(summation order only).  The Chebyshev inputs of the card checks are shown
to expose every term of the step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_tpu.mesh.brick import BrickMesh as JBrickMesh
from multigrid_tpu.mesh.brick import DofGrid as JDofGrid
from multigrid_tpu.ops import laplace_kron as jk
from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid, poisson_cube_mesh
from multigrid_tpu_torch.ops import laplace_kernel as lk
from multigrid_tpu_torch.ops import laplace_kron as tk
from multigrid_tpu_torch.ops.laplace import make_diag_coef

DEGREES = range(1, 10)   # every compiled degree of brick_kron
CELLS = [(2, 3, 5), (1, 4, 3)]


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


@pytest.mark.parametrize("p", DEGREES)
def test_assembled_1d_equals_jax(p):
    gj, gt = grids((2, 3, 5), p)
    for axis in range(3):
        for a, b in zip(tk.assembled_1d(gt, axis), jk.assembled_1d(gj, axis)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cells", CELLS)
@pytest.mark.parametrize("p", DEGREES)
def test_residue_taps_equal_jax_diagonals(p, cells):
    """Every interior row i of the JAX banded diagonals carries the taps of
    residue i mod p (mass, and c_d times stiffness per axis), exactly."""
    gj, gt = grids(cells, p)
    coef = make_diag_coef(gt).values
    taps = tk.kron_taps(gt, coef)
    assert taps.shape == (4, p, 2 * p + 1)
    for axis in range(3):
        M, L = jk.assembled_1d(gj, axis)
        DM, DL = jk._diagonals(M, p), jk._diagonals(L, p)
        rows = range(1, M.shape[0] - 1)
        assert len(rows) > 0 or p == 1
        for i in rows:
            for k in range(2 * p + 1):
                assert taps[0, i % p, k] == DM[k][i]
                assert taps[1 + axis, i % p, k] == coef[axis] * DL[k][i]


@pytest.mark.parametrize("p", DEGREES)
def test_brick_kron_plain_f32_matches_kron_laplace_f32(p):
    gj, gt = grids((3, 2, 4), p)
    x = rand(gt.shape, 0).astype(np.float32)
    b = rand(gt.shape, 1).astype(np.float32)
    ref = jk.KronLaplaceF32(gj)
    want = np.asarray(ref.vmult(jnp.asarray(x)))
    want_r = np.asarray(ref.vmult_residual(jnp.asarray(b), jnp.asarray(x)))
    op = lk.BrickLaplace(gt, torch.float32, "cpu")
    xt, bt = torch.as_tensor(x), torch.as_tensor(b)
    y = tk.brick_kron_plain(xt, op.taps)
    got = torch.where(op.interior, y, xt).numpy()
    got_r = lk.cheb_epilogue_plain(bt, y, x=xt, residual_only=True).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(got_r, want_r, rtol=0, atol=2e-6 * scale)


@pytest.mark.parametrize("cells", CELLS)
@pytest.mark.parametrize("p", DEGREES)
def test_brick_kron_plain_f64_matches_dense(p, cells):
    """The separable arithmetic with the kernel's taps against the dense
    element path, on an anisotropic grid and one with a one-cell axis."""
    _, gt = grids(cells, p)
    op = lk.BrickLaplace(gt, torch.float64, "cpu")
    x = torch.as_tensor(rand(gt.shape, 2))
    want = lk.brick_apply_plain(x, op.K).numpy()
    got = tk.brick_kron_plain(x, op.taps).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-13 * np.abs(want).max())
    assert np.all(got[~np.broadcast_to(op.interior.numpy(), got.shape)] == 0)


@pytest.mark.parametrize("mode", sorted(lk.KRON_MODES))
def test_brick_kron_on_the_cpu_is_its_plain_version(mode):
    """On CPU tensors the wrapper runs brick_kron_reference, which agrees
    with the operator's dense path in every mode (f64, 1e-13), also into
    ``out`` aliasing ``x_old``; nothing is launched."""
    _, gt = grids((2, 3, 4), 3)
    op = lk.BrickLaplace(gt, torch.float64, "cpu")
    b, x, xo = lk.smoother_iterates(op, 5)
    want = {"apply": lambda: op.apply(x), "vmult": lambda: op.vmult(x),
            "residual": lambda: op.vmult_residual(b, x),
            "cheb": lambda: op.cheb_step(b, x, xo, 0.37, 0.81)}[mode]()
    lk.reset_launches()
    alias = xo.clone()
    got = lk.brick_kron(x, op, mode, b=b, x_old=alias, f1=0.37, f2=0.81,
                        out=alias)
    assert got is alias
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-13 * float(want.abs().max()))
    assert all(v == 0 for v in lk.LAUNCHES.values())


@pytest.mark.parametrize("grid", ["cube8", "aniso", "cube4_p7"])
def test_brick_kron_cheb_check_sees_every_term(grid):
    """The Chebyshev inputs the card checks use (``smoother_iterates``:
    random b, x = D^-1 z, x_old = D^-1 z') put every term of the step at
    the output's scale: the f32 separable step meets the 3e-6·max|out| bar
    against the f64 dense step, and leaving out A x, x or x_old misses it
    more than a thousandfold."""
    g = {"cube8": lambda: DofGrid(poisson_cube_mesh(8), 3, 4),
         "aniso": lambda: grids((3, 4, 5), 4)[1],
         "cube4_p7": lambda: DofGrid(poisson_cube_mesh(4), 2, 7)}[grid]()
    op, op32 = (lk.BrickLaplace(g, t, "cpu")
                for t in (torch.float64, torch.float32))
    b, x, xo = lk.smoother_iterates(op, 3)
    f1, f2 = 0.37, 0.81
    y = lk.brick_apply_plain(x, op.K)
    want = lk.cheb_epilogue_plain(b, y, x, xo, op.lines, f1, f2)
    bar = 3e-6 * float(want.abs().max())
    got = lk.brick_kron(x.float(), op32, "cheb", b=b.float(), x_old=xo.float(),
                        f1=f1, f2=f2)
    assert float((got.double() - want).abs().max()) <= bar
    for miss in (lk.cheb_epilogue_plain(b, torch.zeros_like(y), x, xo,
                                        op.lines, f1, f2),
                 lk.cheb_epilogue_plain(b, y, None, xo, op.lines, f1, f2),
                 lk.cheb_epilogue_plain(b, y, x, None, op.lines, f1, f2)):
        assert float((miss - want).abs().max()) > 1e3 * bar


def test_brick_kron_refuses_other_devices():
    _, gt = grids((2, 2, 2), 2)
    op = lk.BrickLaplace(gt, torch.float32, "cpu")
    x = torch.zeros(gt.shape, dtype=torch.float32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        lk.brick_kron(x, op)
    with pytest.raises(ValueError, match="mode"):
        lk.brick_kron(torch.zeros(gt.shape), op, "resid")
    assert not op.kron
    assert all(v == 0 for v in lk.LAUNCHES.values())


@pytest.mark.parametrize("p", [8, 9])
@pytest.mark.parametrize("cells", [(1, 1, 1), (3, 3, 3), (5, 7, 3), (2, 1, 4)])
def test_cell_form_blocks_cover_every_node_once(p, cells):
    """The cell form's ownership (``csrc/brick_kron.cuh``,
    brick_cell_kernel: block (cz, cy, cx) of a grid of cells writes nodes
    [c p, c p + p) on each axis, and the last cell of an axis also its
    boundary node c p + p) writes every node of the grid exactly once."""
    shape = tuple(c * p + 1 for c in cells)
    hits = np.zeros(shape, dtype=np.int64)
    ranges = [[slice(c * p, (c + 1) * p + (c == n - 1)) for c in range(n)]
              for n in cells]
    for rz in ranges[0]:
        for ry in ranges[1]:
            for rx in ranges[2]:
                hits[rz, ry, rx] += 1
    assert (hits == 1).all()


def layer_launch(shape, p, txc, tyc, g, slots):
    """The layer march's launch and runs as ``csrc/brick_kron.cuh`` makes
    them (launch_layer, brick_layer_kernel, layer_run) for a tile of txc x
    tyc cells and g planes a group on a card of ``slots`` block slots:
    node hits, and per run its groups' planes and z sweeps (layer base,
    emits) with the ring slot of every plane each z sweep reads."""
    Z, Y, X = shape
    TX, TY, R = txc * p, tyc * p, p + 1
    tiles_x, tiles_y = (X - 2) // TX + 1, (Y - 2) // TY + 1
    cells_z = (Z - 1) // p
    units = tiles_x * tiles_y * cells_z
    nwork = min(units, slots)
    hits = np.zeros(shape, dtype=np.int64)
    # the blocks in front: the node planes x = X - 1, y = Y - 1 where the
    # tiles end one node short of them
    xrem, yrem = tiles_x * TX == X - 1, tiles_y * TY == Y - 1
    if xrem:
        hits[:, :, X - 1] += 1
    if yrem:
        hits[:, Y - 1, :X - 1 if xrem else X] += 1
    runs = []
    for bid in range(nwork):
        u, u_end = bid * units // nwork, (bid + 1) * units // nwork
        while u < u_end:
            tile, c0 = divmod(u, cells_z)
            c1 = min(cells_z, c0 + (u_end - u))
            u += c1 - c0
            x0, y0 = tile % tiles_x * TX, tile // tiles_x * TY
            o = c0 * p
            jstart = 1 - g if c0 == 0 else o - p - g + 1
            ngroups = (c1 * p - jstart + 1) // g
            zfirst = 0 if c0 == 0 else o - p
            ring, groups, sweeps = [None] * R, [], []
            for gi in range(ngroups):
                jg = jstart + gi * g
                groups.append(list(range(jg, jg + g)))
                for j in range(jg, jg + g):
                    ring[(j + 2 * R) % R] = j
                bz = jg + g - 1 - p
                if gi % (p // g) or bz < zfirst:
                    continue
                slot0 = (bz + 2 * R) % R
                read = [ring[slot0 + s if slot0 + s < R else slot0 + s - R]
                        for s in range(R)]
                sweeps.append((bz, bz >= o, read))
                if bz >= o:
                    hits[bz:bz + p, y0:y0 + TY, x0:x0 + TX] += 1
            if c1 == cells_z:
                hits[Z - 1, y0:y0 + TY, x0:x0 + TX] += 1
            runs.append(dict(c0=c0, c1=c1, groups=groups, sweeps=sweeps))
    return hits, runs


@pytest.mark.parametrize("p", [8, 9])
@pytest.mark.parametrize("cells", [(1, 1, 1), (3, 3, 3), (5, 7, 3), (2, 1, 4),
                                   (4, 8, 4), (9, 5, 12)])
def test_layer_march_covers_every_node_once(p, cells):
    """The layer march's ownership (``csrc/brick_kron.cuh``: launch_layer,
    brick_layer_kernel, layer_run), for its tile at p = 8, 9 (4 x 3 / 4 x 4
    cells, 4 / 3 planes a group) and others, on one block slot up to more than
    there are units: each node of the grid is written exactly once (tiles
    partial at the x / y ends or ending one node short, a one-cell axis,
    runs that end in one tile and go on in the next); a run's groups are
    its planes from the halo below it up to its top vertex plane, each
    once, in order; its z sweeps are at every layer from the one below
    it (only to start the carry) or from layer 0, and each reads the
    layer's planes base .. base + p from the ring, ascending."""
    shape = tuple(c * p + 1 for c in cells)
    tile = (4, 4, 3) if p == 9 else (4, 3, 4)   # LayerShape<p>
    for txc, tyc, g in (tile, (4, 2, p), (1, 3, 1)):
        for slots in (1, 7, 132, 10**6):
            hits, runs = layer_launch(shape, p, txc, tyc, g, slots)
            assert (hits == 1).all(), (txc, tyc, g, slots)
            for r in runs:
                c0, c1 = r["c0"], r["c1"]
                planes = [j for grp in r["groups"] for j in grp]
                low = (1 - g) if c0 == 0 else c0 * p - p - g + 1
                assert planes == list(range(low, c1 * p + 1))
                bases = [bz for bz, _, _ in r["sweeps"]]
                assert bases == list(range(0 if c0 == 0 else c0 * p - p,
                                           c1 * p - p + 1, p))
                for bz, emit, read in r["sweeps"]:
                    assert emit == (bz >= c0 * p)
                    assert read == list(range(bz, bz + p + 1))


def test_brick_form_follows_degree_type_and_grid():
    """The march below p = 8; at p = 8, 9 the cell form on every double
    grid and on the float grids up to F32_CELL_FORM_MAX_CELLS[p] cells
    (the coarse levels, where a V-cycle takes most of its steps), the
    layer march on the float grids above; both float forms are reached
    on the p = 8, 9 hierarchies (the cube rows and poisson_dg's FE_Q(p)
    ladder at size 24)."""
    f32, f64 = torch.float32, torch.float64
    seen = set()
    for p, sizes in ((8, (32, 24)), (9, (28, 24))):
        for size in sizes:
            mesh = poisson_cube_mesh(size)
            for level in range(mesh.n_levels):
                shape = DofGrid(mesh, level, p).shape
                cells = int(np.prod([(n - 1) // p for n in shape]))
                assert lk.brick_form(shape, p, f64) == "cell"
                want = ("cell" if cells <= lk.F32_CELL_FORM_MAX_CELLS[p]
                        else "layer")
                assert lk.brick_form(shape, p, f32) == want
                seen.add((p, want))
        assert lk.brick_form(DofGrid(poisson_cube_mesh(8), 0, p).shape, p,
                             f32) == "cell"
    assert seen == {(p, f) for p in (8, 9) for f in ("cell", "layer")}
    for p in range(1, lk.CELL_DEGREE):
        shape = DofGrid(poisson_cube_mesh(4), 0, p).shape
        assert lk.brick_form(shape, p, f32) == "march"
        assert lk.brick_form(shape, p, f64) == "march"
