"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need an NVIDIA GPU (and ``nvcc`` to build
``multigrid_tpu_torch/csrc``), and skip without one.  Run them on the card
with ``python -m pytest tests/test_torch_cuda.py -q``.  Bars as in
chip_smoke.py: brick_kron against the dense plain f64 path at 1e-13
(double) / 2e-6 (float) of max|y| for apply, vmult and residual, the fused
Chebyshev step on the smoother's iterates at 1e-12 (double) / 3e-6
(float) of max|out|; the f32 epilogue 3e-6 of max|out|; the CG vector
kernels 1e-14; the DG kernels against the plain f64 operator (and the
face-based one) at 1e-13 (dg_apply<double>, apply and residual), 3e-6
(dg_apply<float>) of max|A x| and 1e-5 of max|out| (dg_cheb<float>, on
the smoother's iterates; 1e-6 of max|x| with f2 = 0), at p = 1..16 and on
ragged pencils, and their outputs on seeded inputs bit for bit as
``DG_DIGESTS`` pins them; at p = 8, 9, where the step (and at p = 8 the
double apply) are the kernels of ``csrc/dg_pencil_high.cu``, also on
one-cell axes, ragged pencils and many pencils, every launch of those
theirs, none spilling; at p = 10..16, the pencils of
``csrc/dg_pencil_wide*.cu``, on the same kinds of grids, each kernel's
tile within a block's shared memory (232,448 B).
Every compiled degree of brick_kron (p = 1..16; p = 10..16 the z-slab
march of ``brick_kron_wide*.cu``, bit for bit as ``KRON_WIDE_DIGESTS``
pins it) and of the DG kernels (p = 1..16) is held.  The launch counters
count device kernels: 1 per brick_kron call, 2 per reduction, 1 per
xpay, 1 per DG kernel call.  The
size-4 FE_Q, DG and pure-DG (DGPlain) solves on the card agree with the
CPU to 1e-5 of max|u|; the f32 ``DGTransfer`` on the card agrees with the
f64 one to 1e-6 of max; a DGPlain solve launches K7, K8, K9 and the CG
kernels and no brick kernel.  The plain PyTorch operators of the curved DG
and adaptive paths on the card agree with the CPU (1e-13 in f64, 2e-6 in
f32); their solves launch only the CG kernels, and two adaptive CG solves
on the card are bit for bit equal.  The plain routes of the one-device
configurations the kernels do not cover: 2-D DG-plain (16^2 cells, p = 3,
every kind; its within one, frac its and L2 to 1% of the CPU's) and the
2-D brick (FMG to 1e-5 of max|u|, CG its equal, reduction to 2%) launch
only the CG kernels; a p = 17 ``matvec_dg`` row runs the plain operator at
the driver's bars; a checkpoint of card tensors reads back bit for bit;
``device_memory_stats`` reads the allocator on the card (in use <= peak
< the card's memory, peak >= the solver's level tensors).  Ranks of
``torch.distributed`` sharing the card (gloo): the collected distributed
``vmult`` equals ``BrickLaplace`` on the whole grid bit for bit in float
and double; a 2-rank size-8 solve gives the one-device CG its, reduction
to 1e-4 and solution to 1e-9 of max|u|, two CG solves bit for bit, and
launches every kernel of the cube path; one rank on nccl is the
one-device solver bit for bit, and nccl with more ranks than cards
raises.  The DG solvers on 2 gloo ranks sharing the card (size 8, p = 4):
the owned cells of the slab's dg_apply<double> (K9), dg_residual<float>
(K7) and dg_cheb<float> (K8), their inputs' ghost layers through the
traces wire, are those of DGOperator on the whole grid bit for bit, and
of the plain JAX algorithm (``vmult_plain``) to 1e-13 of max|y|; the
hermite wire's owned cells (z split and a 2 x 2 rank grid) within 1e-12
of max|y| in f64; each solve launches K7, K8, K9 and the CG kernels, and
gives the one-device frac its to 5%, rate to 1e-3 and L2 to 1e-6
relative."""

import numpy as np
import pytest
import torch

from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid, poisson_cube_mesh
from multigrid_tpu_torch.ops.dg_kernel import HIGH_CELLS, MARCH_CELLS

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multigrid_tpu_torch import _build

    _build.library()
    return torch.device("cuda", 0)


def rand(shape, dtype, dev, seed):
    a = np.random.default_rng(seed).standard_normal(shape)
    return torch.as_tensor(a, dtype=dtype, device=dev)


def brick(cells, p):
    return DofGrid(BrickMesh(cells, (-0.9,) * 3, (1.9, 1.3, 1.1)), 0, p)


GRIDS = {"cube8": lambda: DofGrid(poisson_cube_mesh(8), 3, 4),
         "aniso": lambda: brick((3, 4, 5), 4),
         "p2": lambda: DofGrid(poisson_cube_mesh(4), 2, 2)}
# brick_kron's cases: every degree 1..9 (4 and 2 in GRIDS, 5 in
# tiles_p5), a one-cell axis, node counts that do not divide the tile,
# several tiles in x and y
KRON_GRIDS = dict(GRIDS, **{
    "cube8_p1": lambda: DofGrid(poisson_cube_mesh(8), 3, 1),
    "cube8_p3": lambda: DofGrid(poisson_cube_mesh(8), 3, 3),
    "cube4_p6": lambda: DofGrid(poisson_cube_mesh(4), 2, 6),
    "cube4_p7": lambda: DofGrid(poisson_cube_mesh(4), 2, 7),
    "cube4_p8": lambda: DofGrid(poisson_cube_mesh(4), 2, 8),
    "cube4_p9": lambda: DofGrid(poisson_cube_mesh(4), 2, 9),
    "one_cell_axis_p9": lambda: brick((1, 4, 3), 9),
    "tiles_p8": lambda: brick((2, 5, 9), 8),
    "tiles_p9": lambda: brick((3, 6, 9), 9),
    "one_cell_axis": lambda: brick((1, 4, 3), 4),
    "one_cell_axis_p1": lambda: brick((1, 4, 3), 1),
    "ragged_p3": lambda: brick((7, 5, 9), 3),
    "tiles_p4": lambda: brick((3, 12, 20), 4),
    "tiles_p5": lambda: brick((2, 9, 11), 5),
    # the coarse grids of the p = 8, 9 hierarchies (poisson_cube size 28
    # at p = 9, poisson_dg size 24 at p = 9 and 8, poisson_cube size 32 at
    # p = 8) and grids ragged in both x and y
    "coarse_cube28_p9": lambda: brick((7, 7, 7), 9),
    "coarse_dg24_p9": lambda: brick((3, 3, 3), 9),
    "coarse_dg24_p8": lambda: brick((3, 3, 3), 8),
    "coarse_cube32_p8": lambda: brick((1, 1, 1), 8),
    "ragged_xy_p9": lambda: brick((5, 7, 3), 9),
    "ragged_xy_p8": lambda: brick((5, 7, 3), 8),
    # p = 10..16 (the z-slab march in both types): several tiles in x and
    # y, one-cell axes, grids ragged against the tile, at every degree
    "cube2_p10": lambda: brick((2, 2, 2), 10),
    "tiles_p10": lambda: brick((3, 4, 7), 10),
    "tiles_p11": lambda: brick((2, 3, 5), 11),
    "ragged_p12": lambda: brick((3, 2, 4), 12),
    "ragged_p13": lambda: brick((3, 2, 4), 13),
    "one_cell_axis_p14": lambda: brick((1, 3, 2), 14),
    "cube2_p15": lambda: brick((2, 2, 2), 15),
    "one_cell_axis_p16": lambda: brick((1, 3, 2), 16),
    "cube2_p16": lambda: brick((2, 2, 2), 16)})


# value type -> (name in LAUNCHES, bar of apply / vmult / residual, bar of
# the Chebyshev step)
KRON = {torch.float64: ("double", 1e-13, 1e-12),
        torch.float32: ("float", 2e-6, 3e-6)}


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_brick_apply_matches_plain(dev, grid, dtype):
    """op.apply against the dense plain version: brick_kron in the
    operator's dtype, one launch."""
    from multigrid_tpu_torch.ops import laplace_kernel as lk

    g = GRIDS[grid]()
    op = lk.BrickLaplace(g, dtype, dev)
    x = rand(g.shape, dtype, dev, 1)
    cname, tol, _ = KRON[dtype]
    before = lk.LAUNCHES[f"brick_kron<{cname}>"]
    y = op.apply(x)
    assert lk.LAUNCHES[f"brick_kron<{cname}>"] - before == 1
    want = lk.brick_apply_plain(x, op.K)
    torch.cuda.synchronize()
    assert float((y - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("grid", sorted(KRON_GRIDS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_brick_kron_modes_match_plain(dev, grid, dtype):
    """brick_kron in its four modes against the dense plain path in f64:
    apply, vmult and residual at the dtype's bar of the largest output
    (max|y| for apply; at least that for the others), the Chebyshev step
    on the smoother's iterates at its bar of max|out|, with x_old, with
    x_old = None and in place into x_old; one launch per call, bit-for-bit
    repeatable."""
    from multigrid_tpu_torch.ops import laplace_kernel as lk

    cname, tol, tol_cheb = KRON[dtype]
    g = KRON_GRIDS[grid]()
    op = lk.BrickLaplace(g, dtype, dev)
    op64 = lk.BrickLaplace(g, torch.float64, dev)
    x = rand(g.shape, torch.float32, dev, 1).to(dtype)
    x64 = x.double()
    y = lk.brick_apply_plain(x64, op64.K)
    b = rand(g.shape, torch.float32, dev, 2).to(dtype)
    wants = {"apply": y, "vmult": torch.where(op64.interior, y, x64),
             "residual": lk.cheb_epilogue_plain(b.double(), y, x=x64,
                                                residual_only=True)}
    lk.reset_launches()
    for mode, want in wants.items():
        got = lk.brick_kron(x, op, mode, b=b)
        torch.cuda.synchronize()
        assert float((got.double() - want).abs().max()) \
            <= tol * float(want.abs().max()), mode
    assert torch.equal(lk.brick_kron(x, op, "apply"), op.apply(x))

    b, xc, xo = lk.smoother_iterates(op64, 3)
    bt, xct, xot = (t.to(dtype) for t in (b, xc, xo))
    y = lk.brick_apply_plain(xc, op64.K)
    for xold in (xo, None):
        want = lk.cheb_epilogue_plain(b, y, xc, xold, op64.lines, 0.37, 0.81)
        got = lk.brick_kron(xct, op, "cheb", b=bt,
                            x_old=None if xold is None else xot,
                            f1=0.37, f2=0.81)
        torch.cuda.synchronize()
        assert float((got.double() - want).abs().max()) \
            <= tol_cheb * float(want.abs().max())
    first = lk.brick_kron(xct, op, "cheb", b=bt, x_old=xot, f1=0.37, f2=0.81)
    alias = xot.clone()
    assert op.cheb_step(bt, xct, alias, 0.37, 0.81, out=alias) is alias
    assert torch.equal(alias, first)
    assert lk.LAUNCHES[f"brick_kron<{cname}>"] == 5
    assert lk.LAUNCHES[f"brick_kron_cheb<{cname}>"] == 4
    assert sum(lk.LAUNCHES.values()) == 9


# brick_kron at p = 8, 9 on seeded inputs: sha256 (first 16 hex digits) of
# each mode's output, recorded on an H100 from the z-slab march, the only
# form these degrees had before the cell form (csrc/brick_kron.cuh).  The
# cell form sums every node's taps in the march's order, so either form
# gives the same bits.
KRON_HIGH_CASES = ("cube4_p8", "cube4_p9", "one_cell_axis_p9", "tiles_p8",
                   "tiles_p9", "coarse_cube28_p9", "coarse_dg24_p9",
                   "coarse_dg24_p8", "coarse_cube32_p8", "ragged_xy_p9",
                   "ragged_xy_p8")
KRON_HIGH_DIGESTS = {
    "cube4_p8 float apply": "a5cd0df7e93987dc",
    "cube4_p8 float vmult": "fabee234cd1133d6",
    "cube4_p8 float residual": "2debc4a193617756",
    "cube4_p8 float cheb": "f67f35482139b3d6",
    "cube4_p8 double apply": "33228f2adf18279b",
    "cube4_p8 double vmult": "1d3122a37c291db0",
    "cube4_p8 double residual": "7450156a31b91cb4",
    "cube4_p8 double cheb": "821e4e58bbae159e",
    "cube4_p9 float apply": "d51b087ecb7cbc68",
    "cube4_p9 float vmult": "43a730a4009e696f",
    "cube4_p9 float residual": "1a4a0bddaa7ec497",
    "cube4_p9 float cheb": "0f336295d9c3ae5a",
    "cube4_p9 double apply": "17c20815b25c23d5",
    "cube4_p9 double vmult": "33e1da54d21886d3",
    "cube4_p9 double residual": "f54a30d5bd88d7c4",
    "cube4_p9 double cheb": "bfa5f39960cc1306",
    "one_cell_axis_p9 float apply": "d0e11565e015d879",
    "one_cell_axis_p9 float vmult": "151cdd2e1677a265",
    "one_cell_axis_p9 float residual": "fa0b4c24d5813a77",
    "one_cell_axis_p9 float cheb": "757d74f04322ee5d",
    "one_cell_axis_p9 double apply": "bad3b49a42c502ce",
    "one_cell_axis_p9 double vmult": "acbf2499f27e2fc6",
    "one_cell_axis_p9 double residual": "0dcdc83bda28fdd6",
    "one_cell_axis_p9 double cheb": "085a981f5af0aa78",
    "tiles_p8 float apply": "585e2471ad891cc4",
    "tiles_p8 float vmult": "ab03bb940d485648",
    "tiles_p8 float residual": "dec5bd59c6849871",
    "tiles_p8 float cheb": "3356630b5742aa95",
    "tiles_p8 double apply": "b853fe10fdff7832",
    "tiles_p8 double vmult": "0b9dda1314b5b501",
    "tiles_p8 double residual": "3811df83bd6e482b",
    "tiles_p8 double cheb": "b0888c6472e7f609",
    "tiles_p9 float apply": "c9c81738d332e398",
    "tiles_p9 float vmult": "e04fb958f3bb8a67",
    "tiles_p9 float residual": "b8b2bd002e1ef62b",
    "tiles_p9 float cheb": "6423632238172015",
    "tiles_p9 double apply": "475da2a9639cbc13",
    "tiles_p9 double vmult": "b765fe76d8a08cc3",
    "tiles_p9 double residual": "6dc82160e94d3e2e",
    "tiles_p9 double cheb": "74da1f6c98f1cf15",
    "coarse_cube28_p9 float apply": "852b4707c1d76750",
    "coarse_cube28_p9 float vmult": "39a944bc506120e1",
    "coarse_cube28_p9 float residual": "9eb30200108ddd46",
    "coarse_cube28_p9 float cheb": "123aa99e42be7bdb",
    "coarse_cube28_p9 double apply": "aa52a3ef381aa81b",
    "coarse_cube28_p9 double vmult": "ce7f455845a6d1e2",
    "coarse_cube28_p9 double residual": "e28f6ff8393ec314",
    "coarse_cube28_p9 double cheb": "69bb8291d38a46e3",
    "coarse_dg24_p9 float apply": "1eb503fd8a0a290a",
    "coarse_dg24_p9 float vmult": "52258aa5c8fc0df3",
    "coarse_dg24_p9 float residual": "8e74883cce440718",
    "coarse_dg24_p9 float cheb": "ea51820983ceb9d3",
    "coarse_dg24_p9 double apply": "85157a31e069ce29",
    "coarse_dg24_p9 double vmult": "2cb9d07afa6d7cb2",
    "coarse_dg24_p9 double residual": "e268321198e9448e",
    "coarse_dg24_p9 double cheb": "6d65dbf71d434b9a",
    "coarse_dg24_p8 float apply": "aa8bac595d2b9a85",
    "coarse_dg24_p8 float vmult": "98384382b9e6d31c",
    "coarse_dg24_p8 float residual": "21baee550157ee81",
    "coarse_dg24_p8 float cheb": "9a888a7ddad63bea",
    "coarse_dg24_p8 double apply": "3dc4e0ac7f9df85e",
    "coarse_dg24_p8 double vmult": "4fef7afd0a80dab3",
    "coarse_dg24_p8 double residual": "214d3d54491782e1",
    "coarse_dg24_p8 double cheb": "9cdf117a248abd6c",
    "coarse_cube32_p8 float apply": "8d2accc8c71d02f3",
    "coarse_cube32_p8 float vmult": "a9109e87e6e119d8",
    "coarse_cube32_p8 float residual": "0b2f057ba0ac6504",
    "coarse_cube32_p8 float cheb": "636c329ecf222543",
    "coarse_cube32_p8 double apply": "0226c3a6e324bb3b",
    "coarse_cube32_p8 double vmult": "17bf9fc5894f02f6",
    "coarse_cube32_p8 double residual": "e785f070b29b61c6",
    "coarse_cube32_p8 double cheb": "7fefdd866dcb6432",
    "ragged_xy_p9 float apply": "c5459fa087aae27a",
    "ragged_xy_p9 float vmult": "97d3c89998bac609",
    "ragged_xy_p9 float residual": "0e34f5b02e694333",
    "ragged_xy_p9 float cheb": "f267494b3d06b122",
    "ragged_xy_p9 double apply": "33ad5054d019dfd1",
    "ragged_xy_p9 double vmult": "00ec37918ba0c4f8",
    "ragged_xy_p9 double residual": "6cad4e4478a1548e",
    "ragged_xy_p9 double cheb": "e1694af62ef8b57d",
    "ragged_xy_p8 float apply": "af0a0aa3a3990c60",
    "ragged_xy_p8 float vmult": "89fedd4bbf300280",
    "ragged_xy_p8 float residual": "8e251845e6265089",
    "ragged_xy_p8 float cheb": "8c0c40abe31e6713",
    "ragged_xy_p8 double apply": "5c5d15afe4791de6",
    "ragged_xy_p8 double vmult": "49f264bbb1da1c32",
    "ragged_xy_p8 double residual": "a29c119c7242d3a1",
    "ragged_xy_p8 double cheb": "e1cdfb2a88c25f3b",
}


def kron_high_digests(dev, cases=KRON_HIGH_CASES) -> dict:
    """"<case> <type> <mode>" -> the digest of brick_kron's output at
    ``cases`` on the inputs of seeds 1 (x), 2 (b), 3 (x_old), f1 = 0.37,
    f2 = 0.81."""
    import hashlib

    from multigrid_tpu_torch.ops import laplace_kernel as lk

    out = {}
    for case in cases:
        g = KRON_GRIDS[case]()
        for dtype in (torch.float32, torch.float64):
            op = lk.BrickLaplace(g, dtype, dev)
            x, b, xo = (rand(g.shape, dtype, dev, s) for s in (1, 2, 3))
            for mode in lk.KRON_MODES:
                y = lk.brick_kron(x, op, mode, b=b, x_old=xo, f1=0.37,
                                  f2=0.81)
                out[f"{case} {KRON[dtype][0]} {mode}"] = hashlib.sha256(
                    y.cpu().numpy().tobytes()).hexdigest()[:16]
    return out


@pytest.mark.parametrize("form", ["cell", "march", "layer"])
def test_brick_kron_high_degree_is_the_march_bit_for_bit(dev, form,
                                                         monkeypatch):
    """At p = 8, 9 every mode in both types gives the outputs the z-slab
    march gave, bit for bit, on the hierarchies' coarse grids, grids with
    a one-cell axis and grids of several cells on every axis: float in
    each form (the z-slab march, the cell form, the layer march), double
    in its cell form; the march in double is refused there."""
    from multigrid_tpu_torch.ops import laplace_kernel as lk

    auto = lk.brick_form
    monkeypatch.setattr(lk, "brick_form", lambda shape, p, dtype: (
        form if dtype == torch.float32 else auto(shape, p, dtype)))
    assert kron_high_digests(dev) == KRON_HIGH_DIGESTS
    monkeypatch.setattr(lk, "brick_form", lambda shape, p, dtype: "march")
    g = KRON_GRIDS["coarse_dg24_p9"]()
    op = lk.BrickLaplace(g, torch.float64, dev)
    with pytest.raises(RuntimeError, match="cudaError"):
        lk.brick_kron(rand(g.shape, torch.float64, dev, 1), op)


# brick_kron at p = 10..16 on the inputs of kron_high_digests: sha256
# (first 16 hex digits) of each mode's output, recorded on an H100 from the
# z-slab march of csrc/brick_kron_wide*.cu (chip_smoke.py pins the same)
KRON_WIDE_CASES = ("cube2_p10", "one_cell_axis_p16", "tiles_p10",
                   "tiles_p11", "ragged_p13", "cube2_p16")
KRON_WIDE_DIGESTS = {
    "cube2_p10 float apply": "d18bfeffe84b9d1a",
    "cube2_p10 float vmult": "d38a0dc276f38469",
    "cube2_p10 float residual": "512e7977d6cc7693",
    "cube2_p10 float cheb": "4c17401b23586f49",
    "cube2_p10 double apply": "10980282e66a3dd3",
    "cube2_p10 double vmult": "25f2fcc6853a1f36",
    "cube2_p10 double residual": "f2db088aa0b3bf5f",
    "cube2_p10 double cheb": "f42cffda6d16cac0",
    "one_cell_axis_p16 float apply": "138c913cd63a8382",
    "one_cell_axis_p16 float vmult": "d2b9da31b361668a",
    "one_cell_axis_p16 float residual": "8f571344ac399681",
    "one_cell_axis_p16 float cheb": "ca24f68401914190",
    "one_cell_axis_p16 double apply": "97a802e2d406a516",
    "one_cell_axis_p16 double vmult": "9eedc5cdd2a880e0",
    "one_cell_axis_p16 double residual": "fee2c8d1d1372dc3",
    "one_cell_axis_p16 double cheb": "84cdd9a2a336aff8",
    "tiles_p10 float apply": "d6aea056670b3d29",
    "tiles_p10 float vmult": "be21f2869a66e4e2",
    "tiles_p10 float residual": "8e7b8d24b6004288",
    "tiles_p10 float cheb": "5b731a94a904b646",
    "tiles_p10 double apply": "1dc9460d044683fe",
    "tiles_p10 double vmult": "7ba25dc59ac330d5",
    "tiles_p10 double residual": "f08b243f52a1f525",
    "tiles_p10 double cheb": "a18cb5ca964d65b3",
    "tiles_p11 float apply": "e39f6c5487c55e86",
    "tiles_p11 float vmult": "9eada12b52c482a6",
    "tiles_p11 float residual": "2c9e9b701d6904d0",
    "tiles_p11 float cheb": "5f05570099aad7c2",
    "tiles_p11 double apply": "0afa41516346ef1a",
    "tiles_p11 double vmult": "87d883286efced23",
    "tiles_p11 double residual": "069e6eadf124c17a",
    "tiles_p11 double cheb": "997352cdfe032088",
    "ragged_p13 float apply": "e015aebef2a9621b",
    "ragged_p13 float vmult": "2ce4fb7e74617230",
    "ragged_p13 float residual": "7f2b645f981ef7cb",
    "ragged_p13 float cheb": "a0c110b9d8422a62",
    "ragged_p13 double apply": "467e1849979d1c82",
    "ragged_p13 double vmult": "b809a8a7d39947f4",
    "ragged_p13 double residual": "4ba7a64d47ff9848",
    "ragged_p13 double cheb": "ea13f8925f52e873",
    "cube2_p16 float apply": "20bebad61efe7f00",
    "cube2_p16 float vmult": "07e43775960eea5b",
    "cube2_p16 float residual": "416aee5be43202ad",
    "cube2_p16 float cheb": "8c40de7d5e554446",
    "cube2_p16 double apply": "a6084f199c059e71",
    "cube2_p16 double vmult": "36eb337778eb49e8",
    "cube2_p16 double residual": "f2448168aad5a24f",
    "cube2_p16 double cheb": "ec3a9ea5220fe916",
}


def test_brick_kron_wide_degrees_keep_their_bits(dev):
    """At p = 10..16 every mode in both types gives the pinned outputs bit
    for bit, on cubes of 2^3 cells, a one-cell axis and grids of several
    tiles; the cell form is refused there (its neighbourhood outgrows a
    block)."""
    from multigrid_tpu_torch.ops import laplace_kernel as lk

    assert kron_high_digests(dev, KRON_WIDE_CASES) == KRON_WIDE_DIGESTS
    g = KRON_GRIDS["cube2_p10"]()
    op = lk.BrickLaplace(g, torch.float64, dev)
    lk.brick_form, auto = (lambda shape, p, dtype: "cell"), lk.brick_form
    try:
        with pytest.raises(RuntimeError, match="cudaError"):
            lk.brick_kron(rand(g.shape, torch.float64, dev, 1), op)
    finally:
        lk.brick_form = auto


@pytest.mark.parametrize("p, cells", [(8, 16), (9, 28)])
def test_brick_kron_layer_is_the_march_bit_for_bit_on_large_grids(dev, p,
                                                                  cells):
    """Above the cell form's grids (129^3 nodes at p = 8, where the tiles
    leave the node plane x = X - 1 to the Dirichlet blocks; 253^3 at p = 9,
    x = X - 1 and y = Y - 1) the layer march gives the z-slab march's
    outputs bit for bit in all four modes, and it is the form
    ``brick_form`` picks there."""
    from multigrid_tpu_torch.ops import laplace_kernel as lk

    g = DofGrid(poisson_cube_mesh(cells), poisson_cube_mesh(cells).max_level,
                p)
    op = lk.BrickLaplace(g, torch.float32, dev)
    x, b, xo = (rand(g.shape, torch.float32, dev, s) for s in (1, 2, 3))
    assert lk.brick_form(g.shape, p, torch.float32) == "layer"
    auto = lk.brick_form
    try:
        for mode in lk.KRON_MODES:
            outs = {}
            for form in ("march", "layer"):
                lk.brick_form = lambda shape, q, dtype, form=form: form
                outs[form] = lk.brick_kron(x, op, mode, b=b, x_old=xo,
                                           f1=0.37, f2=0.81)
            assert torch.equal(outs["march"], outs["layer"]), mode
    finally:
        lk.brick_form = auto


@pytest.mark.parametrize("residual_only", [True, False])
def test_cheb_epilogue_matches_plain(dev, residual_only):
    from multigrid_tpu_torch.ops import laplace_kernel as lk

    g = GRIDS["aniso"]()
    op = lk.BrickLaplace(g, torch.float32, dev)
    b, y, x, xo = (rand(g.shape, torch.float32, dev, s) for s in range(4))
    args = dict(x=x, x_old=xo, lines=op.lines, f1=0.37, f2=0.81,
                residual_only=residual_only)
    got = lk.cheb_epilogue(b, y, **args)
    want = lk.cheb_epilogue_plain(b, y, **args)
    assert float((got - want).abs().max()) <= 3e-6 * float(want.abs().max())
    # in place into x_old
    out = lk.cheb_epilogue(b, y, **dict(args, out=xo.clone()))
    assert torch.equal(out, got)


def test_cg_kernels_match_plain(dev):
    from multigrid_tpu_torch.ops import cg_kernel as ck

    ck.reset_launches()
    n = 100_003
    x, r, p, q = (rand((n,), torch.float64, dev, s) for s in range(4))
    x1, r1, x2, r2 = x.clone(), r.clone(), x.clone(), r.clone()
    rr = ck.cg_update(x1, r1, p, q, 0.7)
    rr_ref = ck.cg_update_plain(x2, r2, p, q, 0.7)
    assert float((x1 - x2).abs().max()) <= 1e-14 * float(x2.abs().max())
    assert abs(float(rr) - float(rr_ref)) <= 1e-14 * float(rr_ref)
    p1, p2 = p.clone(), p.clone()
    ck.cg_xpay(p1, r, 0.3)
    ck.cg_xpay_plain(p2, r, 0.3)
    assert float((p1 - p2).abs().max()) <= 1e-14 * float(p2.abs().max())
    d = ck.cg_dot(x, q)
    d_ref = ck.cg_dot_plain(x, q)
    assert abs(float(d) - float(d_ref)) <= 1e-14 * float((x * q).abs().sum())
    assert ck.LAUNCHES == {"cg_update": 2, "cg_dot": 2, "cg_xpay": 1}


@pytest.mark.parametrize("n,p_off,z_off", [(100_003, 0, 0), (100_003, 1, 1),
                                           (100_004, 1, 0), (1, 0, 0),
                                           (2, 1, 1), (7, 0, 1)])
def test_cg_xpay_ragged(dev, n, p_off, z_off):
    """cg_xpay on odd n and on views that start off a 16-byte boundary
    (the same phase for p and z: the double2 body with a scalar head; a
    different phase: the scalar loop), bit for bit against the plain
    version, which rounds alike (one multiply, one add)."""
    from multigrid_tpu_torch.ops import cg_kernel as ck

    p = rand((n + 1,), torch.float64, dev, 5)[p_off:p_off + n]
    z = rand((n + 1,), torch.float64, dev, 6)[z_off:z_off + n]
    assert p.data_ptr() % 16 == 8 * p_off and z.data_ptr() % 16 == 8 * z_off
    want = ck.cg_xpay_plain(p.clone(), z, 0.3)
    before = ck.LAUNCHES["cg_xpay"]
    assert ck.cg_xpay(p, z, 0.3) is p
    assert ck.LAUNCHES["cg_xpay"] - before == 1
    torch.cuda.synchronize()
    assert float((p - want).abs().max()) <= 1e-14 * float(want.abs().max())


def test_solver_on_card_matches_cpu(dev):
    from multigrid_tpu_torch.experiments.poisson_cube import build_solver

    u_gpu = build_solver(poisson_cube_mesh(4), 4, device=dev).solve().cpu()
    u_cpu = build_solver(poisson_cube_mesh(4), 4, device="cpu").solve()
    assert float((u_gpu - u_cpu).abs().max()) <= 1e-5 * float(u_cpu.abs().max())


def dg_grid(cells, p, kind, seed=0):
    """The sheared affine DG grid of tests/test_pallas_dg.py:20-25."""
    from multigrid_tpu_torch.ops.dg import DGGrid

    rng = np.random.default_rng(seed)
    J = np.diag(1.0 / np.array(cells)) @ (np.eye(3) + 0.08 * rng.random((3, 3)))
    return DGGrid(cells=cells, jacobian=tuple(map(tuple, J)), degree=p,
                  kind=kind)


@pytest.mark.parametrize("cells", [(3, 2, 4), (4, 1, 3), (1, 1, 1)])
@pytest.mark.parametrize("p", range(1, 10))
@pytest.mark.parametrize("kind", ["hermite", "gll", "gauss"])
def test_dg_kernels_match_plain(dev, kind, p, cells):
    """dg_apply<double> against the plain f64 operator at 1e-13·max|y|;
    dg_apply<float> against it at 3e-6·max|y|; dg_cheb<float> against the
    plain f64 step on the smoother's iterates (every term at the output's
    scale) at 1e-5·max|out|, with x, without x, without x_old, with f2 = 0
    at 1e-6·max|x|, and in place into x_old.  One device kernel per call."""
    from multigrid_tpu_torch.ops import dg_kernel as dk
    from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed

    g = dg_grid(cells, p, kind)
    ops = {}
    for dtype in (torch.float64, torch.float32):
        ops[dtype] = dk.DGOperator(g, dtype, dev)
        ops[dtype].install_jacobi(JacobiTransformed(g, dtype, dev))
    x = rand(g.shape, torch.float32, dev, 0)
    d = lambda t: t.double()
    want = dk.dg_apply_plain(d(x), ops[torch.float64])
    scale = float(want.abs().max())
    dk.reset_launches()
    y64 = dk.dg_apply(d(x), ops[torch.float64])
    y32 = dk.dg_apply(x, ops[torch.float32])
    torch.cuda.synchronize()
    assert float((y64 - want).abs().max()) <= 1e-13 * scale
    assert float((d(y32) - want).abs().max()) <= 3e-6 * scale

    op32, op64 = ops[torch.float32], ops[torch.float64]
    b, x, xo = dk.smoother_iterates(op64.jacobi, 3)
    for args in ((x, xo, 0.37, 0.81), (None, None, 0.0, 0.81), (x, None, 0.0, 0.5),
                 (x, xo, 0.37, 0.0)):
        xa, xoa, f1, f2 = args
        got = dk.dg_cheb(b, xa, xoa, op32, f1, f2)
        want = dk.dg_cheb_plain(d(b), None if xa is None else d(xa),
                                None if xoa is None else d(xoa), op64, f1, f2)
        torch.cuda.synchronize()
        bar = 1e-5 * float(want.abs().max()) if f2 else 1e-6 * float(x.abs().max())
        assert float((d(got) - want).abs().max()) <= bar
    out = dk.dg_cheb(b, x, xo.clone(), op32, 0.37, 0.81)
    alias = xo.clone()
    assert dk.dg_cheb(b, x, alias, op32, 0.37, 0.81, out=alias) is alias
    assert torch.equal(alias, out)
    assert dk.LAUNCHES == {"dg_apply<double>": 1, "dg_apply<float>": 1,
                           "dg_cheb<float>": 6, "dg_cg<double>": 0,
                           "dg_jacobi_cg<double>": 0}


@pytest.mark.parametrize("cells", [(3, 2, 5), (2, 3, 1), (5, 4, 9),
                                   (3, 2, 4)])
@pytest.mark.parametrize("p", range(1, 10))
@pytest.mark.parametrize("kind", ["hermite", "gll", "gauss"])
def test_dg_apply_residual_every_degree(dev, kind, p, cells):
    """dg_apply and dg_residual (b - A x) in double and float at every
    compiled degree, on grids whose x axis does not fill a pencil or has
    one cell, against the plain f64 operator and the face-based one
    (ops/dg_face.py): double at 1e-13·max|A x|, float at 3e-6·max|A x|.
    One launch per call; a repeated call is equal bit for bit."""
    from multigrid_tpu_torch.ops import dg_kernel as dk
    from multigrid_tpu_torch.ops.dg_face import DGLaplaceFaceBased

    g = dg_grid(cells, p, kind)
    # inputs that float32 holds exactly: one oracle for both types
    x, b = (rand(g.shape, torch.float32, dev, s).double() for s in (11, 12))
    wants = [op.apply(x) for op in (dk.DGOperator(g, torch.float64, dev).plain,
                                    DGLaplaceFaceBased(g, torch.float64, dev))]
    for dtype, tol in ((torch.float64, 1e-13), (torch.float32, 3e-6)):
        op = dk.DGOperator(g, dtype, dev)
        xt, bt = x.to(dtype), b.to(dtype)
        dk.reset_launches()
        y, r = dk.dg_apply(xt, op), op.vmult_residual(bt, xt)
        cname = "double" if dtype == torch.float64 else "float"
        assert dk.LAUNCHES[f"dg_apply<{cname}>"] == 2
        assert sum(dk.LAUNCHES.values()) == 2
        torch.cuda.synchronize()
        for want in wants:
            bar = tol * float(want.abs().max())
            assert float((y.double() - want).abs().max()) <= bar
            assert float((r.double() - (b - want)).abs().max()) <= bar
        assert torch.equal(y, dk.dg_apply(xt, op))
        assert torch.equal(r, dk.dg_residual(bt, xt, op))


@pytest.mark.parametrize("cells", [(3, 2, 5), (2, 3, 1), (5, 4, 9)])
@pytest.mark.parametrize("p", range(1, 10))
@pytest.mark.parametrize("kind", ["hermite", "gll", "gauss"])
def test_dg_cheb_every_degree(dev, kind, p, cells):
    """dg_cheb<float> at every compiled degree, on grids whose x axis is
    not a multiple of the kernel's pencil (5, 9 cells) or has one cell,
    against the plain f64 step on the smoother's iterates: with x and
    x_old, without x, without x_old at 1e-5·max|out|, with f2 = 0 at
    1e-6·max|x|, and in place into x_old; the same step with A from the
    face-based operator (ops/dg_face.py) at 1e-5·max|out|.  One launch
    per call."""
    import types

    from multigrid_tpu_torch.ops import dg_kernel as dk
    from multigrid_tpu_torch.ops.dg_face import DGLaplaceFaceBased
    from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed

    g = dg_grid(cells, p, kind)
    op32 = dk.DGOperator(g, torch.float32, dev)
    op64 = dk.DGOperator(g, torch.float64, dev)
    for op in (op32, op64):
        op.install_jacobi(JacobiTransformed(g, op.dtype, dev))
    face64 = types.SimpleNamespace(
        plain=DGLaplaceFaceBased(g, torch.float64, dev), jacobi=op64.jacobi)
    b, x, xo = dk.smoother_iterates(op64.jacobi, 7)
    d = lambda t: None if t is None else t.double()
    dk.reset_launches()
    for xa, xoa, f1, f2 in ((x, xo, 0.37, 0.81), (None, None, 0.0, 0.81),
                            (x, None, 0.2, 0.5), (x, xo, 0.37, 0.0)):
        got = d(dk.dg_cheb(b, xa, xoa, op32, f1, f2))
        for ref in (op64, face64):
            want = dk.dg_cheb_plain(d(b), d(xa), d(xoa), ref, f1, f2)
            bar = (1e-5 * float(want.abs().max()) if f2
                   else 1e-6 * float(x.abs().max()))
            torch.cuda.synchronize()
            assert float((got - want).abs().max()) <= bar, (xa is None, f2)
    first = dk.dg_cheb(b, x, xo, op32, 0.37, 0.81)
    alias = xo.clone()
    assert dk.dg_cheb(b, x, alias, op32, 0.37, 0.81, out=alias) is alias
    assert torch.equal(alias, first)
    assert dk.LAUNCHES["dg_cheb<float>"] == 6


@pytest.mark.parametrize("cells", HIGH_CELLS)
@pytest.mark.parametrize("p", [8, 9])
@pytest.mark.parametrize("kind", ["hermite", "gll", "gauss"])
def test_dg_high_degree_edges_every_mode(dev, kind, p, cells):
    """The DG pencil kernels at p = 8, 9 (``csrc/dg_pencil_high.cu``'s at
    the degrees of ``dg_kernel.HIGH_DEGREES``, else the template) on
    the cells of ``dg_kernel.HIGH_CELLS`` (a one-cell column, a one-layer
    ragged row, many pencils with a ragged last one), at the bars of the
    every-degree tests: dg_apply and dg_residual in double at 1e-13 and in
    float at 3e-6 of max|A x| against the plain f64 operator, dg_cheb<float>
    on the smoother's iterates at 1e-5 of max|out| (1e-6 of max|x| with f2
    = 0) and in place into x_old.  Every launch at those degrees is
    ``dg_pencil_high.cu``'s, by the counts its C code keeps where it
    launches them, none of its kernels spills; a repeated call is equal
    bit for bit."""
    from multigrid_tpu_torch.ops import dg_kernel as dk
    from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed

    g = dg_grid(cells, p, kind)
    ops = {}
    for dtype in (torch.float64, torch.float32):
        ops[dtype] = dk.DGOperator(g, dtype, dev)
        ops[dtype].install_jacobi(JacobiTransformed(g, dtype, dev))
    for name, tile in dk.high_tile(g.n).items():
        assert tile["local_bytes"] == 0, (name, tile)
    x, b = (rand(g.shape, torch.float32, dev, s).double() for s in (11, 12))
    want = ops[torch.float64].plain.apply(x)
    dk.reset_launches()
    high_before = dk.high_launches()
    for dtype, tol in ((torch.float64, 1e-13), (torch.float32, 3e-6)):
        op = ops[dtype]
        xt, bt = x.to(dtype), b.to(dtype)
        y, r = dk.dg_apply(xt, op), dk.dg_residual(bt, xt, op)
        torch.cuda.synchronize()
        bar = tol * float(want.abs().max())
        assert float((y.double() - want).abs().max()) <= bar
        assert float((r.double() - (b - want)).abs().max()) <= bar
        assert torch.equal(y, dk.dg_apply(xt, op))
    op32, op64 = ops[torch.float32], ops[torch.float64]
    bs, xs, xo = dk.smoother_iterates(op64.jacobi, 7)
    d = lambda t: None if t is None else t.double()
    for xa, xoa, f1, f2 in ((xs, xo, 0.37, 0.81), (None, None, 0.0, 0.81),
                            (xs, None, 0.2, 0.5), (xs, xo, 0.37, 0.0)):
        got = d(dk.dg_cheb(bs, xa, xoa, op32, f1, f2))
        ref = dk.dg_cheb_plain(d(bs), d(xa), d(xoa), op64, f1, f2)
        bar = (1e-5 * float(ref.abs().max()) if f2
               else 1e-6 * float(xs.abs().max()))
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= bar, (xa is None, f2)
    first = dk.dg_cheb(bs, xs, xo, op32, 0.37, 0.81)
    alias = xo.clone()
    assert dk.dg_cheb(bs, xs, alias, op32, 0.37, 0.81, out=alias) is alias
    assert torch.equal(alias, first)
    calls = {"dg_apply<double>": 3, "dg_cheb<float>": 6}
    assert {k: dk.LAUNCHES[k] for k in calls} == calls
    high = {k: n - high_before[k] for k, n in dk.high_launches().items()}
    assert high == {k: n if p in dk.HIGH_DEGREES[k] else 0
                    for k, n in calls.items()}


@pytest.mark.parametrize("cells", [(3, 2, 5), (2, 3, 1)] + list(HIGH_CELLS))
@pytest.mark.parametrize("p", range(10, 17))
@pytest.mark.parametrize("kind", ["hermite", "gll", "gauss"])
def test_dg_wide_degrees_every_mode(dev, kind, p, cells):
    """The DG pencil kernels at p = 10..16 (``csrc/dg_pencil_wide*.cu``) on
    pencil rows that do not fill a pencil, one-cell axes, a one-layer
    ragged row and many pencils, at the bars of the every-degree tests:
    dg_apply and dg_residual in double at 1e-13 and in float at 3e-6 of
    max|A x| against the plain f64 operator and the face-based one,
    dg_cheb<float> on the smoother's iterates at 1e-5 of max|out| (1e-6 of
    max|x| with f2 = 0) and in place into x_old; one launch a call, none
    of dg_pencil_high.cu's; each kernel's tile within a block's shared
    memory (the in-place layout of its pencil) and held by an SM; a
    repeated call is equal bit for bit."""
    from multigrid_tpu_torch.ops import dg_kernel as dk
    from multigrid_tpu_torch.ops.dg_face import DGLaplaceFaceBased
    from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed

    g = dg_grid(cells, p, kind)
    n = g.n
    for name, tile in dk.wide_tile(n).items():
        size = 8 if "double" in name else 4
        assert tile["smem_bytes"] == tile["cells"] * (
            4 * n ** 3 + 22 * n ** 2) * size <= 232448, (name, tile)
        assert tile["blocks_per_sm"] >= 1 and tile["registers"] <= 255
    ops = {}
    for dtype in (torch.float64, torch.float32):
        ops[dtype] = dk.DGOperator(g, dtype, dev)
        ops[dtype].install_jacobi(JacobiTransformed(g, dtype, dev))
    x, b = (rand(g.shape, torch.float32, dev, s).double() for s in (11, 12))
    wants = [ops[torch.float64].plain.apply(x),
             DGLaplaceFaceBased(g, torch.float64, dev).apply(x)]
    dk.reset_launches()
    high_before = dk.high_launches()
    for dtype, tol in ((torch.float64, 1e-13), (torch.float32, 3e-6)):
        op = ops[dtype]
        xt, bt = x.to(dtype), b.to(dtype)
        y, r = dk.dg_apply(xt, op), dk.dg_residual(bt, xt, op)
        torch.cuda.synchronize()
        for want in wants:
            bar = tol * float(want.abs().max())
            assert float((y.double() - want).abs().max()) <= bar
            assert float((r.double() - (b - want)).abs().max()) <= bar
        assert torch.equal(y, dk.dg_apply(xt, op))
    op32, op64 = ops[torch.float32], ops[torch.float64]
    bs, xs, xo = dk.smoother_iterates(op64.jacobi, 7)
    d = lambda t: None if t is None else t.double()
    for xa, xoa, f1, f2 in ((xs, xo, 0.37, 0.81), (None, None, 0.0, 0.81),
                            (xs, None, 0.2, 0.5), (xs, xo, 0.37, 0.0)):
        got = d(dk.dg_cheb(bs, xa, xoa, op32, f1, f2))
        ref = dk.dg_cheb_plain(d(bs), d(xa), d(xoa), op64, f1, f2)
        bar = (1e-5 * float(ref.abs().max()) if f2
               else 1e-6 * float(xs.abs().max()))
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= bar, (xa is None, f2)
    first = dk.dg_cheb(bs, xs, xo, op32, 0.37, 0.81)
    alias = xo.clone()
    assert dk.dg_cheb(bs, xs, alias, op32, 0.37, 0.81, out=alias) is alias
    assert torch.equal(alias, first)
    calls = {"dg_apply<double>": 3, "dg_apply<float>": 3, "dg_cheb<float>": 6}
    assert {k: dk.LAUNCHES[k] for k in calls} == calls
    assert dk.high_launches() == high_before


@pytest.mark.parametrize("cells", [(3, 2, 5), (2, 3, 1), (5, 4, 9)]
                         + list(MARCH_CELLS))
@pytest.mark.parametrize("p", range(1, 10))
@pytest.mark.parametrize("kind", ["hermite", "gll", "gauss"])
def test_dg_cg_kernels_every_degree(dev, kind, p, cells):
    """The fused CG's kernels at every compiled degree against their plain
    versions, at dg_apply<double>'s bar (1e-13 of each output's max;
    the device scalars to 1e-13 relative): dg_cg<double> (x += alpha_prev
    p_old, p = z + beta p_old, q = A p, alpha = rz / p.q) and
    dg_jacobi_cg<double> (r -= alpha q, z = P^-1 r, beta, rz, rr), the
    latter also as the first pass (q unread, r unchanged, beta = 0).  Two
    launches a call (the pass, the finish); a repeated call bit for
    bit.  The cells take dg_cg's march through both ends of a column, runs
    of it (dg_kernel.MARCH_CELLS) and ragged pencils."""
    from multigrid_tpu_torch.ops import dg_kernel as dk
    from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed

    g = dg_grid(cells, p, kind)
    op = dk.DGOperator(g, torch.float64, dev)
    jac = JacobiTransformed(g, torch.float64, dev)
    op.install_jacobi(jac)
    p_old, z, x, r, q = (rand(g.shape, torch.float64, dev, s)
                         for s in range(5))
    scal = torch.tensor([0.37, 0.61, 1.7, 0.0, 0.0], dtype=torch.float64,
                        device=dev)

    def close(got, want):
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= 1e-13 * float(
                b.abs().max()), (kind, p, cells)

    dk.reset_launches()
    runs = []
    for _ in range(2):
        xs, s = x.clone(), scal.clone()
        pp, qq = torch.empty_like(x), torch.empty_like(x)
        dk.dg_cg(p_old, z, xs, s, pp, qq, op)
        runs.append((xs, pp, qq, s))
    xs, s = x.clone(), scal.clone()
    pp, qq = torch.empty_like(x), torch.empty_like(x)
    dk.dg_cg_plain(p_old, z, xs, s, pp, qq, op.plain.apply)
    close(runs[0][:3], (xs, pp, qq))
    assert torch.allclose(runs[0][3], s, rtol=1e-13, atol=0)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    for first in (False, True):
        rs, s, zs = r.clone(), scal.clone(), torch.empty_like(r)
        dk.dg_jacobi_cg(rs, None if first else q, s, zs, op, first=first)
        rw, sw, zw = r.clone(), scal.clone(), torch.empty_like(r)
        dk.dg_jacobi_cg_plain(rw, q, sw, zw, jac.vmult, first)
        close((rs, zs), (rw, zw))
        assert torch.allclose(s, sw, rtol=1e-13, atol=0)
        if first:
            assert torch.equal(rs, r) and float(s[dk.BETA]) == 0.0
    assert dk.LAUNCHES["dg_cg<double>"] == 4
    assert dk.LAUNCHES["dg_jacobi_cg<double>"] == 4


# The DG kernels' bits on seeded inputs (dg_kernel.kernel_digests: every
# mode of every kernel at p = 1..9 in every kind, on 9 x 3 x 7 sheared
# cells): sha256, first 16 hex digits, recorded on an H100 from the
# kernels as they were before the operator's phases became device
# functions shared by all of them (csrc/dg_pencil.cuh), so that every
# change to those phases is held to these bits.
DG_DIGESTS = {
    "p=1 hermite apply<double>": "cbe389b4cdc0a7ed",
    "p=1 hermite residual<double>": "da4b691d1a04e395",
    "p=1 hermite apply<float>": "fc0e5c679027ce7d",
    "p=1 hermite residual<float>": "6645ddf6dea3af39",
    "p=1 hermite cheb<float>": "ad0f187e19c42082",
    "p=1 hermite cheb<float> x=0": "96f695e52fdf41bc",
    "p=1 hermite dg_cg<double>": "7da9ebf46ce0cf63",
    "p=1 hermite dg_jacobi_cg<double>": "b758e6f723fbf287",
    "p=1 gll apply<double>": "c95fdb7d6858c591",
    "p=1 gll residual<double>": "3c4bc3f943c1dbc2",
    "p=1 gll apply<float>": "fc0e5c679027ce7d",
    "p=1 gll residual<float>": "6645ddf6dea3af39",
    "p=1 gll cheb<float>": "ad0f187e19c42082",
    "p=1 gll cheb<float> x=0": "96f695e52fdf41bc",
    "p=1 gll dg_cg<double>": "68cc75f274d47298",
    "p=1 gll dg_jacobi_cg<double>": "a12e94fafdfd9395",
    "p=1 gauss apply<double>": "e03b6e4844dca226",
    "p=1 gauss residual<double>": "62e2ae5a7607e0b3",
    "p=1 gauss apply<float>": "ca32dae2d76f75b3",
    "p=1 gauss residual<float>": "5492675a84b2ea84",
    "p=1 gauss cheb<float>": "7729b54e79e874d7",
    "p=1 gauss cheb<float> x=0": "c1397c116fd1966c",
    "p=1 gauss dg_cg<double>": "3dd5076b5f0300e0",
    "p=1 gauss dg_jacobi_cg<double>": "10078d98844cfa97",
    "p=2 hermite apply<double>": "d09ff99c96a14569",
    "p=2 hermite residual<double>": "63825632f01c7ce7",
    "p=2 hermite apply<float>": "891b98c7861cc3ea",
    "p=2 hermite residual<float>": "7bb339bfccc31f67",
    "p=2 hermite cheb<float>": "e6f8ac5ece895bbe",
    "p=2 hermite cheb<float> x=0": "d22d9987929d917d",
    "p=2 hermite dg_cg<double>": "e24384999fdbf29b",
    "p=2 hermite dg_jacobi_cg<double>": "a04ea0fa07b6306d",
    "p=2 gll apply<double>": "72717d49ab849d33",
    "p=2 gll residual<double>": "b6978377e14b6932",
    "p=2 gll apply<float>": "891b98c7861cc3ea",
    "p=2 gll residual<float>": "7bb339bfccc31f67",
    "p=2 gll cheb<float>": "e6f8ac5ece895bbe",
    "p=2 gll cheb<float> x=0": "d22d9987929d917d",
    "p=2 gll dg_cg<double>": "35a1203dd1b7467a",
    "p=2 gll dg_jacobi_cg<double>": "b81211b36e33daa4",
    "p=2 gauss apply<double>": "9c51abbeb30c05c2",
    "p=2 gauss residual<double>": "0bc8ac605cf39905",
    "p=2 gauss apply<float>": "2f61f96dcf6f6de4",
    "p=2 gauss residual<float>": "db5b828aabd51832",
    "p=2 gauss cheb<float>": "1d5e0617772c7fc6",
    "p=2 gauss cheb<float> x=0": "058df93cc5eaf45d",
    "p=2 gauss dg_cg<double>": "0a720ec4d79e03b5",
    "p=2 gauss dg_jacobi_cg<double>": "b3398e162df1c478",
    "p=3 hermite apply<double>": "ce2d98e8af3cb13f",
    "p=3 hermite residual<double>": "7088460b96f1b707",
    "p=3 hermite apply<float>": "237ba209fbdefcd3",
    "p=3 hermite residual<float>": "dbc82233eca41e2b",
    "p=3 hermite cheb<float>": "f8cf8010af033aa8",
    "p=3 hermite cheb<float> x=0": "754f23b44fe5621e",
    "p=3 hermite dg_cg<double>": "ee50a7cb2e1566ec",
    "p=3 hermite dg_jacobi_cg<double>": "d771abb08fb7784d",
    "p=3 gll apply<double>": "ae65adbae01d36d6",
    "p=3 gll residual<double>": "f26f87d8d419e42e",
    "p=3 gll apply<float>": "d944f2d2e5c657a7",
    "p=3 gll residual<float>": "4d4305c1410c861a",
    "p=3 gll cheb<float>": "891b7eb1ed43ed0f",
    "p=3 gll cheb<float> x=0": "f734087fa385d963",
    "p=3 gll dg_cg<double>": "0fae6c960bbcf68b",
    "p=3 gll dg_jacobi_cg<double>": "ab863e1c07f9be43",
    "p=3 gauss apply<double>": "873d0c370cc0819a",
    "p=3 gauss residual<double>": "7ef5fe5f7c1ce546",
    "p=3 gauss apply<float>": "f20b267f04f8c60b",
    "p=3 gauss residual<float>": "ce053714bbd35c13",
    "p=3 gauss cheb<float>": "cbd4bc3b1247643c",
    "p=3 gauss cheb<float> x=0": "fda9c8507067837e",
    "p=3 gauss dg_cg<double>": "84fce5a51fc83a8c",
    "p=3 gauss dg_jacobi_cg<double>": "0d95040563be1715",
    "p=4 hermite apply<double>": "0e96fdd52f153add",
    "p=4 hermite residual<double>": "7c9728365943135e",
    "p=4 hermite apply<float>": "5f4707c8ff24b944",
    "p=4 hermite residual<float>": "13b6e7186b0d6b60",
    "p=4 hermite cheb<float>": "0ebb556f8ebcfe59",
    "p=4 hermite cheb<float> x=0": "f1d0ef9c5bc1c864",
    "p=4 hermite dg_cg<double>": "2363cef068abf936",
    "p=4 hermite dg_jacobi_cg<double>": "3eb61a08c22e3b80",
    "p=4 gll apply<double>": "030c7fb02138d41c",
    "p=4 gll residual<double>": "3975663287b6fb6c",
    "p=4 gll apply<float>": "d2f57a890f62a8a4",
    "p=4 gll residual<float>": "1cca43797b5dabf6",
    "p=4 gll cheb<float>": "d3ce8099cf937248",
    "p=4 gll cheb<float> x=0": "e8cc25725a972e5b",
    "p=4 gll dg_cg<double>": "dd7283a8a26a4272",
    "p=4 gll dg_jacobi_cg<double>": "45a4bc1185280bc8",
    "p=4 gauss apply<double>": "a49d571b2030233b",
    "p=4 gauss residual<double>": "b4a5ea5a5c19219d",
    "p=4 gauss apply<float>": "59974179f8f05731",
    "p=4 gauss residual<float>": "524f658933362856",
    "p=4 gauss cheb<float>": "d1a376ba002b0028",
    "p=4 gauss cheb<float> x=0": "47d9f441840460e0",
    "p=4 gauss dg_cg<double>": "c9df4a3f821268c9",
    "p=4 gauss dg_jacobi_cg<double>": "27dda0cb9e430156",
    "p=5 hermite apply<double>": "d029de91ff84a443",
    "p=5 hermite residual<double>": "fe0982b7ca589267",
    "p=5 hermite apply<float>": "c233a387dbc0e0b0",
    "p=5 hermite residual<float>": "8ce4630333379677",
    "p=5 hermite cheb<float>": "6eb229bc5942ef51",
    "p=5 hermite cheb<float> x=0": "c3b0ecbd2ef0049a",
    "p=5 hermite dg_cg<double>": "e6a3c6c656fd0e86",
    "p=5 hermite dg_jacobi_cg<double>": "aba918e5a780e09d",
    "p=5 gll apply<double>": "6b2b8cf5f8516366",
    "p=5 gll residual<double>": "fdab6cc2645a044e",
    "p=5 gll apply<float>": "3c8f0790d0bbb5ed",
    "p=5 gll residual<float>": "1450e000e639baee",
    "p=5 gll cheb<float>": "87ef264744ebdabe",
    "p=5 gll cheb<float> x=0": "091a8244d7df4260",
    "p=5 gll dg_cg<double>": "9cd6f9695843f94d",
    "p=5 gll dg_jacobi_cg<double>": "a8fe63d7c73e6db5",
    "p=5 gauss apply<double>": "92fab143489e6ce9",
    "p=5 gauss residual<double>": "11809eab31d7116f",
    "p=5 gauss apply<float>": "25e2e3a3c60587b5",
    "p=5 gauss residual<float>": "5e405194cb22d812",
    "p=5 gauss cheb<float>": "1618d9dbdf289694",
    "p=5 gauss cheb<float> x=0": "b5ce8d4ddabf84b8",
    "p=5 gauss dg_cg<double>": "6dd2715fb8faf22c",
    "p=5 gauss dg_jacobi_cg<double>": "a71486b528b31e8c",
    "p=6 hermite apply<double>": "1353f657b9c2cadc",
    "p=6 hermite residual<double>": "7e0ee0e90f17249d",
    "p=6 hermite apply<float>": "7f87525a26e3348a",
    "p=6 hermite residual<float>": "92d5b25282b89b79",
    "p=6 hermite cheb<float>": "f6240e8ab5aabba5",
    "p=6 hermite cheb<float> x=0": "17c17b1be0fd3d6d",
    "p=6 hermite dg_cg<double>": "8d541bdcbb951b37",
    "p=6 hermite dg_jacobi_cg<double>": "51355a79173e3c7c",
    "p=6 gll apply<double>": "3da7114adf5908ce",
    "p=6 gll residual<double>": "5c89faf44000120d",
    "p=6 gll apply<float>": "474ab9b494c0aaec",
    "p=6 gll residual<float>": "962d276c19a64284",
    "p=6 gll cheb<float>": "023778461c72c198",
    "p=6 gll cheb<float> x=0": "4358fc677cecf2e1",
    "p=6 gll dg_cg<double>": "e78db1c354da2613",
    "p=6 gll dg_jacobi_cg<double>": "5837b6125e4bfdb8",
    "p=6 gauss apply<double>": "838b27fd2b88f550",
    "p=6 gauss residual<double>": "79617b2177635903",
    "p=6 gauss apply<float>": "8ba83d99256542ad",
    "p=6 gauss residual<float>": "5798efd2372943f6",
    "p=6 gauss cheb<float>": "1779680b1b3598ad",
    "p=6 gauss cheb<float> x=0": "63f1a1757c5c62e2",
    "p=6 gauss dg_cg<double>": "aa134388b920c8e5",
    "p=6 gauss dg_jacobi_cg<double>": "48204fe54a88f2e2",
    "p=7 hermite apply<double>": "0764e2cb4541e174",
    "p=7 hermite residual<double>": "bbb1e612c72e4e88",
    "p=7 hermite apply<float>": "b7a1b32c9e7fb936",
    "p=7 hermite residual<float>": "91d33e6f8d88d1d9",
    "p=7 hermite cheb<float>": "cd973aaa83d41627",
    "p=7 hermite cheb<float> x=0": "55d83a7c697b6407",
    "p=7 hermite dg_cg<double>": "72f3ad8cd4740f5e",
    "p=7 hermite dg_jacobi_cg<double>": "75b63723e03a438c",
    "p=7 gll apply<double>": "f892b438efd71463",
    "p=7 gll residual<double>": "26afbfc47c6b6331",
    "p=7 gll apply<float>": "96861381e8e5287b",
    "p=7 gll residual<float>": "dfc61af91185be91",
    "p=7 gll cheb<float>": "934c099b64fe9bf5",
    "p=7 gll cheb<float> x=0": "35ad4923ca607fba",
    "p=7 gll dg_cg<double>": "9233112feb9af1f8",
    "p=7 gll dg_jacobi_cg<double>": "5a923ea81b1acf8f",
    "p=7 gauss apply<double>": "cd5a95006490cd18",
    "p=7 gauss residual<double>": "c393f514197ce25c",
    "p=7 gauss apply<float>": "c4dc9e539b43ef06",
    "p=7 gauss residual<float>": "fe6066ff4ca75b6b",
    "p=7 gauss cheb<float>": "7338acd0e51bd948",
    "p=7 gauss cheb<float> x=0": "1b0944874bd4b325",
    "p=7 gauss dg_cg<double>": "ed30222af899b09c",
    "p=7 gauss dg_jacobi_cg<double>": "52b691fd32ed842a",
    "p=8 hermite apply<double>": "4ea424c4d3f2851e",
    "p=8 hermite residual<double>": "b6c0f4215fe2433b",
    "p=8 hermite apply<float>": "03708519182ade47",
    "p=8 hermite residual<float>": "53736ea5ba000b09",
    "p=8 hermite cheb<float>": "188010c7fcc243af",
    "p=8 hermite cheb<float> x=0": "2bf28804cdbf7cd4",
    "p=8 hermite dg_cg<double>": "f15e0f3e0d6c1346",
    "p=8 hermite dg_jacobi_cg<double>": "70d280729fcdab08",
    "p=8 gll apply<double>": "7f2bb7f5bddd19bf",
    "p=8 gll residual<double>": "1e06912ed8b63dec",
    "p=8 gll apply<float>": "28007f92af65b02f",
    "p=8 gll residual<float>": "7051aaaad9ed97ff",
    "p=8 gll cheb<float>": "e3da41069b599ad9",
    "p=8 gll cheb<float> x=0": "2622d76840911ee9",
    "p=8 gll dg_cg<double>": "65e2aa84aec71dfc",
    "p=8 gll dg_jacobi_cg<double>": "4da2c4f6750e5e83",
    "p=8 gauss apply<double>": "1ac2c71b96454028",
    "p=8 gauss residual<double>": "77568340ab6710e2",
    "p=8 gauss apply<float>": "808ed210c6e8fbf4",
    "p=8 gauss residual<float>": "f55d88c6e1c90813",
    "p=8 gauss cheb<float>": "870f95215e4e550f",
    "p=8 gauss cheb<float> x=0": "22a78c0d3c39b2a0",
    "p=8 gauss dg_cg<double>": "3ed9cd5f1ee393e5",
    "p=8 gauss dg_jacobi_cg<double>": "c0fc1d1ef768601c",
    "p=9 hermite apply<double>": "02756c82dbfa4eac",
    "p=9 hermite residual<double>": "131d8914eb231026",
    "p=9 hermite apply<float>": "85dcdf20411ded86",
    "p=9 hermite residual<float>": "933b2cd06cd5f353",
    "p=9 hermite cheb<float>": "81e79bddfc96c891",
    "p=9 hermite cheb<float> x=0": "59af851d163eedc1",
    "p=9 hermite dg_cg<double>": "0bf8e631f8161e4d",
    "p=9 hermite dg_jacobi_cg<double>": "6fc7f0d3684c5a49",
    "p=9 gll apply<double>": "6464c083ae83fe3b",
    "p=9 gll residual<double>": "80625610349f4374",
    "p=9 gll apply<float>": "1a481eaf62c7d178",
    "p=9 gll residual<float>": "1d83e39a11e08145",
    "p=9 gll cheb<float>": "63179bf30e3f234c",
    "p=9 gll cheb<float> x=0": "5cfbffc09335ac90",
    "p=9 gll dg_cg<double>": "3b7c50eb7b56f60d",
    "p=9 gll dg_jacobi_cg<double>": "81ba547bda4690fe",
    "p=9 gauss apply<double>": "5bd51644b8aabf08",
    "p=9 gauss residual<double>": "0452855dd6afab1f",
    "p=9 gauss apply<float>": "c55309fd03ddb48a",
    "p=9 gauss residual<float>": "857d96a8f37ff2bd",
    "p=9 gauss cheb<float>": "379fe76fdb880742",
    "p=9 gauss cheb<float> x=0": "e90b1107b710eccb",
    "p=9 gauss dg_cg<double>": "b1632f9637f082ea",
    "p=9 gauss dg_jacobi_cg<double>": "b9713fbf9d85db0f",
    "p=10 hermite apply<double>": "40c73de9938d2657",
    "p=10 hermite residual<double>": "052354a6fe498c36",
    "p=10 hermite apply<float>": "43b003e6b19af53f",
    "p=10 hermite residual<float>": "130e342b140ed540",
    "p=10 hermite cheb<float>": "1d1ed3dea73c9f0c",
    "p=10 hermite cheb<float> x=0": "4c4f17a95b82bc67",
    "p=10 gll apply<double>": "17eb8a3a6e5c4ef1",
    "p=10 gll residual<double>": "416610a675c2717d",
    "p=10 gll apply<float>": "5914f39f24b4d072",
    "p=10 gll residual<float>": "c885d3b2766acf97",
    "p=10 gll cheb<float>": "226b8feef5d901f0",
    "p=10 gll cheb<float> x=0": "d3fbb9ea2bc7c3bb",
    "p=10 gauss apply<double>": "663de14476d8a573",
    "p=10 gauss residual<double>": "90b978e439f4f387",
    "p=10 gauss apply<float>": "71554e064d9973c0",
    "p=10 gauss residual<float>": "9dedf515f0c21bff",
    "p=10 gauss cheb<float>": "8e680c95ebddc741",
    "p=10 gauss cheb<float> x=0": "ef1b3b11f9aea004",
    "p=11 hermite apply<double>": "042aa817331db0b2",
    "p=11 hermite residual<double>": "b81ba66e755dea67",
    "p=11 hermite apply<float>": "4b6d7adeacdabd28",
    "p=11 hermite residual<float>": "df1fc9a0a95ba1d2",
    "p=11 hermite cheb<float>": "d02d90b28b5f6614",
    "p=11 hermite cheb<float> x=0": "151446fd97a208ce",
    "p=11 gll apply<double>": "41576f260eb57b24",
    "p=11 gll residual<double>": "8b3da8affbd52489",
    "p=11 gll apply<float>": "a70d8cf810b1a7a0",
    "p=11 gll residual<float>": "614018514e31e7f1",
    "p=11 gll cheb<float>": "c7ff01b13ca7f117",
    "p=11 gll cheb<float> x=0": "c7f1a2e63df26eaa",
    "p=11 gauss apply<double>": "b4b86b566ea4c580",
    "p=11 gauss residual<double>": "d950eb32a3ef190c",
    "p=11 gauss apply<float>": "3a78c9263b062156",
    "p=11 gauss residual<float>": "83c7c437d95b5d32",
    "p=11 gauss cheb<float>": "e1534f17c1ce813e",
    "p=11 gauss cheb<float> x=0": "55d51302e7aeea69",
    "p=12 hermite apply<double>": "1f3aede5686aa2e6",
    "p=12 hermite residual<double>": "f7e21585c38e3b5a",
    "p=12 hermite apply<float>": "808cc289093e74ac",
    "p=12 hermite residual<float>": "fc7585a8d5c5df74",
    "p=12 hermite cheb<float>": "34387cffebc359af",
    "p=12 hermite cheb<float> x=0": "a57554b6faafe25b",
    "p=12 gll apply<double>": "6a173b636ada7048",
    "p=12 gll residual<double>": "842b30ea50d27a6c",
    "p=12 gll apply<float>": "21650ff1e438353b",
    "p=12 gll residual<float>": "26b4aa84424a8b3d",
    "p=12 gll cheb<float>": "a0a4b9fd66b9169e",
    "p=12 gll cheb<float> x=0": "354a6298fa647e6c",
    "p=12 gauss apply<double>": "06846a9069aa2b92",
    "p=12 gauss residual<double>": "a6c82927a4845bba",
    "p=12 gauss apply<float>": "0c220fdf53a87eb9",
    "p=12 gauss residual<float>": "1075a1d7076c10f7",
    "p=12 gauss cheb<float>": "dfdf2d10113973b6",
    "p=12 gauss cheb<float> x=0": "967c07bcbc22bd7d",
    "p=13 hermite apply<double>": "d4c60878efe4d4ea",
    "p=13 hermite residual<double>": "5d16924c1f7abb3c",
    "p=13 hermite apply<float>": "672f9b5b09c84eb2",
    "p=13 hermite residual<float>": "c7af6f903c1523d8",
    "p=13 hermite cheb<float>": "f6a53c01315c81ac",
    "p=13 hermite cheb<float> x=0": "e0682a68b5bcd96d",
    "p=13 gll apply<double>": "c2642f18d77f429d",
    "p=13 gll residual<double>": "cb4233b29e137575",
    "p=13 gll apply<float>": "17d38c91acbf39fd",
    "p=13 gll residual<float>": "5f7032fa255719e3",
    "p=13 gll cheb<float>": "a82ec8f775eb7507",
    "p=13 gll cheb<float> x=0": "f3a195ba2c3e7bca",
    "p=13 gauss apply<double>": "1a70cbad1be52cbc",
    "p=13 gauss residual<double>": "b774d7632a188f1f",
    "p=13 gauss apply<float>": "a9952633218cacdd",
    "p=13 gauss residual<float>": "9c495f4b884eb6ba",
    "p=13 gauss cheb<float>": "be0ca71964ea2993",
    "p=13 gauss cheb<float> x=0": "5c26d589e3e83aa5",
    "p=14 hermite apply<double>": "66387039f3002232",
    "p=14 hermite residual<double>": "3c552197c0049bd7",
    "p=14 hermite apply<float>": "90a27a68f51de87f",
    "p=14 hermite residual<float>": "e236f8a840729f89",
    "p=14 hermite cheb<float>": "3dcbaa4977ef3b40",
    "p=14 hermite cheb<float> x=0": "28d6aba5cf2ea174",
    "p=14 gll apply<double>": "a57cd03a715972cc",
    "p=14 gll residual<double>": "5c11642d706e953c",
    "p=14 gll apply<float>": "9df4bae875c66ff1",
    "p=14 gll residual<float>": "fad7327bee9c3393",
    "p=14 gll cheb<float>": "c2386a53c694bbbe",
    "p=14 gll cheb<float> x=0": "b3d37fe61b186bad",
    "p=14 gauss apply<double>": "910bae73965fe6ee",
    "p=14 gauss residual<double>": "4e53a8ee667f1c65",
    "p=14 gauss apply<float>": "24d3490ae7e63bb5",
    "p=14 gauss residual<float>": "0b08de200f00da65",
    "p=14 gauss cheb<float>": "c5602b6290af22ae",
    "p=14 gauss cheb<float> x=0": "0e89c8c6a38cde89",
    "p=15 hermite apply<double>": "28fcc11d8a21ad98",
    "p=15 hermite residual<double>": "164dd56516e736b6",
    "p=15 hermite apply<float>": "918d423fd6a2c3ff",
    "p=15 hermite residual<float>": "66b62c9b862d586a",
    "p=15 hermite cheb<float>": "7f16fa2802375229",
    "p=15 hermite cheb<float> x=0": "759125629cafe4f0",
    "p=15 gll apply<double>": "f23026788a28cdf5",
    "p=15 gll residual<double>": "e3f4022595c7a1ec",
    "p=15 gll apply<float>": "86ee5ddf5f51caaa",
    "p=15 gll residual<float>": "d234b7b9a6a86216",
    "p=15 gll cheb<float>": "9a53fe6c062c3116",
    "p=15 gll cheb<float> x=0": "e29fee20721b2df9",
    "p=15 gauss apply<double>": "9b9738a7b74966c9",
    "p=15 gauss residual<double>": "9744f6c99c098074",
    "p=15 gauss apply<float>": "e07df9dd191b63e5",
    "p=15 gauss residual<float>": "bf98b374dd30ab2d",
    "p=15 gauss cheb<float>": "5d8b1e195c791d0e",
    "p=15 gauss cheb<float> x=0": "2296b880c7415e5a",
    "p=16 hermite apply<double>": "8e1aa105a52999b5",
    "p=16 hermite residual<double>": "09917587da2bd00a",
    "p=16 hermite apply<float>": "3783ba59306c7f04",
    "p=16 hermite residual<float>": "f7362036a2d44df7",
    "p=16 hermite cheb<float>": "160abfbb46ab8342",
    "p=16 hermite cheb<float> x=0": "453d059ccf081a88",
    "p=16 gll apply<double>": "7ea88fbed9719837",
    "p=16 gll residual<double>": "966dbced62633051",
    "p=16 gll apply<float>": "6752710526fd83de",
    "p=16 gll residual<float>": "f8d969843bf597e6",
    "p=16 gll cheb<float>": "42662889f4fd542a",
    "p=16 gll cheb<float> x=0": "a2bf267cfaeb4cbe",
    "p=16 gauss apply<double>": "7cd14a14b8030702",
    "p=16 gauss residual<double>": "fca166673cf86ea2",
    "p=16 gauss apply<float>": "a609d1486f6d2b89",
    "p=16 gauss residual<float>": "058818b5c242a03c",
    "p=16 gauss cheb<float>": "7f753442357f8fee",
    "p=16 gauss cheb<float> x=0": "dcf06f4b2be243f4",
}


@pytest.mark.parametrize("p", range(1, 17))
def test_dg_kernels_keep_their_bits_every_degree(dev, p):
    """Every DG kernel's outputs at p, in every kind: apply and residual
    in both types, the step with x and with x = 0, dg_cg's x, p, q and
    scalars, dg_jacobi_cg's r, z and scalars (p <= 9, the fused CG's
    degrees), bit for bit as DG_DIGESTS pins them."""
    from multigrid_tpu_torch.ops import dg_kernel as dk

    want = {k: v for k, v in DG_DIGESTS.items() if k.startswith(f"p={p} ")}
    assert len(want) == 3 * (len(dk.DIGEST_MODES)
                             - (0 if p <= dk.CG_MAX_DEGREE else 2))
    assert dk.kernel_digests(dev, degrees=[p]) == want


def test_fused_solver_dg_loop_on_card_matches_cpu(dev):
    """solver_dg's fused row, 10 iterations on the card's kernels with no
    host sync inside the loop (PyTorch's sync debug mode raises on one),
    against the same loop on the CPU (the kernels' plain versions) to
    1e-11 of max|x|; 2 + 2 launches an iteration and the first pass."""
    from multigrid_tpu_torch.experiments import solver_dg
    from multigrid_tpu_torch.experiments.matvec_dg import bench_grid
    from multigrid_tpu_torch.ops import dg_kernel as dk
    from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed

    grid = bench_grid(3, "hermite", 6, shear=False)
    b = np.random.default_rng(0).standard_normal(grid.shape)
    xs = {}
    for where in (dev, torch.device("cpu")):
        op = dk.DGOperator(grid, torch.float64, where)
        jac = JacobiTransformed(grid, torch.float64, where)
        op.install_jacobi(jac)
        passes = solver_dg.fused_passes(op, jac, grid, kernel=True)
        bt = torch.as_tensor(b, device=where)  # a copy from the host syncs
        dk.reset_launches()
        with solver_dg.no_host_sync(where):
            x, rn = solver_dg.cg_fused(*passes, bt, 10)
        xs[where.type] = x.cpu()
        if where.type == "cuda":
            assert dk.LAUNCHES["dg_cg<double>"] == 20
            assert dk.LAUNCHES["dg_jacobi_cg<double>"] == 22
    scale = float(xs["cpu"].abs().max())
    assert float((xs["cuda"] - xs["cpu"]).abs().max()) <= 1e-11 * scale


def test_dg_solver_on_card_matches_cpu(dev):
    from multigrid_tpu_torch.experiments.poisson_cube import exact_fn, rhs_fn
    from multigrid_tpu_torch.solvers.multigrid_dg import MultigridSolverDG

    sols = {}
    for where in (dev, "cpu"):
        s = MultigridSolverDG(poisson_cube_mesh(4), 4, exact_fn, rhs_fn,
                              n_pre=3, n_post=3, device=where)
        sols[str(where)] = s.solve_cg(tolerance=1e-9)[0].cpu()
    u_gpu, u_cpu = sols[str(dev)], sols["cpu"]
    assert float((u_gpu - u_cpu).abs().max()) <= 1e-5 * float(u_cpu.abs().max())


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("p", [8, 9])
def test_dg_solvers_at_high_degree_on_card_match_cpu(dev, p, plain):
    """poisson_dg and poisson_dg_plain (3-D, hermite, n_pre = n_post = 3,
    rtol 1e-9) on 2^3 cells at p = 8, 9 on the card against the CPU: the
    solution to 1e-5 of max|u|, frac its and L2 to 1%; K7, K8 and K9
    launch."""
    from multigrid_tpu_torch.experiments.poisson_cube import exact_fn, rhs_fn
    from multigrid_tpu_torch.ops import dg_kernel as dk
    from multigrid_tpu_torch.solvers.multigrid_dg import (
        MultigridSolverDG, MultigridSolverDGPlain)

    cls = MultigridSolverDGPlain if plain else MultigridSolverDG
    rows = {}
    for where in (dev, "cpu"):
        s = cls(poisson_cube_mesh(2), p, exact_fn, rhs_fn, kind="hermite",
                n_pre=3, n_post=3, device=where)
        dk.reset_launches()
        u, its, _ = s.solve_cg(tolerance=1e-9)
        rows[str(where)] = (u.cpu(), its, s.l2_error(u, s.exact_quad),
                            dict(dk.LAUNCHES))
    (u_gpu, its_gpu, l2_gpu, counts), (u_cpu, its_cpu, l2_cpu, _) = (
        rows[str(dev)], rows["cpu"])
    assert float((u_gpu - u_cpu).abs().max()) <= 1e-5 * float(u_cpu.abs().max())
    assert its_gpu == pytest.approx(its_cpu, rel=0.01)
    assert l2_gpu == pytest.approx(l2_cpu, rel=0.01)
    # the solvers' DG kernels (the fused CG's are solver_dg's alone)
    assert all(counts[k] > 0 for k in ("dg_apply<double>", "dg_apply<float>",
                                       "dg_cheb<float>")), counts


def _dg_plain(where):
    from multigrid_tpu_torch.experiments.poisson_cube import exact_fn, rhs_fn
    from multigrid_tpu_torch.solvers.multigrid_dg import MultigridSolverDGPlain

    return MultigridSolverDGPlain(poisson_cube_mesh(4), 4, exact_fn, rhs_fn,
                                  kind="hermite", n_pre=3, n_post=3,
                                  device=where)


def test_dg_plain_solver_on_card_matches_cpu(dev):
    u_gpu, u_cpu = (_dg_plain(where).solve_cg(tolerance=1e-9)[0].cpu()
                    for where in (dev, "cpu"))
    assert float((u_gpu - u_cpu).abs().max()) <= 1e-5 * float(u_cpu.abs().max())


@pytest.mark.parametrize("kind", ["hermite", "gll", "gauss"])
def test_dg_transfer_f32_on_card_matches_f64(dev, kind):
    """The float32 transfer on the card (full-precision matrix products, no
    TF32) against the float64 one, to 1e-6 of the largest value."""
    from multigrid_tpu_torch.ops.dg_transfer import DGTransfer
    from multigrid_tpu_torch.solvers.multigrid import set_full_precision_matmul

    set_full_precision_matmul()
    fine, coarse = dg_grid((6, 4, 8), 4, kind), dg_grid((3, 2, 4), 4, kind)
    t32, t64 = (DGTransfer(fine, coarse, dt, dev)
                for dt in (torch.float32, torch.float64))
    for fn, shape, seed in (("prolongate", coarse.shape, 1),
                            ("restrict", fine.shape, 2)):
        x = rand(shape, torch.float64, dev, seed)
        want = getattr(t64, fn)(x)
        got = getattr(t32, fn)(x.float()).double()
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_dg_plain_solve_launches_the_dg_kernels(dev):
    """A constant-coefficient 3-D DGPlain solve on the card runs K7, K8, K9
    and the CG kernels, and no brick kernel."""
    from multigrid_tpu_torch.ops import cg_kernel, dg_kernel, laplace_kernel

    s = _dg_plain(dev)
    for mod in (cg_kernel, dg_kernel, laplace_kernel):
        mod.reset_launches()
    s.solve_cg(tolerance=1e-9)
    torch.cuda.synchronize()
    for name in ("dg_apply<double>", "dg_apply<float>", "dg_cheb<float>"):
        assert dg_kernel.LAUNCHES[name] > 0, name
    for name in ("cg_update", "cg_dot", "cg_xpay"):
        assert cg_kernel.LAUNCHES[name] > 0, name
    assert not any(laplace_kernel.LAUNCHES.values()), laplace_kernel.LAUNCHES


def _shell_grid(n_levels=2, level=1, degree=3):
    from multigrid_tpu_torch.mesh.mapped import GeneralGrid
    from multigrid_tpu_torch.mesh.shapes import hyper_shell

    return GeneralGrid(hyper_shell(0.5, 1.0, n_levels=n_levels), level,
                       degree)


def test_general_operator_on_card_matches_cpu(dev):
    """The general (mapped-mesh) operator and transfer in f64 on the card
    against the same on the CPU: vmult, vmult_residual, the inverse
    diagonal and both transfer directions to 1e-13 of max."""
    from multigrid_tpu_torch.experiments.poisson_shell import coef_fn
    from multigrid_tpu_torch.ops.laplace_general import GeneralLaplace
    from multigrid_tpu_torch.ops.transfer_general import GeneralTransfer

    fine, coarse = _shell_grid(), _shell_grid(level=0)
    coef = fine.merged_coefficient(coef_fn)
    ops = {d: GeneralLaplace(fine, torch.float64, coef=coef, device=d)
           for d in ("cpu", dev)}
    trs = {d: GeneralTransfer(fine, coarse, torch.float64, True, d)
           for d in ("cpu", dev)}
    x = rand(fine.n_dofs, torch.float64, "cpu", 3)
    b = rand(fine.n_dofs, torch.float64, "cpu", 4)
    xc = rand(coarse.n_dofs, torch.float64, "cpu", 5)
    pairs = [(lambda d: ops[d].vmult(x.to(d))),
             (lambda d: ops[d].vmult_residual(b.to(d), x.to(d))),
             (lambda d: ops[d].inverse_diagonal()),
             (lambda d: trs[d].restrict(x.to(d))),
             (lambda d: trs[d].prolongate(xc.to(d)))]
    for f in pairs:
        want = f("cpu")
        got = f(dev).cpu()
        assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_general_scatter_is_deterministic(dev, dtype):
    """The general operator's scatter sums in a fixed order: two applies
    (and two transfers) on the card agree bit for bit, and the scatter
    agrees with index_add_ to rounding."""
    from multigrid_tpu_torch.ops.laplace_general import GeneralLaplace
    from multigrid_tpu_torch.ops.transfer_general import GeneralTransfer

    fine, coarse = _shell_grid(3, 2, 4), _shell_grid(3, 1, 4)
    op = GeneralLaplace(fine, dtype, device=dev)
    tr = GeneralTransfer(fine, coarse, dtype, True, dev)
    x = rand(fine.n_dofs, dtype, dev, 6)
    assert torch.equal(op.vmult(x), op.vmult(x))
    assert torch.equal(tr.restrict(x), tr.restrict(x))
    y = rand(op.cell_nodes.numel(), dtype, dev, 7)
    ref = torch.zeros(fine.n_dofs, dtype=torch.float64, device=dev)
    ref.index_add_(0, op.cell_nodes, y.double())
    got = op.scatter_add(y)
    tol = 1e-14 if dtype == torch.float64 else 2e-6
    assert float((got.double() - ref).abs().max()) <= tol * float(ref.abs().max())


def test_general_solver_on_card_matches_cpu(dev):
    """A small shell solve (mixed and pure double) and a CG solve on the
    card agree with the CPU: FMG to 1e-5 of max|u| (f32 V-cycle), CG
    iterations equal; the CG vector kernels run on the card."""
    from multigrid_tpu_torch.experiments.poisson_shell import (coef_fn,
                                                               exact_fn, rhs_fn)
    from multigrid_tpu_torch.mesh.shapes import hyper_shell
    from multigrid_tpu_torch.ops import cg_kernel
    from multigrid_tpu_torch.solvers.multigrid_general import (
        GeneralMultigridSolver)

    for kw in ({}, dict(pure_double=True)):
        s = {d: GeneralMultigridSolver(hyper_shell(0.5, 1.0, n_levels=2), 3,
                                       exact_fn, rhs_fn, coef_fn=coef_fn,
                                       n_pre=3, n_post=3, device=d, **kw)
             for d in ("cpu", dev)}
        u_cpu, u_gpu = s["cpu"].solve(), s[dev].solve().cpu()
        assert float((u_gpu - u_cpu).abs().max()) <= 1e-5 * float(u_cpu.abs().max())
        cg_kernel.reset_launches()
        its = [s[d].solve_cg()[1] for d in ("cpu", dev)]
        assert its[0] == its[1]
        assert cg_kernel.LAUNCHES["cg_update"] == 2 * its[1]   # 2 a call


@pytest.mark.parametrize("p", [4, 9])
def test_jacobi_probe_on_card_matches_cpu(dev, p):
    """The transformed Jacobi's category probe runs on the
    preconditioner's device: its inverse diagonal on the card against the
    CPU's to 1e-13 of max, on a sheared grid and on a slab of it that
    takes the whole grid's categories."""
    from multigrid_tpu_torch.ops.dg import DGGrid
    from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed

    g = dg_grid((4, 2, 3), p, "hermite")
    slab = DGGrid(cells=(2, 2, 3), jacobian=g.jacobian, degree=p,
                  kind="hermite")
    for grid, whole in ((g, None), (slab, (g.cells, (1, 0, 0)))):
        want = JacobiTransformed(grid, torch.float64, "cpu",
                                 whole=whole).inv_diag
        got = JacobiTransformed(grid, torch.float64, dev, whole=whole).inv_diag
        assert got.device.type == "cuda"
        assert float((got.cpu() - want).abs().max()) <= 1e-13 * float(
            want.abs().max())


def _deform(p):
    return p + (0.08 * np.prod(np.sin(np.pi * p), axis=1))[:, None]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 2e-6)])
def test_curved_dg_operator_on_card_matches_cpu(dev, dtype, tol):
    """The curved SIP-DG operator (plain PyTorch) on the card against the
    CPU: apply, the weak-Dirichlet right-hand side and the exact per-cell
    transformed-Jacobi diagonal, to ``tol`` of max."""
    from multigrid_tpu_torch.ops.dg_curved import DGCurvedGrid, DGLaplaceCurved
    from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed

    g = DGCurvedGrid((3, 2, 4), _deform, 3, "hermite")
    ops = {d: DGLaplaceCurved(g, dtype, d) for d in ("cpu", dev)}
    x = rand(g.shape, dtype, "cpu", 12)
    g_bc = {(0, 1): np.ones((1, 2, 4, 4, 4))}
    pairs = [lambda d: ops[d].apply(x.to(d)),
             lambda d: ops[d].compute_rhs(x.to(d), g_bc),
             lambda d: JacobiTransformed(g, dtype, d, op=ops[d]).inv_diag]
    for f in pairs:
        want = f("cpu")
        got = f(dev)
        assert got.device.type == "cuda"
        assert float((got.cpu() - want).abs().max()) <= tol * float(
            want.abs().max())


def test_curved_dg_plain_solve_on_card(dev):
    """The curved DGPlain solve on the card agrees with the CPU (1e-5 of
    max|u|, frac its to 1%) and launches only the CG kernels."""
    from multigrid_tpu_torch.ops import cg_kernel, dg_kernel, laplace_kernel
    from multigrid_tpu_torch.experiments.poisson_cube import exact_fn, rhs_fn
    from multigrid_tpu_torch.experiments.poisson_dg_plain import deform_chart
    from multigrid_tpu_torch.solvers.multigrid_dg import MultigridSolverDGPlain

    mesh = poisson_cube_mesh(4)
    s = {d: MultigridSolverDGPlain(mesh, 3, exact_fn, rhs_fn, kind="hermite",
                                   device=d, mapping=deform_chart(mesh, 0.05))
         for d in ("cpu", dev)}
    for mod in (cg_kernel, dg_kernel, laplace_kernel):
        mod.reset_launches()
    (u_gpu, its_gpu, _), (u_cpu, its_cpu, _) = (
        s[d].solve_cg(tolerance=1e-9) for d in (dev, "cpu"))
    assert float((u_gpu.cpu() - u_cpu).abs().max()) <= 1e-5 * float(
        u_cpu.abs().max())
    assert its_gpu == pytest.approx(its_cpu, rel=0.01)
    assert cg_kernel.LAUNCHES["cg_update"] > 0
    assert not any(dg_kernel.LAUNCHES.values()), dg_kernel.LAUNCHES
    assert not any(laplace_kernel.LAUNCHES.values()), laplace_kernel.LAUNCHES


def _l_forest(cycles=2):
    from multigrid_tpu_torch.experiments.poisson_l import l_forest

    f = l_forest(2)
    for _ in range(cycles):
        f = f.refine([c for c in f.active
                      if max(abs(f.cell_corner(c)[0] + f.h(c.level) / 2),
                             abs(f.cell_corner(c)[1] + f.h(c.level) / 2))
                      < 0.3])
    return f


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 2e-6)])
def test_adaptive_operator_on_card_matches_cpu(dev, dtype, tol):
    """AdaptiveLaplace and NestedTransfer (plain PyTorch) on the card
    against the CPU: vmult, vmult_residual, both transfer directions, to
    ``tol`` of max; two applies on the card agree bit for bit."""
    from multigrid_tpu_torch.experiments.poisson_l import boundary_fn
    from multigrid_tpu_torch.mesh.adaptive import AdaptiveGrid
    from multigrid_tpu_torch.ops.laplace_adaptive import AdaptiveLaplace
    from multigrid_tpu_torch.solvers.multigrid_adaptive import NestedTransfer

    f = _l_forest()
    fine = AdaptiveGrid(f, 2, boundary_fn)
    coarse = AdaptiveGrid(f.coarsen_global(), 2, boundary_fn)
    assert fine.n_constraints > 0
    ops = {d: AdaptiveLaplace(fine, dtype, d) for d in ("cpu", dev)}
    trs = {d: NestedTransfer(fine, coarse, dtype, d) for d in ("cpu", dev)}
    x = rand(fine.n_dofs, dtype, "cpu", 13)
    b = rand(fine.n_dofs, dtype, "cpu", 14)
    xc = rand(coarse.n_dofs, dtype, "cpu", 15)
    pairs = [lambda d: ops[d].vmult(x.to(d)),
             lambda d: ops[d].vmult_residual(b.to(d), x.to(d)),
             lambda d: trs[d].restrict(x.to(d)),
             lambda d: trs[d].prolongate(xc.to(d))]
    for f_ in pairs:
        want = f_("cpu")
        got = f_(dev).cpu()
        assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    xd = x.to(dev)
    assert torch.equal(ops[dev].vmult(xd), ops[dev].vmult(xd))


@pytest.mark.parametrize("local", [False, True])
def test_adaptive_solves_on_card_are_deterministic(dev, local):
    """Two adaptive CG solves on the card are bit for bit equal (the
    scatters sum in a fixed order); the card's iterations are the CPU's,
    its solution within 1e-7 of max; only the CG kernels launch."""
    from multigrid_tpu_torch.experiments.poisson_l import build_solver
    from multigrid_tpu_torch.ops import cg_kernel, dg_kernel, laplace_kernel

    f = _l_forest()
    s = {d: build_solver(f, 2, local_smoothing=local, device=d)
         for d in ("cpu", dev)}
    for mod in (cg_kernel, dg_kernel, laplace_kernel):
        mod.reset_launches()
    sols = [s[dev].solve_cg() for _ in range(2)]
    assert torch.equal(sols[0][0], sols[1][0])
    u_cpu, its_cpu, _ = s["cpu"].solve_cg()
    assert sols[0][1] == its_cpu
    assert float((sols[0][0].cpu() - u_cpu).abs().max()) <= 1e-7 * float(
        u_cpu.abs().max())
    assert cg_kernel.LAUNCHES["cg_dot"] > 0
    assert not any(dg_kernel.LAUNCHES.values())
    assert not any(laplace_kernel.LAUNCHES.values())


# ------------------------------------------------ one-device configurations
def _launch_counts():
    from multigrid_tpu_torch.ops import cg_kernel, dg_kernel, laplace_kernel

    out = {}
    for mod in (cg_kernel, dg_kernel, laplace_kernel):
        out.update(mod.LAUNCHES)
    return out


def _reset_counts():
    from multigrid_tpu_torch.ops import cg_kernel, dg_kernel, laplace_kernel

    for mod in (cg_kernel, dg_kernel, laplace_kernel):
        mod.reset_launches()


@pytest.mark.parametrize("kind", ["hermite", "gll", "gauss"])
def test_dg_plain_2d_on_card_matches_cpu(dev, kind):
    """The reference's 2-D DG-plain row (16^2 cells, p = 3, rtol 1e-10) on
    the card's plain route against the CPU: iterations within one,
    fractional iterations and L2 to 1%; the solve launches only the CG
    kernels."""
    from multigrid_tpu_torch.experiments.poisson_cube import exact_fn, rhs_fn
    from multigrid_tpu_torch.solvers.multigrid_dg import MultigridSolverDGPlain

    got = {}
    for where in (dev, "cpu"):
        s = MultigridSolverDGPlain(poisson_cube_mesh(2, 2), 3, exact_fn,
                                   rhs_fn, kind=kind, device=where)
        assert s.plain_route
        _reset_counts()
        sol, its, _ = s.solve_cg(tolerance=1e-10)
        got[str(where)] = (its, s.l2_error(sol, s.exact_quad),
                           _launch_counts())
    (its, l2, counts), (c_its, c_l2, _) = got[str(dev)], got["cpu"]
    assert abs(np.ceil(its) - np.ceil(c_its)) <= 1
    assert its == pytest.approx(c_its, rel=0.01)
    assert l2 == pytest.approx(c_l2, rel=0.01)
    assert {k for k, v in counts.items() if v} == {"cg_update", "cg_dot",
                                                   "cg_xpay"}


def test_brick_2d_solve_on_card_matches_cpu(dev):
    """poisson_cube in 2-D (32^2 cells, FE_Q(4)) on the card: FMG against
    the CPU to 1e-5 of max|u|, CG its equal and reduction to 2%; the
    levels run the plain operator and the CG its kernels."""
    from multigrid_tpu_torch.experiments.poisson_cube import build_solver

    solvers = {str(w): build_solver(poisson_cube_mesh(4, 2), 4, device=w)
               for w in (dev, "cpu")}
    u_gpu, u_cpu = (solvers[k].solve().cpu() for k in (str(dev), "cpu"))
    assert float((u_gpu - u_cpu).abs().max()) <= 1e-5 * float(u_cpu.abs().max())
    _reset_counts()
    _, its, red = solvers[str(dev)].solve_cg()
    counts = _launch_counts()
    _, c_its, c_red = solvers["cpu"].solve_cg()
    assert its == c_its and red == pytest.approx(c_red, rel=0.02)
    assert {k for k, v in counts.items() if v} == {"cg_update", "cg_dot",
                                                   "cg_xpay"}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_matvec_dg_above_the_kernels_degree_on_card(dev, dtype):
    """A matvec_dg row above the DG kernels' degree (p = 17) on the card
    runs the plain operator, says so and meets matvec_dg's bar against
    the face-based operator."""
    from multigrid_tpu_torch.experiments import matvec_dg
    from multigrid_tpu_torch.ops import dg_kernel as dk

    _reset_counts()
    row = matvec_dg.run(dk.MAX_DEGREE + 1, "hermite", 3, dtype, dev)
    assert row["route"] == "plain" and not any(_launch_counts().values())
    assert row["verify"] < matvec_dg.VERIFY_TOL[dtype]


def test_dg_levels_above_the_kernels_degree_refuse_the_card(dev):
    """A 3-D constant-coefficient DG level above p = 16 has no kernel: the
    JAX DG solvers run Pallas there, so the card refuses it rather than
    run plain PyTorch; a 2-D one is a plain level on the card."""
    from multigrid_tpu_torch.ops import dg_kernel as dk
    from multigrid_tpu_torch.ops.dg import DGGrid
    from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed
    from multigrid_tpu_torch.solvers.fused import PlainLevel
    from multigrid_tpu_torch.solvers.multigrid_dg import constant_level

    g = dg_grid((2, 2, 2), dk.MAX_DEGREE + 1, "hermite")
    jac = JacobiTransformed(g, torch.float32, "cpu")
    with pytest.raises(ValueError, match="no DG kernel"):
        constant_level(g, torch.float32, dev, jac)
    with pytest.raises(ValueError, match="no DG kernel"):
        constant_level(g, torch.float64, dev)
    g2 = DGGrid(cells=(3, 2), jacobian=((0.5, 0.0), (0.0, 0.5)), degree=3,
                kind="hermite")
    level = constant_level(g2, torch.float32, dev,
                           JacobiTransformed(g2, torch.float32, dev))
    assert type(level) is PlainLevel and level.device.type == "cuda"


def test_checkpoint_round_trip_of_card_tensors(dev, tmp_path):
    from multigrid_tpu_torch.utils import checkpoint

    x = rand((33, 17), torch.float64, dev, 5)
    y = rand((9,), torch.float32, dev, 6)
    path = str(tmp_path / "c.npz")
    checkpoint.save_state(path, {"cg": {"x": x}, "levels": [y]}, {"its": 8})
    got, meta = checkpoint.load_state(path)
    assert meta == {"its": 8}
    assert torch.equal(torch.as_tensor(got["cg/x"], device=dev), x)
    assert torch.equal(torch.as_tensor(got["levels/0"], device=dev), y)


def test_device_memory_stats_on_card(dev):
    from multigrid_tpu_torch.experiments.poisson_cube import build_solver
    from multigrid_tpu_torch.utils import memory

    torch.cuda.reset_peak_memory_stats(dev)
    s = build_solver(poisson_cube_mesh(8), 4, device=dev)
    stats = memory.device_memory_stats(dev)
    assert 0 < stats["bytes_in_use"] <= stats["peak_bytes_in_use"] \
        < stats["bytes_limit"]
    rep = memory.solver_memory_report(s)
    assert rep["allocator"]["peak_bytes_in_use"] >= rep["total_bytes"] > 0


# ---- ranks of torch.distributed on the card (parallel/): gloo ranks share
# the card, their planes staged through pinned host memory
def test_halo_vmult_on_card_is_the_whole_grid_bit_for_bit(dev):
    from multigrid_tpu_torch.ops.laplace_kernel import BrickLaplace
    from multigrid_tpu_torch.parallel.programs import halo_program
    from multigrid_tpu_torch.parallel.sharding import launch

    g = DofGrid(BrickMesh((8, 3, 5), (-0.9,) * 3, (1.9, 1.3, 1.1)), 1, 4)
    x = np.random.default_rng(7).standard_normal(g.shape)
    for dtype in (torch.float32, torch.float64):
        out = launch(halo_program, 2, "gloo", "cuda", args=(g, x, dtype))
        want = BrickLaplace(g, dtype, dev).vmult(
            torch.as_tensor(x, dtype=dtype, device=dev)).cpu().numpy()
        np.testing.assert_array_equal(out["vmult"], want)


def test_halo2d_vmult_on_card_is_the_whole_grid_bit_for_bit(dev):
    """A 2 x 2 rank grid: every rank's owned nodes, the corners near both
    cuts included, are brick_kron on the whole grid bit for bit."""
    from multigrid_tpu_torch.parallel.programs import halo_program
    from multigrid_tpu_torch.parallel.sharding import launch

    g = DofGrid(BrickMesh((4, 4, 5), (-0.9,) * 3, (1.9, 1.3, 1.1)), 1, 4)
    x = np.random.default_rng(7).standard_normal(g.shape)
    for dtype in (torch.float32, torch.float64):
        out = launch(halo_program, 4, "gloo", "cuda", args=(g, x, dtype),
                     kwargs=dict(shape=(2, 2), whole=True))
        assert out["whole"]["equal"], (dtype, out["whole"])


@pytest.mark.parametrize("cells,shape", [((12, 3, 4), None),
                                         ((10, 10, 3), (2, 2))])
def test_overlap_schedule_on_card_is_the_whole_box_bit_for_bit(dev, cells,
                                                              shape):
    """The split vmult (send regions first, their exchange in flight while
    the interior box runs) on gloo ranks sharing the card: in both dtypes
    the box equals apply-then-refresh bit for bit, and its owned nodes
    brick_kron on the whole grid."""
    from multigrid_tpu_torch.parallel.programs import overlap_program
    from multigrid_tpu_torch.parallel.sharding import launch

    g = DofGrid(BrickMesh(cells, (-0.9,) * 3, (1.9, 1.3, 1.1)), 0, 4)
    out = launch(overlap_program, 4 if shape else 2, "gloo", "cuda",
                 args=(g, shape))
    for key, c in out["checks"].items():
        assert c["whole_box"] and c["single"], (key, c)


def test_distributed_solve_on_card_matches_one_device(dev, tmp_path):
    from multigrid_tpu_torch.experiments.poisson_cube import build_solver
    from multigrid_tpu_torch.parallel.programs import cube_program
    from multigrid_tpu_torch.parallel.sharding import launch

    mesh = poisson_cube_mesh(8)
    s = build_solver(mesh, 4, n_cycles=2, device=dev)
    x, its, red = s.solve_cg()
    ref = tmp_path / "cg.npy"
    np.save(ref, x.cpu().numpy())
    out = launch(cube_program, 2, "gloo", "cuda", args=(mesh,),
                 kwargs=dict(reps=2, reference=str(ref), apply_seed=1))
    assert out["levels"] == [False, False, True, True]
    assert out["cg_its"] == its
    assert abs(out["cg_reduction"] - red) < 1e-4
    assert out["cg_ref_diff"] <= 1e-9 * out["cg_ref_max"]
    assert out["cg_repeat_equal"]
    assert all(v["equal"] for v in out["apply"].values())
    for k in ("brick_kron<float>", "brick_kron_cheb<float>",
              "brick_kron<double>", "cheb_epilogue<float>", "cg_update",
              "cg_dot", "cg_xpay"):
        assert out["launches"][k] > 0, k


def test_one_nccl_rank_is_the_one_device_solver(dev):
    from multigrid_tpu_torch.parallel.programs import cube_program
    from multigrid_tpu_torch.parallel.sharding import check_backend, launch

    out = launch(cube_program, 1, "nccl", "cuda",
                 args=(poisson_cube_mesh(8),), kwargs=dict(single=True))
    assert out["single"]["fmg_equal"] and out["single"]["cg_equal"]
    with pytest.raises(ValueError, match="--backend gloo"):
        check_backend("nccl", torch.cuda.device_count() + 1, "cuda")


@pytest.mark.parametrize("path", ["dg-plain", "dg"])
def test_distributed_dg_slab_kernels_are_the_whole_grids(dev, path):
    from multigrid_tpu_torch.experiments.poisson_cube import exact_fn, rhs_fn
    from multigrid_tpu_torch.parallel.programs import dg_program
    from multigrid_tpu_torch.parallel.sharding import launch
    from multigrid_tpu_torch.solvers.multigrid_dg import (
        MultigridSolverDG, MultigridSolverDGPlain)

    mesh = poisson_cube_mesh(8)
    cls = MultigridSolverDGPlain if path == "dg-plain" else MultigridSolverDG
    one = cls(mesh, 4, exact_fn, rhs_fn, device=dev)
    x, its, rate = one.solve_cg(tolerance=1e-9)
    l2 = one.l2_error(x, one.exact_quad)
    out = launch(dg_program, 2, "gloo", "cuda", args=(mesh,),
                 kwargs=dict(path=path, reps=2, apply_seed=3))
    assert out["levels"][0 if path == "dg" else -1]
    for name, c in out["apply"].items():
        if name.endswith("vmult_plain"):
            assert c["max_diff"] <= 1e-13 * c["scale"], (name, c)
        else:
            assert c["equal"], (name, c)
    assert abs(out["frac_its"] / its - 1) <= 0.05
    assert abs(out["rate"] / rate - 1) <= 1e-3
    assert abs(out["L2"] / l2 - 1) <= 1e-6
    assert out["cg_repeat_equal"]
    for k in ("dg_apply<double>", "dg_apply<float>", "dg_cheb<float>",
              "cg_update", "cg_dot", "cg_xpay"):
        assert out["launches"][k] > 0, k


def test_dg_halo_wires_on_card(dev):
    from multigrid_tpu_torch.ops.dg import DGGrid
    from multigrid_tpu_torch.parallel.programs import dg_halo_program
    from multigrid_tpu_torch.parallel.sharding import launch

    cases = []
    for kind in ("gauss", "hermite"):
        for cells, shape in (((12, 6, 5), None), ((8, 6, 5), (2, 2))):
            g = DGGrid(cells=cells, jacobian=((0.25, 0.03, 0.0),
                                              (0.02, 0.31, 0.04),
                                              (0.0, 0.05, 0.21)),
                       degree=4, kind=kind)
            for wire in ("traces", "hermite"):
                cases.append((g, 5, wire, shape))
    for world in (2, 4):
        todo = [c for c in cases if (c[3] is None) == (world == 2)]
        for case, out in zip(todo, launch(
                dg_halo_program, world, "gloo", "cuda", args=(todo,),
                kwargs=dict(collect=False, whole=True))):
            w = out["vmult_whole"]
            if case[2] == "traces":
                assert w["equal"], (case, w)
            else:
                assert w["max_diff"] <= 1e-12 * w["scale"], (case, w)
            assert out["vmult_plain_whole"]["max_diff"] <= \
                1e-12 * out["vmult_plain_whole"]["scale"]
