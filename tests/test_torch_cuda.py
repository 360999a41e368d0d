"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need an NVIDIA GPU (and ``nvcc`` to build
``multigrid_tpu_torch/csrc``), and skip without one.  Run them on the card
with ``python -m pytest tests/test_torch_cuda.py -q``.  Bars as in
chip_smoke.py: brick_apply 1e-13 (f64) / 2e-6 (f32) of max|y|, the
Chebyshev epilogue 3e-6 of max|out|, the CG vector kernels 1e-14; the DG
kernels against the plain f64 operator at 1e-13 (dg_apply<double>), 3e-6
(dg_apply<float>) of max|y| and 1e-5 of max|out| (dg_cheb<float>, on the
smoother's iterates; 1e-6 of max|x| with f2 = 0).  The
launch counters count device kernels: 8 parity classes per brick_apply on
grids of two or more cells per axis, 2 per reduction, 1 per xpay, 1 per DG
kernel call.  The size-4 FE_Q and DG solves on the card agree with the CPU
to 1e-5 of max|u|."""

import numpy as np
import pytest
import torch

from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid, poisson_cube_mesh

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


GRIDS = {"cube8": lambda: DofGrid(poisson_cube_mesh(8), 3, 4),
         "aniso": lambda: DofGrid(BrickMesh((3, 4, 5), (-0.9,) * 3,
                                            (1.9, 1.3, 1.1)), 0, 4),
         "p2": lambda: DofGrid(poisson_cube_mesh(4), 2, 2)}


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 2e-6)])
def test_brick_apply_matches_plain(dev, grid, dtype, tol):
    from multigrid_tpu_torch.ops import laplace_kernel as lk

    g = GRIDS[grid]()
    op = lk.BrickLaplace(g, dtype, dev)
    x = rand(g.shape, dtype, dev, 1)
    name = "brick_apply<double>" if dtype == torch.float64 else "brick_apply<float>"
    before = lk.LAUNCHES[name]
    y = lk.brick_apply(x, op)
    assert lk.LAUNCHES[name] - before == 8
    want = lk.brick_apply_plain(x, op.K)
    torch.cuda.synchronize()
    assert float((y - want).abs().max()) <= tol * float(want.abs().max())


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
@pytest.mark.parametrize("p", [3, 4, 6])
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
                           "dg_cheb<float>": 6}


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
