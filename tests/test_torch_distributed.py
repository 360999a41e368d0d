"""The port's rank-decomposed multigrid (``multigrid_tpu_torch.parallel.
distributed.DistributedMultigrid``) on 2 and 4 ranks of
``torch.distributed`` (gloo, the CPU), against the port's single-device
solver and the JAX ``DistributedMultigrid`` over a ``("z",)`` mesh.

The mesh is tests/test_distributed.py:19-30's (2 x 2 x 2 coarse cells,
three levels, FE_Q(4), 35,937 dofs).  Bars, the JAX test's: FMG to atol
1e-6 (the f32 V-cycle adds in another order), its L2 error to 1e-3
relative; CG its equal, reduction within 1e-4, solution to atol 1e-9.
The 4-rank run installs the JAX solver's state first
(``convert.load_state``: every rank the same smoother state, its slab of
the rhs).  The finest level splits and the coarsest is replicated; two CG
solves are bit for bit equal; one rank is the single-device solver bit for
bit; ``nccl`` with fewer cards than ranks raises, and a rank that fails
fails the launch with its traceback.  Each world size is one
launch of ``parallel.programs.cube_program`` (module-scoped).
"""

import numpy as np
import pytest
import torch

from experiments.poisson_cube import exact_fn as j_exact
from experiments.poisson_cube import rhs_fn as j_rhs
from multigrid_tpu.mesh.brick import BrickMesh as JBrickMesh
from multigrid_tpu.parallel.distributed import \
    DistributedMultigrid as JDistributedMultigrid
from multigrid_tpu.parallel.sharding import make_mesh
from multigrid_tpu.solvers.multigrid import MultigridSolver as JMultigridSolver
from multigrid_tpu_torch.experiments.poisson_cube import build_solver
from multigrid_tpu_torch.mesh.brick import BrickMesh
from multigrid_tpu_torch.parallel.programs import cube_program
from multigrid_tpu_torch.parallel.sharding import check_backend, launch

STATE_WORLD = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _geo(cls):
    return cls(coarse_cells=(2, 2, 2), origin=(-0.9,) * 3, lengths=(1.9,) * 3,
               n_levels=3)


@pytest.fixture(scope="module")
def single():
    """The port's single-device FMG and CG."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s = build_solver(_geo(BrickMesh), 4, n_cycles=2, device="cpu")
        sol = s.solve()
        cg, its, red = s.solve_cg()
        return dict(fmg=sol.numpy(), fmg_L2error=s.l2_error(s.maxlevel, sol),
                    cg=cg.numpy(), cg_its=its, cg_reduction=red)
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX DistributedMultigrid's FMG and CG, and its solver's state."""
    s = JMultigridSolver(_geo(JBrickMesh), 4, j_exact, j_rhs, n_pre=2,
                         n_post=2, n_cycles=2)
    dm = JDistributedMultigrid(s, make_mesh(8, ("z",)))
    sol = dm.solve()
    cg, its, red = dm.solve_cg()
    state = {
        "rhs": [np.asarray(r) for r in s.rhs],
        "u_bc": [[np.asarray(f) for f in faces] for faces in s.u_bc],
        "chebyshev": [(m.theta, m.delta, m.degree, m.max_eig, m.min_eig)
                      for m in s.smoothers],
        "element_matrix": [np.asarray(op.K) for op in s.sp_ops],
    }
    return dict(fmg=np.asarray(sol), fmg_L2error=s.l2_error(s.maxlevel, sol),
                cg=np.asarray(cg), cg_its=its, cg_reduction=red), state


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}ranks")
def ranks_run(request, jax_run):
    n = request.param
    state = jax_run[1] if n == STATE_WORLD else None
    return n, launch(cube_program, n, "gloo", "cpu", args=(_geo(BrickMesh),),
                     kwargs=dict(reps=2, state=state, collect=True))


@pytest.mark.parametrize("against", ["single", "jax"])
def test_fmg_matches(ranks_run, single, jax_run, against):
    _, out = ranks_run
    ref = single if against == "single" else jax_run[0]
    np.testing.assert_allclose(out["fmg"], ref["fmg"], rtol=0, atol=1e-6)
    assert abs(out["fmg_L2error"] - ref["fmg_L2error"]) \
        <= 1e-3 * abs(ref["fmg_L2error"])


@pytest.mark.parametrize("against", ["single", "jax"])
def test_cg_matches(ranks_run, single, jax_run, against):
    _, out = ranks_run
    ref = single if against == "single" else jax_run[0]
    assert out["cg_its"] == ref["cg_its"]
    assert abs(out["cg_reduction"] - ref["cg_reduction"]) < 1e-4
    np.testing.assert_allclose(out["cg"], ref["cg"], rtol=0, atol=1e-9)


def test_levels_split_and_replicate(ranks_run):
    n, out = ranks_run
    assert out["levels"][-1], "the finest level must split"
    assert not out["levels"][0], "the coarsest level must be replicated"
    assert out["bounds"][-1][-1] == 8 and len(out["bounds"][-1]) == n + 1


def test_cg_solves_repeat_bit_for_bit(ranks_run):
    _, out = ranks_run
    assert out["cg_repeat_equal"]


def test_one_rank_is_the_single_device_solver():
    out = launch(cube_program, 1, "gloo", "cpu", args=(_geo(BrickMesh),),
                 kwargs=dict(single=True))
    assert out["levels"] == [False, False, False]
    assert out["single"]["fmg_equal"] and out["single"]["cg_equal"]


def test_nccl_needs_a_card_per_rank():
    with pytest.raises(ValueError, match="--backend gloo"):
        check_backend("nccl", 2, "cuda" if torch.cuda.device_count() < 2
                      else "cpu")
    with pytest.raises(ValueError, match="--backend gloo"):
        launch(cube_program, 2, "nccl", "cpu", args=(_geo(BrickMesh),))
    with pytest.raises(ValueError, match="backend"):
        check_backend("mpi", 2, "cpu")


def test_a_failed_rank_fails_the_launch():
    line = BrickMesh((4,), (0.0,), (1.0,), n_levels=2)
    with pytest.raises(RuntimeError, match="failed:(.|\n)*3-D bricks"):
        launch(cube_program, 2, "gloo", "cpu", args=(line,), timeout_s=120)
