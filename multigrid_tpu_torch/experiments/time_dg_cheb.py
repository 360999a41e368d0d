"""Time one DG Chebyshev step (``dg_kernel.dg_cheb``) on the card.

    python -m multigrid_tpu_torch.experiments.time_dg_cheb [size] [degree]
        [--pencil K ...]

The poisson_dg grid of ``size``^3 cells (default 48, hermite, degree 4:
13,824,000 DG dofs) with the smoother's iterates; CUDA events over 50
calls after 3 warm-ups, three rounds of (step, step with x = 0, f32 A·x).
``--pencil K`` also builds ``csrc/dg_cheb.cu`` alone with K cells per
block (``-DDG_CHEB_PENCIL=K``) and times that step beside the library's,
after checking that it agrees with it to 1e-5·max|out| (K moves x faces
between the in-pencil and the neighbour path, which round apart).  Run
it with another tree's package on ``PYTHONPATH`` to time that tree in the
same call.  Prints the card line and one JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch


def time_ms(fn, reps: int = 50) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def pencil_entry(k: int):
    """``dg_cheb_f32`` of ``csrc/dg_cheb.cu`` built alone with ``k`` cells
    per block."""
    from multigrid_tpu_torch import _build

    src = _build.PACKAGE_DIR / "csrc" / "dg_cheb.cu"
    out = _build.BUILD_DIR / f"dg_cheb_pencil{k}_{_build._digest()}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                        f"-DDG_CHEB_PENCIL={k}", "-o", str(out), str(src)],
                       check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).dg_cheb_f32
    fn.argtypes = _build.SIGNATURES["dg_cheb_f32"]
    fn.restype = ctypes.c_int
    return fn


def main(argv: list[str]) -> int:
    from multigrid_tpu_torch import _build
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh
    from multigrid_tpu_torch.ops import dg_kernel as dk
    from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed
    from multigrid_tpu_torch.solvers.multigrid_dg import dg_grid_from_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("size", type=int, nargs="?", default=48)
    ap.add_argument("degree", type=int, nargs="?", default=4)
    ap.add_argument("--pencil", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_dg_cheb: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    mesh = poisson_cube_mesh(args.size)
    grid = dg_grid_from_mesh(mesh, mesh.max_level, args.degree, "hermite")
    op = dk.DGOperator(grid, torch.float32, dev)
    op.install_jacobi(JacobiTransformed(grid, torch.float32, dev))
    b, x, xo = dk.smoother_iterates(
        JacobiTransformed(grid, torch.float64, dev), 22)
    fns = dict(cheb=lambda: dk.dg_cheb(b, x, xo, op, 0.37, 0.81),
               cheb_x0=lambda: dk.dg_cheb(b, None, None, op, 0.0, 0.81),
               apply=lambda: dk.dg_apply(x, op))
    want = fns["cheb"]()
    for k in args.pencil:
        entry, out = pencil_entry(k), torch.empty_like(b)
        launched = ctypes.c_int(0)

        def step(entry=entry, out=out, launched=launched):
            err = entry(b.data_ptr(), x.data_ptr(), xo.data_ptr(),
                        op.jacobi.inv_diag.data_ptr(),
                        op.host_tables.ctypes.data, out.data_ptr(), 0.37,
                        0.81, *grid.cells, grid.n, 0,
                        _build.stream_handle(dev), ctypes.byref(launched))
            if err:
                raise RuntimeError(f"pencil {k}: cudaError {err}")

        step()
        torch.cuda.synchronize()
        diff = float((out - want).abs().max())
        if diff > 1e-5 * float(want.abs().max()):
            raise AssertionError(f"pencil {k}: the step differs by {diff}")
        fns[f"cheb_pencil{k}"] = step
    rounds = [{k: time_ms(fn) for k, fn in fns.items()} for _ in range(3)]
    print(card)
    print(json.dumps(dict(size=args.size, degree=args.degree,
                          dofs=grid.n_dofs, card=card, rounds=rounds,
                          best={k: min(r[k] for r in rounds) for k in fns})))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
