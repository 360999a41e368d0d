"""poisson_cube on ranks against one device, backend by backend.

    python -m multigrid_tpu_torch.experiments.time_ranks 128 64 --ranks 4 \\
        --backends nccl gloo

For each cube size: the one-device row on the first card (FMG, V-cycle
reduction, FMG L2, CG its, reduction and wall, the CG solution saved under
``build/time_ranks/``), then the same row on ``--ranks`` ranks
(``parallel.programs.cube_program``: set-up, FMG and CG walls of two
solves each, the CG solution against the one-device one, two CG solves
and the owned planes of the distributed apply bit for bit, the exchange
split of the f64 vmult and its refresh by step, the peak device memory of
a rank) for each backend in turn.  Rank r runs on ``cuda:(r % cards)``:
with as many cards as ranks, each rank has its own; ``nccl`` needs that.
A row is ``ok`` when its its, reductions and FMG L2 are the one-device
row's within 3%, its CG solution within 1e-7 of max|u|, and the bit for
bit checks hold.  ``--device cpu`` runs it on the CPU (gloo only), to
rehearse.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..devices import card_line
from ..mesh.brick import poisson_cube_mesh
from ..parallel.programs import cube_program
from ..parallel.sharding import launch
from .poisson_cube import build_solver

OUT = Path(__file__).resolve().parents[2] / "build" / "time_ranks"
ROW_TOL = 0.03
SOL_BAR = 1e-7


def one_device(size: int, dev: torch.device, path: Path) -> dict:
    """The one-device row; its CG solution goes to ``path``."""
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    s = build_solver(poisson_cube_mesh(size), 4, device=dev)
    sol = s.solve()
    _, _, red = s.solve_analyze()
    fmg_l2 = s.l2_error(s.maxlevel, sol)
    del sol
    s.solve_cg()
    sync()
    t0 = time.perf_counter()
    x, its, cg_red = s.solve_cg()
    sync()
    cg_s = time.perf_counter() - t0
    np.save(path, x.cpu().numpy())
    return dict(reduction=red, fmg_L2error=fmg_l2, cg_its=its,
                cg_reduction=cg_red, cg_time=cg_s)


def row_ok(out: dict, ref: dict) -> bool:
    return (out["cg_its"] == ref["cg_its"]
            and all(abs(out[k] / ref[k] - 1) <= ROW_TOL
                    for k in ("cg_reduction", "reduction", "fmg_L2error"))
            and out["cg_ref_diff"] <= SOL_BAR * out["cg_ref_max"]
            and out["cg_repeat_equal"]
            and all(v["equal"] for v in out["apply"].values()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("sizes", type=int, nargs="*", default=[128, 64])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backends", nargs="+", default=["nccl", "gloo"],
                    choices=["nccl", "gloo"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0) if args.device == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; --device cpu runs the CPU")
        print(f"# card: {card_line()} x {torch.cuda.device_count()}",
              flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    failed = 0
    for size in args.sizes:
        path = OUT / f"cube{size}_cg.npy"
        ref = one_device(size, dev, path)
        print(f"size {size}, one device: its {ref['cg_its']}, CG "
              f"{ref['cg_time']:.4f} s, CG reduction "
              f"{ref['cg_reduction']:.6e}, V-cycle reduction "
              f"{ref['reduction']:.6e}, FMG L2 {ref['fmg_L2error']:.6e}",
              flush=True)
        for backend in args.backends:
            t0 = time.perf_counter()
            out = launch(cube_program, args.ranks, backend, args.device,
                         args=(poisson_cube_mesh(size),),
                         kwargs=dict(reps=2, reference=str(path),
                                     apply_seed=3, comm_reps=10))
            ok = row_ok(out, ref)
            failed += not ok
            comm = out["comm"]
            print(f"size {size}, {args.ranks} ranks, {backend}: ok {ok}; "
                  f"levels split {out['levels']}; launch "
                  f"{time.perf_counter() - t0:.1f} s, set-up "
                  f"{out['setup_time']:.2f} s, FMG "
                  f"{', '.join(f'{t:.4f}' for t in out['fmg_times'])} s, CG "
                  f"{', '.join(f'{t:.4f}' for t in out['cg_times'])} s, "
                  f"{out['cg_its']} its, CG reduction "
                  f"{out['cg_reduction']:.6e}, V-cycle reduction "
                  f"{out['reduction']:.6e}, FMG L2 {out['fmg_L2error']:.6e}; "
                  f"CG solution max diff {out['cg_ref_diff']:.3e} of "
                  f"{out['cg_ref_max']:.4e}; f64 vmult "
                  f"{comm['total'] * 1e3:.3f} ms, without the refresh "
                  f"{comm['cell_loop'] * 1e3:.3f} ms, exchange share "
                  f"{comm['comm_fraction']:.3f}, rank 0's refresh "
                  + ", ".join(f"{k} {v * 1e3:.3f} ms"
                              for k, v in comm["steps"].items())
                  + (f"; peak device memory of a rank "
                     f"{int(out['peak_bytes'])} bytes"
                     if "peak_bytes" in out else ""), flush=True)
        path.unlink()
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
