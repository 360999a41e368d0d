"""Where the device time of the poisson_cube and poisson_dg solves goes, on
one CUDA device.

    python -m multigrid_tpu_torch.experiments.profile_solve 64 128 \\
        --out chiprun_out/profile_solve.json
    python -m multigrid_tpu_torch.experiments.profile_solve 48 64 --dg

For each cube size (``poisson_cube_mesh(size)``, FE_Q(degree)) and each of
FMG (``solve``) and V-cycle-preconditioned CG (``solve_cg``) -- with
``--dg``, the poisson_dg CG (hermite, n_pre = n_post = 3, rtol 1e-9) -- one
warm-up
run, the best of ``--repeat`` runs without the profiler (host clock around
``torch.cuda.synchronize``), then one run under ``torch.profiler``.  From
that run's trace: the device-busy time (union of kernel, memcpy and memset
intervals), the idle share (1 - busy / profiled wall, where the profiled
wall is the host time of that run) and each kernel class's share of the
summed device-event time, with its event count.  One line per cell is
printed, and with ``--out`` all numbers go to a JSON file.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch

from ..mesh.brick import poisson_cube_mesh
from ..solvers.multigrid import set_full_precision_matmul
from ..solvers.multigrid_dg import MultigridSolverDG
from .poisson_cube import build_solver, exact_fn, rhs_fn

# class -> substrings of the demangled kernel name (first match wins; the
# port's own kernels sit in an anonymous namespace)
CLASSES = (
    ("brick_apply<float>", ("brick_apply_kernel<float>",)),
    ("brick_apply<double>", ("brick_apply_kernel<double>",)),
    ("cheb_epilogue<float>", ("cheb_epilogue_kernel<float>",)),
    ("cheb_epilogue<double>", ("cheb_epilogue_kernel<double>",)),
    ("cg kernels", ("cg_update_kernel", "namespace)::dot_kernel",
                    "xpay_kernel", "finish_sum_kernel")),
    ("dg_apply<double>", tuple(f"dg_kernel<double, {n}, false>"
                               for n in range(2, 9))),
    ("dg_apply<float>", tuple(f"dg_kernel<float, {n}, false>"
                              for n in range(2, 9))),
    ("dg_cheb<float>", tuple(f"dg_kernel<float, {n}, true>"
                             for n in range(2, 9))),
    ("matmul", ("gemm", "cutlass")),
    ("fill/copy", ("fill", "copy")),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k.lower() in low for k in keys):
            return cls
    return "other torch"


def union_seconds(intervals_us) -> float:
    """Length of the union of ``(start, end)`` intervals (microseconds), in
    seconds."""
    total, reach = 0.0, -math.inf
    for start, end in sorted(intervals_us):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e6


def breakdown(events: list, wall_s: float) -> dict:
    """Device-busy seconds, idle share and per-class shares from the
    ``traceEvents`` of a chrome trace taken over ``wall_s`` seconds."""
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    busy = union_seconds([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    time_us, count = defaultdict(float), defaultdict(int)
    for e in dev:
        cls = kernel_class(e["name"]) if e["cat"] == "kernel" else "fill/copy"
        time_us[cls] += e["dur"]
        count[cls] += 1
    total = sum(time_us.values()) or 1.0
    order = sorted(time_us, key=lambda c: -time_us[c])
    return {"profiled_wall_s": wall_s, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall_s, "device_events": len(dev),
            "share": {c: time_us[c] / total for c in order},
            "events": {c: count[c] for c in order}}


def profile_call(fn, trace: Path) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and break its trace down."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    return breakdown(events, wall)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("sizes", type=int, nargs="+", help="poisson_cube sizes")
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--out", default=None, help="JSON file for the numbers")
    ap.add_argument("--dg", action="store_true",
                    help="profile the poisson_dg solve at these sizes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_solve needs a CUDA device")
    set_full_precision_matmul()
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    trace = Path(args.out or "profile_solve.json").with_suffix(".trace.json")
    trace.parent.mkdir(parents=True, exist_ok=True)
    cells = []
    for size in args.sizes:
        if args.dg:
            solver = MultigridSolverDG(poisson_cube_mesh(size), args.degree,
                                       exact_fn, rhs_fn, n_pre=3, n_post=3,
                                       device=dev)
            dofs = solver.dg_grid.n_dofs
            phases = (("dg cg", lambda: solver.solve_cg(tolerance=1e-9)),)
        else:
            solver = build_solver(poisson_cube_mesh(size), args.degree,
                                  device=dev)
            dofs = solver.grids[solver.maxlevel].n_dofs
            phases = (("fmg", solver.solve), ("cg", solver.solve_cg))
        for phase, fn in phases:
            fn()
            torch.cuda.synchronize()
            walls = []
            for _ in range(args.repeat):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            cell = {"size": size, "dofs": dofs, "phase": phase,
                    "wall_s": min(walls), "walls_s": walls, "card": card,
                    **profile_call(fn, trace)}
            cells.append(cell)
            shares = ", ".join(f"{c} {s:.3f}" for c, s in cell["share"].items())
            print(f"size {size} ({dofs} dofs) {phase}: wall {cell['wall_s']:.6f} s"
                  f" (runs {', '.join(f'{w:.6f}' for w in walls)}); profiled "
                  f"wall {cell['profiled_wall_s']:.6f} s, device busy "
                  f"{cell['device_busy_s']:.6f} s, idle share "
                  f"{cell['idle_share']:.4f}, {cell['device_events']} device "
                  f"events; shares: {shares} [{card}]", flush=True)
        del solver
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(cells, indent=1))
    return cells


if __name__ == "__main__":
    main()
