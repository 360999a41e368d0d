"""Where the device time of the poisson_cube and poisson_dg solves goes, on
one CUDA device.

    python -m multigrid_tpu_torch.experiments.profile_solve 64 128 \\
        --out chiprun_out/profile_solve.json
    python -m multigrid_tpu_torch.experiments.profile_solve 48 64 --path dg
    python -m multigrid_tpu_torch.experiments.profile_solve 48 --path dg-plain
    python -m multigrid_tpu_torch.experiments.profile_solve 5 --path shell
    python -m multigrid_tpu_torch.experiments.profile_solve 48 --path dg-curved
    python -m multigrid_tpu_torch.experiments.profile_solve 8 --path l
    python -m multigrid_tpu_torch.experiments.profile_solve 64 --path \\
        dg-plain --dim 2 --degree 3
    python -m multigrid_tpu_torch.experiments.profile_solve 28 --degree 9 \\
        --levels

For each cube size (``poisson_cube_mesh(size, dim)``, FE_Q(degree)) and each of
FMG (``solve``) and V-cycle-preconditioned CG (``solve_cg``) -- with
``--path dg``, the poisson_dg CG (hermite, n_pre = n_post = 3, rtol 1e-9);
with ``--path dg-plain``, the poisson_dg_plain CG (pure-DG h-multigrid, the
same settings); with ``--path dg-curved``, the same CG on the curved
geometry of ``poisson_dg_plain --deform`` (factor 0.05); with ``--path
shell``, poisson_shell's FMG and CG (mixed precision, FE_Q(degree), n_pre =
n_post = 3) on the 6-block shell with ``size`` levels; with ``--path l``,
poisson_l's CG (global coarsening, FE_Q(2) unless ``--degree`` says
otherwise) on the 2-D L refined uniformly ``size`` times and then
adaptively once (poisson_l's Kelly marking) -- one warm-up
run, the best of ``--repeat`` runs without the profiler (host clock around
``torch.cuda.synchronize``), then one run under ``torch.profiler``.  From
that run's trace: the device-busy time (union of kernel, memcpy and memset
intervals), the idle share (1 - busy / profiled wall, where the profiled
wall is the host time of that run) and each kernel class's share of the
summed device-event time, with its event count.  One line per cell is
printed, and with ``--out`` all numbers go to a JSON file.

The general-geometry, curved DG and adaptive paths are plain PyTorch, so
their kernels carry no name of their own.  For ``--path shell``,
``dg-curved`` and ``l`` the operator's and the transfers' methods run
inside ``torch.profiler.record_function`` ranges (:data:`RANGES`) for the
profiled run only, and a device event launched inside one of them (found
through the launch's correlation id) falls in the innermost range's class:

* shell: the operator's gather, scatter, 1-D contractions and
  quadrature-point product, and the transfers;
* dg-curved: the face traces (the gather of face values), the lifts (their
  scatter back), the operator's 1-D contractions (``apply_1d`` and
  ``sweep``, the matmuls), the rest of the apply (the per-point geometry
  products and the neighbour shifts), the transformed Jacobi's
  contractions and the transfers;
* l: the operator's weighted gather, the element matmul (the rest of
  ``apply_cells``), the weighted scatter, and the transfers.

With ``--levels`` (cube and dg paths) each ``brick_kron`` call of the
profiled run sits in a range named by its node grid, and the cell also
gives the brick kernels' device time and launches by kernel and grid
(``brick_levels``: "brick_kron<float> 64x64x64" -> seconds, launches),
so that a solve's brick time can be read level by level.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
from collections import defaultdict
from pathlib import Path

import torch

from ..devices import card_line
from ..mesh.brick import poisson_cube_mesh
from ..ops import dg_curved, dg_precond
from ..ops import laplace_kernel as lk
from ..ops.dg import DGLaplace
from ..ops.dg_transfer import DGTransfer
from ..ops.laplace_adaptive import AdaptiveLaplace
from ..ops.laplace_general import GeneralLaplace
from ..ops.transfer_general import GeneralTransfer
from ..solvers.multigrid import set_full_precision_matmul
from ..solvers.multigrid_adaptive import NestedTransfer
from ..solvers.multigrid_dg import MultigridSolverDG, MultigridSolverDGPlain
from ..utils.profiling import device_trace, profile_fn
from .poisson_cube import build_solver, exact_fn, rhs_fn
from . import poisson_l, poisson_shell
from .poisson_dg_plain import deform_chart

# class -> substrings of the demangled kernel name (first match wins; the
# port's own kernels sit in an anonymous namespace)
CLASSES = (
    ("brick_kron<float>", ("brick_kron_kernel<float,",
                           "brick_cell_kernel<float,",
                           "brick_layer_kernel<float,")),
    ("brick_kron<double>", ("brick_kron_kernel<double,",
                            "brick_cell_kernel<double,")),
    ("cheb_epilogue<float>", ("cheb_epilogue_kernel<float>",)),
    ("cheb_epilogue<double>", ("cheb_epilogue_kernel<double>",)),
    ("cg kernels", ("cg_update_kernel", "namespace)::dot_kernel",
                    "xpay_kernel", "finish_sum_kernel")),
    ("dg_apply<double>", ("dg_apply_kernel<double,", "dg_high_apply_kernel<")),
    ("dg_apply<float>", ("dg_apply_kernel<float,",)),
    ("dg_cheb<float>", ("dg_cheb_kernel<", "dg_high_cheb_kernel<")),
    ("matmul", ("gemm", "cutlass")),
    ("fill/copy", ("fill", "copy")),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# record_function ranges of the plain PyTorch paths: per path, (class or
# module, attribute) -> class of the device events launched inside
RANGES = {
    "shell": (
        (GeneralLaplace, "gather", "op gather"),
        (GeneralLaplace, "scatter_add", "op scatter"),
        (GeneralLaplace, "_eval_grads", "op contraction"),
        (GeneralLaplace, "_integrate_grads", "op contraction"),
        (GeneralLaplace, "_quad_op", "op quad-point"),
        (GeneralTransfer, "prolongate", "transfer"),
        (GeneralTransfer, "restrict", "transfer"),
    ),
    "dg-curved": (
        (dg_curved.DGLaplaceCurved, "apply", "op quad-point"),
        (DGLaplace, "_trace", "op gather"),
        (DGLaplace, "_lift", "op scatter"),
        (dg_curved, "apply_1d", "op matmul"),
        (dg_curved, "sweep", "op matmul"),
        (dg_precond, "sweep", "jacobi"),
        (DGTransfer, "prolongate", "transfer"),
        (DGTransfer, "restrict", "transfer"),
    ),
    "l": (
        (AdaptiveLaplace, "apply_cells", "op matmul"),
        (AdaptiveLaplace, "gather", "op gather"),
        (AdaptiveLaplace, "scatter", "op scatter"),
        (NestedTransfer, "prolongate", "transfer"),
        (NestedTransfer, "restrict", "transfer"),
    ),
}
# the port's own kernels keep their class inside a range
OWN_CLASSES = ("brick_kron", "cheb_epilogue", "cg kernels", "dg_")
# the range of a brick_kron call under --levels, before its node grid
LEVEL_RANGE = "grid "


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


def launch_ranges(events: list) -> dict:
    """Correlation id -> the innermost ``user_annotation`` range open on
    the host when that device event was launched."""
    points = []
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "user_annotation":
            points.append((e["ts"], 0, e["name"]))
            points.append((e["ts"] + e["dur"], 2, None))
        elif (e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})):
            points.append((e["ts"], 1, e["args"]["correlation"]))
    out, stack = {}, []
    for _, kind, payload in sorted(points, key=lambda p: (p[0], p[1])):
        if kind == 0:
            stack.append(payload)
        elif kind == 2:
            if stack:
                stack.pop()
        elif stack:
            out[payload] = stack[-1]
    return out


def breakdown(events: list, wall_s: float) -> dict:
    """Device-busy seconds, idle share and per-class shares from the
    ``traceEvents`` of a chrome trace taken over ``wall_s`` seconds; a
    device event launched inside a ``record_function`` range takes the
    range's name as its class, unless it is one of the port's kernels."""
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    busy = union_seconds([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    ranges = launch_ranges(events)
    time_us, count = defaultdict(float), defaultdict(int)
    level_s, level_n = {}, {}
    for e in dev:
        cls = kernel_class(e["name"]) if e["cat"] == "kernel" else "fill/copy"
        rng = ranges.get(e.get("args", {}).get("correlation"))
        if rng is not None and not cls.startswith(OWN_CLASSES):
            cls = rng
        time_us[cls] += e["dur"]
        count[cls] += 1
        if rng is not None and rng.startswith(LEVEL_RANGE) and \
                cls.startswith("brick_kron"):
            key = f"{cls} {rng.removeprefix(LEVEL_RANGE)}"
            level_s[key] = level_s.get(key, 0.0) + e["dur"] / 1e6
            level_n[key] = level_n.get(key, 0) + 1
    total = sum(time_us.values()) or 1.0
    order = sorted(time_us, key=lambda c: -time_us[c])
    out = {"profiled_wall_s": wall_s, "device_busy_s": busy,
           "idle_share": 1.0 - busy / wall_s, "device_events": len(dev),
           "share": {c: time_us[c] / total for c in order},
           "events": {c: count[c] for c in order}}
    if level_s:
        out["brick_levels"] = {k: {"seconds": level_s[k],
                                   "launches": level_n[k]}
                               for k in sorted(level_s)}
    return out


@contextlib.contextmanager
def level_ranges():
    """Run each ``brick_kron`` call inside a ``record_function`` range named
    by its node grid (``LEVEL_RANGE`` + "ZxYxX") while the context is
    open."""
    from torch.profiler import record_function

    fn = lk.brick_kron

    def wrapped(x, *a, **k):
        with record_function(LEVEL_RANGE + "x".join(map(str, x.shape))):
            return fn(x, *a, **k)

    lk.brick_kron = wrapped
    try:
        yield
    finally:
        lk.brick_kron = fn


@contextlib.contextmanager
def path_ranges(path: str):
    """Wrap the methods (and module functions) of ``RANGES[path]`` in
    ``record_function`` ranges while the context is open."""
    from torch.profiler import record_function

    saved = []
    for cls, meth, label in RANGES.get(path, ()):
        fn = getattr(cls, meth)
        saved.append((cls, meth, fn))

        def wrapped(*a, _fn=fn, _label=label, **k):
            with record_function(_label):
                return _fn(*a, **k)

        setattr(cls, meth, wrapped)
    try:
        yield
    finally:
        for cls, meth, fn in saved:
            setattr(cls, meth, fn)


def profile_call(fn, trace: Path, path: str = "cube",
                 levels: bool = False) -> dict:
    """Run ``fn`` once under ``torch.profiler``
    (:func:`~..utils.profiling.device_trace`) and break its trace down,
    inside the ranges of ``path`` (:func:`path_ranges`) and, with
    ``levels``, of :func:`level_ranges`."""
    with path_ranges(path), (level_ranges() if levels
                             else contextlib.nullcontext()), \
            device_trace(str(trace)):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    return breakdown(events, wall)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("sizes", type=int, nargs="+",
                    help="poisson_cube sizes (--path shell: shell levels; "
                         "--path l: uniform refinements of the L)")
    ap.add_argument("--degree", type=int, default=None,
                    help="element degree (default 4; 2 for --path l)")
    ap.add_argument("--dim", type=int, default=3, choices=[2, 3],
                    help="2: the 2-D ladder (cube, dg, dg-plain paths), whose "
                         "levels run the plain operators")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--out", default=None, help="JSON file for the numbers")
    ap.add_argument("--levels", action="store_true",
                    help="also the brick kernels' device time and launches "
                         "by node grid (cube and dg paths)")
    ap.add_argument("--path", default="cube",
                    choices=["cube", "dg", "dg-plain", "dg-curved", "shell",
                             "l"],
                    help="the solve to profile: poisson_cube (FMG and CG), "
                         "poisson_dg, poisson_dg_plain or its --deform (CG), "
                         "poisson_shell (FMG and CG), poisson_l (CG)")
    args = ap.parse_args(argv)
    if args.degree is None:
        args.degree = 2 if args.path == "l" else 4
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
        if args.path == "dg":
            solver = MultigridSolverDG(poisson_cube_mesh(size, args.dim),
                                       args.degree, exact_fn, rhs_fn,
                                       n_pre=3, n_post=3, device=dev)
            dofs = solver.dg_grid.n_dofs
            phases = (("dg cg", lambda: solver.solve_cg(tolerance=1e-9)),)
        elif args.path in ("dg-plain", "dg-curved"):
            mesh = poisson_cube_mesh(size, args.dim)
            solver = MultigridSolverDGPlain(
                mesh, args.degree, exact_fn, rhs_fn, kind="hermite", n_pre=3,
                n_post=3, device=dev,
                mapping=(deform_chart(mesh, 0.05)
                         if args.path == "dg-curved" else None))
            dofs = solver.grids[-1].n_dofs
            phases = ((f"{args.path} cg",
                       lambda: solver.solve_cg(tolerance=1e-9)),)
        elif args.path == "l":
            forest = poisson_l.l_forest(size)
            _, _, eta2, _ = poisson_l.run_cycle(forest, args.degree,
                                                device=dev)
            forest = poisson_l.refine_and_coarsen_fixed_number(
                forest, eta2, 0.15, 0.03)
            solver = poisson_l.build_solver(forest, args.degree, device=dev)
            dofs = solver.grids[-1].n_dofs
            phases = (("l cg", solver.solve_cg),)
        elif args.path == "shell":
            solver = poisson_shell.build_solver(
                poisson_shell.shell_mesh(2 * (size - 1)), args.degree,
                device=dev)
            dofs = solver.grids[solver.maxlevel].n_dofs
            phases = (("shell fmg", solver.solve), ("shell cg", solver.solve_cg))
        else:
            solver = build_solver(poisson_cube_mesh(size, args.dim),
                                  args.degree, device=dev)
            dofs = solver.grids[solver.maxlevel].n_dofs
            phases = (("fmg", solver.solve), ("cg", solver.solve_cg))
        for phase, fn in phases:
            walls = []
            profile_fn(fn, n_warmup=1, n_runs=args.repeat, walls=walls)
            cell = {"size": size, "dofs": dofs, "phase": phase,
                    "wall_s": min(walls), "walls_s": walls, "card": card,
                    **profile_call(fn, trace, args.path, args.levels)}
            cells.append(cell)
            shares = ", ".join(f"{c} {s:.3f}" for c, s in cell["share"].items())
            print(f"size {size} ({dofs} dofs) {phase}: wall {cell['wall_s']:.6f} s"
                  f" (runs {', '.join(f'{w:.6f}' for w in walls)}); profiled "
                  f"wall {cell['profiled_wall_s']:.6f} s, device busy "
                  f"{cell['device_busy_s']:.6f} s, idle share "
                  f"{cell['idle_share']:.4f}, {cell['device_events']} device "
                  f"events; shares: {shares} [{card}]", flush=True)
            for key, v in cell.get("brick_levels", {}).items():
                print(f"  {key}: {v['launches']} launches, "
                      f"{v['seconds']:.6f} s device [{card}]", flush=True)
        del solver
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(cells, indent=1))
    return cells


if __name__ == "__main__":
    main()
