"""poisson_cube (or a DG solver) on ranks against one device, backend by
backend.

    python -m multigrid_tpu_torch.experiments.time_ranks 128 64 --ranks 4 \\
        --backends nccl gloo
    python -m multigrid_tpu_torch.experiments.time_ranks 64 --path dg \\
        --ranks 4 --backends nccl gloo
    python -m multigrid_tpu_torch.experiments.time_ranks 64 --ranks 4 \\
        --grid 4 --backends gloo
    python -m multigrid_tpu_torch.experiments.time_ranks 256 --path dg-plain \\
        --dim 2 --ranks 4 --backends gloo

For each cube size: the one-device row on the first card (FMG, V-cycle
reduction, FMG L2, CG its, reduction and wall, the CG solution saved under
``build/time_ranks/``), then the same row on ``--ranks`` ranks
(``parallel.programs.cube_program``: set-up, FMG and CG walls of two
solves each, the CG solution against the one-device one, two CG solves
and the owned nodes of the distributed apply bit for bit, the exchange
split of the f64 vmult in the apply-then-refresh order, its refresh by
step and the bytes a refresh by stage; on cuts that split, the same vmult
in the overlap schedule of ``parallel.halo.SplitApply``, ``split_line``:
with and without its exchange, the refresh alone, the hidden share, the
plan's overlappable fraction and its box against apply-then-refresh bit
for bit; the peak device memory of a rank) for each backend in turn.  The
ranks form the grid ``--grid NZxNY`` (or ``--grid N``, z-slabs; default:
the experiments' rule, ``parallel.sharding.default_grid``: z-slabs below 4
ranks, 4 -> 2x2); on a z x y grid a refresh has two stages, the y rows
then the z planes, and its steps are named by them ("y wire", "z
wire").  Rank r runs on ``cuda:(r % cards)``:
with as many cards as ranks, each rank has its own; ``nccl`` needs that.
A row is ``ok`` when its its, reductions and FMG L2 are the one-device
row's within 3%, its CG solution within 1e-7 of max|u|, and the bit for
bit checks hold.  ``--device cpu`` runs it on the CPU (gloo only), to
rehearse.

``--path dg`` (poisson_dg: hermite p = 4, n_pre 3, rtol 1e-9; the FE_Q
hierarchy on the ranks too) and ``--path dg-plain`` (poisson_dg_plain:
gauss p = 4, n_pre 3) run ``parallel.programs.dg_program`` instead: the
one-device row (frac its, rate, L2, CG wall) and per backend set-up, the
CG walls of two solves, frac its, rate, L2, the CG solution against the
one-device one, the owned cells of ``dg_apply<double>``,
``dg_residual<float>`` and ``dg_cheb<float>`` on the slab against
``DGOperator`` on the whole grid (bit for bit) and against the plain
algorithm, and the exchange split of the finest level's f32 apply with
the bytes of a refresh, by wire (both wires for dg-plain).  A DG row is
``ok`` when its frac its are within 5%, its rate within 1e-3 and its L2
within 1e-6 relative of the one-device row, its CG solution within 1e-7
of max|u|, and the bit for bit checks hold.  ``--dim 2`` runs the DG
paths on the 2-D cube (``poisson_cube_mesh(size, 2)``), whose DG levels
run the plain operators on every device: there the slab passes are held
to the whole grid's within ``PLAIN_ROUTE_BAR`` of max|y| (a box and the
whole grid are tensor contractions of other shapes, whose sums may round
apart), the kernels of a 3-D row bit for bit.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..devices import card_line
from ..mesh.brick import poisson_cube_mesh
from ..parallel.programs import cube_program, dg_program
from ..parallel.sharding import default_grid, launch, parse_grid
from .poisson_cube import build_solver, exact_fn, rhs_fn

OUT = Path(__file__).resolve().parents[2] / "build" / "time_ranks"
ROW_TOL = 0.03
SOL_BAR = 1e-7
# the DG rows: (kind, wires of the exchange split); degree 4, n_pre 3
DG_PATHS = {"dg": ("hermite", ("traces",)),
            "dg-plain": ("gauss", ("traces", "hermite"))}
DG_DEGREE, DG_N_PRE, DG_RTOL = 4, 3, 1e-9
DG_ITS_TOL, DG_RATE_TOL, DG_L2_TOL = 0.05, 1e-3, 1e-6
PLAIN_BAR = 1e-12          # the slab apply against the plain algorithm
# a 2-D row's plain slab passes against the whole grid's, of max|y|, by
# value type (f32 on the CPU: 4.8e-7 apart on 2 x 2 ranks)
PLAIN_ROUTE_BAR = {"float": 1e-6, "double": 1e-12}


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
            and all(v["equal"] for v in out["apply"].values())
            and (out["comm"]["overlap"] or {}).get("equal", True))


def one_device_dg(size: int, path: str, dev: torch.device,
                  out: Path, dim: int = 3) -> dict:
    """The one-device DG row on the ``dim``-D cube; its CG solution goes to
    ``out``."""
    from ..solvers.multigrid_dg import MultigridSolverDG, \
        MultigridSolverDGPlain

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    cls = MultigridSolverDG if path == "dg" else MultigridSolverDGPlain
    s = cls(poisson_cube_mesh(size, dim), DG_DEGREE, exact_fn, rhs_fn,
            kind=DG_PATHS[path][0], n_pre=DG_N_PRE, n_post=DG_N_PRE,
            device=dev)
    s.solve_cg(tolerance=DG_RTOL)
    sync()
    t0 = time.perf_counter()
    x, its, rate = s.solve_cg(tolerance=DG_RTOL)
    sync()
    cg_s = time.perf_counter() - t0
    np.save(out, x.cpu().numpy())
    return dict(frac_its=its, rate=rate, L2=s.l2_error(x, s.exact_quad),
                cg_time=cg_s, dg_dofs=x.numel())


def apply_ok(name: str, check: dict, plain_route: bool) -> bool:
    """One slab pass of ``dg_program``'s apply check: against the plain
    algorithm within ``PLAIN_BAR``; against the whole grid bit for bit,
    or on the plain route within ``PLAIN_ROUTE_BAR``."""
    if name.endswith("vmult_plain"):
        return check["max_diff"] <= PLAIN_BAR * check["scale"]
    bar = PLAIN_ROUTE_BAR["float" if "<float>" in name else "double"]
    return check["equal"] or (plain_route and check["max_diff"]
                              <= bar * check["scale"])


def dg_row_ok(out: dict, ref: dict) -> bool:
    return (abs(out["frac_its"] / ref["frac_its"] - 1) <= DG_ITS_TOL
            and abs(out["rate"] / ref["rate"] - 1) <= DG_RATE_TOL
            and abs(out["L2"] / ref["L2"] - 1) <= DG_L2_TOL
            and out["cg_ref_diff"] <= SOL_BAR * out["cg_ref_max"]
            and out["cg_repeat_equal"]
            and all(apply_ok(k, v, out["plain_route"])
                    for k, v in out["apply"].items()))


def dg_kwargs(path: str, reference: Path, comm_reps: int = 10,
              shape=None) -> dict:
    """``dg_program``'s keywords for a DG row of ``path`` on the rank grid
    ``shape``."""
    kind, wires = DG_PATHS[path]
    return dict(path=path, degree=DG_DEGREE, kind=kind, n_pre=DG_N_PRE,
                tolerance=DG_RTOL, reps=2, reference=str(reference),
                apply_seed=3, comm_reps=comm_reps, comm_wires=wires,
                shape=shape)


def comm_line(comm: dict) -> str:
    """One wire's exchange split: the apply with and without the refresh,
    the share, this rank's refresh by step, the bytes a refresh (by stage
    where it has stages)."""
    stages = comm.get("bytes_by_stage")
    by = "" if not stages or len(stages) < 2 else " (" + ", ".join(
        f"{k} {v}" for k, v in stages.items()) + ")"
    return (f"{comm['total'] * 1e3:.3f} / {comm['cell_loop'] * 1e3:.3f} ms, "
            f"share {comm['comm_fraction']:.3f}, refresh "
            + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in comm["steps"].items())
            + f" ms, {comm['bytes']} B{by}")


def split_line(comm: dict) -> str:
    """The f64 vmult in the overlap schedule beside its parts (``overlap``
    of ``HaloLaplace.comm_split_report``): with and without the exchange,
    the refresh alone, the hidden share, the plan's overlappable fraction
    (``utils.overlap``), the cells a pass applies, the box's bits."""
    sc = comm["overlap"]
    if sc is None:
        return "the level does not split (apply then refresh)"
    return (f"{sc['total'] * 1e3:.3f} / {sc['cell_loop'] * 1e3:.3f} ms, "
            f"refresh alone {sc['refresh'] * 1e3:.3f} ms, hidden "
            f"{sc['hidden']:.3f}, overlappable fraction "
            f"{sc['overlappable_fraction']:.3f}, rank 0 applies "
            f"{sc['cells']} cells a pass (its box {sc['box_cells']}), the "
            f"box apply-then-refresh's bit for bit {sc['equal']}")


def grid_name(shape) -> str:
    return "x".join(str(n) for n in shape)


def run_dg(args, dev) -> int:
    failed = 0
    for size in args.sizes:
        path = OUT / f"{args.path}{size}_{args.dim}d_cg.npy"
        ref = one_device_dg(size, args.path, dev, path, args.dim)
        print(f"{args.path} size {size} ({args.dim}-D), one device: "
              f"{ref['dg_dofs']} DG "
              f"dofs, frac its {ref['frac_its']:.6f}, rate {ref['rate']:.6e},"
              f" L2 {ref['L2']:.9e}, CG {ref['cg_time']:.4f} s", flush=True)
        for backend in args.backends:
            t0 = time.perf_counter()
            out = launch(dg_program, args.ranks, backend, args.device,
                         args=(poisson_cube_mesh(size, args.dim),),
                         kwargs=dg_kwargs(args.path, path, shape=args.grid))
            ok = dg_row_ok(out, ref)
            failed += not ok
            print(f"{args.path} size {size}, {args.ranks} ranks "
                  f"({grid_name(args.grid)}), {backend}: "
                  f"ok {ok}; levels split {out['levels']}, cuts "
                  f"{out['bounds']}; launch {time.perf_counter() - t0:.1f} s, "
                  f"set-up {out['setup_time']:.2f} s, CG "
                  f"{', '.join(f'{t:.4f}' for t in out['cg_times'])} s, frac "
                  f"its {out['frac_its']:.6f}, rate {out['rate']:.6e}, L2 "
                  f"{out['L2']:.9e}; CG solution max diff "
                  f"{out['cg_ref_diff']:.3e} of {out['cg_ref_max']:.4e}"
                  + (f"; peak device memory of a rank "
                     f"{int(out['peak_bytes'])} bytes"
                     if "peak_bytes" in out else ""), flush=True)
            for k, v in out["apply"].items():
                print(f"  {k}: owned cells bit for bit {v['equal']}, max "
                      f"diff {v['max_diff']:.3e} of {v['scale']:.3e}")
            for wire, comm in out["comm"].items():
                print(f"  f32 apply, {wire} wire: {comm_line(comm)}")
        path.unlink()
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("sizes", type=int, nargs="*")
    ap.add_argument("--path", default="cube", choices=["cube", *DG_PATHS])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--grid", type=parse_grid, default=None,
                    help="rank grid NZxNY or N (default: z-slabs below 4 "
                         "ranks, a z x y grid from 4 on)")
    ap.add_argument("--backends", nargs="+", default=["nccl", "gloo"],
                    choices=["nccl", "gloo"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dim", type=int, default=3, choices=[2, 3],
                    help="the DG paths' cube: 3-D (default) or 2-D")
    args = ap.parse_args(argv)
    if args.dim != 3 and args.path == "cube":
        raise SystemExit("--dim 2 takes --path dg or dg-plain")
    if args.grid is None:
        args.grid = default_grid(args.ranks)
    if int(np.prod(args.grid)) != args.ranks:
        raise SystemExit(f"--grid {grid_name(args.grid)} is not "
                         f"{args.ranks} ranks")
    dev = torch.device("cuda", 0) if args.device == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; --device cpu runs the CPU")
        print(f"# card: {card_line()} x {torch.cuda.device_count()}",
              flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    if args.path != "cube":
        args.sizes = args.sizes or [64 if args.path == "dg" else 48]
        return run_dg(args, dev)
    args.sizes = args.sizes or [128, 64]
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
                                     apply_seed=3, comm_reps=10,
                                     shape=args.grid))
            ok = row_ok(out, ref)
            failed += not ok
            comm = out["comm"]
            print(f"size {size}, {args.ranks} ranks ({grid_name(args.grid)}),"
                  f" {backend}: ok {ok}; "
                  f"levels split {out['levels']}; launch "
                  f"{time.perf_counter() - t0:.1f} s, set-up "
                  f"{out['setup_time']:.2f} s, FMG "
                  f"{', '.join(f'{t:.4f}' for t in out['fmg_times'])} s, CG "
                  f"{', '.join(f'{t:.4f}' for t in out['cg_times'])} s, "
                  f"{out['cg_its']} its, CG reduction "
                  f"{out['cg_reduction']:.6e}, V-cycle reduction "
                  f"{out['reduction']:.6e}, FMG L2 {out['fmg_L2error']:.6e}; "
                  f"CG solution max diff {out['cg_ref_diff']:.3e} of "
                  f"{out['cg_ref_max']:.4e}; f64 vmult, apply then "
                  f"refresh, rank 0's refresh: {comm_line(comm)}"
                  + (f"; peak device memory of a rank "
                     f"{int(out['peak_bytes'])} bytes"
                     if "peak_bytes" in out else ""), flush=True)
            print(f"  f64 vmult, overlap schedule: {split_line(comm)}",
                  flush=True)
        path.unlink()
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
