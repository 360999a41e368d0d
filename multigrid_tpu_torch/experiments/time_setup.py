"""Host set-up of the poisson_shell ladder with and without the native mesh
helper.

    python -m multigrid_tpu_torch.experiments.time_setup 8 10 \\
        --out time_setup.json

For each ladder cycle (``poisson_shell.shell_mesh(cycle)``, FE_Q(degree);
cycle 8 is the 1,597,570-dof shell, cycle 10 the 12,681,474-dof one) it
builds every level's :class:`GeneralGrid` -- the only set-up step that
calls the helper -- once with ``mesh/meshgen.cpp`` and once with the numpy
versions (:func:`.native.quantize_labels_numpy`,
:func:`.native.block_cell_nodes_numpy`) in their place, in the order
native, numpy, numpy, native (``--repeat 1``: native, numpy), and prints
each build's host seconds, the seconds spent inside the two helper calls,
and whether both builds gave the same ``cell_nodes`` and ``boundary``.
With ``--solver`` it then times the whole solver set-up
(``poisson_shell.build_solver`` on ``--device``) once with the native
helper, to put the grids' share of it beside them.  The helper library is
built before the first timing.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..devices import card_line, resolve
from ..mesh import native
from ..mesh.mapped import GeneralGrid
from . import poisson_shell


@contextlib.contextmanager
def helper(kind: str, clock: list):
    """Route the grid builder's two helper calls to ``kind`` ("native" or
    "numpy") and add the seconds spent in them to ``clock[0]``."""
    quantize = {"native": native._quantize_labels,
                "numpy": native.quantize_labels_numpy}[kind]
    cell_nodes = {"native": native.block_cell_nodes,
                  "numpy": native.block_cell_nodes_numpy}[kind]
    saved = native._quantize_labels, native.block_cell_nodes

    def timed(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                clock[0] += time.perf_counter() - t0
        return call

    native._quantize_labels = timed(quantize)
    native.block_cell_nodes = timed(cell_nodes)
    try:
        yield
    finally:
        native._quantize_labels, native.block_cell_nodes = saved


def build_grids(cycle: int, degree: int, kind: str):
    mesh = poisson_shell.shell_mesh(cycle)
    clock = [0.0]
    with helper(kind, clock):
        t0 = time.perf_counter()
        grids = [GeneralGrid(mesh, l, degree) for l in range(mesh.n_levels)]
        wall = time.perf_counter() - t0
    return grids, wall, clock[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("cycles", type=int, nargs="+")
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--repeat", type=int, default=2, choices=(1, 2))
    ap.add_argument("--solver", action="store_true",
                    help="also time the whole solver set-up once")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="JSON file for the numbers")
    args = ap.parse_args(argv)
    native.load()
    card = card_line() if torch.cuda.is_available() else "no card"
    print(f"card: {card}")
    order = ("native", "numpy") if args.repeat == 1 else (
        "native", "numpy", "numpy", "native")
    rows = []
    for cycle in args.cycles:
        ref = None
        for kind in order:
            grids, wall, in_helper = build_grids(cycle, args.degree, kind)
            fine = grids[-1]
            same = True
            if ref is None:
                ref = [(g.cell_nodes, g.boundary) for g in grids]
            else:
                same = all(np.array_equal(a, g.cell_nodes)
                           and np.array_equal(b, g.boundary)
                           for (a, b), g in zip(ref, grids))
            row = {"cycle": cycle, "dofs": fine.n_dofs, "helper": kind,
                   "grids_s": wall, "in_helper_s": in_helper,
                   "same_as_first": same, "card": card}
            rows.append(row)
            print(f"cycle {cycle} ({fine.n_dofs} dofs) {kind}: grids "
                  f"{wall:.3f} s, of which helper {in_helper:.3f} s; same "
                  f"tables as the first build: {same}", flush=True)
            del grids, fine
            gc.collect()
            if not same:
                raise SystemExit("the two helpers built different grids")
        if args.solver:
            dev = resolve(args.device)
            t0 = time.perf_counter()
            s = poisson_shell.build_solver(poisson_shell.shell_mesh(cycle),
                                           args.degree, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            rows.append({"cycle": cycle, "dofs": s.grids[-1].n_dofs,
                         "helper": "native", "solver_setup_s": wall,
                         "card": card})
            print(f"cycle {cycle}: whole solver set-up (native) {wall:.3f} s",
                  flush=True)
            del s
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
