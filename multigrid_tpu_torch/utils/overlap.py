"""Structure of the exchange/compute overlap of the FE_Q halo operators.

Twin of ``multigrid_tpu/utils/overlap.py``.  The reference overlaps its
MPI exchanges with interior cell work through a hand-built schedule
(laplace_operator_dg.h:607-723); the JAX package measures the same thing
as the dependency cone of the first collective in the traced program,
which XLA's scheduler may overlap with everything outside it.  The port
has no program to trace: its schedule is explicit, a
:class:`~..parallel.halo.SplitPlan` per level, and the report reads it.
The first ``post`` of a pass waits for the sub-boxes of its stage (the z
boundary boxes on a z split, the y strips on a rank grid); every other
sub-box is applied while those planes travel.  A pass counts
``brick_kron``'s flops, ``14 (p + 2)`` a node of each sub-box (the bound
of ``chip_smoke.py``), so a sub-box counts with its margins.  What a run
hides is measured, not read: :func:`~..parallel.halo.comm_split`'s
``hidden``.
"""

from __future__ import annotations

import numpy as np


def collective_overlap_report(target) -> dict:
    """The overlap of one ``vmult`` of ``target`` (a
    :class:`~..parallel.halo.HaloLaplace` or its
    :class:`~..parallel.halo.Slabs`) on this rank: ``dict(flops_in_cone,
    flops_total, overlappable_fraction)`` as the JAX report, the flops the first
    exchange waits for and those of the whole pass; with ``split``
    (whether the level runs the schedule: else the pass is one apply of
    the box, all of it in the cone), ``applies`` (``brick_kron`` launches
    a pass) and ``cells`` (the cells a pass applies) beside ``box_cells``
    (the box's)."""
    slabs = getattr(target, "slabs", target)
    plan = slabs.plan
    cells = dict(cells=plan.cells_applied(),
                 box_cells=int(np.prod(slabs.local.cells)))
    if not plan.split:
        total = float(plan.flops(int(slabs.local.n_dofs)))
        return dict(flops_in_cone=total, flops_total=total,
                    overlappable_fraction=0.0, split=False, applies=1,
                    **cells)
    first = "y" if plan.of("y") else "z"
    flops = [plan.flops(b.nodes) for b in plan.boxes]
    cone = sum(f for f, b in zip(flops, plan.boxes) if b.role == first)
    total = sum(flops)
    return dict(flops_in_cone=float(cone), flops_total=float(total),
                overlappable_fraction=1.0 - cone / total, split=True,
                applies=len(plan.boxes), **cells)
