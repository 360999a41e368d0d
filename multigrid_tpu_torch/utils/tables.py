"""Convergence-table reporting mirroring deal.II's ``ConvergenceTable``
output schema (reference poisson_cube/program.cc:390-400, 578-606) so
runs are directly comparable with the reference transcript."""

from __future__ import annotations

import math


def reduction_rate_log2(errors, cells, dim):
    """log2 reduction rates as in ConvergenceTable::reduction_rate_log2."""
    rates = [None]
    for i in range(1, len(errors)):
        if errors[i] == 0 or errors[i - 1] == 0 or cells[i] == cells[i - 1]:
            rates.append(None)
            continue
        rates.append(
            dim
            * math.log(errors[i - 1] / errors[i])
            / math.log(cells[i] / cells[i - 1])
        )
    return rates


def print_convergence_table(rows: list[dict], dim: int = 3):
    if not rows:
        return
    cols = [
        "cells", "dofs", "mv_outer", "mv_inner", "reduction",
        "fmg_L2error", "fmg_time", "cg_L2error", "cg_time", "cg_its",
        "cg_reduction",
    ]
    cells = [r["cells"] for r in rows]
    rates = {}
    for c in ("fmg_L2error", "cg_L2error"):
        if all(c in r for r in rows):
            rates[c] = reduction_rate_log2([r[c] for r in rows], cells, dim)

    def fmt(r, c, i):
        v = r.get(c)
        if v is None:
            return "-"
        if c in ("cells", "dofs", "cg_its"):
            return str(int(v))
        s = f"{float(v):.3e}"
        if c in rates:
            rate = rates[c][i]
            s += " -" if rate is None else f" {rate:.2f}"
        return s

    table = [[fmt(r, c, i) for c in cols] for i, r in enumerate(rows)]
    widths = [max(len(c), *(len(row[j]) for row in table)) for j, c in enumerate(cols)]
    print("  ".join(c.ljust(w) for c, w in zip(cols, widths)))
    for row in table:
        print("  ".join(v.ljust(w) for v, w in zip(row, widths)))
