"""Device-memory telemetry.

Twin of ``multigrid_tpu/utils/memory.py``, the analogue of the reference's
MemoryConsumption reporting (poisson_cube/program.cc:273-279: MGTransfer /
level vector / operator memory per rank): per-level byte accounting of the
solver's live tensors (``Tensor.nbytes``) plus the CUDA caching
allocator's view under the JAX key names (``bytes_in_use``,
``peak_bytes_in_use``, ``bytes_limit``); on the CPU the allocator view is
``{}``, as JAX's is there.
"""

from __future__ import annotations

import torch


def device_memory_stats(device) -> dict:
    """Allocator stats of ``device`` in bytes: ``bytes_in_use`` and
    ``peak_bytes_in_use`` (``torch.cuda.memory_stats``, tensors allocated
    now and at the peak since the last ``reset_peak_memory_stats``) and
    ``bytes_limit`` (the card's memory, ``torch.cuda.mem_get_info``).
    ``{}`` for a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.mem_get_info(device)[1])}


def _nbytes(x) -> int:
    """Bytes of a tensor, or of the tensors in a list or tuple."""
    if isinstance(x, torch.Tensor):
        return int(x.nbytes)
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def solver_memory_report(solver) -> dict:
    """Byte accounting per level for a MultigridSolver-like object (rhs and
    boundary vectors, the hot-path operator's tensors) and the allocator's
    view of the solver's device."""
    per_level = []
    for l in range(len(solver.grids)):
        row = dict(level=l, dofs=int(solver.grids[l].n_dofs))
        row["vectors"] = _nbytes(solver.rhs[l]) + _nbytes(solver.u_bc[l])
        op = solver.sp_ops[l] if hasattr(solver, "sp_ops") else solver.ops[l]
        row["operator"] = sum(_nbytes(v) for v in vars(op).values())
        per_level.append(row)
    total = sum(r["vectors"] + r["operator"] for r in per_level)
    return dict(levels=per_level, total_bytes=total,
                allocator=device_memory_stats(solver.device))


def print_memory_report(solver, file=None) -> dict:
    rep = solver_memory_report(solver)
    mb = 1.0 / (1024 * 1024)
    print("Memory usage (MB):", file=file)
    for r in rep["levels"]:
        print(f"  level {r['level']:2d}  dofs {r['dofs']:>12d}  "
              f"vectors {r['vectors']*mb:8.1f}  operator {r['operator']*mb:8.1f}",
              file=file)
    alloc = rep["allocator"]
    if alloc:
        print(f"  device: in_use {alloc.get('bytes_in_use', 0)*mb:.1f} MB, "
              f"peak {alloc.get('peak_bytes_in_use', 0)*mb:.1f} MB, "
              f"limit {alloc.get('bytes_limit', 0)*mb:.1f} MB", file=file)
    return rep
