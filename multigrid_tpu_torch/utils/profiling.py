"""Device-profiler integration.

Twin of ``multigrid_tpu/utils/profiling.py``.  The reference instruments
with hand timers and optional LIKWID counters
(cmake/macro_pick_up_benchmark.cmake:10-16, poisson_cube/program.cc:
281-355); here :mod:`.timing` gives the per-level wall-time tables, and
this module ``torch.profiler`` traces (Chrome / Perfetto JSON) and the
best wall time of a call, each run ended by ``torch.cuda.synchronize``
on the card.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(path: str):
    """Trace the block with ``torch.profiler`` (host activity, and the
    card's when there is one) and write the trace to ``path`` as Chrome /
    Perfetto JSON; yields the profiler and prints where the trace went."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _sync()
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(path)
    print(f"# device trace written to {path} (chrome://tracing or "
          "ui.perfetto.dev)")


def profile_fn(fn, *args, n_warmup: int = 1, n_runs: int = 5,
               walls: list | None = None) -> float:
    """Best wall time (s) of ``fn(*args)`` over ``n_runs`` runs after
    ``n_warmup`` warm-up runs, each ended by a synchronize, without the
    profiler (trace a run with :func:`device_trace`); each run's time is
    appended to ``walls`` when given."""
    for _ in range(n_warmup):
        fn(*args)
        _sync()
    best = float("inf")
    for _ in range(n_runs):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        wall = time.perf_counter() - t0
        best = min(best, wall)
        if walls is not None:
            walls.append(wall)
    return best
