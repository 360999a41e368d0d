"""Per-level wall-time accounting, mirroring the reference's
``print_wall_times`` table (reference common/multigrid_solver.h:347-371):
columns smoother / mg_mv / mg_vec / restrict / prolongate / inhomBC per
level, plus coarse-solver totals.

Twin of ``multigrid_tpu/utils/timing.py``.  On the card each span is timed
with a pair of ``torch.cuda.Event``s around the call on the current stream
(device time of the span's kernels); on the CPU with the host clock.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

COLUMNS = ("smoother", "mg_mv", "mg_vec", "restrict", "prolongate", "inhomBC")


def time_call(fn, *args):
    """(result, seconds) of ``fn(*args)``: CUDA events when the first
    tensor argument lies on the card, the host clock otherwise."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
               torch.device("cpu"))
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


class LevelTimings:
    def __init__(self):
        self.t = defaultdict(lambda: defaultdict(float))
        self.coarse_calls = 0
        self.coarse_time = 0.0

    def add(self, level: int, column: str, seconds: float):
        self.t[level][column] += seconds

    def timed(self, level: int, column: str, fn, *args):
        out, sec = time_call(fn, *args)
        self.add(level, column, sec)
        return out

    def coarse(self, fn, *args):
        out, sec = time_call(fn, *args)
        self.coarse_time += sec
        self.coarse_calls += 1
        return out

    def print_table(self):
        print(f"Coarse solver {self.coarse_calls} times: {self.coarse_time:.6g}")
        print("level  " + "".join(f"{c:<12}" for c in COLUMNS))
        for level in sorted(self.t):
            row = self.t[level]
            print(f"L{level:<5d}"
                  + "".join(f"{row.get(c, 0.0):<12.4g}" for c in COLUMNS))

    def reset(self):
        self.t.clear()
        self.coarse_calls = 0
        self.coarse_time = 0.0
