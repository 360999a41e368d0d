"""z-slabs with ghost planes, and the halo-exchange operator.

Twin of ``multigrid_tpu/parallel/halo.py`` (``HaloLaplace``), the
rendering of the reference's MPI ghost machinery (deal.II's partitioner
``update_ghost_values`` inside ``cell_loop``,
reference common/laplace_operator.h:568-590) for ranks of
``torch.distributed``.  The contract is the JAX class's: the collected
``vmult`` equals the single-device ``vmult``.  The layout is this
package's own.

Layout.  A level's cells are cut along z at cell boundaries
(:func:`split_cells`); rank r owns cells ``[c_r, c_{r+1})`` and the node
planes ``c_r p .. c_{r+1} p - 1`` (the last rank also the top plane).  It
stores them with ``GHOST_CELLS`` = 2 cells (2p planes) of ghosts on each
side that has a neighbour: a :class:`~..mesh.brick.ZSlab` of its own.  The
JAX class keeps one shared plane and adds partial sums from a cell-wise
apply (compress(add)); the port's ``brick_kron`` is node-centric and
reads every outer plane of its tensor as a Dirichlet plane (0), so a slab
must reach past the p planes an owned node reads, to a plane whose
index keeps the residue mod p of the level (the taps of a row depend on
it): 2p planes.  Then every owned output is computed with the same taps
in the same order as on one device, and the owned planes of a
distributed apply equal the single-device ``brick_kron`` bit for bit,
with no kernel change.  The price is 2p planes of traffic a side where a
Dirichlet-face argument to the kernel would need p (PERF.md).

A slab is *fresh* when every plane but its outermost ghost planes holds the
level's value; :meth:`Slabs.refresh` makes it so after any operation that
reads neighbours (an operator pass, a transfer), by copying the 2p planes
next to each cut from the rank that owns them.  Pointwise operations keep
a fresh slab fresh (the outermost plane, which the kernel reads as
Dirichlet and the transfers zero, is never read for an owned value).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..mesh.brick import DofGrid
from ..ops.laplace_kernel import BrickLaplace
from .sharding import Ranks

GHOST_CELLS = 2


def split_cells(n_cells: int, world: int, align: int = 1) -> list[int]:
    """Cell boundaries ``[c_0 = 0, ..., c_world = n_cells]`` of ``world``
    z-slabs as even as cuts on multiples of ``align`` allow."""
    units = n_cells // align
    if units * align != n_cells:
        raise ValueError(f"{n_cells} cells do not split on multiples of "
                         f"{align}")
    return [align * ((r * units) // world) for r in range(world + 1)]


class Slabs:
    """One level's z-slab on one rank: which planes it stores and owns, and
    the ghost refresh.  ``bounds`` are the cell boundaries of all ranks
    (:func:`split_cells`); every rank must own at least ``GHOST_CELLS``
    cells when there is more than one."""

    def __init__(self, grid: DofGrid, ranks: Ranks, bounds):
        world, r = ranks.world, ranks.rank
        if len(bounds) != world + 1 or bounds[0] != 0 \
                or bounds[-1] != grid.cells[0]:
            raise ValueError(f"bounds {bounds} do not cut {grid.cells[0]} "
                             f"z cells into {world} slabs")
        if world > 1 and min(np.diff(bounds)) < GHOST_CELLS:
            raise ValueError(f"every rank must own at least {GHOST_CELLS} z "
                             f"cells: bounds {bounds}")
        p = grid.degree
        self.grid, self.ranks, self.bounds = grid, ranks, list(bounds)
        self.c0, self.c1 = bounds[r], bounds[r + 1]
        g0 = max(0, self.c0 - GHOST_CELLS)
        g1 = min(grid.cells[0], self.c1 + GHOST_CELLS)
        self.local = grid.z_slab(g0, g1)
        self.lo, self.hi = g0 * p, g1 * p + 1       # stored planes [lo, hi)
        last = r == world - 1
        # owned planes, local indices [own0, own1)
        self.own0 = self.c0 * p - self.lo
        self.own1 = (grid.shape[0] if last else self.c1 * p) - self.lo
        w = GHOST_CELLS * p
        self.below = r - 1 if r > 0 else None
        self.above = r + 1 if not last else None
        self._sends = []
        self._recvs = []
        if self.below is not None:
            self._sends.append((self.below, slice(self.own0, self.own0 + w)))
            self._recvs.append((self.below, slice(0, self.own0)))
        if self.above is not None:
            self._sends.append((self.above, slice(self.own1 - w, self.own1)))
            self._recvs.append((self.above, slice(self.own1, self.own1 + w)))

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.local.shape)

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """The owned planes of a slab (a contiguous view)."""
        return t[self.own0:self.own1]

    def owned_rows(self) -> slice:
        """The global planes this rank owns, ``[lo + own0, lo + own1)``."""
        return slice(self.lo + self.own0, self.lo + self.own1)

    def refresh(self, t: torch.Tensor) -> torch.Tensor:
        """Copy the 2p planes next to each cut from their owner, in place;
        returns ``t``."""
        self.ranks.exchange([(peer, t[s]) for peer, s in self._sends],
                            [(peer, t[s]) for peer, s in self._recvs])
        return t

    def collect(self, t: torch.Tensor) -> torch.Tensor:
        """The global node grid from every rank's owned planes, on every
        rank (small grids: tests and checks)."""
        if self.ranks.world == 1:
            return t.clone()
        own = self.own(t)
        n_max = max(self.local_owned(r) for r in range(self.ranks.world))
        pad = t.new_zeros((n_max,) + tuple(t.shape[1:]))
        pad[:own.shape[0]] = own
        if self.ranks.staged:
            pad = pad.cpu()
        parts = [torch.empty_like(pad) for _ in range(self.ranks.world)]
        dist.all_gather(parts, pad)
        return torch.cat([q[:self.local_owned(r)] for r, q in
                          enumerate(parts)]).to(t.device)

    def local_owned(self, r: int) -> int:
        """Number of planes rank ``r`` owns."""
        p = self.grid.degree
        last = r == self.ranks.world - 1
        return (self.bounds[r + 1] - self.bounds[r]) * p + (1 if last else 0)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Global ``a . b`` over the owned planes (0-d, ``a``'s dtype),
        summed over the ranks in rank order."""
        oa, ob = self.own(a), self.own(b)
        return self.ranks.allsum(torch.dot(oa.reshape(-1), ob.reshape(-1)))


class HaloLaplace:
    """z-slab-distributed FE_Q Laplace ``vmult`` with explicit ghost
    exchange: each rank applies ``brick_kron`` (the plain dense path on the
    CPU) to its slab, then refreshes the ghost planes.  ``grid`` is the
    global level (3-D), split evenly over the ranks."""

    def __init__(self, grid: DofGrid, ranks: Ranks, dtype=torch.float64,
                 coefficient: float = 1.0):
        self.grid = grid
        self.slabs = Slabs(grid, ranks, split_cells(grid.cells[0],
                                                    ranks.world))
        self.op = BrickLaplace(self.slabs.local, dtype, ranks.device,
                               coefficient)

    def distribute(self, u: np.ndarray) -> torch.Tensor:
        """This rank's slab of the global grid ``u`` on its device."""
        return torch.as_tensor(np.array(u[self.slabs.lo:self.slabs.hi]),
                               dtype=self.op.dtype, device=self.op.device)

    def collect(self, v: torch.Tensor) -> torch.Tensor:
        return self.slabs.collect(v)

    def vmult(self, v: torch.Tensor, comm: bool = True) -> torch.Tensor:
        """A v on the slab (identity rows on the true Dirichlet faces), its
        ghosts refreshed; ``comm=False`` skips the refresh (the same
        compute with no traffic), for :meth:`comm_split_report`."""
        y = self.op.vmult(v)
        return self.slabs.refresh(y) if comm else y

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.slabs.dot(a, b)

    def comm_split_report(self, n_rep: int = 20, seed: int = 0) -> dict:
        """:func:`comm_split` of this operator's ``vmult`` on a random slab
        (``seed``) in its dtype."""
        rng = np.random.default_rng(seed)
        u = rng.standard_normal((self.slabs.hi - self.slabs.lo,)
                                + tuple(self.grid.shape[1:]))
        v = torch.as_tensor(u, dtype=self.op.dtype, device=self.op.device)
        return comm_split(self.vmult, v, self.slabs.ranks, n_rep)


def comm_split(vmult, v: torch.Tensor, ranks: Ranks, n_rep: int = 20) -> dict:
    """Wall time of one distributed ``vmult(v, comm)`` with and without its
    ghost refresh, best of three runs of ``n_rep`` (the reference's
    per-matvec communication / cell-loop split,
    laplace_operator_dg.h:766-768); seconds, taken by rank 0's clock after
    a barrier, with a device synchronize on a card.  ``steps``: this
    rank's refresh a ``vmult`` by step (:attr:`Ranks.times`: the copies to
    pinned host memory, the backend's send and receive, the copies back,
    and any packing), from another run of ``n_rep``."""

    def sync():
        if v.device.type == "cuda":
            torch.cuda.synchronize(v.device)
        ranks.barrier()

    out = {}
    for name, comm in (("total", True), ("cell_loop", False)):
        vmult(v, comm)
        best = float("inf")
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            for _ in range(n_rep):
                vmult(v, comm)
            sync()
            best = min(best, (time.perf_counter() - t0) / n_rep)
        out[name] = best
    out["comm"] = max(0.0, out["total"] - out["cell_loop"])
    out["comm_fraction"] = out["comm"] / out["total"] if out["total"] else 0.0
    # the refresh by steps, a run of n_rep timed on its own
    ranks.times = {}
    try:
        for _ in range(n_rep):
            vmult(v)
        out["steps"] = {k: t / n_rep for k, t in ranks.times.items()}
    finally:
        ranks.times = None
    return out
