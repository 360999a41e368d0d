"""Boxes of cells with ghost planes, and the halo-exchange operators.

Twin of ``multigrid_tpu/parallel/halo.py`` (``HaloLaplace``,
``HaloLaplace2D``), the rendering of the reference's MPI ghost machinery
(deal.II's partitioner ``update_ghost_values`` inside ``cell_loop``,
reference common/laplace_operator.h:568-590) for ranks of
``torch.distributed``.  The contract is the JAX classes': the collected
``vmult`` equals the single-device ``vmult``.  The layout is this
package's own.

Layout.  A level's cells are cut at cell boundaries along z, or along z
and y on a rank grid (:func:`split_cells` each axis;
:class:`~.sharding.RankGrid`); along each split axis a rank owns cells
``[c_r, c_{r+1})`` and the node planes ``c_r p .. c_{r+1} p - 1`` (the
last rank of the axis also the top plane).  It stores them with
``GHOST_CELLS`` = 2 cells (2p planes) of ghosts on each side that has a
neighbour: a :class:`~..mesh.brick.CellBox` of its own.  The JAX classes
keep one shared plane and add partial sums from a cell-wise apply
(compress(add)); the port's ``brick_kron`` is node-centric and reads every
outer plane of its tensor as a Dirichlet plane (0), so a box must reach
past the p planes an owned node reads, to a plane whose index keeps the
residue mod p of the level (the taps of a row depend on it): 2p planes
along each split axis.  Then every owned output is computed with the same
taps in the same order as on one device, and the owned nodes of a
distributed apply equal the single-device ``brick_kron`` bit for bit,
with no kernel change.  The price is 2p planes of traffic a side where a
Dirichlet-face argument to the kernel would need p (PERF.md).

A box is *fresh* when every node but its outermost ghost planes holds the
level's value; :meth:`Slabs.refresh` makes it so after any operation that
reads neighbours (an operator pass, a transfer), by copying the 2p planes
next to each cut from the rank that owns them.  Pointwise operations keep
a fresh box fresh (the outermost plane, which the kernel reads as
Dirichlet and the transfers zero, is never read for an owned value).

Corners.  On a z x y rank grid an owned node within p of both cuts reads
the corner ghost region, which only the diagonal neighbour owns.  The
JAX class routes it through compress(add) z then y and ghost updates y
then z.  The port copies ghosts, in two stages: first the y ghost rows of
the owned z planes (strided, through :meth:`~.sharding.Ranks.
exchange_packed`), then the z ghost planes over the whole stored y width,
y ghosts included (contiguous planes), so that the corner arrives from the
diagonal rank through its z neighbour.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..mesh.brick import DofGrid
from ..ops.laplace_kernel import BrickLaplace
from .sharding import RankGrid, Ranks

GHOST_CELLS = 2
AXIS_NAMES = ("z", "y")


def split_cells(n_cells: int, world: int, align: int = 1) -> list[int]:
    """Cell boundaries ``[c_0 = 0, ..., c_world = n_cells]`` of ``world``
    slabs of one axis as even as cuts on multiples of ``align`` allow."""
    units = n_cells // align
    if units * align != n_cells:
        raise ValueError(f"{n_cells} cells do not split on multiples of "
                         f"{align}")
    return [align * ((r * units) // world) for r in range(world + 1)]


def axis_cuts(bounds) -> list[list[int]]:
    """Cuts per split axis: a flat list of ints is the z split alone, a
    list of lists the cuts of z (and y)."""
    if len(bounds) and isinstance(bounds[0], (int, np.integer)):
        return [[int(c) for c in bounds]]
    return [[int(c) for c in b] for b in bounds]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _numel(index: tuple, shape) -> int:
    """Elements of ``t[index]`` for a tensor ``t`` of ``shape``."""
    n = 1
    for a, e in enumerate(shape):
        if a < len(index):
            e = len(range(*index[a].indices(e)))
        n *= e
    return n


def owned_dot(a: torch.Tensor, b: torch.Tensor, own: tuple, fn=_dot):
    """``a . b`` over the entries ``own`` (one slice a split axis) of two
    contiguous boxes: ``fn`` (a dot of two contiguous tensors:
    ``torch.dot`` or the ``cg_dot`` kernel) over the owned range of axis
    0, a contiguous view.  Along a second split axis that range also holds
    ghosts: ``a``'s are set to zero for the call and put back after it (a
    weight of 0 there, with no copy of the vector); the sum order is the
    same on every rank."""
    za, zb = a[own[0]], b[own[0]]
    if len(own) == 1:
        return fn(za, zb)
    ghosts = [g for g in (za[:, :own[1].start], za[:, own[1].stop:])
              if g.numel()]
    saved = [g.clone() for g in ghosts]
    for g in ghosts:
        g.zero_()
    try:
        return fn(za, zb)
    finally:
        for g, v in zip(ghosts, saved):
            g.copy_(v)


class Slabs:
    """One level's box on one rank: which planes it stores and owns along
    each split axis, and the ghost refresh.  ``bounds``: the cell
    boundaries of the ranks along z (a flat list, :func:`split_cells`), or
    ``[z bounds, y bounds]`` for a rank grid of their lengths; along a
    split axis with more than one rank every rank owns at least
    ``GHOST_CELLS`` cells.  Axis 0's numbers keep the z split's names
    (``c0``, ``c1``, ``lo``, ``hi``, ``own0``, ``own1``, ``below``,
    ``above``)."""

    def __init__(self, grid: DofGrid, ranks: Ranks, bounds):
        cuts = axis_cuts(bounds)
        if not 1 <= len(cuts) <= min(2, grid.dim):
            raise ValueError(f"cuts along {len(cuts)} axes: z, or z and y")
        shape = tuple(len(b) - 1 for b in cuts)
        if int(np.prod(shape)) != ranks.world:
            raise ValueError(f"bounds {bounds} make a rank grid of {shape} "
                             f"for {ranks.world} ranks")
        p = grid.degree
        self.grid, self.ranks, self.bounds = grid, ranks, bounds
        self.cuts = cuts
        self.rgrid = RankGrid(shape, ranks.rank)
        coords = self.rgrid.coords
        # per split axis: owned cells, stored planes (global), owned
        # planes (local), neighbours (below, above)
        self.cells, self.stored, self.owned, self.nbrs = [], [], [], []
        ranges = []
        for a, b in enumerate(cuts):
            name = AXIS_NAMES[a]
            if b[0] != 0 or b[-1] != grid.cells[a] or min(np.diff(b)) < 1:
                raise ValueError(f"bounds {b} do not cut {grid.cells[a]} "
                                 f"{name} cells into {len(b) - 1} slabs")
            if len(b) > 2 and min(np.diff(b)) < GHOST_CELLS:
                raise ValueError(f"every rank must own at least "
                                 f"{GHOST_CELLS} {name} cells: bounds {b}")
            c0, c1 = b[coords[a]], b[coords[a] + 1]
            below, above = self.rgrid.neighbor(a, 0), self.rgrid.neighbor(a, 1)
            g0 = c0 - GHOST_CELLS if below is not None else c0
            g1 = c1 + GHOST_CELLS if above is not None else c1
            lo, hi = g0 * p, g1 * p + 1
            self.cells.append((c0, c1))
            self.stored.append((lo, hi))
            self.owned.append((c0 * p - lo, (grid.shape[a] if above is None
                                             else c1 * p) - lo))
            self.nbrs.append((below, above))
            ranges.append((g0, g1))
        self.local = grid.box(ranges)
        (self.c0, self.c1), (self.lo, self.hi) = self.cells[0], self.stored[0]
        (self.own0, self.own1), (self.below, self.above) = (self.owned[0],
                                                            self.nbrs[0])
        # the refresh, one stage a split axis, the last axis first; a stage
        # moves the 2p planes next to each cut over the owned range of the
        # axes before it (refreshed later) and the stored range of the
        # axes after it (refreshed already: the corners)
        w = GHOST_CELLS * p
        self._stages = []
        for a in reversed(range(len(cuts))):
            (o0, o1), (below, above) = self.owned[a], self.nbrs[a]
            pre = tuple(slice(*self.owned[b]) for b in range(a))
            sends, recvs = [], []
            if below is not None:
                sends.append((below, pre + (slice(o0, o0 + w),)))
                recvs.append((below, pre + (slice(0, o0),)))
            if above is not None:
                sends.append((above, pre + (slice(o1 - w, o1),)))
                recvs.append((above, pre + (slice(o1, o1 + w),)))
            self._stages.append((a, sends, recvs))
        # axis 0's stage as slices of axis 0 (the z split's)
        _, sends, recvs = self._stages[-1]
        self._sends = [(peer, idx[0]) for peer, idx in sends]
        self._recvs = [(peer, idx[0]) for peer, idx in recvs]
        self._own = tuple(slice(o0, o1) for o0, o1 in self.owned)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.local.shape)

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """The owned nodes of a box (a view; contiguous for a z split)."""
        return t[self._own]

    def owned_rows(self) -> slice:
        """The global planes of axis 0 this rank owns, ``[lo + own0, lo +
        own1)``."""
        return slice(self.lo + self.own0, self.lo + self.own1)

    def owned_index(self) -> tuple[slice, ...]:
        """The global nodes this rank owns, one slice a split axis."""
        return tuple(slice(lo + o0, lo + o1) for (lo, _), (o0, o1)
                     in zip(self.stored, self.owned))

    def stored_index(self) -> tuple[slice, ...]:
        """The global nodes of the box, one slice a split axis."""
        return tuple(slice(lo, hi) for lo, hi in self.stored)

    def refresh(self, t: torch.Tensor) -> torch.Tensor:
        """Copy the 2p planes next to each cut from their owner, in place,
        stage by stage (the module note); returns ``t``.  A stage of a
        rank grid times its steps under its axis's name
        (:attr:`~.sharding.Ranks.times`)."""
        two = len(self._stages) > 1
        for a, sends, recvs in self._stages:
            out = [(peer, t[idx]) for peer, idx in sends]
            into = [(peer, t[idx]) for peer, idx in recvs]
            if two:
                self.ranks.label = AXIS_NAMES[a] + " "
            try:
                if a == 0:
                    self.ranks.exchange(out, into)
                else:
                    self.ranks.exchange_packed(out, into)
            finally:
                self.ranks.label = ""
        return t

    def bytes_per_refresh(self, dtype) -> dict:
        """Bytes this rank sends in one refresh of a ``dtype`` box, by
        stage (``"y"``, ``"z"``)."""
        size = torch.empty((), dtype=dtype).element_size()
        return {AXIS_NAMES[a]: size * sum(_numel(idx, self.shape)
                                          for _, idx in sends)
                for a, sends, _ in self._stages}

    def collect(self, t: torch.Tensor) -> torch.Tensor:
        """The global node grid from every rank's owned nodes, on every
        rank (a sum of grids that are zero off their owner: exact; small
        grids: tests, checks and output)."""
        if self.ranks.world == 1:
            return t.clone()
        out = t.new_zeros(self.grid.shape)
        out[self.owned_index()] = self.own(t)
        return self.ranks.sum_(out)

    def local_dot(self, a: torch.Tensor, b: torch.Tensor, fn=_dot):
        """This rank's part of ``a . b`` (:func:`owned_dot`)."""
        return owned_dot(a, b, self._own, fn)

    def dot(self, a: torch.Tensor, b: torch.Tensor, fn=_dot) -> torch.Tensor:
        """Global ``a . b`` over the owned nodes (0-d, ``a``'s dtype),
        summed over the ranks in rank order (:meth:`local_dot`)."""
        return self.ranks.allsum(self.local_dot(a, b, fn))


class HaloLaplace:
    """z-slab-distributed FE_Q Laplace ``vmult`` with explicit ghost
    exchange: each rank applies ``brick_kron`` (the plain dense path on the
    CPU) to its box, then refreshes the ghost planes.  ``grid`` is the
    global level (3-D), split evenly along z over the ranks, or by
    ``bounds`` (:class:`Slabs`)."""

    def __init__(self, grid: DofGrid, ranks: Ranks, dtype=torch.float64,
                 coefficient: float = 1.0, bounds=None):
        self.grid = grid
        if bounds is None:
            bounds = split_cells(grid.cells[0], ranks.world)
        self.slabs = Slabs(grid, ranks, bounds)
        self.op = BrickLaplace(self.slabs.local, dtype, ranks.device,
                               coefficient)

    def distribute(self, u: np.ndarray) -> torch.Tensor:
        """This rank's box of the global grid ``u`` on its device."""
        return torch.as_tensor(np.array(u[self.slabs.stored_index()]),
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

    def bytes_per_refresh(self) -> dict:
        return self.slabs.bytes_per_refresh(self.op.dtype)

    def comm_split_report(self, n_rep: int = 20, seed: int = 0) -> dict:
        """:func:`comm_split` of this operator's ``vmult`` on a random box
        (``seed``) in its dtype, with ``bytes``, this rank's bytes a
        refresh, and ``bytes_by_stage`` (``"y"``, ``"z"``); on a rank grid
        the refresh's ``steps`` carry the stage's axis in their names."""
        rng = np.random.default_rng(seed)
        v = torch.as_tensor(rng.standard_normal(self.slabs.shape),
                            dtype=self.op.dtype, device=self.op.device)
        out = comm_split(self.vmult, v, self.slabs.ranks, n_rep)
        out["bytes_by_stage"] = self.bytes_per_refresh()
        out["bytes"] = sum(out["bytes_by_stage"].values())
        return out


class HaloLaplace2D(HaloLaplace):
    """('z', 'y')-distributed FE_Q Laplace ``vmult`` on an ``nz x ny``
    rank grid (JAX ``HaloLaplace2D``): boxes with 2p ghost planes along z
    and y, refreshed in two stages that carry the corners (the module
    note).  ``distribute``, ``collect``, ``vmult(comm=)``, ``dot`` and
    ``comm_split_report`` as :class:`HaloLaplace`."""

    def __init__(self, grid: DofGrid, ranks: Ranks, shape: tuple[int, int],
                 dtype=torch.float64, coefficient: float = 1.0):
        nz, ny = shape
        super().__init__(grid, ranks, dtype, coefficient,
                         bounds=[split_cells(grid.cells[0], nz),
                                 split_cells(grid.cells[1], ny)])


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
