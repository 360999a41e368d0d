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

Overlap.  :class:`HaloLaplace`'s ``vmult`` on a split level computes the
planes its neighbours need first, starts their exchange, and computes the
rest while the planes travel (the JAX classes' layer split,
``halo.py:99-131`` and ``:278-326``, where XLA schedules the collective
early; the reference's ``cell_schedule_list``).  The planes a neighbour
needs are the *send regions*: the 2p owned planes next to each cut.
:class:`SplitPlan` cuts a box, once per level, into sub-boxes, each a
:class:`~..mesh.brick.CellBox` with a ``BrickLaplace`` of its own: one a
cut side that sends (its output holds the send region), and one interior
box (the rest of the owned planes, a true Dirichlet face included).  A
sub-box reaches from two cells below its first kept plane to one cell
above its last (cell boundaries: the residue rule above; a kept plane's
taps reach p planes, and the box's outer planes are read as Dirichlet),
so every kept output is the whole box's, bit for bit.  :class:`SplitApply` runs the
schedule: on a z split the two boundary boxes, ``post`` of the z
exchange from their outputs, the interior box (written straight into the
result), the kept planes copied over the interior's margins, ``finish``;
on a z x y grid the y strips (the y send regions, over the owned z
range) and ``post`` of y first, then the z slabs and the interior, then
``finish`` of y, ``post`` and ``finish`` of z (whose send regions take
their y ghost rows from the y receive: the corners).  A level splits only
when every split axis owns at least ``SPLIT_MIN_CELLS`` cells on every
rank (the JAX ``loc_cells >= 2``); other levels keep the whole-box order,
apply then refresh, and so do the solver's levels
(:class:`~.distributed.SlabLevel`), where the schedule's extra launches
and copies cost more than the exchange it hides (PERF.md).
"""

from __future__ import annotations

import time
from functools import cached_property

import numpy as np
import torch

from ..mesh.brick import DofGrid
from ..ops.laplace_kernel import BrickLaplace
from .sharding import RankGrid, Ranks

GHOST_CELLS = 2
AXIS_NAMES = ("z", "y")
# the fewest owned cells a split axis needs for the overlap schedule: two
# boundary boxes' kept cells and one interior cell
SPLIT_MIN_CELLS = 2 * GHOST_CELLS + 1


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

    @cached_property
    def plan(self) -> "SplitPlan":
        """The box's overlap schedule (:class:`SplitPlan`), built when
        first read."""
        return SplitPlan(self)

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


def _reach(k0: int, k1: int, g0: int, g1: int, p: int) -> tuple[int, int]:
    """The cells of a sub-box whose output keeps the planes ``[k0, k1)``
    of an axis stored as cells ``[g0, g1)``: every kept plane reads p
    planes further on each side, none of them the box's outer plane (read
    as Dirichlet), and the box starts and ends on cell boundaries (the
    taps of a plane depend on its residue mod p); a true face is the
    box's own."""
    return max(g0, k0 // p - 2), min(g1, (k1 - 1) // p + 2)


class SubBox:
    """One box of a :class:`SplitPlan`, in the rank's box: ``role`` "y" (a
    y strip, which feeds the y send region only), "z" (a z boundary slab)
    or "interior"; ``side`` 0 (below) or 1 (above) of a boundary box;
    ``cells``, its global cells along each split axis; ``index``, its
    nodes in the rank's box; ``keep``, the node regions of its output that
    the result takes (global, one ``(k0, k1)`` a split axis); ``send``, the
    send region (global) of a boundary box."""

    def __init__(self, role, side, cells, keep, send, slabs):
        p = slabs.grid.degree
        self.role, self.side, self.cells = role, side, tuple(cells)
        self.keep, self.send = keep, send
        self.origin = tuple(c0 * p for c0, _ in self.cells)
        self.index = tuple(slice(c0 * p - lo, c1 * p + 1 - lo)
                           for (c0, c1), (lo, _) in zip(self.cells,
                                                        slabs.stored))
        self.nodes = int(np.prod([(c1 - c0) * p + 1 for c0, c1 in self.cells]
                                 + list(slabs.grid.shape[len(self.cells):])))

    def local(self, region) -> tuple:
        """A global region as an index of this box's output."""
        return _region(region, self.origin)


def _region(region, origin) -> tuple:
    return tuple(slice(k0 - o, k1 - o) for (k0, k1), o in zip(region, origin))


class SplitPlan:
    """The overlap schedule of one level's box on one rank (the module
    note), built from the cuts alone.  ``split``: whether the
    level runs it (every split axis owns at least ``SPLIT_MIN_CELLS``
    cells on every rank of a world above one); ``boxes``: the sub-boxes,
    the y strips first (on a rank grid), then the z slabs, the interior
    last; ``recvs``: per stage ``(axis, [(peer, region)])``, the ghost
    regions each exchange fills (global)."""

    def __init__(self, slabs: "Slabs"):
        p = slabs.grid.degree
        self.slabs, self.boxes, self.recvs = slabs, [], []
        self.split = slabs.ranks.world > 1 and all(
            min(np.diff(b)) >= SPLIT_MIN_CELLS for b in slabs.cuts
            if len(b) > 2)
        if not self.split:
            return
        w = GHOST_CELLS * p
        stored = [(lo // p, (hi - 1) // p) for lo, hi in slabs.stored]
        whole = list(slabs.stored)
        own = [(lo + o0, lo + o1) for (lo, _), (o0, o1)
               in zip(slabs.stored, slabs.owned)]

        def sends(a):
            (k0, k1), (below, above) = own[a], slabs.nbrs[a]
            return ([(0, below, (k0, k0 + w))] if below is not None else []) \
                + ([(1, above, (k1 - w, k1))] if above is not None else [])

        def reach(a, k):
            return _reach(k[0], k[1], stored[a][0], stored[a][1], p)

        rest = whole[1:]
        if len(own) == 2:
            for side, peer, ky in sends(1):
                self.boxes.append(SubBox(
                    "y", side, (reach(0, own[0]), reach(1, ky)), [],
                    (peer, (own[0], ky)), slabs))
        for side, peer, kz in sends(0):
            cells = [reach(0, kz)] + stored[1:]
            keep = [(kz,) + tuple(rest)]
            if side == 1:   # up to the stored top: its Dirichlet plane
                cells[0] = (cells[0][0], stored[0][1])
                keep.append(((whole[0][1] - 1, whole[0][1]),) + tuple(rest))
            self.boxes.append(SubBox("z", side, cells, keep,
                                     (peer, (kz,) + tuple(rest)), slabs))
        (k0, k1), (below, above) = own[0], slabs.nbrs[0]
        kz = (k0 + (w if below is not None else 0),
              k1 - (w if above is not None else 0))
        self.boxes.append(SubBox("interior", -1, [reach(0, kz)] + stored[1:],
                                 [(kz,) + tuple(rest)], None, slabs))
        for a, _, recvs in slabs._stages:
            lo = whole[a][0]
            self.recvs.append((a, [
                (peer, tuple(own[:a]) + ((lo + idx[a].start,
                                          lo + idx[a].stop),)
                 + tuple(rest[a:])) for peer, idx in recvs]))

    def of(self, role: str) -> list[int]:
        """The indices of the sub-boxes of ``role``."""
        return [k for k, b in enumerate(self.boxes) if b.role == role]

    def flops(self, nodes: int) -> int:
        """``brick_kron``'s flops on ``nodes`` nodes: seven banded sweeps
        of p + 2 taps on average a node (``chip_smoke.py``'s bound)."""
        return 14 * (self.slabs.grid.degree + 2) * nodes

    def cells_applied(self) -> int:
        """Cells the sub-boxes of one pass apply (the box's own when the
        level does not split)."""
        boxes = [b.cells for b in self.boxes] if self.split else \
            [self.slabs.local.ranges]
        return sum(int(np.prod([c1 - c0 for c0, c1 in cells]))
                   for cells in boxes) * int(np.prod(
                       self.slabs.grid.cells[len(boxes[0]):]))


class SplitApply:
    """``BrickLaplace.vmult`` on a split level in the overlap schedule of
    its :class:`SplitPlan` (the module note), ending with the box fresh:
    the same box, bit for bit, as ``vmult`` on the whole box followed by
    :meth:`Slabs.refresh`.  Each sub-box has the operator on its own
    ``CellBox``; on the card each is one ``brick_kron`` launch.  The
    boundary boxes write into buffers of their own, kept for reuse (a pass
    allocates only its result), and every index of the schedule is worked
    out here, once."""

    def __init__(self, op, slabs: "Slabs"):
        plan = slabs.plan
        self.slabs, self.plan = slabs, plan
        self.ops = [BrickLaplace(slabs.grid.box(b.cells), op.dtype,
                                 op.device, op.coefficient)
                    for b in plan.boxes]
        self.two = len(slabs.cuts) == 2
        self._bufs: dict = {}
        origin = tuple(lo for lo, _ in slabs.stored)
        boxes = plan.boxes
        self.ys = plan.of("y")
        self.zs = plan.of("z")
        (self.interior,) = plan.of("interior")
        # (peer, box, its send region in the box's output)
        self.sends = {r: [(boxes[k].send[0], k, boxes[k].local(
            boxes[k].send[1])) for k in plan.of(r)] for r in ("y", "z")}
        recvs = dict(plan.recvs)
        self.zrecv = [(peer, _region(reg, origin)) for peer, reg in recvs[0]]
        # the y receive: (peer, buffer shape, where it lands in the box)
        self.yrecv = [(peer, tuple(k1 - k0 for k0, k1 in reg)
                       + slabs.shape[len(reg):], _region(reg, origin))
                      for peer, reg in recvs.get(1, [])]
        # the z send regions' y ghost rows from the y receive:
        # (z box, where in its output, which y buffer, where in it)
        self.patch = [
            (k, boxes[k].local(both), i,
             _region(both, tuple(k0 for k0, _ in reg)))
            for k in self.zs for i, (_, reg) in enumerate(recvs.get(1, []))
            for both in [_meet(boxes[k].send[1], reg)] if both is not None]
        # the kept planes of the z boxes: (box, into the result, from it)
        self.keep = [(k, _region(reg, origin), boxes[k].local(reg))
                     for k in self.zs for reg in boxes[k].keep]

    def _buf(self, key, shape, like: torch.Tensor) -> torch.Tensor:
        buf = self._bufs.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=like.dtype, device=like.device)
            self._bufs[key] = buf
        return buf

    def _call(self, k: int, x: torch.Tensor, dst=None) -> torch.Tensor:
        """Sub-box ``k``'s ``vmult`` of its part of ``x`` into ``dst``
        (default: its buffer).  A y strip's input is not contiguous: it is
        gathered into a buffer first."""
        box, op = self.plan.boxes[k], self.ops[k]
        xs = x[box.index]
        if box.role == "y":
            xs = self._buf(("in", k), op.shape, x).copy_(xs)
        if dst is None:
            dst = self._buf(("out", k), op.shape, x)
        return op.vmult(xs, out=dst)

    def run(self, x: torch.Tensor, comm: bool = True) -> torch.Tensor:
        """A x on the box ``x`` (identity rows on the true Dirichlet
        faces), refreshed; ``comm=False`` runs the same compute with no
        traffic."""
        ranks = self.slabs.ranks
        y = torch.empty_like(x)
        step_y = step_z = None
        ybufs = []
        if self.two:
            strips = {k: self._call(k, x) for k in self.ys}
            if comm:
                ybufs = [self._buf(("yrecv", i), shape, x)
                         for i, (_, shape, _) in enumerate(self.yrecv)]
                step_y = ranks.post(
                    [(peer, self._buf(("ysend", k), strips[k][idx].shape, x)
                      .copy_(strips[k][idx]))
                     for peer, k, idx in self.sends["y"]],
                    [(peer, buf) for (peer, _, _), buf
                     in zip(self.yrecv, ybufs)])
        zs = {k: self._call(k, x) for k in self.zs}

        def post_z():
            return ranks.post(
                [(peer, zs[k][idx]) for peer, k, idx in self.sends["z"]],
                [(peer, y[idx]) for peer, idx in self.zrecv])

        if comm and not self.two:
            step_z = post_z()
        self._call(self.interior, x, y[self.plan.boxes[self.interior].index])
        if self.two and comm:
            ranks.finish(step_y)
            for k, into, i, src in self.patch:     # the corners
                zs[k][into] = ybufs[i][src]
            step_z = post_z()
        for k, into, src in self.keep:
            y[into] = zs[k][src]
        for (_, _, into), buf in zip(self.yrecv, ybufs):
            y[into] = buf
        ranks.finish(step_z)
        return y


def _meet(a, b):
    """The intersection of two regions (one ``(k0, k1)`` an axis), or
    None."""
    out = tuple((max(a0, b0), min(a1, b1)) for (a0, a1), (b0, b1)
                in zip(a, b))
    return None if any(k0 >= k1 for k0, k1 in out) else out


class HaloLaplace:
    """z-slab-distributed FE_Q Laplace ``vmult`` with explicit ghost
    exchange: each rank applies ``brick_kron`` (the plain dense path on the
    CPU) to its box and refreshes the ghost planes, on a level that splits
    in the overlap schedule (:class:`SplitApply`: the send regions first,
    their exchange in flight while the interior box is applied), else
    apply, then refresh.  ``grid`` is the global level (3-D), split evenly
    along z over the ranks, or by ``bounds`` (:class:`Slabs`)."""

    def __init__(self, grid: DofGrid, ranks: Ranks, dtype=torch.float64,
                 coefficient: float = 1.0, bounds=None):
        self.grid = grid
        if bounds is None:
            bounds = split_cells(grid.cells[0], ranks.world)
        self.slabs = Slabs(grid, ranks, bounds)
        self.op = BrickLaplace(self.slabs.local, dtype, ranks.device,
                               coefficient)
        self.split = (SplitApply(self.op, self.slabs)
                      if self.slabs.plan.split else None)

    def distribute(self, u: np.ndarray) -> torch.Tensor:
        """This rank's box of the global grid ``u`` on its device."""
        return torch.as_tensor(np.array(u[self.slabs.stored_index()]),
                               dtype=self.op.dtype, device=self.op.device)

    def collect(self, v: torch.Tensor) -> torch.Tensor:
        return self.slabs.collect(v)

    def vmult(self, v: torch.Tensor, comm: bool = True) -> torch.Tensor:
        """A v on the box (identity rows on the true Dirichlet faces), its
        ghosts refreshed; ``comm=False`` skips the traffic (the same
        compute), for :meth:`comm_split_report`."""
        if self.split is not None:
            return self.split.run(v, comm)
        return self.vmult_whole(v, comm)

    def vmult_whole(self, v: torch.Tensor, comm: bool = True):
        """:meth:`vmult` in the apply-then-refresh order: the box's one
        ``vmult``, then the refresh (the reference order that the overlap
        schedule is held and timed against)."""
        y = self.op.vmult(v)
        return self.slabs.refresh(y) if comm else y

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.slabs.dot(a, b)

    def bytes_per_refresh(self) -> dict:
        return self.slabs.bytes_per_refresh(self.op.dtype)

    def comm_split_report(self, n_rep: int = 20, seed: int = 0) -> dict:
        """:func:`comm_split` of :meth:`vmult_whole` on a random box
        (``seed``) in its dtype, with ``bytes``, this rank's bytes a
        refresh, and ``bytes_by_stage`` (``"y"``, ``"z"``); on a rank grid
        the refresh's ``steps`` carry the stage's axis in their names.
        ``overlap``: on a level that splits, :func:`comm_split` of
        :meth:`vmult` in the overlap schedule with the refresh alone and
        the hidden share, beside the plan's
        :func:`~..utils.overlap.collective_overlap_report` and ``equal``,
        whether its box is the apply-then-refresh box bit for bit, every
        node, on every rank; else None."""
        from ..utils.overlap import collective_overlap_report

        rng = np.random.default_rng(seed)
        v = torch.as_tensor(rng.standard_normal(self.slabs.shape),
                            dtype=self.op.dtype, device=self.op.device)
        ranks = self.slabs.ranks
        out = comm_split(self.vmult_whole, v, ranks, n_rep)
        out["bytes_by_stage"] = self.bytes_per_refresh()
        out["bytes"] = sum(out["bytes_by_stage"].values())
        out["overlap"] = None
        if self.split is not None:
            same = torch.equal(self.vmult(v), self.vmult_whole(v))
            sc = comm_split(self.vmult, v, ranks, n_rep,
                            refresh=self.slabs.refresh, steps=False)
            sc.update(collective_overlap_report(self),
                      equal=ranks.allmax(0.0 if same else 1.0) == 0.0)
            out["overlap"] = sc
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


def comm_split(vmult, v: torch.Tensor, ranks: Ranks, n_rep: int = 20,
               refresh=None, steps: bool = True) -> dict:
    """Wall time of one distributed ``vmult(v, comm)``: ``total`` with its
    ghost exchange, ``cell_loop`` without (``comm=False``: the same
    compute, in the overlap schedule every sub-box and the copies of their
    kept planes, with no traffic); with ``refresh`` (a box's refresh in
    place) also the refresh alone and ``hidden``, the share of the shorter
    of the two that the schedule hides, ``(cell_loop + refresh - total) /
    min(cell_loop, refresh)`` (0 when they add up, 1 when the shorter is
    all hidden).  The reference's per-matvec communication / cell-loop
    split, laplace_operator_dg.h:766-768; best of three runs of ``n_rep``,
    seconds, taken by rank 0's clock after a barrier, with a device
    synchronize on a card.  ``steps``: this rank's refresh a ``vmult`` by
    step (:attr:`Ranks.times`: the copies to pinned host memory, the
    backend's send and receive, the copies back, and any packing), from
    another run of ``n_rep`` (the timed steps synchronize the device)."""

    def sync():
        if v.device.type == "cuda":
            torch.cuda.synchronize(v.device)
        ranks.barrier()

    def best_of(fn):
        fn()
        best = float("inf")
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            for _ in range(n_rep):
                fn()
            sync()
            best = min(best, (time.perf_counter() - t0) / n_rep)
        return best

    out = {"total": best_of(lambda: vmult(v, True)),
           "cell_loop": best_of(lambda: vmult(v, False))}
    out["comm"] = max(0.0, out["total"] - out["cell_loop"])
    out["comm_fraction"] = out["comm"] / out["total"] if out["total"] else 0.0
    if refresh is not None:
        y = vmult(v, True)
        out["refresh"] = best_of(lambda: refresh(y))
        short = min(out["cell_loop"], out["refresh"])
        out["hidden"] = ((out["cell_loop"] + out["refresh"] - out["total"])
                         / short if short > 0 else 0.0)
        del y
    if steps:
        # the refresh by steps, a run of n_rep timed on its own
        ranks.times = {}
        try:
            for _ in range(n_rep):
                vmult(v)
            out["steps"] = {k: t / n_rep for k, t in ranks.times.items()}
        finally:
            ranks.times = None
    return out
