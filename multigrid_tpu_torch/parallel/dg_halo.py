"""Cell slabs with ghost cell layers, the two DG wire formats, and the
distributed SIP-DG operators.

Twin of ``multigrid_tpu/parallel/dg_halo.py`` (``HaloDGLaplace``,
``HaloDGLaplace2D``), the rendering of the reference's DG face exchange
(reference common/laplace_operator_dg.h:981-1058) for ranks of
``torch.distributed``.  The contract is the JAX classes': the collected
``vmult`` equals the single-device apply.  The layout is this package's
own.

Layout.  A level's cells are cut along z (and, on a rank grid, along y)
at cell boundaries; a rank owns a block of cells and stores ``ghost``
layers of its neighbours' cells on each side that has a neighbour
(:class:`DGSlabs`).  The JAX operator ships two trace planes a face and
puts them in place of the Dirichlet mirror inside its fused apply
(``apply(u, ext=...)``); the port's pencil kernels
(``csrc/dg_pencil.cuh``) take no external traces: they evaluate a
neighbour's face traces from the neighbour's cell block and read the outer
faces of their tensor as the mirror.  So the kernels run unchanged on the
slab, ghosts included: an owned cell reads a ghost cell only through its
face traces, and the pencils run along x, which no cut crosses.  A ghost
cell's own output sees the mirror and is wrong; nothing reads it before
the next refresh.  One ghost layer is enough for the operator; the
DG-over-CG solver stores two (its FE_Q slab's width,
``parallel/halo.GHOST_CELLS``), so that the two slabs cover the same
cells.

The wires (``WIRE_FORMATS``), as :meth:`DGSlabs.refresh` fills a ghost
layer:

* ``"traces"`` (the JAX default): the owner ships its boundary cell
  layers and the receiving kernel forms the traces itself, as on one
  device, so the owned cells of an apply are the single-device bits.  The
  price is ``n`` node planes a layer where the JAX wire ships 2 trace
  planes (``n = p + 1``; 2.5 times the bytes at p = 4 with one layer);
* ``"hermite"`` (degree >= 3): the owner ships exactly the JAX payload,
  :meth:`~..ops.dg.DGLaplace.boundary_coeff_planes` (2 planes a face); the
  receiver expands it into a ghost cell whose face value and normal
  derivative on the shared face are the neighbour's: the two planes in a
  zeroed cell for the hermite kind, one 1-D change of basis along the
  normal for gauss and gll.  The owned cells agree with one device to
  rounding (the mirror-free face algebra sees the other coefficients as
  zeros where the owner's traces see them multiplied by rounding-level
  face values).  One ghost layer only.

A slab is *fresh* when its ghost layers hold the neighbours' values;
refresh after every pass whose output a neighbour's cell reads (an apply,
a Chebyshev step with A x), never after a pointwise step, which keeps a
fresh slab fresh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.dg import DGGrid, DGLaplace, hermite_basis_change
from ..ops.dg_kernel import DGOperator, covers
from ..ops.laplace import apply_1d
from .halo import _dot, comm_split, owned_dot, split_cells
from .sharding import RankGrid, Ranks

GHOST_LAYERS = 1
WIRE_FORMATS = ("traces", "hermite")


class DGSlabs:
    """One DG level's block of cells on one rank: which cells it stores
    and owns, and the ghost refresh by ``wire``.  ``bounds``: the cell
    boundaries of the split axes, ``[z bounds]`` or ``[z bounds, y
    bounds]`` (:func:`~.halo.split_cells` each); the ranks form the grid
    of their lengths (:class:`~.sharding.RankGrid`).  Every rank of a
    split axis owns at least ``ghost`` cells along it."""

    def __init__(self, grid: DGGrid, ranks: Ranks, bounds,
                 ghost: int = GHOST_LAYERS, wire: str = "traces"):
        cuts = [list(b) for b in bounds]
        if not 1 <= len(cuts) <= min(2, grid.dim):
            raise ValueError(f"cuts along {len(cuts)} axes: z, or z and y")
        if wire not in WIRE_FORMATS:
            raise ValueError(f"wire must be one of {WIRE_FORMATS}, not "
                             f"{wire!r}")
        if wire == "hermite" and (grid.degree < 3 or ghost != 1):
            raise ValueError("the hermite wire fills one ghost layer at "
                             "degree >= 3")
        shape = tuple(len(b) - 1 for b in cuts)
        if int(np.prod(shape)) != ranks.world:
            raise ValueError(f"a rank grid of {shape} for {ranks.world} "
                             "ranks")
        self.rgrid = RankGrid(shape, ranks.rank)
        self.grid, self.ranks, self.bounds = grid, ranks, cuts
        self.ghost, self.wire = ghost, wire
        coords = self.rgrid.coords
        self.owned, self.stored, self.nbrs = [], [], []
        for a, b in enumerate(cuts):
            if b[0] != 0 or b[-1] != grid.cells[a] or min(np.diff(b)) < (
                    ghost if len(b) > 2 else 1):
                raise ValueError(f"bounds {b} do not cut {grid.cells[a]} "
                                 f"cells of axis {a} into {len(b) - 1} "
                                 f"blocks of at least {ghost}")
            c0, c1 = b[coords[a]], b[coords[a] + 1]
            lo, hi = self.rgrid.neighbor(a, 0), self.rgrid.neighbor(a, 1)
            self.owned.append((c0, c1))
            self.stored.append((c0 - ghost if lo is not None else c0,
                                c1 + ghost if hi is not None else c1))
            self.nbrs.append((lo, hi))
        k = len(cuts)
        self.local = DGGrid(
            cells=tuple(s1 - s0 for s0, s1 in self.stored) + grid.cells[k:],
            jacobian=grid.jacobian, degree=grid.degree, kind=grid.kind)
        self.owned_grid = DGGrid(
            cells=tuple(c1 - c0 for c0, c1 in self.owned) + grid.cells[k:],
            jacobian=grid.jacobian, degree=grid.degree, kind=grid.kind)
        # the owned cells in the slab, per split axis
        self._own = tuple(slice(c0 - s0, c1 - s0) for (c0, c1), (s0, _)
                          in zip(self.owned, self.stored))
        self._cache = {}

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.local.shape)

    @property
    def split(self) -> bool:
        """Whether any split axis has a neighbour (else the slab is the
        whole level and a refresh does nothing)."""
        return any(n is not None for pair in self.nbrs for n in pair)

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """The owned cells of a slab (a view; contiguous for a z split)."""
        return t[self._own]

    def owned_cells(self) -> tuple[slice, ...]:
        """The global cells this rank owns, per split axis."""
        return tuple(slice(c0, c1) for c0, c1 in self.owned)

    def stored_cells(self) -> tuple[slice, ...]:
        """The global cells of the slab, per split axis."""
        return tuple(slice(s0, s1) for s0, s1 in self.stored)

    def distribute(self, u, dtype, device) -> torch.Tensor:
        """This rank's slab of the whole block ``u`` (numpy or torch)."""
        if isinstance(u, torch.Tensor):
            part = u[self.stored_cells()]
        else:
            part = np.array(u[self.stored_cells()])
        return torch.as_tensor(part, dtype=dtype, device=device).contiguous()

    # ----------------------------------------------------------- refresh
    def _index(self, a: int, layers: slice) -> tuple:
        """The slab index of cell ``layers`` along split axis ``a``: the
        whole stored range of axis 0 (a contiguous z layer; its y ghosts
        land in the ghost corners: fresh when the y layers went first,
        :meth:`refresh`), the owned range of the other split axis."""
        idx = [slice(None) if a == 0 or b == a else self._own[b]
               for b in range(len(self._own))]
        idx[a] = layers
        return tuple(idx)

    def _hermite_rows(self, dtype, device):
        """(pack, expand) 1-D matrices of the hermite wire for gauss and
        gll (:func:`~..ops.dg.hermite_basis_change`) in ``dtype`` on
        ``device``; None for the hermite kind, whose pack is a slice."""
        key = ("hermite", dtype, device)
        if key not in self._cache:
            maps = hermite_basis_change(self.grid)
            self._cache[key] = None if maps is None else tuple(
                torch.as_tensor(m, dtype=dtype, device=device) for m in maps)
        return self._cache[key]

    def pack_planes(self, layer: torch.Tensor, a: int,
                    side: int) -> torch.Tensor:
        """The hermite wire's payload of a boundary cell layer along split
        axis ``a`` at this block's ``side``: the two Hermite-like
        coefficient planes that carry the face value and normal
        derivative (:meth:`~..ops.dg.DGLaplace.boundary_coeff_planes`),
        node axis ``a`` kept, 2 long, in node order."""
        ax, r = self.grid.dim + a, 0 if side == 0 else self.grid.n - 2
        rows = self._hermite_rows(layer.dtype, layer.device)
        if rows is None:
            return layer.narrow(ax, r, 2)
        return apply_1d(layer, rows[0][r:r + 2], ax)

    def expand_planes(self, ghost: torch.Tensor, planes: torch.Tensor,
                      a: int, side: int) -> torch.Tensor:
        """Write into the ghost layer ``ghost`` (in place) the cell whose
        face value and normal derivative on its ``side`` face are those of
        :meth:`pack_planes`' ``planes`` (its sender's ``side``): the planes
        in a zeroed cell for the hermite kind, changed back to this basis
        for gauss and gll."""
        ax, r = self.grid.dim + a, 0 if side == 0 else self.grid.n - 2
        rows = self._hermite_rows(planes.dtype, planes.device)
        if rows is None:
            ghost.zero_()
            ghost.narrow(ax, r, 2).copy_(planes)
        else:
            ghost.copy_(apply_1d(planes, rows[1][:, r:r + 2], ax))
        return ghost

    def _plan(self, t: torch.Tensor, axes=None):
        """Sends, receives and, for the hermite wire, the ghost layers to
        expand after the exchange, of the split ``axes`` (None: all):
        ``(sends, recvs, expand)``."""
        G = self.ghost
        sends, recvs, expand = [], [], []
        for a, (lo, hi) in enumerate(self.nbrs):
            if axes is not None and a not in axes:
                continue
            o0, o1 = self._own[a].start, self._own[a].stop
            for side, peer in ((0, lo), (1, hi)):
                if peer is None:
                    continue
                if self.wire == "traces":
                    mine = slice(o0, o0 + G) if side == 0 else slice(o1 - G,
                                                                     o1)
                    ghost = slice(0, o0) if side == 0 else slice(o1, o1 + G)
                    sends.append((peer, t[self._index(a, mine)]))
                    recvs.append((peer, t[self._index(a, ghost)]))
                    continue
                # hermite: this side's two planes of the boundary layer
                # out, the neighbour's facing two planes in
                planes = self.pack_planes(
                    t[self._index(a, slice(o0, o0 + 1) if side == 0
                                  else slice(o1 - 1, o1))], a, side)
                key = (a, side, t.dtype, t.device)
                buf = self._cache.get(key)
                if buf is None or buf.shape != planes.shape:
                    buf = torch.empty(planes.shape, dtype=t.dtype,
                                      device=t.device)
                    self._cache[key] = buf
                sends.append((peer, planes))
                recvs.append((peer, buf))
                ghost = t[self._index(a, slice(0, 1) if side == 0
                                      else slice(o1, o1 + 1))]
                expand.append((ghost, buf, a, 1 - side))
        return sends, recvs, expand

    def refresh(self, t: torch.Tensor) -> torch.Tensor:
        """Fill the ghost layers from their owners by the wire, in place;
        returns ``t``.  One exchange; with more than one ghost layer on a
        rank grid, two (the y layers of the owned z range, then the z
        layers over the whole stored y range), so that the ghost corners,
        which the DG-over-CG coupling reads, arrive from the diagonal rank
        through the z neighbour."""
        if not self.split:
            return t
        stages = [None] if self.ghost == 1 or len(self.nbrs) == 1 \
            else [(1,), (0,)]
        for axes in stages:
            sends, recvs, expand = self._plan(t, axes)
            self.ranks.exchange_packed(sends, recvs)
            for ghost, buf, a, side in expand:
                self.expand_planes(ghost, buf, a, side)
        return t

    def bytes_per_refresh(self, dtype) -> int:
        """Bytes this rank sends in one refresh of a ``dtype`` slab."""
        dim, n = self.grid.dim, self.grid.n
        node = self.ghost * n ** dim if self.wire == "traces" \
            else 2 * n ** (dim - 1)
        total = 0
        for a, pair in enumerate(self.nbrs):
            face = 1
            for b, c in enumerate(self.local.cells):
                if b != a:
                    face *= (self._own[b].stop - self._own[b].start
                             if b < len(self._own) and a != 0 else c)
            total += sum(p is not None for p in pair) * face * node
        return total * torch.empty((), dtype=dtype).element_size()

    # ----------------------------------------------------- whole-level ops
    def collect(self, t: torch.Tensor) -> torch.Tensor:
        """The whole block from every rank's owned cells, on every rank
        (a sum of blocks that are zero off their owner: exact; small
        grids: tests and checks)."""
        out = t.new_zeros(self.grid.shape)
        out[self.owned_cells()] = self.own(t)
        return self.ranks.sum_(out)

    def dot(self, a: torch.Tensor, b: torch.Tensor,
            fn=_dot) -> torch.Tensor:
        """Global ``a . b`` over the owned cells (0-d, ``a``'s dtype; ``fn``
        as :func:`~.halo.owned_dot` takes it), summed over the ranks in
        rank order."""
        return self.ranks.allsum(owned_dot(a, b, self._own, fn))


class HaloDGLaplace:
    """z-slab-distributed SIP-DG ``vmult`` (JAX ``HaloDGLaplace``): each
    rank runs :class:`~..ops.dg_kernel.DGOperator` (the DG kernels on the
    card, their plain version on the CPU; on a 2-D grid the plain
    ``DGLaplace`` on every device, as ``dg_kernel.covers`` has it) on its
    slab, then refreshes the
    ghost layer by ``wire``.  ``op``: the whole level's operator (a
    ``DGLaplace`` or ``DGOperator``: its grid and dtype).
    :meth:`vmult_plain` is the JAX algorithm, the plain oracle."""

    def __init__(self, op, ranks: Ranks, wire: str = "traces",
                 bounds=None):
        grid = op.grid
        if bounds is None:
            bounds = [split_cells(grid.cells[0], ranks.world)]
        self._setup(op, ranks, wire, bounds)

    def _setup(self, op, ranks, wire, bounds):
        self.grid, self.dtype, self.wire = op.grid, op.dtype, wire
        self.slabs = DGSlabs(op.grid, ranks, bounds, GHOST_LAYERS, wire)
        local = self.slabs.local
        self.op = (DGOperator if covers(local) else DGLaplace)(
            local, op.dtype, ranks.device)
        self.plain = DGLaplace(self.slabs.owned_grid, op.dtype, ranks.device)

    def distribute(self, u) -> torch.Tensor:
        """This rank's slab of the whole block ``u`` on its device."""
        return self.slabs.distribute(u, self.dtype, self.op.device)

    def collect(self, v: torch.Tensor) -> torch.Tensor:
        return self.slabs.collect(v)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.slabs.dot(a, b)

    def vmult(self, v: torch.Tensor, comm: bool = True) -> torch.Tensor:
        """A v on the slab, its ghosts refreshed; ``comm=False`` skips the
        refresh (the same compute with no traffic), for
        :meth:`comm_split_report`."""
        y = self.op.vmult(v)
        return self.slabs.refresh(y) if comm else y

    def vmult_plain(self, v: torch.Tensor) -> torch.Tensor:
        """The JAX algorithm on the owned cells of ``v``: the face payload
        of the wire (two trace planes, or two coefficient planes turned
        into traces by the receiver) from each neighbour in place of the
        Dirichlet mirror (``DGLaplace.apply(u, ext=...)``), plain PyTorch;
        a slab with the result in its owned cells, refreshed."""
        s = self.slabs
        own = s.own(v)
        if self.wire == "hermite":
            payload = {a: self.plain.boundary_coeff_planes(own, a)
                       for a in range(len(s.nbrs))}
        else:
            payload = {a: self.plain.boundary_traces(own, a)
                       for a in range(len(s.nbrs))}
        sends, recvs, got = [], [], []
        for a, (lo, hi) in enumerate(s.nbrs):
            for side, peer in ((0, lo), (1, hi)):
                if peer is None:
                    continue
                mine = payload[a][side]
                theirs = tuple(torch.empty_like(m) for m in mine)
                sends += [(peer, m) for m in mine]
                recvs += [(peer, m) for m in theirs]
                got.append(((a, side), theirs))
        s.ranks.exchange_packed(sends, recvs)
        ext = {key: (self.plain.traces_from_coeff_planes(p, key[0])
                     if self.wire == "hermite" else p) for key, p in got}
        out = v.new_zeros(v.shape)
        out[s._own] = self.plain.apply(own, ext=ext)
        return s.refresh(out)

    def bytes_per_refresh(self) -> int:
        return self.slabs.bytes_per_refresh(self.dtype)

    def comm_split_report(self, n_rep: int = 20, seed: int = 0) -> dict:
        """:func:`~.halo.comm_split` of :meth:`vmult` on a random slab
        (``seed``), with ``bytes``, this rank's bytes a refresh."""
        rng = np.random.default_rng(seed)
        v = torch.as_tensor(rng.standard_normal(self.slabs.shape),
                            dtype=self.dtype, device=self.op.device)
        out = comm_split(self.vmult, v, self.slabs.ranks, n_rep)
        out["bytes"] = self.bytes_per_refresh()
        return out


class HaloDGLaplace2D(HaloDGLaplace):
    """('z', 'y')-distributed SIP-DG ``vmult`` on an ``nz x ny`` rank grid
    (JAX ``HaloDGLaplace2D``): one exchange with up to four neighbours a
    refresh.  DG couples through faces only, so the ghost corners are
    never read and no corner routing exists."""

    def __init__(self, op, ranks: Ranks, shape: tuple[int, int],
                 wire: str = "traces"):
        nz, ny = shape
        grid = op.grid
        self._setup(op, ranks, wire, [split_cells(grid.cells[0], nz),
                                      split_cells(grid.cells[1], ny)])
