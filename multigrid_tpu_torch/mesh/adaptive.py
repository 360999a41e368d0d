"""Adaptive forest meshes with hanging-node constraints (2-D quadtree and
3-D octree).

Twin of ``multigrid_tpu/mesh/adaptive.py`` (host numpy; the port keeps its
own copy so that it never imports the JAX package).  It stands for the
p4est + AffineConstraints + SolutionTransfer machinery of the reference's
poisson_l (reference poisson_l/program.cc:232-243, 504-543):

* a forest of active cells ``(level, ix, iy[, iz])`` on a cubic root
  lattice with a domain mask (the L-domain drops the first-quadrant root
  column), 2:1 balanced, with ``refine_and_coarsen_fixed_number``
  execution;
* FE_Q(p) dofs identified by coordinate hashing
  (:func:`.native.unique_nodes`); hanging nodes on 2:1 interfaces (faces
  and, in 3-D, edges) are eliminated at set-up by one geometric rule -- a
  node is constrained iff the coarsest active cell containing it is
  coarser than every cell owning it as a node, and its masters are that
  coarse cell's tensor-Lagrange interpolation at the node.  Every
  cell-local node becomes a short (dof, weight) list, so the constrained
  operator ``C^T A_loc C`` is a weighted gather, one batched element
  matmul and a weighted scatter, with no constraint pass at run time;
* nested-mesh interpolation between AMR cycles (deal.II SolutionTransfer
  and MGTransferGlobalCoarsening): each dof of the fine mesh is a point
  evaluation of the coarse mesh, one gather table per mesh pair
  (:meth:`AdaptiveGrid.point_eval_table`, here vectorized over the points
  with the JAX twin's tables, entry order and sums unchanged).

Cells are axis-aligned cubes: level l has size h = L0 / 2^l.  Cells of all
levels batch into one dense element matmul; the element stiffness scales
as h^(dim-2) per cell (scale-free in 2-D).
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import product

import numpy as np

from ..core.basis import Basis1D, make_basis
from . import native


@dataclass(frozen=True)
class Cell:
    """Forest cell; ``iz`` is None in 2-D (axis order x, y[, z])."""

    level: int
    ix: int
    iy: int
    iz: int | None = None

    @property
    def dim(self) -> int:
        return 2 if self.iz is None else 3

    @property
    def coords(self) -> tuple[int, ...]:
        return (self.ix, self.iy) if self.iz is None else (self.ix, self.iy, self.iz)

    @staticmethod
    def of(level: int, coords) -> "Cell":
        return Cell(level, *coords) if len(coords) == 3 else Cell(
            level, coords[0], coords[1])

    def children(self):
        base = tuple(2 * c for c in self.coords)
        out = []
        for offs in product((0, 1), repeat=self.dim):
            out.append(Cell.of(self.level + 1,
                               tuple(b + o for b, o in zip(base, offs))))
        return out

    @property
    def parent(self):
        return Cell.of(self.level - 1, tuple(c // 2 for c in self.coords))


class Forest:
    """Active-cell set over a ``root^dim`` base lattice on
    ``[origin, origin+extent]^dim`` with an optional root mask."""

    dim = 2

    def __init__(self, root_cells: int = 2, origin: float = -1.0,
                 extent: float = 2.0, active=None, root_mask=None):
        self.root_cells = root_cells
        self.origin = origin
        self.extent = extent
        if active is not None:
            self.active = set(active)
        else:
            self.active = set()
            for coords in product(range(root_cells), repeat=self.dim):
                if root_mask is None or root_mask(*coords):
                    self.active.add(Cell.of(0, coords))

    def _make(self, active) -> "Forest":
        f = type(self).__new__(type(self))
        Forest.__init__(f, self.root_cells, self.origin, self.extent,
                        active=active)
        return f

    # ------------------------------------------------------------ geometry
    def h(self, level: int) -> float:
        return self.extent / (self.root_cells * (1 << level))

    def cell_corner(self, c: Cell):
        h = self.h(c.level)
        return tuple(self.origin + i * h for i in c.coords)

    # ----------------------------------------------------------- structure
    def exists(self, c: Cell) -> bool:
        return c in self.active

    def _covered(self, c: Cell) -> bool:
        while c.level >= 0:
            if c in self.active:
                return True
            c = c.parent
        return False

    def neighbor(self, c: Cell, d: int, side: int):
        """Neighbor cell coordinates at the same level (may not be active)."""
        n = self.root_cells << c.level
        coords = list(c.coords)
        coords[d] += 1 if side else -1
        if not (0 <= coords[d] < n):
            return None
        return Cell.of(c.level, coords)

    @property
    def ancestors(self):
        """Set of all strict ancestors of active cells (regions that are
        refined).  Forests are immutable after construction; cached."""
        anc = self.__dict__.get("_anc")
        if anc is None:
            anc = set()
            for a in self.active:
                q = a.parent
                while q.level >= 0 and q not in anc:
                    anc.add(q)
                    q = q.parent
            self.__dict__["_anc"] = anc
        return anc

    def find_active_neighbor(self, c: Cell, d: int, side: int):
        """Returns (kind, cell(s)): ('same', cell), ('coarse', ancestor),
        ('fine', [children on the shared face]) or ('boundary', None) —
        regions outside the (masked) domain read as boundary."""
        nb = self.neighbor(c, d, side)
        if nb is None:
            return ("boundary", None)
        if nb in self.active:
            return ("same", nb)
        a = nb.parent
        while a.level >= 0:
            if a in self.active:
                return ("coarse", a)
            a = a.parent
        if nb not in self.ancestors:
            return ("boundary", None)   # void region (e.g. the L's quadrant)
        # finer: the 2^(dim-1) children of nb touching the shared face
        out = []
        face_side = 1 - side  # children's face facing back to c
        for k in nb.children():
            if k.coords[d] % 2 != face_side:
                continue
            if k not in self.active:
                # deeper than one level is excluded by 2:1 balance
                raise AssertionError("forest not 2:1 balanced")
            out.append(k)
        return ("fine", out)

    # ----------------------------------------------------------- refinement
    def balanced_copy(self) -> "Forest":
        """Enforce 2:1 face balance by refining offending coarse cells.

        Uses the ancestor set: ``q in anc`` iff an active cell lies STRICTLY
        below q, so "neighbor refined >= 2 levels deeper across this face"
        is: a shared-face child of the neighbor is itself in ``anc``.
        """
        active = set(self.active)
        dim = self.dim
        while True:
            anc = set()
            for a in active:
                q = a.parent
                while q.level >= 0:
                    if q in anc:
                        break
                    anc.add(q)
                    q = q.parent
            to_refine = set()
            for c in active:
                n = self.root_cells << c.level
                for d in range(dim):
                    for side in (0, 1):
                        coords = list(c.coords)
                        coords[d] += 1 if side else -1
                        if not (0 <= coords[d] < n):
                            continue
                        nb = Cell.of(c.level, coords)
                        if nb not in anc:
                            continue
                        face_side = 1 - side
                        for k in nb.children():
                            if k.coords[d] % 2 == face_side and k in anc:
                                to_refine.add(c)
            if not to_refine:
                break
            for c in to_refine:
                active.discard(c)
                active.update(c.children())
        return self._make(active)

    def refine(self, marks_refine, marks_coarsen=()) -> "Forest":
        """Execute refinement/coarsening marks; returns a balanced forest
        (deal.II refine_and_coarsen + execute, program.cc:533-540)."""
        marks_refine = set(marks_refine)
        marks_coarsen = set(marks_coarsen) - marks_refine
        active = set(self.active)
        for c in marks_refine:
            if c in active:
                active.discard(c)
                active.update(c.children())
        # coarsen only complete sibling groups, none refined this round
        by_parent = {}
        for c in marks_coarsen:
            if c in active and c.level > 0:
                by_parent.setdefault(c.parent, []).append(c)
        for parent, kids in by_parent.items():
            if len(kids) == 2 ** self.dim:
                for k in kids:
                    active.discard(k)
                active.add(parent)
        return self._make(active).balanced_copy()

    def uniform_refine(self) -> "Forest":
        return self.refine(list(self.active))

    def coarsen_global(self) -> "Forest":
        """One global h-coarsening step (deal.II MGTransferGlobalCoarsening
        ladder): every active cell is replaced by its parent, overlaps are
        resolved toward the finer cell, and the result is re-balanced.  The
        output mesh is nested in ``self``."""
        work = set()
        for c in self.active:
            work.add(c.parent if c.level > 0 else c)
        # candidates may overlap (an ancestor of a finer candidate); split
        # offending coarse candidates into children until the set is a
        # partition — splitting (not dropping) preserves coverage of the
        # sibling regions and stays nested in ``self``
        while True:
            anc = set()
            for c in work:
                q = c.parent
                while q.level >= 0 and q not in anc:
                    anc.add(q)
                    q = q.parent
            offending = [c for c in work if c in anc]
            if not offending:
                break
            for c in offending:
                work.discard(c)
                work.update(c.children())
        return self._make(work).balanced_copy()

    @property
    def n_cells(self) -> int:
        return len(self.active)

    def sorted_cells(self):
        return sorted(self.active,
                      key=lambda c: (c.level,) + tuple(reversed(c.coords)))

    @property
    def max_active_level(self) -> int:
        return max(c.level for c in self.active)


class QuadForest(Forest):
    """2-D forest (back-compat name)."""

    dim = 2


class OctForest(Forest):
    """3-D forest of octree cells."""

    dim = 3


class AdaptiveGrid:
    """FE_Q(p) dof layout on a Forest: unique dofs, hanging constraints
    folded into per-cell (index, weight) gathers, Dirichlet mask."""

    def __init__(self, forest: Forest, degree: int, boundary_fn):
        self.forest = forest
        self.degree = degree
        self.dim = forest.dim
        dim = self.dim
        self.basis: Basis1D = make_basis(degree)
        p = degree
        n = p + 1
        self.n = n
        N = n ** dim
        self.N = N
        cells = forest.sorted_cells()
        self.cells = cells
        self.cell_index = {c: i for i, c in enumerate(cells)}
        nodes1 = self.basis.nodes  # on [0,1]

        # ---- 1. all cell-local node coordinates, robust dedup.  Local
        # lexicographic order is (i_{dim-1}, ..., i_1, i_0) -> slowest
        # axis LAST in the coordinate tuple (2-D: [iy, ix]; 3-D: [iz, iy, ix])
        C = len(cells)
        corners = np.array([forest.cell_corner(c) for c in cells])  # [C, dim]
        hs = np.array([forest.h(c.level) for c in cells])           # [C]
        coords = np.empty((C, N, dim))
        for d in range(dim):
            shape = [1] * dim
            shape[dim - 1 - d] = n        # axis d varies along local dim-1-d
            ax = nodes1.reshape(shape)
            local = np.broadcast_to(ax, (n,) * dim).reshape(N)
            coords[:, :, d] = corners[:, None, d] + hs[:, None] * local[None, :]
        flat = coords.reshape(-1, dim)
        scale = np.abs(flat).max() + 1.0
        tol = 1e-12 * scale
        n_nodes, inverse = native.unique_nodes(flat, tol)
        cell_nodes = inverse.reshape(C, N)
        node_xy = np.zeros((n_nodes, dim))
        node_xy[inverse] = flat

        # ---- 2. hanging constraints, geometric rule.  For every node find
        # the COARSEST active cell whose closure contains it; the node is
        # constrained iff that cell is strictly coarser than every cell
        # owning the node (then it lies on a 2:1 interface — a face node,
        # or in 3-D also an edge node — and its masters are the coarse
        # cell's tensor-Lagrange interpolation at the node's position).
        min_owner_level = np.full(n_nodes, 10**9, np.int64)
        lvls = np.array([c.level for c in cells])
        np.minimum.at(min_owner_level, cell_nodes.reshape(-1),
                      np.repeat(lvls, N))

        # per-level active-cell code sets for vectorized containment lookup
        levels_present = sorted({c.level for c in cells})
        origin = forest.origin

        def encode(level, idx):  # idx: [M, dim] int
            nmax = forest.root_cells << level
            code = idx[:, 0]
            for d in range(1, dim):
                code = code * nmax + idx[:, d]
            return code

        level_codes = {}
        for lvl in levels_present:
            arr = np.array([c.coords for c in cells if c.level == lvl],
                           np.int64)
            idx_map = {tuple(r): self.cell_index[Cell.of(lvl, r)]
                       for r in map(tuple, arr)}
            codes = encode(lvl, arr)
            order = np.argsort(codes)
            cidx = np.array([idx_map[tuple(r)] for r in arr[order]], np.int64)
            level_codes[lvl] = (codes[order], cidx)

        containing = np.full(n_nodes, -1, np.int64)   # cell index
        containing_level = np.full(n_nodes, -1, np.int64)
        eps = tol
        for lvl in levels_present:
            undecided = containing < 0
            if not undecided.any():
                break
            pts = node_xy[undecided]
            h = forest.h(lvl)
            nmax = forest.root_cells << lvl
            lo = np.clip(np.floor((pts - origin - eps) / h), 0, nmax - 1
                         ).astype(np.int64)
            hi = np.clip(np.floor((pts - origin + eps) / h), 0, nmax - 1
                         ).astype(np.int64)
            found = np.full(pts.shape[0], -1, np.int64)
            codes_sorted, cidx_sorted = level_codes[lvl]
            for combo in product((0, 1), repeat=dim):
                cand = np.where(np.array(combo)[None, :] > 0, hi, lo)
                code = encode(lvl, cand)
                pos = np.searchsorted(codes_sorted, code)
                pos = np.clip(pos, 0, codes_sorted.size - 1)
                hit = (codes_sorted[pos] == code) & (found < 0)
                found[hit] = cidx_sorted[pos[hit]]
            sel = np.nonzero(undecided)[0][found >= 0]
            containing[sel] = found[found >= 0]
            containing_level[sel] = lvl

        is_constrained = (containing >= 0) & (containing_level
                                              < min_owner_level)
        constrained_ids = np.nonzero(is_constrained)[0]

        # masters by tensor-Lagrange interpolation in the containing cell
        constraints = {}
        for nid in constrained_ids:
            ci = int(containing[nid])
            cc = cells[ci]
            h = forest.h(cc.level)
            corner = corners[ci]
            t = (node_xy[nid] - corner) / h
            wd = [self._lagrange_at(np.array([t[d]]))[0] for d in range(dim)]
            # local index order: slowest axis = coordinate dim-1
            masters = []
            loc = cell_nodes[ci].reshape((n,) * dim)
            rng = [range(n)] * dim
            for mi in product(*rng):    # mi = (i_{dim-1}, ..., i_0)
                w = 1.0
                for d in range(dim):
                    w *= wd[d][mi[dim - 1 - d]]
                if abs(w) > 1e-14:
                    masters.append((int(loc[mi]), float(w)))
            constraints[int(nid)] = masters

        # resolve chains (a master may itself be constrained)
        def resolve(nid, depth=0):
            if nid not in constraints or depth > 8:
                return [(nid, 1.0)]
            out = {}
            for m, w in constraints[nid]:
                for mm, ww in resolve(m, depth + 1):
                    out[mm] = out.get(mm, 0.0) + w * ww
            return list(out.items())

        resolved = {nid: resolve(nid) for nid in constraints}

        # ---- 3. renumber real dofs (unconstrained nodes)
        real_of_node = -np.ones(n_nodes, np.int64)
        real_ids = np.nonzero(~is_constrained)[0]
        real_of_node[real_ids] = np.arange(real_ids.size)
        self.n_dofs = int(real_ids.size)
        self.dof_xy = node_xy[real_ids]

        # ---- 4. per-cell weighted gather tables [C, N, K]
        per_node = []
        Kmax = 1
        for ci in range(C):
            row = []
            for nid in cell_nodes[ci]:
                if is_constrained[nid]:
                    lst = [(int(real_of_node[m]), w)
                           for m, w in resolved[int(nid)]]
                else:
                    lst = [(int(real_of_node[nid]), 1.0)]
                Kmax = max(Kmax, len(lst))
                row.append(lst)
            per_node.append(row)
        self.K = Kmax
        self.gidx = np.zeros((C, N, Kmax), np.int32)
        self.gw = np.zeros((C, N, Kmax))
        for ci in range(C):
            for i in range(N):
                for k, (m, w) in enumerate(per_node[ci][i]):
                    self.gidx[ci, i, k] = m
                    self.gw[ci, i, k] = w

        # ---- 5. Dirichlet mask on real dofs
        self.boundary = np.asarray(boundary_fn(self.dof_xy), bool)
        self.n_cells = C
        self.cell_levels = np.array([c.level for c in cells])
        self.cell_h = hs
        self.n_constraints = int(is_constrained.sum())

    def _lagrange_at(self, pts):
        """1-D Lagrange basis (grid nodes) evaluated at ``pts``."""
        nodes = self.basis.nodes
        n = nodes.size
        out = np.ones((len(pts), n))
        for j in range(n):
            for m in range(n):
                if m != j:
                    out[:, j] *= (pts - nodes[m]) / (nodes[j] - nodes[m])
        return out

    # -------------------------------------------------- nested-mesh gather
    def point_eval_table(self, coarse: "AdaptiveGrid", chunk: int = 1 << 16):
        """Gather table ``(idx [nd, K2], w)`` evaluating the coarse-mesh FE
        function at every real dof position of this grid (SolutionTransfer
        and global-coarsening prolongation; the meshes must be nested).

        Row r lists the coarse dofs of dof r in the order the JAX twin's
        per-point loop meets them (local node, then master), each weight
        summed in that order, padded with ``(0, 0.0)``: the same table."""
        parts = [self._point_eval_rows(coarse, self.dof_xy[i0:i0 + chunk])
                 for i0 in range(0, self.n_dofs, chunk)]
        K2 = max([0] + [p[0].shape[1] for p in parts])
        idx = np.zeros((self.n_dofs, K2), np.int32)
        w = np.zeros((self.n_dofs, K2))
        r0 = 0
        for pi, pw in parts:
            idx[r0:r0 + len(pi), :pi.shape[1]] = pi
            w[r0:r0 + len(pi), :pi.shape[1]] = pw
            r0 += len(pi)
        return idx, w

    def _point_eval_rows(self, coarse: "AdaptiveGrid", xy: np.ndarray):
        n, dim = self.n, self.dim
        f = coarse.forest
        P = xy.shape[0]
        ci = self._locate_all(f, xy, coarse.cell_index)
        lv = coarse.cell_levels[ci]
        h = np.array([f.h(int(lvl)) for lvl in range(int(lv.max()) + 1)])[lv]
        coords = np.array([c.coords for c in coarse.cells], np.int64)[ci]
        wd = []
        for d in range(dim):
            corner = f.origin + coords[:, d] * h
            wd.append(coarse._lagrange_at((xy[:, d] - corner) / h))  # [P, n]
        # w0 of local node mi = (i_{dim-1}, ..., i_0), multiplied in the
        # order d = 0, 1, ...
        N = n**dim
        mi = np.stack(np.unravel_index(np.arange(N), (n,) * dim), axis=1)
        w0 = np.ones((P, N))
        for d in range(dim):
            w0 = w0 * wd[d][:, mi[:, dim - 1 - d]]
        K = coarse.K
        cw = w0[:, :, None] * coarse.gw[ci]                   # [P, N, K]
        valid = (np.abs(w0) >= 1e-14)[:, :, None] & (np.abs(cw) >= 1e-14)
        pp, cc = np.nonzero(valid.reshape(P, N * K))         # (row, candidate)
        mm = coarse.gidx[ci].reshape(P, N * K)[pp, cc].astype(np.int64)
        ww = cw.reshape(P, N * K)[pp, cc]
        # one slot per (row, master) in the order of first appearance
        _, first, inv = np.unique(pp * coarse.n_dofs + mm, return_index=True,
                                  return_inverse=True)
        rank = np.empty(first.size, np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(first.size)
        row = pp[first]
        counts = np.bincount(row, minlength=P)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = rank - starts[row]
        idx = np.zeros((P, int(counts.max()) if P else 0), np.int32)
        w = np.zeros(idx.shape)
        idx[row, slot] = mm[first]
        np.add.at(w, (pp, slot[inv.reshape(-1)]), ww)   # in candidate order
        return idx, w

    @staticmethod
    def _locate_all(forest: Forest, xy: np.ndarray, cell_index) -> np.ndarray:
        """Index (``cell_index``) of the active cell containing each point,
        the JAX twin's ``_locate`` for many points at once: the coarsest
        level first, then the candidate cells in the order of
        ``product((0, -1))``; the points are dof coordinates of a nested
        finer mesh."""
        dim = forest.dim
        eps = 1e-12 * (abs(forest.extent) + 1)
        P = xy.shape[0]
        out = np.full(P, -1, np.int64)
        by_level = {}
        for c, i in cell_index.items():
            by_level.setdefault(c.level, []).append((c.coords, i))
        for lvl in range(0, 40):
            todo = np.nonzero(out < 0)[0]
            if not todo.size:
                break
            if lvl not in by_level:
                continue
            h = forest.h(lvl)
            nmax = forest.root_cells << lvl
            arr = np.array([co for co, _ in by_level[lvl]], np.int64)
            code_of = lambda a: np.ravel_multi_index(a.T, (nmax,) * dim)
            codes = code_of(arr)
            order = np.argsort(codes)
            codes = codes[order]
            cidx = np.array([i for _, i in by_level[lvl]], np.int64)[order]
            pts = xy[todo]
            base = np.minimum(np.trunc((pts - forest.origin + eps) / h
                                       ).astype(np.int64), nmax - 1)
            found = np.full(todo.size, -1, np.int64)
            for offs in product((0, -1), repeat=dim):
                cand = base + np.array(offs)[None, :]
                ok = (cand >= 0).all(axis=1) & (found < 0)
                code = code_of(np.maximum(cand, 0))
                pos = np.clip(np.searchsorted(codes, code), 0, codes.size - 1)
                ok &= codes[pos] == code
                corner = forest.origin + cand * h
                ok &= ((corner - eps <= pts) & (pts <= corner + h + eps)
                       ).all(axis=1)
                found[ok] = cidx[pos[ok]]
            out[todo] = found
        if (out < 0).any():
            raise KeyError(f"point {xy[np.argmax(out < 0)]} not in forest")
        return out
