"""Local-smoothing multigrid on adaptive forests: the reference poisson_l's
preconditioner, beside the global coarsening of :mod:`.multigrid_adaptive`.

Twin of ``multigrid_tpu/solvers/multigrid_local.py``.  The reference uses
deal.II ``Multigrid`` with ``MGConstrainedDoFs`` and ``MGInterfaceOperator``
edge matrices (reference poisson_l/program.cc:338-416, esp. 372-383):
level ``l`` is the uniform-depth mesh of all tree cells at depth ``l``
(active cells and ancestors of deeper ones), covering only the part of the
domain refined to depth ``>= l``; each level smooths with its
refinement-edge dofs (level boundary inside the domain) held at zero, and
interface matrices carry the residual across the edge
(``vmult_interface_down/up``, reference gpu/poisson_l.cu:390-436).

As in the JAX twin:

* every level mesh has one depth, so its operator is one batched element
  matmul with no hanging constraints;
* ``vmult_residual`` and ``vmult_interface_down`` are one unmasked
  operator application (:meth:`LocalLevel.residual_full_rows`): with the
  update supported on interior dofs, ``d - A_l u`` with true rows is the
  level residual on interior rows and the edge coupling on edge rows;
* ``vmult_interface_up`` is its own application after prolongation;
* each global dof is copied to exactly one level, the finest where it sits
  on an active cell (static gather tables); the restriction is the plain
  transpose of the nested point-evaluation prolongation.

Plain PyTorch on every device; the restrictions are deterministic scatters
(:class:`..ops.laplace_general.NodeScatter`) and the copies index with
unique indices, so two solves on the card agree bit for bit.  The edge and
boundary masks come from a per-cell host loop at set-up.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..devices import resolve
from ..mesh import native
from ..mesh.adaptive import AdaptiveGrid, Forest
from ..ops.laplace_adaptive import AdaptiveLaplace
from ..ops.laplace_general import NodeScatter, chebyshev_step
from .chebyshev import Chebyshev
from .multigrid import set_full_precision_matmul
from .multigrid_adaptive import AdaptiveSystem


def level_forest(forest: Forest, level: int) -> Forest:
    """The uniform-depth level mesh: all tree cells at ``level`` (active
    cells of that depth and ancestors of deeper active cells), deal.II's
    level view of the triangulation."""
    cells = {c for c in forest.active if c.level == level}
    cells |= {c for c in forest.ancestors if c.level == level}
    return forest._make(cells)


def _match_coords(A: np.ndarray, B: np.ndarray, tol: float) -> np.ndarray:
    """Index of each row of B in A (coordinates equal within ``tol``), -1
    if absent; A's rows must be pairwise distinct."""
    both = np.ascontiguousarray(np.vstack([A, B]))
    n_nodes, inverse = native.unique_nodes(both, tol)
    lookup = np.full(n_nodes, -1, np.int64)
    lookup[inverse[: len(A)]] = np.arange(len(A))
    return lookup[inverse[len(A):]]


class LocalLevel:
    """One level of the local-smoothing hierarchy: the uniform-depth grid,
    its masks and the operator pieces; ``shape``, ``dtype``, ``device``,
    ``vmult`` and ``cheb_step`` make it a smoother's operator."""

    def __init__(self, global_forest: Forest, level: int, degree: int,
                 boundary_fn: Callable, v_dtype=torch.float32,
                 device="cuda"):
        self.level = level
        forest = level_forest(global_forest, level)
        self.forest = forest
        grid = AdaptiveGrid(forest, degree, boundary_fn)
        if grid.n_constraints:
            raise AssertionError("a level mesh has one depth: no hanging "
                                 "nodes")
        self.grid = grid
        self.op = op = AdaptiveLaplace(grid, v_dtype, device)
        self.shape, self.dtype, self.device = op.shape, op.dtype, op.device

        # the refinement edge: nodes on faces whose same-depth neighbour is
        # not in the level mesh but whose region the global forest covers
        # (the active mesh is coarser there); a missing, uncovered
        # neighbour is the domain boundary
        n, dim = grid.n, grid.dim
        boundary = grid.boundary.copy()
        edge = np.zeros(grid.n_dofs, bool)
        node_of = grid.gidx[:, :, 0].reshape((-1,) + (n,) * dim)
        for ci, c in enumerate(grid.cells):
            for d in range(dim):
                axis = dim - 1 - d   # local axis of coordinate d
                for side in (0, 1):
                    nb = forest.neighbor(c, d, side)
                    if nb is not None and nb in forest.active:
                        continue
                    face = np.take(node_of[ci], -1 if side else 0, axis=axis)
                    if nb is not None and global_forest._covered(nb):
                        edge[face.reshape(-1)] = True
                    else:
                        boundary[face.reshape(-1)] = True
        self.edge = edge & ~boundary
        self.boundary = boundary
        self.constrained = boundary | self.edge
        t = lambda a: torch.as_tensor(a, device=op.device)
        self._int = t(~self.constrained)
        self._edge = t(self.edge)
        self._bdry = t(boundary)
        self._inv_diag = torch.where(t(self.constrained), 1.0, op.inv_diag)

    # ------------------------------------------------- operator pieces
    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        """The smoother's operator: the interior block of A_l, identity on
        the constrained rows (the preconditioner is interior-masked, so
        those rows never feed an update)."""
        y = self.op.apply_cells(torch.where(self._int, x, 0))
        return torch.where(self._int, y, x)

    def precond(self, r: torch.Tensor) -> torch.Tensor:
        return torch.where(self._int, self._inv_diag * r, 0)

    def cheb_step(self, b, x, x_old, f1: float, f2: float, out=None):
        return chebyshev_step(self.vmult, self.precond, b, x, x_old, f1, f2,
                              out)

    def residual_full_rows(self, d: torch.Tensor,
                           u: torch.Tensor) -> torch.Tensor:
        """``d - A_l u`` with true rows everywhere: the level residual on
        interior rows, the down interface coupling on edge rows
        (``vmult_interface_down`` fused into the residual; ``u`` is
        interior-supported).  Domain-Dirichlet rows are zero: their test
        functions are not in the global space."""
        t = d - self.op.apply_cells(torch.where(self._int, u, 0))
        return torch.where(self._bdry, 0, t)

    def interface_up(self, x: torch.Tensor) -> torch.Tensor:
        """``interior . A_l . edge``: the change of the interior defect from
        the edge values that prolongation set (``vmult_interface_up``,
        reference gpu/poisson_l.cu:418-436)."""
        y = self.op.apply_cells(torch.where(self._edge, x, 0))
        return torch.where(self._int, y, 0)


class LevelTransfer:
    """Unconstrained nested-mesh transfer between consecutive level meshes:
    prolongation = parent-cell point evaluation (edge and boundary values
    of the fine level included), restriction = its exact transpose."""

    def __init__(self, fine: AdaptiveGrid, coarse: AdaptiveGrid,
                 dtype=torch.float32, device="cuda"):
        dev = resolve(device)
        idx, w = fine.point_eval_table(coarse)
        self.idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        self.w = torch.as_tensor(w, dtype=dtype, device=dev)
        self._scatter = NodeScatter(idx, coarse.n_dofs, dev, allow_empty=True)

    def prolongate(self, uc: torch.Tensor) -> torch.Tensor:
        return torch.sum(uc[self.idx] * self.w, dim=-1)

    def restrict(self, rf: torch.Tensor) -> torch.Tensor:
        return self._scatter(rf[:, None] * self.w)


class LocalSmoothingMultigrid(AdaptiveSystem):
    """CG on the global adaptive system, preconditioned by one V-cycle of
    level-local smoothing (poisson_l's solver; the reference's smoother
    settings, program.cc:349-365: range 15, degree ``n_pre`` and 15
    Lanczos steps on the levels; range 1e-3, automatic degree and a full
    Lanczos run on the coarsest)."""

    n_pre = 2                   # Chebyshev degree on the finer levels
    f_dtype = torch.float64     # the outer CG's type

    def __init__(self, grid: AdaptiveGrid, exact_fn: Callable,
                 rhs_fn: Callable, device="cuda", v_dtype=torch.float32,
                 smoothing_range: float = 15.0):
        self.device = dev = resolve(device)
        if dev.type == "cuda":
            set_full_precision_matmul()
        self.grid = grid
        self.grids = [grid]        # the global-coarsening solver's interface
        self.v_dtype = v_dtype
        forest = grid.forest
        L = forest.max_active_level
        self.maxlevel = L
        bfn = _grid_boundary(grid)
        self.levels = [LocalLevel(forest, l, grid.degree, bfn, v_dtype, dev)
                       for l in range(L + 1)]
        self.transfers = [None] + [
            LevelTransfer(self.levels[l].grid, self.levels[l - 1].grid,
                          v_dtype, dev) for l in range(1, L + 1)]
        if self.levels[0].edge.any():
            raise AssertionError("the coarsest level mesh must cover the "
                                 "whole domain")

        # global dof -> (finest active level, level dof) copy tables
        tol = 1e-12 * (abs(forest.extent) + abs(forest.origin) + 1.0)
        native_level = np.full(grid.n_dofs, -1, np.int64)
        native_ldof = np.full(grid.n_dofs, -1, np.int64)
        for l in range(L + 1):
            lv = self.levels[l]
            active_rows = [ci for ci, c in enumerate(lv.grid.cells)
                           if c in forest.active]
            if not active_rows:
                continue
            ldofs = np.unique(lv.grid.gidx[active_rows, :, 0])
            g_of = _match_coords(grid.dof_xy, lv.grid.dof_xy[ldofs], tol)
            sel = g_of >= 0          # hanging positions have no global dof
            native_level[g_of[sel]] = l        # the finest wins (l ascending)
            native_ldof[g_of[sel]] = ldofs[sel]
        if (native_level < 0).any():
            raise AssertionError("every global dof sits on an active cell")
        ix = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
        self.copy_glb, self.copy_lvl = [], []
        for l in range(L + 1):
            g_idx = np.nonzero(native_level == l)[0]
            self.copy_glb.append(ix(g_idx))
            self.copy_lvl.append(ix(native_ldof[g_idx]))

        self.smoothers = []
        for l, lv in enumerate(self.levels):
            if l == 0:
                sm = Chebyshev.create(lv, lv.precond, smoothing_range=1e-3,
                                      degree=None,
                                      eig_cg_n_iterations=lv.grid.n_dofs)
            else:
                sm = Chebyshev.create(lv, lv.precond,
                                      smoothing_range=smoothing_range,
                                      degree=self.n_pre,
                                      eig_cg_n_iterations=15)
            self.smoothers.append(sm)
        self._setup_system(grid, exact_fn, rhs_fn)

    # --------------------------------------------------------- V-cycle
    def v_cycle(self, r_global: torch.Tensor) -> torch.Tensor:
        """One local-smoothing V-cycle applied to a global residual."""
        L = self.maxlevel
        d = []
        for l, lv in enumerate(self.levels):
            dl = r_global.new_zeros(lv.grid.n_dofs)
            dl[self.copy_lvl[l]] = r_global[self.copy_glb[l]]
            d.append(dl)
        u = [None] * (L + 1)
        for l in range(L, 0, -1):
            u[l] = self.smoothers[l].vmult(d[l])
            t = self.levels[l].residual_full_rows(d[l], u[l])
            d[l - 1] = d[l - 1] + self.transfers[l].restrict(t)
        u[0] = self.smoothers[0].vmult(d[0])
        for l in range(1, L + 1):
            pu = self.transfers[l].prolongate(u[l - 1])
            u[l] = u[l] + pu
            d[l] = d[l] - self.levels[l].interface_up(pu)
            u[l] = self.smoothers[l].step(u[l], d[l])
        out = torch.zeros_like(r_global)
        for l in range(L + 1):
            out[self.copy_glb[l]] = u[l][self.copy_lvl[l]]
        return out

    def _precond(self, r: torch.Tensor) -> torch.Tensor:
        return self.v_cycle(r.to(self.v_dtype)).to(self.f_dtype)


def _grid_boundary(grid: AdaptiveGrid):
    """A geometric boundary predicate from the global grid's mask (the
    level meshes share nodes with the global mesh only where both exist;
    elsewhere the level's own face logic fills in)."""
    tol = 1e-12 * (np.abs(grid.dof_xy).max() + 1.0)
    bxy = grid.dof_xy[grid.boundary]

    def fn(xy):
        return _match_coords(np.ascontiguousarray(bxy),
                             np.ascontiguousarray(xy), tol) >= 0

    return fn
