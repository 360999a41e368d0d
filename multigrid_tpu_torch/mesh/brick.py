"""Structured brick meshes with a geometric-multigrid level hierarchy.

Copy of ``multigrid_tpu/mesh/brick.py`` (numpy only).  Replaces the
reference's use of
``parallel::distributed::Triangulation`` (p4est) +
``GridGenerator::subdivided_hyper_{cube,rectangle}`` + ``refine_global``
(reference poisson_cube/program.cc:498-570).  A brick is an
``n0 x n1 x ... `` grid of congruent axis-aligned cells; level ``l`` has
``coarse_cells * 2^l`` cells per axis.  The mapping is affine with constant
(per-axis) cell size, which enables the reference's "affine geometry" merged
coefficient fast path (reference common/laplace_operator.h:374-387).

Axis order is (z, y, x) slowest-to-fastest, i.e. arrays are indexed
``u[z, y, x]``; coordinates returned per axis follow the same order.
:class:`CellBox` (the port's own) is a block of cells of one level's grid
cut along z (and y), the box a rank of the decomposed solver
(``parallel/``) builds on.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..core.basis import Basis1D, make_basis


@dataclass(frozen=True)
class BrickMesh:
    """A box ``[origin_d, origin_d + length_d]`` per axis, uniformly refined.

    ``n_levels`` counts multigrid levels: level 0 is the coarse mesh with
    ``coarse_cells`` cells per axis, level ``n_levels-1`` the finest.
    """

    coarse_cells: tuple[int, ...]
    origin: tuple[float, ...]
    lengths: tuple[float, ...]
    n_levels: int = 1

    @property
    def dim(self) -> int:
        return len(self.coarse_cells)

    @property
    def max_level(self) -> int:
        return self.n_levels - 1

    def cells(self, level: int) -> tuple[int, ...]:
        f = 1 << level
        return tuple(c * f for c in self.coarse_cells)

    def n_cells(self, level: int) -> int:
        return int(np.prod(self.cells(level)))

    def h(self, level: int) -> tuple[float, ...]:
        return tuple(
            l / c for l, c in zip(self.lengths, self.cells(level))
        )

    def is_isotropic(self, level: int = 0) -> bool:
        hs = self.h(level)
        return all(abs(h - hs[0]) < 1e-12 * abs(hs[0]) for h in hs)


def cube(n_subdiv: int, left: float, right: float, n_refine: int, dim: int = 3) -> BrickMesh:
    """``GridGenerator::subdivided_hyper_cube`` + ``refine_global`` analogue
    (reference poisson_cube/program.cc:542-570)."""
    return BrickMesh(
        coarse_cells=(n_subdiv,) * dim,
        origin=(left,) * dim,
        lengths=(right - left,) * dim,
        n_levels=n_refine + 1,
    )


def poisson_cube_mesh(size: int, dim: int = 3) -> BrickMesh:
    """Mesh ladder entry of the poisson_cube program: ``size`` cells per axis,
    split into an odd coarse size and global refinements
    (reference poisson_cube/program.cc:530-545)."""
    n_refine = 0
    n_subdiv = size
    if n_subdiv > 1:
        while n_subdiv % 2 == 0:
            n_refine += 1
            n_subdiv //= 2
    if dim == 2:
        # reference refines 2-D meshes three extra times
        # (reference poisson_cube/program.cc:540-541)
        n_refine += 3
    return cube(n_subdiv, -0.9, 1.0, n_refine, dim)


def doubling_mesh(cycle: int, dim: int = 3) -> BrickMesh:
    """Doubling-mesh ladder (1x1x1 -> 2x1x1 -> 2x2x1 -> refined ...) of the
    poisson_cube program (reference poisson_cube/program.cc:509-528)."""
    n_refine = cycle // 3
    remainder = cycle % 3
    subdivisions = tuple(2 if d >= dim - remainder else 1 for d in range(dim))
    # reference doubles the *first* dims in deal.II (x fastest); in (z,y,x)
    # order the doubled axes are the trailing ones.
    lengths = tuple(
        (2.8 if d >= dim - remainder else 0.9) + 1.0 for d in range(dim)
    )
    return BrickMesh(
        coarse_cells=subdivisions,
        origin=(-1.0,) * dim,
        lengths=lengths,
        n_levels=n_refine + 1,
    )


@dataclass(frozen=True)
class DofGrid:
    """Continuous FE_Q(p) dof layout on one level of a brick mesh.

    Dofs form a dense node grid of shape ``(n_d * p + 1, ...)`` in
    lexicographic order; Dirichlet boundary = all outer faces (boundary id 0
    everywhere, reference common/multigrid_solver.h:133-136).
    """

    mesh: BrickMesh
    level: int
    degree: int

    @cached_property
    def basis(self) -> Basis1D:
        return make_basis(self.degree)

    @property
    def dim(self) -> int:
        return self.mesh.dim

    @property
    def cells(self) -> tuple[int, ...]:
        return self.mesh.cells(self.level)

    @property
    def h(self) -> tuple[float, ...]:
        return self.mesh.h(self.level)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(c * self.degree + 1 for c in self.cells)

    @property
    def n_dofs(self) -> int:
        return int(np.prod(self.shape))

    @cached_property
    def axis_nodes(self) -> list[np.ndarray]:
        """Physical node coordinates along each axis (fp64)."""
        out = []
        for d in range(self.dim):
            c = self.cells[d]
            h = self.h[d]
            cells = self.mesh.origin[d] + h * np.arange(c)[:, None]
            pts = cells + h * self.basis.nodes[None, :]
            line = np.concatenate([pts[:, :-1].reshape(-1), pts[-1:, -1]])
            out.append(line)
        return out

    @cached_property
    def axis_quads(self) -> list[np.ndarray]:
        """Physical quadrature coordinates per axis, shape (cells_d, p+1)."""
        out = []
        for d in range(self.dim):
            c = self.cells[d]
            h = self.h[d]
            cells = self.mesh.origin[d] + h * np.arange(c)[:, None]
            out.append(cells + h * self.basis.quad_points[None, :])
        return out

    def quad_coords_interleaved(self) -> list[np.ndarray]:
        """Coordinate arrays broadcastable to the interleaved cell layout
        ``[N0, nq, N1, nq, ...]`` — one array per axis."""
        dim = self.dim
        out = []
        for d in range(dim):
            q = self.axis_quads[d]
            shape = [1] * (2 * dim)
            shape[2 * d] = q.shape[0]
            shape[2 * d + 1] = q.shape[1]
            out.append(q.reshape(shape))
        return out

    def node_coords(self) -> list[np.ndarray]:
        """Coordinate arrays broadcastable to the node grid, one per axis."""
        dim = self.dim
        out = []
        for d in range(dim):
            shape = [1] * dim
            shape[d] = self.shape[d]
            out.append(self.axis_nodes[d].reshape(shape))
        return out

    def boundary_mask(self) -> np.ndarray:
        """Boolean node-grid mask, True on the Dirichlet boundary."""
        m = np.zeros(self.shape, dtype=bool)
        for d in range(self.dim):
            idx = [slice(None)] * self.dim
            idx[d] = 0
            m[tuple(idx)] = True
            idx[d] = -1
            m[tuple(idx)] = True
        return m

    @property
    def jxw_scalar(self) -> float:
        """det(J) for the affine cell map (constant over the brick)."""
        return float(np.prod(self.h))

    def box(self, ranges) -> "CellBox":
        """The cells ``ranges[a][0] .. ranges[a][1] - 1`` of each leading
        axis ``a`` (the others whole) as a grid of their own
        (:class:`CellBox`)."""
        ranges = tuple((int(c0), int(c1)) for c0, c1 in ranges)
        if not 1 <= len(ranges) <= self.dim:
            raise ValueError(f"a box over {len(ranges)} axes of a "
                             f"{self.dim}-D grid")
        for a, (c0, c1) in enumerate(ranges):
            if not 0 <= c0 < c1 <= self.cells[a]:
                raise ValueError(f"cells [{c0}, {c1}) of axis {a} outside "
                                 f"[0, {self.cells[a]})")
        return CellBox(self.mesh, self.level, self.degree, ranges)

    def z_slab(self, z0: int, z1: int) -> "CellBox":
        """Cell layers ``z0 .. z1 - 1`` of axis 0 as a grid of their own:
        the box over axis 0 alone."""
        return self.box(((z0, z1),))


@dataclass(frozen=True)
class CellBox(DofGrid):
    """The cells ``[c0, c1)`` of each leading axis (``ranges``, one pair
    an axis: z, or z and y) of one level's grid: its node planes ``c0 p ..
    c1 p`` along each.  Cell size, node and quadrature coordinates are the
    level's own, sliced and not recomputed, so every table built from a
    box (taps, diagonal lines, boundary values, rhs) holds the level's
    numbers; its Dirichlet boundary is its own outer faces.  The box keeps
    the level number, so two nested boxes of adjacent levels make a
    :class:`~..ops.transfer.Transfer`."""

    ranges: tuple[tuple[int, int], ...] = ()

    @property
    def parent(self) -> DofGrid:
        return DofGrid(self.mesh, self.level, self.degree)

    @property
    def cells(self) -> tuple[int, ...]:
        whole = self.mesh.cells(self.level)
        k = len(self.ranges)
        return tuple(c1 - c0 for c0, c1 in self.ranges) + whole[k:]

    @cached_property
    def axis_nodes(self) -> list[np.ndarray]:
        out = list(self.parent.axis_nodes)
        p = self.degree
        for a, (c0, c1) in enumerate(self.ranges):
            out[a] = out[a][c0 * p: c1 * p + 1]
        return out

    @cached_property
    def axis_quads(self) -> list[np.ndarray]:
        out = list(self.parent.axis_quads)
        for a, (c0, c1) in enumerate(self.ranges):
            out[a] = out[a][c0: c1]
        return out
