"""Mapped multiblock meshes: the general-geometry path.

Twin of ``multigrid_tpu/mesh/mapped.py`` (host numpy, as
:mod:`.brick` is).  A domain is a union of logically structured blocks,
each the image of [0,1]^dim under a smooth mapping (the reference's
curved deal.II grids: ``hyper_shell`` with a spherical manifold,
poisson_shell/program.cc:426-431, and ``hyper_ball`` for
minimal_surface).  Continuity across block interfaces comes from
coordinate-based node identification (:func:`.native.unique_nodes`).
Per-level data are flat index tables built once at set-up.

Jacobians are taken by complex-step differentiation of the mapping
(exact to machine precision for analytic maps), or by central differences
for a block that cannot take complex input.

The JAX package's block-padded layout (``BlockLayout``,
``GeneralGrid.block_layout``) exists because its TPU operators are
scatter-bound; the port does not carry it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..core.basis import make_basis
from ..ops.laplace import sym_components
from . import native

@dataclass
class Block:
    cells: tuple[int, ...]
    mapping: Callable[[np.ndarray], np.ndarray]  # [N, dim] in [0,1]^dim -> [N, dim]
    complex_step_ok: bool = True


@dataclass
class MappedMesh:
    blocks: list[Block]
    n_levels: int
    boundary_fn: Callable[[np.ndarray], np.ndarray]  # phys [N, dim] -> bool [N]

    @property
    def dim(self) -> int:
        return len(self.blocks[0].cells)

    @property
    def max_level(self) -> int:
        return self.n_levels - 1


def _map_jacobian(block: Block, params: np.ndarray) -> np.ndarray:
    """d(mapping)/d(param) at params [N, dim] -> [N, dim, dim] (row = phys)."""
    dim = params.shape[1]
    out = np.zeros(params.shape + (dim,))
    if block.complex_step_ok:
        h = 1e-30
        for d in range(dim):
            p = params.astype(complex)
            p[:, d] += 1j * h
            out[:, :, d] = np.imag(block.mapping(p)) / h
    else:
        h = 1e-6
        for d in range(dim):
            pp = params.copy()
            pm = params.copy()
            pp[:, d] += h
            pm[:, d] -= h
            out[:, :, d] = (block.mapping(pp) - block.mapping(pm)) / (2 * h)
    return out


class GeneralGrid:
    """One multigrid level of FE_Q(p) dofs on a mapped multiblock mesh."""

    def __init__(self, mesh: MappedMesh, level: int, degree: int):
        self.mesh = mesh
        self.level = level
        self.degree = degree
        self.dim = dim = mesh.dim
        self.basis = b = make_basis(degree)
        self.n = degree + 1

        # every block's node lattice, mapped; shared nodes identified by
        # their coordinates
        all_coords = []
        offsets = [0]
        self.block_cells = []
        for blk in mesh.blocks:
            cells = tuple(c * (1 << level) for c in blk.cells)
            self.block_cells.append(cells)
            lines = []
            for d in range(dim):
                h = 1.0 / cells[d]
                pts = (np.arange(cells[d])[:, None] + b.nodes[None, :]) * h
                lines.append(np.concatenate([pts[:, :-1].reshape(-1),
                                             pts[-1:, -1]]))
            grids = np.meshgrid(*lines, indexing="ij")
            params = np.stack([g.reshape(-1) for g in grids], axis=1)
            all_coords.append(blk.mapping(params))
            offsets.append(offsets[-1] + params.shape[0])
        coords = np.concatenate(all_coords, axis=0)
        scale = np.abs(coords).max() + 1.0
        self.n_dofs, inverse = native.unique_nodes(coords, 1e-9 * scale)
        node_coords = np.zeros((self.n_dofs, dim))
        node_coords[inverse] = coords
        self.node_coords = node_coords
        self.boundary = mesh.boundary_fn(node_coords)

        # per-cell global node lists (lexicographic local numbering)
        cn = [inverse[offsets[bi] + native.block_cell_nodes(cells, degree)]
              for bi, cells in enumerate(self.block_cells)]
        self.cell_nodes = np.concatenate(cn, axis=0).astype(np.int32)
        self.n_cells = self.cell_nodes.shape[0]

        # quadrature geometry
        qmg = np.meshgrid(*[b.quad_points] * dim, indexing="ij")
        qref = np.stack([g.reshape(-1) for g in qmg], axis=1)  # [nq^dim, dim]
        qs, js = [], []
        for blk, cells in zip(mesh.blocks, self.block_cells):
            mg = np.meshgrid(*[np.arange(c) for c in cells], indexing="ij")
            cidx = np.stack([g.reshape(-1) for g in mg], axis=1)  # [C, dim]
            h = 1.0 / np.asarray(cells)
            params = (cidx[:, None, :] + qref[None, :, :]) * h[None, None, :]
            flat = params.reshape(-1, dim)
            qs.append(blk.mapping(flat).reshape(params.shape))
            jac = _map_jacobian(blk, flat) * h[None, :]  # chain rule cell->block
            js.append(jac.reshape(params.shape + (dim,)))
        self.quad_coords = np.concatenate(qs, axis=0)   # [C, nq^dim, dim]
        self.jacobians = np.concatenate(js, axis=0)     # [C, nq^dim, dim, dim]
        self.detJ = np.abs(np.linalg.det(self.jacobians))
        w = np.array([1.0])
        for _ in range(dim):
            w = np.kron(w, b.quad_weights)
        self.jxw = self.detJ * w[None, :]               # [C, nq^dim]

    def child_cells(self) -> np.ndarray:
        """For the next-finer level: fine cell ids per (coarse cell, child),
        children ordered lexicographically by per-axis offset."""
        out = []
        off = 0
        for cells in self.block_cells:
            fine_cells = tuple(2 * c for c in cells)
            mg = np.meshgrid(*[np.arange(c) for c in cells], indexing="ij")
            cidx = np.stack([g.reshape(-1) for g in mg], axis=1)
            rows = [np.ravel_multi_index((2 * cidx + np.asarray(s)[None, :]).T,
                                         fine_cells)
                    for s in np.ndindex(*(2,) * self.dim)]
            out.append(np.stack(rows, axis=1) + off)
            off += int(np.prod(fine_cells))
        return np.concatenate(out, axis=0)

    def merged_coefficient(self, coef_fn=None) -> np.ndarray:
        """Per-quad-point symmetric tensor including JxW,
        ``c w detJ J^{-1} J^{-T}`` (reference
        common/laplace_operator.h:388-429): ``[C, nq^dim, n_sym]`` f64."""
        Jinv = np.linalg.inv(self.jacobians)
        G = np.einsum("cqab,cqdb->cqad", Jinv, Jinv)  # J^{-1} J^{-T}
        c = 1.0
        if coef_fn is not None:
            c = coef_fn([self.quad_coords[..., d] for d in range(self.dim)])
        C = G * (self.jxw * c)[..., None, None]
        return np.stack([C[..., a, b] for (a, b) in sym_components(self.dim)],
                        axis=-1)
