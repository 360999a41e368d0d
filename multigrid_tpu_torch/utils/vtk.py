"""Solution output as VTK rectilinear grids (.vtr).

Twin of ``multigrid_tpu/utils/vtk.py`` (the port's own copy: pure numpy,
and the files are byte for byte the JAX module's for the same arrays).
Counterpart of the reference's size-guarded VTU dumps
(reference poisson_cube/program.cc:325-341,
poisson_l/program.cc:420-458): structured brick solutions write as
RectilinearGrid XML (ParaView/VisIt-readable) with per-axis coordinate
vectors — no unstructured connectivity needed on tensor-product node
grids.  ASCII by default (debug sizes); base64-appended rawbinary above
``ascii_max`` points.  Same default size guard as the reference
(program.cc:327: no output beyond ~1e5 dofs unless forced).
"""

from __future__ import annotations

import base64
import struct

import numpy as np

SIZE_GUARD = 100_000


def write_vtr(path: str, axis_nodes, fields: dict, force: bool = False,
              ascii_max: int = 32_768) -> bool:
    """Write point fields on a rectilinear grid.

    ``axis_nodes``: per-axis 1-D coordinate vectors, z-major order
    ([Z, Y, X] grids pass [z, y, x]); 2-D grids are extruded flat.
    ``fields``: name -> array of shape [Z, Y, X] (or [Y, X] in 2-D).
    Returns False (and writes nothing) when the size guard trips.
    """
    axes = [np.asarray(a).reshape(-1) for a in axis_nodes]
    if len(axes) == 2:
        axes = [np.zeros(1)] + axes
    nz, ny, nx = (a.size for a in axes)
    n_pts = nz * ny * nx
    if n_pts > SIZE_GUARD and not force:
        return False
    ascii_mode = n_pts <= ascii_max

    def coord_block(name, a):
        if ascii_mode:
            body = " ".join(f"{v:.16g}" for v in a)
            return (f'<DataArray type="Float64" Name="{name}" '
                    f'format="ascii">{body}</DataArray>')
        raw = np.asarray(a, "<f8").tobytes()
        payload = base64.b64encode(
            struct.pack("<Q", len(raw)) + raw).decode()
        return (f'<DataArray type="Float64" Name="{name}" '
                f'format="binary">{payload}</DataArray>')

    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="RectilinearGrid" version="1.0" '
        'byte_order="LittleEndian" header_type="UInt64">',
        f'<RectilinearGrid WholeExtent="0 {nx - 1} 0 {ny - 1} 0 {nz - 1}">',
        f'<Piece Extent="0 {nx - 1} 0 {ny - 1} 0 {nz - 1}">',
        "<Coordinates>",
        coord_block("x", axes[2]),
        coord_block("y", axes[1]),
        coord_block("z", axes[0]),
        "</Coordinates>",
        "<PointData>",
    ]
    for name, f in fields.items():
        a = np.asarray(f, np.float64)
        if a.ndim == 2:
            a = a[None]
        assert a.shape == (nz, ny, nx), (a.shape, (nz, ny, nx))
        # VTK point order is x-fastest — our [Z, Y, X] layout already is
        lines.append(coord_block(name, a.reshape(-1)))
    lines += ["</PointData>", "</Piece>", "</RectilinearGrid>", "</VTKFile>"]
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
    return True


def write_solution(path: str, grid, solution, exact_fn=None,
                   force: bool = False) -> bool:
    """Dump a DofGrid solution (+ optional pointwise error vs the analytic
    solution) — the reference's ``output_results`` analogue.  ``solution``
    is a host array: a card tensor is copied over first
    (``.cpu().numpy()``)."""
    coords = grid.node_coords()
    fields = {"solution": np.asarray(solution)}
    if exact_fn is not None:
        exact = np.broadcast_to(np.asarray(exact_fn(coords), np.float64),
                                grid.shape)
        fields["error"] = np.asarray(solution) - exact
    return write_vtr(path, [grid.axis_nodes[d] for d in range(grid.dim)],
                     fields, force=force)
