"""Curved multiblock domains (shell, ball, deformed cube).

Twin of ``multigrid_tpu/mesh/shapes.py`` (numpy only).  Replaces
``GridGenerator::hyper_shell`` / ``hyper_ball`` with their manifolds
(reference poisson_shell/program.cc:426-431, minimal_surface/program.cc)
and the reference's ``MyManifold`` deformed cube
(poisson_cube/program.cc:405-484).  The shell is a 6-block cubed sphere
(the 6-cell deal.II coarse shell) or a 12-block rhombic dodecahedron
projected to the sphere (the 12-cell one); radii are exact spheres at
every radial coordinate.
"""

from __future__ import annotations

import numpy as np

from .mapped import Block, MappedMesh


def _face_param(k: int, sign: float, dim: int = 3):
    """Mapping factory for the cubed-sphere face (axis k, sign)."""

    def mapping_factory(r_in, r_out):
        def mapping(p):
            # p[..., 0] = radial s, remaining = face params in [0, 1]
            s = p[:, 0]
            uv = 2.0 * p[:, 1:] - 1.0
            cube = np.empty((p.shape[0], dim), dtype=p.dtype)
            rest = [d for d in range(dim) if d != k]
            cube[:, k] = sign
            for j, d in enumerate(rest):
                cube[:, d] = uv[:, j]
            norm = np.sqrt((cube * cube).sum(axis=1))
            r = r_in + s * (r_out - r_in)
            return cube * (r / norm)[:, None]

        return mapping

    return mapping_factory


def hyper_shell(r_in: float = 0.5, r_out: float = 1.0, n_levels: int = 1,
                coarse_radial: int = 1, coarse_tangential: int = 1) -> MappedMesh:
    """6-block spherical shell (cubed sphere x radial extrusion)."""
    blocks = []
    for k in range(3):
        for sign in (-1.0, 1.0):
            mapping = _face_param(k, sign)(r_in, r_out)
            blocks.append(
                Block(cells=(coarse_radial, coarse_tangential, coarse_tangential),
                      mapping=mapping)
            )

    tol = 1e-6 * r_out

    def boundary_fn(x):
        r = np.sqrt((x * x).sum(axis=1))
        return (np.abs(r - r_in) < tol) | (np.abs(r - r_out) < tol)

    return MappedMesh(blocks=blocks, n_levels=n_levels, boundary_fn=boundary_fn)


def hyper_shell_12(r_in: float = 0.5, r_out: float = 1.0, n_levels: int = 1,
                   coarse_radial: int = 1, coarse_tangential: int = 1) -> MappedMesh:
    """12-block spherical shell: rhombic-dodecahedron faces projected to the
    sphere (the deal.II 12-cell coarse shell,
    reference poisson_shell/program.cc:429)."""
    cube_v = {tuple(s): np.array(s) / np.sqrt(3.0)
              for s in [(sx, sy, sz) for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)]}
    octa_v = []
    for k in range(3):
        for sgn in (-1, 1):
            v = np.zeros(3)
            v[k] = sgn
            octa_v.append(v)

    blocks = []
    # one rhombic face per cube edge: its two cube corners + the two
    # face-center (octahedron) vertices adjacent to that edge
    for k in range(3):            # edge direction
        a, b = (k + 1) % 3, (k + 2) % 3
        for sa in (-1, 1):
            for sb in (-1, 1):
                e1 = np.zeros(3)
                e2 = np.zeros(3)
                lo = np.zeros(3)
                hi = np.zeros(3)
                lo[a], lo[b], lo[k] = sa, sb, -1
                hi[a], hi[b], hi[k] = sa, sb, 1
                c1 = cube_v[tuple(int(x) for x in lo)]
                c2 = cube_v[tuple(int(x) for x in hi)]
                o1 = np.zeros(3)
                o1[a] = sa
                o2 = np.zeros(3)
                o2[b] = sb

                def make_mapping(c1, c2, o1, o2):
                    def mapping(p):
                        s = p[:, 0]
                        u = p[:, 1]
                        v = p[:, 2]
                        q = (
                            np.multiply.outer((1 - u) * (1 - v), c1)
                            + np.multiply.outer(u * (1 - v), o1)
                            + np.multiply.outer((1 - u) * v, o2)
                            + np.multiply.outer(u * v, c2)
                        )
                        norm = np.sqrt((q * q).sum(axis=1))
                        r = r_in + s * (r_out - r_in)
                        return q * (r / norm)[:, None]

                    return mapping

                blocks.append(Block(
                    cells=(coarse_radial, coarse_tangential, coarse_tangential),
                    mapping=make_mapping(c1, c2, o1, o2),
                ))

    tol = 1e-6 * r_out

    def boundary_fn(x):
        r = np.sqrt((x * x).sum(axis=1))
        return (np.abs(r - r_in) < tol) | (np.abs(r - r_out) < tol)

    return MappedMesh(blocks=blocks, n_levels=n_levels, boundary_fn=boundary_fn)


def hyper_ball_2d(radius: float = 1.0, n_levels: int = 1) -> MappedMesh:
    """5-block disc: central square + 4 transfinite ring blocks (the 2-D
    ``hyper_ball`` layout used by minimal_surface)."""
    R = radius
    a = R * 0.5  # half-width of the central square (matches deal.II ratio ~)

    def center(p):
        return np.stack(
            [a * (2 * p[:, 0] - 1), a * (2 * p[:, 1] - 1)], axis=1
        )

    def ring_factory(quadrant):
        # quadrant 0..3: +x, +y, -x, -y; param: t along the edge, s radial
        phi0 = quadrant * np.pi / 2 - np.pi / 4

        def mapping(p):
            s = p[:, 0]  # 0 = inner square edge, 1 = circle
            t = p[:, 1]
            phi = phi0 + t * (np.pi / 2)
            outer = np.stack([R * np.cos(phi), R * np.sin(phi)], axis=1)
            # inner square edge from corner(phi0) to corner(phi0 + pi/2)
            c0 = np.array([np.cos(phi0), np.sin(phi0)]) * a * np.sqrt(2)
            c1 = np.array(
                [np.cos(phi0 + np.pi / 2), np.sin(phi0 + np.pi / 2)]
            ) * a * np.sqrt(2)
            inner = c0[None, :] * (1 - t)[:, None] + c1[None, :] * t[:, None]
            return inner * (1 - s)[:, None] + outer * s[:, None]

        return mapping

    blocks = [Block(cells=(1, 1), mapping=center, complex_step_ok=True)]
    for q in range(4):
        blocks.append(Block(cells=(1, 1), mapping=ring_factory(q)))

    tol = 1e-6 * R

    def boundary_fn(x):
        r = np.sqrt((x * x).sum(axis=1))
        return np.abs(r - R) < tol

    return MappedMesh(blocks=blocks, n_levels=n_levels, boundary_fn=boundary_fn)


def deformed_cube(size: int = 1, n_levels: int = 1, a: float = -0.9,
                  b: float = 1.0, factor: float = 0.01,
                  dim: int = 3) -> MappedMesh:
    """Sinusoidally deformed cube: the reference ``MyManifold`` chart
    ``F(x) = x + factor * prod_d sin(pi x_d) * (1,..,1)`` applied to
    ``[a, b]^dim`` (reference poisson_cube/program.cc:405-484,
    factor 0.01).  One block of ``size^dim`` coarse cells; the boundary
    test Newton-inverts the chart exactly as the reference's ``pull_back``
    (:433-481)."""
    L = b - a

    def chart(x):
        s = factor
        for d in range(dim):
            s = s * np.sin(np.pi * x[:, d])
        return x + s[:, None]

    def mapping(p):
        return chart(a + L * p)

    def pull_back(y, its: int = 50, tol: float = 1e-12):
        x = np.array(y, np.float64, copy=True)
        for _ in range(its):
            sv = np.sin(np.pi * x)                     # [N, dim]
            s = factor * np.prod(sv, axis=1)           # [N]
            res = y - x - s[:, None]
            if np.abs(res).max() < tol:
                break
            # J[e, d] = delta_ed + d s / d x_d  (rank-one column update)
            J = np.broadcast_to(np.eye(dim), (x.shape[0], dim, dim)).copy()
            for d in range(dim):
                der = factor * np.pi * np.cos(np.pi * x[:, d])
                for e in range(dim):
                    if e != d:
                        der = der * sv[:, e]
                J[:, :, d] += der[:, None]
            x = x + np.linalg.solve(J, res[:, :, None])[:, :, 0]
        return x

    def boundary_fn(xphys):
        x = pull_back(np.asarray(xphys, np.float64))
        tol = 1e-9 * max(abs(a), abs(b), 1.0)
        on = np.zeros(x.shape[0], bool)
        for d in range(dim):
            on |= (np.abs(x[:, d] - a) < tol) | (np.abs(x[:, d] - b) < tol)
        return on

    blocks = [Block(cells=(size,) * dim, mapping=mapping)]
    return MappedMesh(blocks=blocks, n_levels=n_levels,
                      boundary_fn=boundary_fn)
