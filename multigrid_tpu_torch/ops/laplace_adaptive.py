"""Laplace operator on adaptively refined (hanging-node) meshes, 2-D and 3-D.

Twin of ``multigrid_tpu/ops/laplace_adaptive.py``.  Every cell-local node
is a short (dof, weight) list (:class:`..mesh.adaptive.AdaptiveGrid`), so
the constrained operator ``C^T A_loc C`` of poisson_l (reference
poisson_l/program.cc:232-243) is

    weighted gather -> one batched element matmul -> weighted scatter,

with no per-constraint control flow.  Cells of all refinement levels share
one reference ``[N, N]`` stiffness; the physical element matrix is
``h^(dim-2) K_ref`` (scale-free in 2-D, a per-cell scalar in 3-D).

Plain PyTorch on every device, as the JAX twin is plain XLA: the matmul is
``torch.matmul`` (full float32 on the card, no TF32), and the scatter is
:class:`.laplace_general.NodeScatter`, a sum in a fixed host-built order,
so that two solves on the card agree bit for bit (``index_add_`` is atomic
on CUDA).  The exact diagonal is assembled in f64 on the host at set-up,
as in the JAX twin.  :class:`KellyEstimator` builds its face lists on the
host at set-up; its traces and jumps run on the operator's device, and the
per-cell sums on the host, into a numpy ``eta2``.
"""

from __future__ import annotations

import itertools
import numpy as np
import torch

from ..core.quadrature import lagrange_values
from ..devices import resolve
from ..mesh.adaptive import AdaptiveGrid
from .laplace import apply_1d
from .laplace_general import NodeScatter, chebyshev_step


def grid_tables(grid: AdaptiveGrid, device: torch.device):
    """The device tables of one grid, built once per device and shared by
    its operators: the flat gather index (int64), the deterministic scatter
    back to the dofs and the interior mask."""
    cache = grid.__dict__.setdefault("_torch_tables", {})
    if device not in cache:
        cache[device] = (
            torch.as_tensor(grid.gidx.reshape(-1), dtype=torch.int64,
                            device=device),
            NodeScatter(grid.gidx, grid.n_dofs, device),
            torch.as_tensor(~grid.boundary, device=device))
    return cache[device]


class AdaptiveLaplace:
    """A·u of FE_Q(p) on one adaptive mesh, hanging nodes folded into the
    gather; ``vmult`` returns ``src`` on Dirichlet rows."""

    def __init__(self, grid: AdaptiveGrid, dtype=torch.float32,
                 device="cuda"):
        self.grid = grid
        self.dtype = dtype
        self.device = dev = resolve(device)
        b = grid.basis
        n, dim = grid.n, grid.dim
        self.n, self.dim = n, dim
        N = n**dim
        self.N = N
        self.n_dofs = grid.n_dofs
        self.shape = (grid.n_dofs,)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=dev)
        # local flat order kron(A_{dim-1}, ..., A_0) (slowest local axis =
        # highest coordinate); reference-cell stiffness, scaled h^(dim-2)
        # per cell
        K = np.zeros((N, N))
        for d in range(dim):
            mat = np.array([[1.0]])
            for e in range(dim - 1, -1, -1):
                mat = np.kron(mat, b.L if e == d else b.M)
            K += mat
        self.Kref = K
        self.Kmat = t(K.T)                      # y = u_loc @ K^T
        self.S = t(b.S)
        self.D = t(b.D)
        self.gidx_flat, self.scatter_sum, self.interior = grid_tables(grid,
                                                                      dev)
        self.gw = t(grid.gw)
        self.cell_shape = (grid.n_cells, N, grid.K)
        self.cell_h = t(grid.cell_h)
        self.cell_scale = t(grid.cell_h ** (dim - 2))
        wnd = np.array([1.0])
        for _ in range(dim):
            wnd = np.kron(wnd, b.quad_weights)
        self.wnd = t(wnd)                       # [N] tensor quad weights

        # the exact diagonal of C^T A_loc C, on the host at set-up (chunked
        # over cells to bound the [chunk, N, N] temporaries)
        diag = np.zeros(grid.n_dofs)
        gi, gwt = grid.gidx, grid.gw
        scale = grid.cell_h ** (dim - 2)
        C = grid.n_cells
        chunk = max(1, 2_000_000 // (N * N))
        for c0 in range(0, C, chunk):
            c1 = min(C, c0 + chunk)
            gi_c, gw_c = gi[c0:c1], gwt[c0:c1]
            sc = scale[c0:c1, None]
            for k in range(grid.K):
                for k2 in range(grid.K):
                    same = gi_c[:, :, None, k] == gi_c[:, None, :, k2]
                    contrib = (gw_c[:, :, None, k] * gw_c[:, None, :, k2]
                               * K[None, :, :]) * same
                    np.add.at(diag, gi_c[:, :, k], contrib.sum(axis=2) * sc)
        diag[grid.boundary] = 1.0
        self.inv_diag = t(1.0 / diag)

    # ------------------------------------------------------ gather/scatter
    def gather(self, u: torch.Tensor) -> torch.Tensor:
        """``[n_dofs]`` -> ``[C, N]`` cell-local values through the
        constraints."""
        vals = u.index_select(0, self.gidx_flat).view(self.cell_shape)
        return torch.sum(vals * self.gw, dim=-1)

    def scatter(self, y: torch.Tensor) -> torch.Tensor:
        """The adjoint of :meth:`gather`: a weighted add into the dofs, in
        a fixed order."""
        return self.scatter_sum(y[:, :, None] * self.gw)

    # --------------------------------------------------------------- vmult
    def apply_cells(self, u: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(self.gather(u), self.Kmat)
        return self.scatter(y * self.cell_scale[:, None])

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        y = self.apply_cells(torch.where(self.interior, src, 0))
        return torch.where(self.interior, y, src)

    def vmult_residual(self, rhs: torch.Tensor, lhs: torch.Tensor):
        y = self.apply_cells(torch.where(self.interior, lhs, 0))
        return torch.where(self.interior, rhs - y, rhs - lhs)

    def inverse_diagonal(self) -> torch.Tensor:
        return self.inv_diag

    def precond(self, r: torch.Tensor) -> torch.Tensor:
        return self.inv_diag * r

    def cheb_step(self, b, x, x_old, f1: float, f2: float, out=None):
        """The Chebyshev step with the point-Jacobi diagonal."""
        return chebyshev_step(self.vmult, self.precond, b, x, x_old, f1, f2,
                              out)

    # ------------------------------------------------------------ rhs / L2
    def quad_points(self) -> np.ndarray:
        """Physical quadrature coordinates, ``[C, N, dim]`` (host)."""
        g = self.grid
        qp = g.basis.quad_points
        dim, n = self.dim, self.n
        corners = np.array([g.forest.cell_corner(c) for c in g.cells])
        out = np.empty((g.n_cells, self.N, dim))
        for d in range(dim):
            shape = [1] * dim
            shape[dim - 1 - d] = n
            local = np.broadcast_to(qp.reshape(shape), (n,) * dim).reshape(-1)
            out[:, :, d] = (corners[:, None, d]
                            + g.cell_h[:, None] * local[None, :])
        return out

    def _sweep(self, w, mats):
        """1-D matrix ``mats[d]`` on the local axis of coordinate d, for
        every d (``w``: ``[C, n, ..., n]``, slowest local axis = coordinate
        dim-1)."""
        for d in range(self.dim):
            w = apply_1d(w, mats[d], 1 + (self.dim - 1 - d))
        return w

    def _to_quad(self, w):
        """``[C, N]`` nodal -> values at the tensor quadrature grid
        ``[C, n, ..., n]``."""
        w = w.reshape((-1,) + (self.n,) * self.dim)
        return self._sweep(w, [self.S] * self.dim)

    def _from_quad_t(self, w):
        w = self._sweep(w, [self.S.T] * self.dim)
        return w.reshape(-1, self.N)

    def jxw(self) -> torch.Tensor:
        """``[C, N]`` quadrature weight times the cell volume."""
        return self.wnd[None, :] * (self.cell_h[:, None] ** self.dim)

    def compute_rhs(self, f_quad: torch.Tensor,
                    u_bc: torch.Tensor) -> torch.Tensor:
        """b = M f - A u_bc, zero on Dirichlet rows.  ``f_quad``: ``[C, N]``
        values at the quadrature points; ``u_bc``: the boundary values as a
        dof vector."""
        fv = self._from_quad_t((f_quad.to(self.dtype) * self.jxw())
                               .reshape((-1,) + (self.n,) * self.dim))
        au = torch.matmul(self.gather(u_bc.to(self.dtype)), self.Kmat)
        au = au * self.cell_scale[:, None]
        b = self.scatter(fv - au)
        return torch.where(self.interior, b, 0)

    def l2_error(self, u: torch.Tensor,
                 exact_quad: torch.Tensor) -> torch.Tensor:
        uq = self._to_quad(self.gather(u)).reshape(-1, self.N)
        jxw = self.jxw()
        err = torch.sum((uq - exact_quad) ** 2 * jxw)
        vol = torch.sum(torch.broadcast_to(jxw, uq.shape))
        return torch.sqrt(err / vol)

    def gradients_quad(self, u: torch.Tensor):
        """Physical gradients at the quadrature grid, ``dim`` arrays
        ``[C, n, ..., n]``."""
        w = self.gather(u).reshape((-1,) + (self.n,) * self.dim)
        h = self.cell_h.reshape((-1,) + (1,) * self.dim)
        return [self._sweep(w, [self.D if e == d else self.S
                                for e in range(self.dim)]) / h
                for d in range(self.dim)]

    def h1_seminorm_error(self, u: torch.Tensor, grad_exact_quad):
        g = self.gradients_quad(u)
        jxw = self.jxw().reshape((-1,) + (self.n,) * self.dim)
        err = 0.0
        for d in range(self.dim):
            ex = torch.as_tensor(np.asarray(grad_exact_quad[d]),
                                 dtype=self.dtype, device=self.device)
            err = err + torch.sum((g[d] - ex) ** 2 * jxw)
        return torch.sqrt(err)


class KellyEstimator:
    """Face-jump indicator ``eta_K^2 = sum_{F in dK} h_F/24 int_F
    [du/dn]^2`` over the forest, 2:1 coarse|fine faces included (the role
    of KellyErrorEstimator, reference poisson_l/program.cc:527-533); 2-D
    line faces and 3-D square faces, a coarse face split into its child
    quadrants."""

    def __init__(self, op: AdaptiveLaplace):
        self.op = op
        g = op.grid
        b = g.basis
        dim = op.dim
        self.dim = dim
        dev = op.device
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                      dtype=op.dtype, device=dev)
        qp = b.quad_points
        self.f0 = t(lagrange_values(qp, np.array([0.0]))[0])
        self.f1 = t(lagrange_values(qp, np.array([1.0]))[0])
        # interpolation of a coarse-face trace (quadrature-point basis) to
        # the quadrature points of child half s along one tangential axis
        self.H = [t(lagrange_values(qp, (s + qp) / 2.0)) for s in (0, 1)]
        wf = np.array([1.0])
        for _ in range(dim - 1):
            wf = np.kron(wf, b.quad_weights)
        self.wf = t(wf)                          # face weights [n^(dim-1)]

        # face lists (host, set-up only): same-level faces from the lower
        # side; coarse|fine pairs from the fine side with the fine cell's
        # quadrant per tangential axis (high coordinate first, the local
        # trace layout)
        same, cf = [], []
        for ci, c in enumerate(g.cells):
            for d in range(dim):
                tang = [e for e in range(dim - 1, -1, -1) if e != d]
                kind, nb = g.forest.find_active_neighbor(c, d, 1)
                if kind == "same":
                    same.append((ci, g.cell_index[nb], d))
                for side in (0, 1):
                    k2, nb2 = g.forest.find_active_neighbor(c, d, side)
                    if k2 == "coarse":
                        halves = [c.coords[e] % 2 for e in tang]
                        cf.append((ci, g.cell_index[nb2], d, side, *halves))
        self.same = np.asarray(same, np.int32).reshape(-1, 3)
        self.cf = np.asarray(cf, np.int32).reshape(-1, 3 + dim)
        # per direction, the device index lists of each face group
        ix = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
        self._same, self._cf = [], []
        for d in range(dim):
            m = self.same[self.same[:, 2] == d]
            self._same.append((m, ix(m[:, 0]), ix(m[:, 1])))
            groups = []
            m = self.cf[self.cf[:, 2] == d]
            for s_fine in (0, 1):
                for halves in itertools.product((0, 1), repeat=dim - 1):
                    sel = m[:, 3] == s_fine
                    for a_i, hv in enumerate(halves):
                        sel &= m[:, 4 + a_i] == hv
                    mm = m[sel]
                    if mm.size:
                        groups.append((s_fine, halves, mm, ix(mm[:, 0]),
                                       ix(mm[:, 1])))
            self._cf.append(groups)

    def _trace(self, a, d, side):
        """Trace of ``[C, n, ..., n]`` on the face of normal d:
        ``[C, n^(dim-1)]``, tangential axes in local (slow-to-fast) order."""
        f = self.f1 if side else self.f0
        tr = torch.tensordot(a, f, dims=([1 + (self.dim - 1 - d)], [0]))
        return tr.reshape(tr.shape[0], -1)

    def _face_integral(self, jmp):
        return torch.sum(jmp**2 * self.wf, dim=1).cpu().numpy()

    def __call__(self, u) -> np.ndarray:
        op = self.op
        g = op.grid
        n, dim = op.n, self.dim
        gq = op.gradients_quad(u)
        eta2 = np.zeros(g.n_cells)
        h_cell = np.asarray(g.cell_h)
        # face measure h^(dim-1); deal.II's weight h_F/24 multiplies it
        fpow = dim - 1
        for d in range(dim):
            tr = [self._trace(gq[d], d, s) for s in (0, 1)]
            m, i0, i1 = self._same[d]
            if m.size:
                jmp = tr[1][i0] - tr[0][i1]
                h = h_cell[m[:, 0]]
                contrib = h / 24.0 * (self._face_integral(jmp) * h**fpow)
                np.add.at(eta2, m[:, 0], contrib)
                np.add.at(eta2, m[:, 1], contrib)
            for s_fine, halves, mm, fi, ci in self._cf[d]:
                fine_tr = tr[s_fine][fi]
                # the coarse trace at the fine quadrature points: one H per
                # tangential axis, slow to fast
                ct = tr[1 - s_fine][ci].reshape((-1,) + (n,) * (dim - 1))
                for a_i, hv in enumerate(halves):
                    ct = apply_1d(ct, self.H[hv], 1 + a_i)
                jmp = fine_tr - ct.reshape(ct.shape[0], -1)
                h = h_cell[mm[:, 0]]
                contrib = h / 24.0 * (self._face_integral(jmp) * h**fpow)
                np.add.at(eta2, mm[:, 0], contrib)
                np.add.at(eta2, mm[:, 1], contrib)
        return eta2
