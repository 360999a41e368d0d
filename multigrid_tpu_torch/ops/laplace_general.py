"""Matrix-free FE_Q Laplace operator on mapped multiblock meshes.

Twin of ``multigrid_tpu/ops/laplace_general.py`` ``GeneralLaplace``
(reference general path: common/laplace_operator.h:493-522): per-quad-point
symmetric merged coefficients ``C [cells, n, .., n, n_sym]`` (JxW and the
geometry included), an index-table gather of every cell's nodes, 1-D
sum-factorized contractions, and a scatter-add back to the nodes.  Native
float32 or float64, 2-D or 3-D.  Plain PyTorch on every device, as its JAX
twin is plain XLA; on the card the float32 contractions run in full float32
(no TF32), the precision the JAX twin asks for.

The scatter is deterministic (:class:`NodeScatter`): JAX's
``zeros().at[idx].add`` becomes a sum in a fixed order over a host-built
inverse map, so two solves on the card agree bit for bit, which
``index_add_`` (atomics on CUDA) would not promise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..devices import resolve
from ..mesh.mapped import GeneralGrid
from .laplace import apply_1d, sym_components, sym_index


class NodeScatter:
    """Sum of a flat array of contributions into node values, in a fixed
    order.

    ``table[i]`` is the node that entry ``i`` of the flat array adds to.
    The host groups the nodes by how many entries they receive (their
    valence v) and lists, per group, each node's v entry positions in
    ascending order.  A scatter is then, per group, one gather of the
    entries and a sum over v, and one gather that puts the group sums in
    node order: no atomics, so the result is the same on every run.
    ``allow_empty``: a node with no entry gets zero (else it is refused,
    as a table that misses a node is a fault of its caller)."""

    def __init__(self, table: np.ndarray, n_nodes: int, device,
                 allow_empty: bool = False):
        table = np.asarray(table, np.int64).reshape(-1)
        counts = np.bincount(table, minlength=n_nodes)
        if counts.shape[0] != n_nodes or not (allow_empty or counts.all()):
            raise ValueError("NodeScatter: every node needs an entry")
        order = np.argsort(table, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        self.n_nodes = n_nodes
        self.groups = []
        node_order = []
        for v in np.unique(counts):
            nodes = np.nonzero(counts == v)[0]
            if v == 0:      # nodes without entries: a group of zeros
                self.groups.append((0, len(nodes)))
                node_order.append(nodes)
                continue
            pos = order[starts[nodes][:, None] + np.arange(v)[None, :]]
            self.groups.append((int(v), torch.as_tensor(
                pos.reshape(-1), dtype=torch.int64, device=device)))
            node_order.append(nodes)
        where = np.empty(n_nodes, np.int64)
        where[np.concatenate(node_order)] = np.arange(n_nodes)
        self.where = torch.as_tensor(where, device=device)

    def __call__(self, flat: torch.Tensor) -> torch.Tensor:
        flat = flat.reshape(-1)
        sums = [flat.new_zeros(pos) if v == 0
                else flat.index_select(0, pos).view(-1, v).sum(1)
                for v, pos in self.groups]
        return torch.cat(sums).index_select(0, self.where)


def chebyshev_step(vmult, precond, b, x, x_old, f1: float, f2: float,
                   out=None):
    """``x + f1 (x - x_old) + f2 P^-1 (b - A x)``, the smoother interface
    of :mod:`..solvers.chebyshev` for the plain operators (``vmult`` is A,
    ``precond`` P^-1); ``x``/``x_old`` None read as zero; ``out`` receives
    the result when given."""
    r = b if x is None else b - vmult(x)
    res = f2 * precond(r)
    if x is not None:
        res += x
        if f1 != 0.0:
            res += f1 * (x if x_old is None else x - x_old)
    elif x_old is not None and f1 != 0.0:
        res -= f1 * x_old
    return res if out is None else out.copy_(res)


def grid_tables(grid: GeneralGrid, device: torch.device):
    """The device tables of one grid, built once per device and shared by
    its operators and transfers: the flat cell -> node index (int64), the
    scatter back to the nodes and the interior mask."""
    cache = grid.__dict__.setdefault("_torch_tables", {})
    if device not in cache:
        cache[device] = (
            torch.as_tensor(grid.cell_nodes.reshape(-1), dtype=torch.int64,
                            device=device),
            NodeScatter(grid.cell_nodes, grid.n_dofs, device),
            torch.as_tensor(~grid.boundary, device=device))
    return cache[device]


class GeneralLaplace:
    """A·u for -div(c grad u) with FE_Q(p) on one mapped multiblock level.

    ``coef``: the merged coefficient as :meth:`GeneralGrid.merged_coefficient`
    returns it (host f64), else built from ``coef_fn``.  ``inv_diag`` (the
    Chebyshev smoother's point Jacobi) is set by the solver."""

    def __init__(self, grid: GeneralGrid, dtype=torch.float32,
                 coef: Optional[np.ndarray] = None, coef_fn=None,
                 device="cuda"):
        self.grid = grid
        self.dtype = dtype
        self.device = device = resolve(device)
        b = grid.basis
        self.n = b.n
        self.dim = grid.dim
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        self.S, self.St = t(b.S), t(b.S.T)
        self.D, self.Dt = t(b.D_col), t(b.D_col.T)
        if coef is None:
            coef = grid.merged_coefficient(coef_fn)
        self.cell_shape = (grid.n_cells,) + (self.n,) * self.dim
        self.C = t(np.asarray(coef).reshape(self.cell_shape + (coef.shape[-1],)))
        self.jxw = t(grid.jxw.reshape(self.cell_shape))
        self.cell_nodes, self.scatter, self.interior = grid_tables(grid, device)
        self.n_dofs = grid.n_dofs
        self.shape = (grid.n_dofs,)
        self.inv_diag: Optional[torch.Tensor] = None

    # ------------------------------------------------------------- helpers
    def gather(self, u: torch.Tensor) -> torch.Tensor:
        return u.index_select(0, self.cell_nodes).view(self.cell_shape)

    def scatter_add(self, y: torch.Tensor) -> torch.Tensor:
        return self.scatter(y)

    def _eval_grads(self, w):
        uq = w
        for d in range(self.dim):
            uq = apply_1d(uq, self.S, 1 + d)
        return [apply_1d(uq, self.D, 1 + d) for d in range(self.dim)]

    def _integrate_grads(self, gq):
        acc = apply_1d(gq[0], self.Dt, 1)
        for d in range(1, self.dim):
            acc = acc + apply_1d(gq[d], self.Dt, 1 + d)
        for d in range(self.dim):
            acc = apply_1d(acc, self.St, 1 + d)
        return acc

    def _quad_op(self, g, C=None):
        """Merged coefficient times the reference gradients; ``C``
        overrides the stored coefficient (the Newton steps of
        minimal_surface pass theirs)."""
        C = self.C if C is None else C
        out = []
        for a in range(self.dim):
            t = None
            for b_ in range(self.dim):
                term = C[..., sym_index(self.dim, a, b_)] * g[b_]
                t = term if t is None else t + term
            out.append(t)
        return out

    def apply_cells(self, u: torch.Tensor, C=None) -> torch.Tensor:
        g = self._eval_grads(self.gather(u))
        return self.scatter_add(self._integrate_grads(self._quad_op(g, C)))

    # --------------------------------------------------------------- vmult
    def vmult(self, src: torch.Tensor, C=None) -> torch.Tensor:
        """A src on interior rows, src on Dirichlet rows."""
        y = self.apply_cells(torch.where(self.interior, src, 0), C)
        return torch.where(self.interior, y, src)

    def vmult_residual(self, rhs: torch.Tensor, lhs: torch.Tensor,
                       C=None) -> torch.Tensor:
        y = self.apply_cells(torch.where(self.interior, lhs, 0), C)
        return torch.where(self.interior, rhs - y, rhs - lhs)

    def cheb_step(self, b, x, x_old, f1: float, f2: float, out=None):
        """The Chebyshev step with the point-Jacobi diagonal
        (:func:`chebyshev_step`)."""
        return chebyshev_step(self.vmult, self.inv_diag.mul, b, x, x_old, f1,
                              f2, out)

    # ----------------------------------------------------------------- rhs
    def compute_rhs(self, f_quad: torch.Tensor,
                    u_bc: torch.Tensor) -> torch.Tensor:
        """b = M f - A u_bc, zero at Dirichlet rows
        (reference common/laplace_operator.h:804-845)."""
        fv = f_quad.to(self.dtype) * self.jxw
        for d in range(self.dim):
            fv = apply_1d(fv, self.St, 1 + d)
        g = self._eval_grads(self.gather(u_bc))
        b = self.scatter_add(fv - self._integrate_grads(self._quad_op(g)))
        return torch.where(self.interior, b, 0)

    # ------------------------------------------------------------ diagonal
    def inverse_diagonal(self, C=None) -> torch.Tensor:
        C = self.C if C is None else C
        b = self.grid.basis
        DS = b.D_col @ b.S
        diag = None
        for s, (a, bb) in enumerate(sym_components(self.dim)):
            term = C[..., s] * (1.0 if a == bb else 2.0)
            for e in range(self.dim):
                F = (DS if a == e else b.S) * (DS if bb == e else b.S)
                term = apply_1d(term, torch.as_tensor(
                    F.T, dtype=self.dtype, device=self.device), 1 + e)
            diag = term if diag is None else diag + term
        diag = torch.where(self.interior, self.scatter_add(diag), 1.0)
        return 1.0 / diag

    # ------------------------------------------------------------ analysis
    def interpolate_to_quad(self, u: torch.Tensor) -> torch.Tensor:
        uq = self.gather(u)
        for d in range(self.dim):
            uq = apply_1d(uq, self.S, 1 + d)
        return uq

    def l2_error(self, u: torch.Tensor,
                 exact_quad: torch.Tensor) -> torch.Tensor:
        err = torch.sum((self.interpolate_to_quad(u) - exact_quad) ** 2
                        * self.jxw)
        return torch.sqrt(err / torch.sum(self.jxw))
