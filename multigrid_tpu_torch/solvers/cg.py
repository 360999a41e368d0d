"""Preconditioned conjugate gradients with deal.II ``SolverCG`` +
``ReductionControl`` semantics (reference common/multigrid_solver.h:483-493):
stop when |r| <= max(abs_tol, rtol |r0|), report the iteration count and
the final residual norm.

Twin of ``multigrid_tpu/solvers/cg.py:cg_solve``.  One Python loop; the
vector work goes through the CG kernels (:mod:`..ops.cg_kernel`), which
update x, r and p in place: the iteration holds five full vectors
(x, r, p, q = A p, z = M r).  The JAX package's host-stepped variants
exist for TPU memory limits and are not needed here.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..ops.cg_kernel import cg_dot, cg_update, cg_xpay


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    initial_norm: float
    final_norm: float


def cg_solve(A: Callable, b: torch.Tensor, precond: Callable,
             max_iterations: int = 1000, abs_tol: float = 1e-16,
             rtol: float = 1e-9, *,
             dot: Optional[Callable] = None) -> CGResult:
    """Solve A x = b from x = 0; ``b`` is not modified.  ``dot(a, c)``
    (a float) replaces the ``cg_dot`` of the whole vector: a rank's slab
    passes the sum over every rank's owned planes, and |r| is then its
    ``dot(r, r)``, not ``cg_update``'s fused sum of the slab."""
    total = (lambda a, c: float(cg_dot(a, c))) if dot is None else dot
    norm0 = math.sqrt(total(b, b))
    tol = max(abs_tol, rtol * norm0)
    z = precond(b)
    rz = total(b, z)
    x = torch.zeros_like(b)
    r = b.clone()
    p = z
    it = 0
    res = norm0
    while res > tol and it < max_iterations:
        q = A(p)
        alpha = rz / total(p, q)
        r2 = cg_update(x, r, p, q, alpha)
        res = math.sqrt(float(r2) if dot is None else dot(r, r))
        del q
        z = precond(r)
        rz_new = total(r, z)
        cg_xpay(p, z, rz_new / rz)
        rz = rz_new
        it += 1
    return CGResult(x=x, iterations=it, initial_norm=norm0, final_norm=res)
