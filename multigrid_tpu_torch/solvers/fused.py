"""Fused operator-update entry points (API parity with the reference).

Twin of ``multigrid_tpu/solvers/fused.py``.  The reference folds vector
updates and reductions into its operator cell loops --
``vmult_with_cg_update`` (reference common/laplace_operator.h:638-719) and
``vmult_with_chebyshev_update`` (common/laplace_operator_dg.h:863-976) --
to save memory passes on a CPU.  Here they are plain compositions over a
``vmult`` and a ``precond``, as in the JAX twin.  On the card the fused
passes that matter are kernels of their own (``dg_cheb``, ``dg_cg``,
``brick_kron``'s Chebyshev mode, ``cg_update``); these compositions are
their plain versions and serve the operators that have no kernel
(:class:`PlainLevel`).
"""

from __future__ import annotations

from typing import Callable

import torch


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def vmult_with_cg_update(vmult: Callable, alpha: float, beta: float,
                         r: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
                         x: torch.Tensor):
    """One fused CG round: the vector updates folded around ``q = A p``
    plus the four reductions the reference returns
    (laplace_operator.h:655-718): <q,p>, <r,r>, <q,r>, <q,q>.
    A float ``alpha == 0`` marks the first iteration (p taken from q); a
    tensor ``alpha`` (a device scalar, read without a host sync) never
    does, and its caller starts from p = 0 instead.  The plain version of
    the fused CG's operator pass (``ops/dg_kernel.dg_cg_plain``, solver_dg's
    fused row)."""
    first = not torch.is_tensor(alpha) and alpha == 0.0
    x = x if first else x + alpha * p
    p = q if first else beta * p + q
    q = vmult(p)
    sums = torch.stack([_dot(q, p), _dot(r, r), _dot(q, r), _dot(q, q)])
    return x, p, q, sums


def vmult_with_chebyshev_update(vmult: Callable, precond: Callable,
                                rhs: torch.Tensor, factor1: float,
                                factor2: float, x: torch.Tensor,
                                x_old: torch.Tensor):
    """Chebyshev step ``x_new = factor2 P^-1 (rhs - A x) + (1 + factor1) x
    - factor1 x_old`` (the epilogue of laplace_operator_dg.h:1839-1860);
    returns ``(x_new, x)``."""
    r = rhs - vmult(x)
    x_new = factor2 * precond(r) + (1.0 + factor1) * x - factor1 * x_old
    return x_new, x


class PlainLevel:
    """A multigrid level without a kernel of its own, as the smoother, the
    V-cycle and the CG call it (``shape``, ``dtype``, ``device``,
    ``vmult``, ``vmult_residual``, ``cheb_step``): ``op``'s own
    ``vmult`` and ``vmult_residual``, and the Chebyshev step composed by
    :func:`vmult_with_chebyshev_update` over ``op.vmult`` and ``precond``.
    Plain PyTorch on every device: the 2-D DG levels and, through
    ``VarCoeffLevel``, the variable-coefficient and curved ones
    (``solvers/multigrid_dg.py``), and the 2-D brick levels' float32
    smoothing (``solvers/multigrid.py``)."""

    def __init__(self, op, precond: Callable):
        self.op, self.precond = op, precond
        self.shape = tuple(op.grid.shape)
        self.dtype, self.device = op.dtype, op.device

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        return self.op.vmult(x)

    def vmult_residual(self, rhs: torch.Tensor, lhs: torch.Tensor):
        return self.op.vmult_residual(rhs, lhs)

    def cheb_step(self, b, x, x_old, f1: float, f2: float, out=None):
        """``x + f1 (x - x_old) + f2 P^-1 (b - A x)``; ``x``/``x_old`` None
        read as zero."""
        xo = b.new_zeros(()) if x_old is None else x_old
        if x is None:
            res = f2 * self.precond(b) - f1 * xo
        else:
            res, _ = vmult_with_chebyshev_update(self.vmult, self.precond, b,
                                                 f1, f2, x, xo)
        return res if out is None else out.copy_(res)
