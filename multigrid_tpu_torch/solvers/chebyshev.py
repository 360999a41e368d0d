"""Chebyshev smoother with CG-Lanczos eigenvalue estimation.

Twin of ``multigrid_tpu/solvers/chebyshev.py`` (first kind), with deal.II
``PreconditionChebyshev`` semantics (reference
common/multigrid_solver.h:268-291):

* eigenvalues from ``eig_cg_n_iterations`` steps of diagonal-preconditioned
  CG, reading the Lanczos tridiagonal off the CG coefficients, from the
  deterministic ``i % 11 - mean`` start vector;
* the Lanczos top Ritz value is boosted by 1.2 FIRST and both interval ends
  derive from it, so the interval ratio equals ``smoothing_range``
  (smoothing, range > 1), or ``[min(0.9 max, min_est), 1.2 max]`` with an
  automatic degree (Chebyshev as coarse solver, range 1e-3);
* ``degree = n_pre`` literally: ``vmult`` makes ``degree + 1`` diagonal
  scalings and ``degree`` operator applications.

The smoother takes either kind of level operator through one method,
``op.cheb_step(b, x, x_old, f1, f2, out)`` = ``x + f1 (x - x_old) +
f2 P^-1 (b - A x)`` (``x``/``x_old`` None read as zero):

* :class:`~..ops.laplace_kernel.BrickLaplace` (FE_Q V-cycle): one
  ``brick_apply`` and one ``cheb_epilogue``, P the point Jacobi diagonal
  (a node's A x is complete only after all its cells, so the two cannot
  fuse);
* :class:`~..ops.dg_kernel.DGOperator` (DG smoother): one ``dg_cheb``
  kernel, A x and the transformed-Jacobi P fused into the pass.

The update writes into the dead ``x_old`` buffer (in place, one vector
saved per step).  The Lanczos estimate takes the preconditioner as a
callable (``precond``: the brick's ``inv_diag.mul``, the DG smoother's
``JacobiTransformed.vmult``).  The fourth kind is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def eig_estimate_start_vector(shape, dtype, device=None) -> torch.Tensor:
    """deal.II's deterministic start vector: global index mod 11, minus the
    exact mean."""
    n = int(np.prod(shape))
    q, r = divmod(n, 11)
    mean = (q * 55.0 + r * (r - 1) / 2.0) / n
    i = torch.arange(n, device=device)
    v = (i % 11).to(dtype) - torch.tensor(mean, dtype=dtype, device=device)
    return v.reshape(shape)


def lanczos_host_stepped(vmult: Callable, precond: Callable,
                         n_iterations: int, rhs: torch.Tensor):
    """CG-Lanczos, one Python step per iteration; returns the CG
    coefficient streams (alphas, betas).  Stops where the JAX twin's
    validity mask first goes false (CG converged to rounding level:
    ``rz <= (100 eps)^2 rz0``, or a non-positive ``p.q`` / ``r.z``)."""
    z0 = precond(rhs)
    rz = _dot(rhs, z0)
    eps = torch.finfo(rhs.dtype).eps
    floor = float((100.0 * eps) ** 2 * rz)
    r, p = rhs, z0
    alphas, betas = [], []
    for _ in range(n_iterations):
        q = vmult(p)
        pq = _dot(p, q)
        if not (float(pq) > 0 and float(rz) > floor):
            break
        alpha = rz / pq
        r = r - alpha * q
        z = precond(r)
        rz2 = _dot(r, z)
        beta = rz2 / rz
        p = z + beta * p
        alphas.append(float(alpha))
        betas.append(float(beta))
        rz = rz2
        if not float(rz2) > 0:
            break
    return alphas, betas


def tridiag_extremes(alphas, betas) -> tuple[float, float]:
    """Lanczos tridiagonal off the CG coefficients -> extreme Ritz values."""
    k = len(alphas)
    if not k:
        return 1.0, 1.0
    diag = np.array([
        1.0 / alphas[i] + (betas[i - 1] / alphas[i - 1] if i > 0 else 0.0)
        for i in range(k)
    ])
    off = np.array([np.sqrt(betas[i]) / alphas[i] for i in range(k - 1)])
    from scipy.linalg import eigvalsh_tridiagonal

    eigs = eigvalsh_tridiagonal(diag, off)
    return float(eigs[-1]), float(eigs[0])


def estimate_eigenvalues(vmult: Callable, precond: Callable,
                         n_iterations: int, rhs: torch.Tensor):
    """Largest/smallest eigenvalue estimate of P^{-1} A by CG-Lanczos."""
    return tridiag_extremes(*lanczos_host_stepped(vmult, precond,
                                                  n_iterations, rhs))


def interval_from_spectrum(max_eig: float, min_eig: float,
                           smoothing_range: float, degree: Optional[int]):
    """deal.II interval + degree conventions; returns (theta, delta, n_apps)
    with n_apps = degree + 1 preconditioner applications (first kind)."""
    max_est = 1.2 * max_eig
    if smoothing_range > 1.0:
        alpha_lb = max_est / smoothing_range
    else:
        alpha_lb = min(0.9 * max_est, min_eig)
    if degree is None:
        actual_range = max_est / alpha_lb if alpha_lb > 0 else 1e4
        sigma = (1.0 - np.sqrt(1.0 / actual_range)) / (
            1.0 + np.sqrt(1.0 / actual_range))
        eps = smoothing_range
        degree = int(1 + np.log(1.0 / eps + np.sqrt(1.0 / eps / eps - 1.0))
                     / np.log(1.0 / sigma))
    n_apps = int(degree) + 1
    theta = 0.5 * (max_est + alpha_lb)
    delta = 0.5 * (max_est - alpha_lb)
    return float(theta), float(delta), n_apps


@dataclass
class Chebyshev:
    """First-kind Chebyshev smoother bound to one level's operator (a
    ``BrickLaplace`` or a ``DGOperator``: ``vmult`` and ``cheb_step``)."""

    op: object
    theta: float
    delta: float
    degree: int
    max_eig: float
    min_eig: float

    @staticmethod
    def create(op, precond: Callable, smoothing_range: float,
               degree: Optional[int],
               eig_cg_n_iterations: int) -> "Chebyshev":
        """Estimate the spectrum of ``P^-1 A`` and fix the interval and
        degree; ``P^-1 r`` is ``precond(r)``."""
        rhs0 = eig_estimate_start_vector(op.shape, op.dtype, op.device)
        max_eig, min_eig = estimate_eigenvalues(
            op.vmult, precond, eig_cg_n_iterations, rhs0)
        theta, delta, n_apps = interval_from_spectrum(
            max_eig, min_eig, smoothing_range, degree)
        return Chebyshev(op, theta, delta, n_apps, max_eig, min_eig)

    def _loop(self, x, x_old, b, x_old_owned: bool):
        th, de = self.theta, self.delta
        rho = de / th
        for _ in range(self.degree - 1):
            rho_new = 1.0 / (2.0 * th / de - rho)
            f1 = rho_new * rho
            f2 = 2.0 * rho_new / de
            out = x_old if x_old_owned else None
            x, x_old = self.op.cheb_step(b, x, x_old, f1, f2, out=out), x
            x_old_owned = True
            rho = rho_new
        return x

    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        """dst = Cheb(A, P) b with zero initial guess."""
        x = self.op.cheb_step(b, None, None, 0.0, 1.0 / self.theta)
        return self._loop(x, None, b, x_old_owned=False)

    def step(self, x0: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """One smoothing pass starting from ``x0`` (deal.II ``step``);
        ``x0`` is not modified."""
        x = self.op.cheb_step(b, x0, None, 0.0, 1.0 / self.theta)
        return self._loop(x, x0, b, x_old_owned=False)
