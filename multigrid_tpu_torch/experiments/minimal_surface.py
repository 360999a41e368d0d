"""minimal_surface experiment: Newton's method for the nonlinear
minimal-surface equation -div(grad u / sqrt(1 + |grad u|^2)) = 0.

Twin of ``experiments/minimal_surface.py`` (the reference program
minimal_surface/program.cc): the 2-D unit disc (``hyper_ball_2d``),
boundary data sin(2 pi (x+y)), FE_Q(4); per Newton step the linearized
coefficient ``(I - w w^T/(1+|w|^2)) / sqrt(1+|w|^2)`` merged with the
geometry on every level (program.cc:102-165), the solution restricted to
the levels by evaluation at the coarse nodes (program.cc:416-457), CG to
rtol 1e-4 preconditioned by the V-cycle, and a halving line search
(program.cc:552-567); outer loop to |r| < 1e-12.  Run as

    python -m multigrid_tpu_torch.experiments.minimal_surface --levels 3

on the card; ``--device cpu`` runs the plain PyTorch path on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..devices import driver_device, resolve
from ..ops.laplace import sym_components
from ..mesh.shapes import hyper_ball_2d
from ..solvers.multigrid_general import GeneralMultigridSolver


def g_fn(coords):
    return np.sin(2 * np.pi * (coords[0] + coords[1]))


def zero_fn(coords):
    return 0.0 * coords[0]


class MinimalSurfaceNewton:
    def __init__(self, n_levels=3, degree=4, device="cuda"):
        self.device = dev = resolve(device)
        self.solver = s = GeneralMultigridSolver(
            hyper_ball_2d(1.0, n_levels=n_levels), degree, g_fn, zero_fn,
            n_pre=2, n_post=2, n_cycles=1, device=dev)
        self.dim = 2
        # per level: inverse Jacobians and JxW at the quadrature points
        self.Jinv, self.jxw = [], []
        for g, op in zip(s.grids, s.ops_dp):
            self.Jinv.append(torch.tensor(
                np.linalg.inv(g.jacobians).reshape(op.cell_shape + (2, 2)),
                dtype=torch.float64, device=dev))
            self.jxw.append(op.jxw)

    # -------------------------------------------------------------- fields
    def phys_grad(self, level, u):
        """Physical gradient at the quadrature points: J^{-T} grad_ref u."""
        op = self.solver.ops_dp[level]
        g = op._eval_grads(op.gather(u))
        J = self.Jinv[level]
        return [sum(J[..., b, a] * g[b] for b in range(self.dim))
                for a in range(self.dim)]

    def linearized_coef(self, level, u):
        """Merged Newton coefficient (program.cc:120-165):
        jxw J^{-1} c(w) J^{-T}, c = (I - w w^T/(1+|w|^2))/sqrt(1+|w|^2)."""
        w = self.phys_grad(level, u)
        J = self.Jinv[level]
        norm2 = sum(wi * wi for wi in w)
        s_ = torch.sqrt(1.0 + norm2)
        f = 1.0 / (1.0 + norm2)
        v = [sum(J[..., a, b] * w[b] for b in range(self.dim))
             for a in range(self.dim)]
        G = [[sum(J[..., a, k] * J[..., b, k] for k in range(self.dim))
              for b in range(self.dim)] for a in range(self.dim)]
        return torch.stack([(G[a][b] - v[a] * v[b] * f) / s_ * self.jxw[level]
                            for (a, b) in sym_components(self.dim)], dim=-1)

    def residual(self, u):
        """Nonlinear residual -(flux, grad phi) with zero Dirichlet rows
        (program.cc:169-198); ``u`` carries its boundary values."""
        s = self.solver
        level = s.maxlevel
        op = s.ops_dp[level]
        w = self.phys_grad(level, u)
        inv_s = 1.0 / torch.sqrt(1.0 + sum(wi * wi for wi in w))
        flux = [wi * inv_s for wi in w]
        J = self.Jinv[level]
        ref = [sum(J[..., a, b] * flux[b] for b in range(self.dim))
               * self.jxw[level] for a in range(self.dim)]
        acc = op._integrate_grads(ref)
        return torch.where(op.interior, -op.scatter_add(acc), 0.0)

    def restrict_solution(self, u_fine):
        """Pointwise FE restriction down the hierarchy
        (program.cc:416-457); returns the per-level solutions."""
        s = self.solver
        sols = [None] * len(s.grids)
        sols[-1] = u_fine
        for l in range(len(s.grids) - 2, -1, -1):
            sols[l] = s.transfers_nobc[l + 1].restrict_solution(sols[l + 1])
        return sols

    # --------------------------------------------------------------- solve
    def solve(self, tol=1e-12, max_newton=30, verbose=True, u0=None):
        """Returns (solution, residual norms, total CG iterations)."""
        s = self.solver
        L = s.maxlevel
        u = torch.where(s.bmask[L], s.u_bc[L],
                        0.0 if u0 is None else u0)
        res_norms = []
        cg_total = 0
        for it in range(max_newton):
            sols = self.restrict_solution(u)
            s.update_coefficients([self.linearized_coef(l, sols[l])
                                   for l in range(len(sols))])
            r = self.residual(u)
            rn = float(torch.linalg.vector_norm(r))
            res_norms.append(rn)
            if verbose:
                print(f"Newton {it}: |r| = {rn:.3e}")
            if rn < tol:
                break
            delta, cg_its, _ = s.solve_cg(rtol=1e-4, b=r)
            cg_total += cg_its
            delta = torch.where(s.bmask[L], 0.0, delta)
            alpha = 1.0
            for _ in range(12):
                rn_new = float(torch.linalg.vector_norm(
                    self.residual(u + alpha * delta)))
                if rn_new < rn:
                    break
                alpha *= 0.5
            u = u + alpha * delta
            if verbose:
                print(f"  cg_its {cg_its}, step length {alpha}")
        return u, res_norms, cg_total


def run_refinement_cycles(n_cycles=2, first_levels=3, degree=4, tol=1e-12,
                          verbose=True, device="cuda"):
    """Newton solve + global refinement cycles with solution interpolation
    (program.cc:623-647): after each converged solve the disc is refined
    once, the solution prolongated onto the new finest level (the new
    hierarchy's second-finest level is the previous finest mesh) and
    Newton restarts warm."""
    results = []
    u = None
    for cyc in range(n_cycles):
        newton = MinimalSurfaceNewton(first_levels + cyc, degree, device)
        s = newton.solver
        u0 = None if u is None else s.transfers_nobc[s.maxlevel].prolongate(u)
        t0 = time.perf_counter()
        u, res, cg_total = newton.solve(tol=tol, verbose=verbose, u0=u0)
        results.append(dict(cycle=cyc, dofs=s.grids[s.maxlevel].n_dofs,
                            newton_its=len(res) - 1, cg_its=cg_total,
                            final_residual=res[-1],
                            seconds=time.perf_counter() - t0))
        if verbose:
            print(f"cycle {cyc}: {results[-1]}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--cycles", type=int, default=1,
                    help="refinement cycles (program.cc:623-647)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    device = driver_device(args.device)
    t0 = time.perf_counter()
    if args.cycles > 1:
        return run_refinement_cycles(args.cycles, args.levels, args.degree,
                                     device=device)
    newton = MinimalSurfaceNewton(args.levels, args.degree, device)
    u, res, cg_total = newton.solve()
    print(f"converged in {len(res) - 1} Newton steps ({cg_total} CG its), "
          f"{time.perf_counter() - t0:.1f}s; final |r| = {res[-1]:.3e}")
    return res


if __name__ == "__main__":
    main()
