"""Carry a solver's state from the JAX package into the port.

The JAX ``MultigridSolver`` and this package's build the same set-up
independently; the only parts that can differ are those made by a run
(the Lanczos eigenvalue estimates, which see a different summation order)
and data a caller may want to pin.  :func:`load_state` installs, from plain
numpy arrays and floats (so this module never imports JAX):

* ``"rhs"``: per level, the f64 right-hand side ``[Z, Y, X]``;
* ``"u_bc"``: per level, the six Dirichlet face slabs (axis d of extent 1,
  ordered ``[(d, side) for d for side in (0, 1)]``);
* ``"chebyshev"``: per level, ``(theta, delta, degree, max_eig, min_eig)``
  with ``degree`` counting preconditioner applications, as both packages
  store it;
* ``"element_matrix"``: per level, the ``[(p+1)^3, (p+1)^3]`` element
  stiffness; the CUDA kernel builds it from its 1-D tables, so a matrix
  that differs from :func:`~.ops.laplace_dense.element_matrix` is refused.

For a :class:`~.solvers.multigrid_dg.MultigridSolverDG` the state is

* ``"rhs"``: the f64 DG right-hand side ``[C0, C1, C2, n, n, n]``;
* ``"chebyshev"``: the DG smoother's ``(theta, delta, degree, max_eig,
  min_eig)``;
* ``"inv_diag"``: the transformed-Jacobi inverse diagonal, DG block;
* ``"cg"``: the FE_Q hierarchy's state, in the form above.

For a :class:`~.solvers.multigrid_dg.MultigridSolverDGPlain` it is

* ``"rhs"``: the f64 DG right-hand side of the finest level;
* ``"chebyshev"``: per level, the smoother's ``(theta, delta, degree,
  max_eig, min_eig)``;
* ``"inv_diag"``: per level, the transformed-Jacobi inverse diagonal.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.laplace import make_diag_coef
from .ops.laplace_dense import element_matrix
from .solvers.multigrid_dg import MultigridSolverDGPlain


def _validate(solver, state: dict) -> None:
    L = len(solver.grids)
    for key in ("rhs", "u_bc", "chebyshev", "element_matrix"):
        if key in state and len(state[key]) != L:
            raise ValueError(f"state[{key!r}] has {len(state[key])} levels, "
                             f"the solver {L}")
    for l, g in enumerate(solver.grids):
        if "rhs" in state and np.shape(state["rhs"][l]) != g.shape:
            raise ValueError(f"rhs[{l}]: shape {np.shape(state['rhs'][l])} "
                             f"!= {g.shape}")
        for i, f in enumerate(state.get("u_bc", [[]] * L)[l]):
            want = list(g.shape)
            want[i // 2] = 1
            if list(np.shape(f)) != want:
                raise ValueError(f"u_bc[{l}][{i}]: shape {np.shape(f)} != {want}")
        if "chebyshev" in state:
            _check_chebyshev(f"chebyshev[{l}]", state["chebyshev"][l])
        if "element_matrix" in state:
            K = np.asarray(state["element_matrix"][l], np.float64)
            want = element_matrix(g, make_diag_coef(g, solver.coefficient))
            if K.shape != want.shape or not np.allclose(K, want, rtol=1e-13,
                                                        atol=0):
                raise ValueError(f"element_matrix[{l}] differs from the "
                                 "brick element matrix the kernels apply")


def _check_chebyshev(name: str, values) -> None:
    if len(values) != 5:
        raise ValueError(f"{name}: {len(values)} values, not (theta, delta, "
                         "degree, max_eig, min_eig)")
    if int(values[2]) < 1:
        raise ValueError(f"{name}: degree {values[2]} < 1")


def _install_chebyshev(sm, values) -> None:
    theta, delta, degree, max_eig, min_eig = values
    sm.theta, sm.delta = float(theta), float(delta)
    sm.degree = int(degree)
    sm.max_eig, sm.min_eig = float(max_eig), float(min_eig)


def _load_dg_state(solver, state: dict) -> None:
    shape = solver.dg_grid.shape
    for key in ("rhs", "inv_diag"):
        if key in state and np.shape(state[key]) != shape:
            raise ValueError(f"{key}: shape {np.shape(state[key])} != {shape}")
    if "chebyshev" in state:
        _check_chebyshev("chebyshev", state["chebyshev"])
    if "cg" in state:
        _validate(solver.cg, state["cg"])
    dev = solver.device
    if "rhs" in state:
        solver.rhs = torch.tensor(np.asarray(state["rhs"], np.float64),
                                  dtype=solver.f_dtype, device=dev)
    if "inv_diag" in state:
        jac = solver.jacobi
        jac.inv_diag = torch.tensor(np.asarray(state["inv_diag"], np.float64),
                                    dtype=jac.dtype, device=dev)
    if "chebyshev" in state:
        _install_chebyshev(solver.smooth_dg, state["chebyshev"])
    if "cg" in state:
        load_state(solver.cg, state["cg"])


def _load_dg_plain_state(solver, state: dict) -> None:
    L = len(solver.grids)
    for key in ("chebyshev", "inv_diag"):
        if key in state and len(state[key]) != L:
            raise ValueError(f"state[{key!r}] has {len(state[key])} levels, "
                             f"the solver {L}")
    if "rhs" in state and np.shape(state["rhs"]) != solver.grids[-1].shape:
        raise ValueError(f"rhs: shape {np.shape(state['rhs'])} != "
                         f"{solver.grids[-1].shape}")
    for l, g in enumerate(solver.grids):
        if "inv_diag" in state and np.shape(state["inv_diag"][l]) != g.shape:
            raise ValueError(f"inv_diag[{l}]: shape "
                             f"{np.shape(state['inv_diag'][l])} != {g.shape}")
        if "chebyshev" in state:
            _check_chebyshev(f"chebyshev[{l}]", state["chebyshev"][l])
    dev = solver.device
    if "rhs" in state:
        solver.rhs = torch.tensor(np.asarray(state["rhs"], np.float64),
                                  dtype=solver.f_dtype, device=dev)
    for l, jac in enumerate(solver.jacobis):
        if "inv_diag" in state:
            jac.inv_diag = torch.tensor(
                np.asarray(state["inv_diag"][l], np.float64),
                dtype=jac.dtype, device=dev)
        if "chebyshev" in state:
            _install_chebyshev(solver.smoothers[l], state["chebyshev"][l])


def load_state(solver, state: dict) -> None:
    """Install ``state`` into ``solver`` (a
    :class:`~.solvers.multigrid.MultigridSolver`, a
    :class:`~.solvers.multigrid_dg.MultigridSolverDG` or a
    :class:`~.solvers.multigrid_dg.MultigridSolverDGPlain`) in place; the
    whole state is checked before anything is installed."""
    if hasattr(solver, "dg_grid"):
        _load_dg_state(solver, state)
        return
    if isinstance(solver, MultigridSolverDGPlain):
        _load_dg_plain_state(solver, state)
        return
    _validate(solver, state)
    dev, f_dtype = solver.device, solver.f_dtype
    t = lambda a, dtype: torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                                      device=dev)
    for l in range(len(solver.grids)):
        if "rhs" in state:
            solver.rhs[l] = t(state["rhs"][l], f_dtype)
        if "u_bc" in state:
            solver.u_bc[l] = [t(f, f_dtype) for f in state["u_bc"][l]]
        if "chebyshev" in state:
            _install_chebyshev(solver.smoothers[l], state["chebyshev"][l])
        if "element_matrix" in state:
            for op in (solver.dp_ops[l], solver.sp_ops[l]):
                op.K = t(state["element_matrix"][l], op.dtype)
