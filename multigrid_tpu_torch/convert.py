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

A :class:`~.parallel.distributed.DistributedMultigrid` takes the same
state, for the whole grids: every rank installs the same Chebyshev values
and element matrices, and its slab of each split level's ``rhs`` and
``u_bc``.  So does a :class:`~.parallel.distributed.DistributedMultigridDG`
(the DG forms below): every rank the same Chebyshev values, its slab of
the DG ``rhs`` and of each split level's ``inv_diag``, and the FE_Q
state through its ``DistributedMultigrid``.

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

For a :class:`~.solvers.multigrid_general.GeneralMultigridSolver` it is,
per level (:func:`general_state` reads it off a JAX solver):

* ``"C_sp"``, ``"C_dp"``: the merged coefficient ``[cells, n, .., n,
  n_sym]`` of the V-cycle operator and of the f64 operator;
* ``"inv_diag"``: the V-cycle operator's point-Jacobi inverse diagonal;
* ``"chebyshev"``: ``(theta, delta, degree, max_eig, min_eig)``;
* ``"rhs"``, ``"u_bc"``: the f64 right-hand side and boundary data
  ``[n_dofs]``;
* ``"cell_nodes"``, ``"boundary"``, ``"jxw"``: the grid's tables, which
  must equal the port's (``jxw`` to 1e-13 relative): a state built on
  another numbering or geometry is refused.

A curved :class:`~.solvers.multigrid_dg.MultigridSolverDGPlain`
(``mapping``) takes the DG-plain state as it is: its levels keep their
transformed-Jacobi inverse diagonals in the same ``jacobis`` and their
smoothers in ``smoothers``.

For an :class:`~.solvers.multigrid_adaptive.AdaptiveMultigridSolver`
(global coarsening; the levels are its ``grids``) or a
:class:`~.solvers.multigrid_local.LocalSmoothingMultigrid` (the levels are
its level meshes), :func:`adaptive_state` reads, as plain numpy:

* ``"chebyshev"``: per level, ``(theta, delta, degree, max_eig, min_eig)``;
* ``"inv_diag"``: per level, the smoother's inverse diagonal ``[n_dofs]``
  (for local smoothing the one with the constrained rows set to 1);
* ``"rhs"``, ``"u_bc"``: the f64 right-hand side and Dirichlet data of the
  finest (global) grid;
* ``"gidx"``, ``"gw"``, ``"boundary"``: per level, the grid's gather tables
  and Dirichlet mask, which must equal the port's (``gw`` to 1e-14): a
  state built on another numbering is refused.

:func:`adaptive_forest` turns a JAX ``Forest`` into the port's, so that both
packages can run on one mesh, and :func:`sym_coef_from_jax` a JAX
``SymCoef`` array (interleaved cell layout) into the port's (blocked).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.laplace import SymCoef, make_diag_coef
from .ops.laplace_dense import element_matrix
from .mesh.adaptive import Cell, Forest, OctForest, QuadForest
from .parallel.distributed import DistributedMultigrid, DistributedMultigridDG
from .solvers.multigrid_adaptive import AdaptiveSystem
from .solvers.multigrid_dg import MultigridSolverDGPlain
from .solvers.multigrid_general import GeneralMultigridSolver

GENERAL_KEYS = ("C_sp", "C_dp", "inv_diag", "chebyshev", "rhs", "u_bc",
                "cell_nodes", "boundary", "jxw")
ADAPTIVE_LEVEL_KEYS = ("chebyshev", "inv_diag", "gidx", "gw", "boundary")


def sym_coef_from_jax(array) -> SymCoef:
    """A JAX ``SymCoef`` array (numpy), interleaved ``[C0, q, C1, q, ...,
    n_sym]`` (``multigrid_tpu/ops/laplace.py:84``), as the port's
    :class:`~.ops.laplace.SymCoef`, blocked ``[C0, C1, ..., q, q, ...,
    n_sym]`` (numpy; the operator puts it on its device); axes of extent
    1 (a broadcast) stay so."""
    a = np.asarray(array)
    dim = (a.ndim - 1) // 2
    order = ([2 * d for d in range(dim)] + [2 * d + 1 for d in range(dim)]
             + [2 * dim])
    return SymCoef(np.ascontiguousarray(a.transpose(order)))


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


def _whole(a, level):
    """A one-device solver keeps every array whole."""
    return a


def _load_dg_state(solver, state: dict, part=_whole) -> None:
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
        solver.rhs = torch.tensor(part(np.asarray(state["rhs"], np.float64),
                                       -1), dtype=solver.f_dtype, device=dev)
    if "inv_diag" in state:
        jac = solver.jacobi
        jac.inv_diag = torch.tensor(
            part(np.asarray(state["inv_diag"], np.float64), -1),
            dtype=jac.dtype, device=dev)
    if "chebyshev" in state:
        _install_chebyshev(solver.smooth_dg, state["chebyshev"])
    if "cg" in state:
        load_state(solver.cg, state["cg"])


def _load_dg_plain_state(solver, state: dict, part=_whole) -> None:
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
        solver.rhs = torch.tensor(part(np.asarray(state["rhs"], np.float64),
                                       -1), dtype=solver.f_dtype, device=dev)
    for l, jac in enumerate(solver.jacobis):
        if "inv_diag" in state:
            jac.inv_diag = torch.tensor(
                part(np.asarray(state["inv_diag"][l], np.float64), l),
                dtype=jac.dtype, device=dev)
        if "chebyshev" in state:
            _install_chebyshev(solver.smoothers[l], state["chebyshev"][l])


def general_state(solver) -> dict:
    """The state of a JAX ``GeneralMultigridSolver`` on the flat layout
    (its CPU configuration) as numpy arrays and floats, in the form
    :func:`load_state` takes.  Reads attributes only, so this module still
    imports no JAX."""
    params = solver._params
    return {
        "C_sp": [np.asarray(C) for C in params["C_sp"]],
        "C_dp": [np.asarray(C) for C in params["C_dp"]],
        "inv_diag": [np.asarray(d) for d in params["inv_diag"]],
        "chebyshev": [(float(sm.theta), float(sm.delta), int(sm.degree),
                       float(sm.max_eig), float(sm.min_eig))
                      for sm in solver.smoothers],
        "rhs": [np.asarray(r) for r in solver.rhs],
        "u_bc": [np.asarray(u) for u in solver.u_bc],
        "cell_nodes": [np.asarray(g.cell_nodes) for g in solver.grids],
        "boundary": [np.asarray(g.boundary) for g in solver.grids],
        "jxw": [np.asarray(g.jxw) for g in solver.grids],
    }


def _load_general_state(solver, state: dict) -> None:
    L = len(solver.grids)
    for key in GENERAL_KEYS:
        if key in state and len(state[key]) != L:
            raise ValueError(f"state[{key!r}] has {len(state[key])} levels, "
                             f"the solver {L}")
    for l, (g, op) in enumerate(zip(solver.grids, solver.ops)):
        for key in ("cell_nodes", "boundary"):
            if key in state and not np.array_equal(state[key][l],
                                                   getattr(g, key)):
                raise ValueError(f"{key}[{l}] differs from the port's grid")
        if "jxw" in state:
            jxw = np.asarray(state["jxw"][l], np.float64)
            if jxw.shape != g.jxw.shape or not np.allclose(
                    jxw, g.jxw, rtol=1e-13, atol=0):
                raise ValueError(f"jxw[{l}] differs from the port's grid")
        for key in ("C_sp", "C_dp"):
            if key in state and np.shape(state[key][l]) != tuple(op.C.shape):
                raise ValueError(f"{key}[{l}]: shape {np.shape(state[key][l])}"
                                 f" != {tuple(op.C.shape)}")
        for key in ("inv_diag", "rhs", "u_bc"):
            if key in state and np.shape(state[key][l]) != op.shape:
                raise ValueError(f"{key}[{l}]: shape {np.shape(state[key][l])}"
                                 f" != {op.shape}")
        if "chebyshev" in state:
            _check_chebyshev(f"chebyshev[{l}]", state["chebyshev"][l])
    t = lambda a, dtype: torch.tensor(np.asarray(a), dtype=dtype,
                                      device=solver.device)
    for l, (op, dp) in enumerate(zip(solver.ops, solver.ops_dp)):
        if "C_dp" in state:
            dp.C = t(state["C_dp"][l], dp.dtype)
        if "C_sp" in state and op is not dp:
            op.C = t(state["C_sp"][l], op.dtype)
        if "inv_diag" in state:
            op.inv_diag = t(state["inv_diag"][l], op.dtype)
        if "chebyshev" in state:
            _install_chebyshev(solver.smoothers[l], state["chebyshev"][l])
        for key in ("rhs", "u_bc"):
            if key in state:
                getattr(solver, key)[l] = t(state[key][l], solver.f_dtype)


def adaptive_forest(forest) -> Forest:
    """The port's forest of a JAX ``Forest``: the same root lattice and
    active cells (attributes only, so no JAX import)."""
    cls = OctForest if forest.dim == 3 else QuadForest
    return cls(forest.root_cells, forest.origin, forest.extent,
               active=[Cell(c.level, c.ix, c.iy, c.iz)
                       for c in forest.active])


def _adaptive_levels(solver):
    """(grids, inverse diagonals' owners) of either adaptive solver."""
    levels = getattr(solver, "levels", None)
    if levels is not None:
        return [lv.grid for lv in levels], levels
    return solver.grids, solver.ops


def adaptive_state(solver) -> dict:
    """The state of a JAX ``AdaptiveMultigridSolver`` or
    ``LocalSmoothingMultigrid`` as numpy arrays and floats, in the form
    :func:`load_state` takes."""
    grids, owners = _adaptive_levels(solver)
    inv = [np.asarray(o._inv_diag if hasattr(o, "_inv_diag")
                      else o.inv_diag_arr) for o in owners]
    return {
        "chebyshev": [(float(sm.theta), float(sm.delta), int(sm.degree),
                       float(sm.max_eig), float(sm.min_eig))
                      for sm in solver.smoothers],
        "inv_diag": inv,
        "rhs": np.asarray(solver.rhs),
        "u_bc": np.asarray(solver.u_bc),
        "gidx": [np.asarray(g.gidx) for g in grids],
        "gw": [np.asarray(g.gw) for g in grids],
        "boundary": [np.asarray(g.boundary) for g in grids],
    }


def _load_adaptive_state(solver, state: dict) -> None:
    grids, owners = _adaptive_levels(solver)
    L = len(grids)
    for key in ADAPTIVE_LEVEL_KEYS:
        if key in state and len(state[key]) != L:
            raise ValueError(f"state[{key!r}] has {len(state[key])} levels, "
                             f"the solver {L}")
    for l, g in enumerate(grids):
        for key in ("gidx", "boundary"):
            if key in state and not np.array_equal(state[key][l],
                                                   getattr(g, key)):
                raise ValueError(f"{key}[{l}] differs from the port's grid")
        if "gw" in state:
            gw = np.asarray(state["gw"][l], np.float64)
            if gw.shape != g.gw.shape or not np.allclose(gw, g.gw, rtol=0,
                                                         atol=1e-14):
                raise ValueError(f"gw[{l}] differs from the port's grid")
        if "inv_diag" in state and np.shape(state["inv_diag"][l]) != (
                g.n_dofs,):
            raise ValueError(f"inv_diag[{l}]: shape "
                             f"{np.shape(state['inv_diag'][l])} != "
                             f"{(g.n_dofs,)}")
        if "chebyshev" in state:
            _check_chebyshev(f"chebyshev[{l}]", state["chebyshev"][l])
    n = solver.op_dp.n_dofs
    for key in ("rhs", "u_bc"):
        if key in state and np.shape(state[key]) != (n,):
            raise ValueError(f"{key}: shape {np.shape(state[key])} != {(n,)}")
    t = lambda a, dtype: torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                                      device=solver.device)
    for l, o in enumerate(owners):
        if "inv_diag" in state:
            name = "_inv_diag" if hasattr(o, "_inv_diag") else "inv_diag"
            setattr(o, name, t(state["inv_diag"][l], solver.v_dtype))
        if "chebyshev" in state:
            _install_chebyshev(solver.smoothers[l], state["chebyshev"][l])
    for key in ("rhs", "u_bc"):
        if key in state:
            setattr(solver, key, t(state[key], solver.f_dtype))


def load_state(solver, state: dict) -> None:
    """Install ``state`` into ``solver`` (a
    :class:`~.solvers.multigrid.MultigridSolver`, a
    :class:`~.solvers.multigrid_dg.MultigridSolverDG`, a
    :class:`~.solvers.multigrid_dg.MultigridSolverDGPlain`, a
    :class:`~.solvers.multigrid_general.GeneralMultigridSolver` or one of
    the adaptive solvers, or the rank-decomposed ones) in place; the whole
    state is checked before anything is installed."""
    if isinstance(solver, DistributedMultigridDG):
        inner = solver.solver
        plain = solver.kind == "dg-plain"
        slabs = inner.slabs if plain else [inner.dg_slabs]

        def part(a, level):
            s = slabs[level]
            return a if s is None else np.ascontiguousarray(
                a[s.stored_cells()])

        (_load_dg_plain_state if plain else _load_dg_state)(inner, state,
                                                            part)
        return
    if isinstance(solver, AdaptiveSystem):
        _load_adaptive_state(solver, state)
        return
    if isinstance(solver, GeneralMultigridSolver):
        _load_general_state(solver, state)
        return
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
    ranked = isinstance(solver, DistributedMultigrid)
    for l in range(len(solver.grids)):
        if "rhs" in state:
            rhs = np.asarray(state["rhs"][l], np.float64)
            box = solver.stored_index(l) if ranked else None
            if box is not None:
                rhs = rhs[box]
            solver.rhs[l] = t(rhs, f_dtype)
        if "u_bc" in state:
            solver.u_bc[l] = (solver.local_faces(l, state["u_bc"][l]) if ranked
                              else [t(f, f_dtype) for f in state["u_bc"][l]])
        if "chebyshev" in state:
            _install_chebyshev(solver.smoothers[l], state["chebyshev"][l])
        if "element_matrix" in state:
            for op in (solver.dp_ops[l], solver.sp_ops[l]):
                op = getattr(op, "op", op) if ranked else op
                op.K = t(state["element_matrix"][l], op.dtype)
