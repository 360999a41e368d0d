"""Matvec throughput model of the DG operator (DoFs/s, GFlop/s, GB/s).

Copy of ``dg_matvec_model`` and ``print_matvec_details`` from
``multigrid_tpu/utils/perf_model.py``.  The reference prints an
arithmetic and bandwidth model with every DG benchmark
(reference common/laplace_operator_dg.h:1970-1986, poisson_dg/program.cc:
266-309).  The operation count (:func:`dg_matvec_ops`) is that of the
sum-factorized operator (``ops/dg.py``): the algorithm's flops, which the
CUDA kernel exceeds by recomputing the neighbours' face traces;
``chip_smoke.py`` takes its operation bound from it.
"""

from __future__ import annotations


def dg_matvec_ops(dim: int, degree: int, n_cells: int, kind: str) -> int:
    """Flops of one sum-factorized SIP-DG apply (about 201 per dof at
    p = 4, hermite)."""
    n = degree + 1
    N = n**dim
    sweeps = 2 * dim + (0 if kind == "gauss" else 2 * dim)
    ops_cell = sweeps * 2 * N * n + (2 * dim * dim + dim) * N
    ops_face = 2 * dim * ((dim + 1) * 2 * n ** (dim - 1) * n
                          + 10 * n ** (dim - 1))
    return n_cells * (ops_cell + ops_face)


def dg_matvec_model(dim: int, degree: int, n_cells: int, kind: str,
                    itemsize: int, n_dofs: int, seconds: float) -> dict:
    """Throughput model for the fused SIP-DG operator (ops/dg.py);
    ``seconds`` per apply."""
    ops = dg_matvec_ops(dim, degree, n_cells, kind)
    return dict(
        seconds=seconds,
        dofs_per_s=n_dofs / seconds,
        gflops=1e-9 * ops / seconds,
        gbs=1e-9 * n_dofs * itemsize * 3 / seconds,
        ops_per_dof=ops / n_dofs,
    )


def print_matvec_details(label: str, model: dict, n_dofs: int, file=None):
    """One reference-style matvec telemetry line
    (cf. print_matvec_details, poisson_dg/program.cc:266-309)."""
    print(f"{label:14s} n_dof {n_dofs:>11d}  {model['seconds']:.5f} s  "
          f"DoFs/s {model['dofs_per_s']:.4g}  GFlop/s {model['gflops']:.4g}  "
          f"GB/s {model['gbs']:.4g}  ops/dof {model['ops_per_dof']:.1f}",
          file=file)
