"""One copy of the SIP-DG operator's arithmetic in the CUDA sources.

The operator's phases (T0's reductions, T1-T6, the face stages, fluxes,
lifts and back end) are device functions of
``multigrid_tpu_torch/csrc/dg_pencil.cuh``, each written once.  The other
kernels that apply A call them: ``dg_pencil_high.cu`` runs the header's
pencil body over the in-place layout, ``dg_cg_f64.cu`` (solver_dg's
z march) calls the phases between its own loads and its store of q, and
the sources of p = 10..16 (``dg_pencil_wide*.cu``) instantiate the
header's ``dg_wide_kernel``, the same body over the in-place layout.
These tests read the sources, so a second copy of a sweep, a flux or the
operator's tables in any of them fails on the CPU, without a compiler or
a card.
"""

import re
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "multigrid_tpu_torch" / "csrc"
HEADER = "dg_pencil.cuh"
WIDE = ("dg_pencil_wide.cu", "dg_pencil_wide_top.cu", "dg_pencil_wide_f64.cu",
        "dg_pencil_wide_top_f64.cu")
CALLERS = ("dg_pencil_high.cu", "dg_cg_f64.cu") + WIDE

# what only a copy of the operator's arithmetic would hold
COPIES = {
    "a flux": r"\bflux\s*\(",
    "a face stage's work items": r"\bface_item\b",
    "a neighbour test": r"\bhas_nb\s*=",
    "the operator's tables": r"::(S|DS|ST|DST|B|C|F|W|GSYM|GVEC|SIGMA|JXW)\b",
    "an entry of the table": r"\b(ct|tab\.v)\s*\[",
    "a body of its own": r"\bhigh_body\b",
}
# the header's functions that each caller must call
CALLS = {
    "dg_pencil_high.cu": ("pencil_body",),
    "dg_cg_f64.cu": ("reduce_bc", "t0_lines", "phase1", "phase2", "phase3",
                     "phase4", "phase5", "phase6"),
    **{name: ("wide_entry", "wide_tile") for name in WIDE},
}
PHASES = ("reduce_bc", "t0_lines", "phase0", "phase1", "phase2", "phase3",
          "phase4", "phase5", "phase6", "face_sums", "normal", "vol_term",
          "flux", "pencil_body")


def code(name: str) -> str:
    """The source ``name`` of csrc without its comments."""
    text = (CSRC / name).read_text()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


@pytest.mark.parametrize("what", sorted(COPIES))
@pytest.mark.parametrize("caller", CALLERS)
def test_no_second_copy_of_the_operator(caller, what):
    """Neither caller holds a flux, a face stage, a neighbour test, the
    operator's tables or a body of its own."""
    found = re.findall(COPIES[what], code(caller))
    assert not found, f"{caller} holds {what}: {found}"


@pytest.mark.parametrize("caller", CALLERS)
def test_callers_run_the_header_phases(caller):
    """Each caller includes dg_pencil.cuh and calls its phases."""
    src = code(caller)
    assert '#include "dg_pencil.cuh"' in src
    for fn in CALLS[caller]:
        assert re.search(rf"\b{fn}\s*<", src), f"{caller} calls no {fn}"


def test_each_phase_is_written_once():
    """Each phase function of dg_pencil.cuh is defined there once and in
    no other source of csrc."""
    header = code(HEADER)
    others = [code(p.name) for p in sorted(CSRC.glob("*.cu*"))
              if p.name != HEADER]
    for fn in PHASES:
        define = rf"__device__ __forceinline__ [\w:<>]+ {fn}\s*\("
        assert len(re.findall(define, header)) == 1, fn
        assert not any(re.search(define, src) for src in others), fn


def test_wide_kernel_runs_the_pencil_body():
    """The kernel the sources of p = 10..16 instantiate, dg_wide_kernel of
    dg_pencil.cuh, is the pencil body over the in-place layout and nothing
    else."""
    header = code(HEADER)
    body = re.search(r"dg_wide_kernel\([^)]*\)\s*\{(.*?)\n\}", header, re.S)
    assert body, "dg_pencil.cuh defines no dg_wide_kernel"
    statements = [st for st in body[1].split(";") if st.strip()]
    assert len(statements) == 1
    assert re.match(r"\s*pencil_body<T, N, MODE, WideLayout<T, N>>\(",
                    statements[0])
