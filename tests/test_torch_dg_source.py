"""One copy of the SIP-DG operator's arithmetic in the CUDA sources.

The operator's phases (T0's reductions, T1-T6, the face stages, fluxes,
lifts and back end) are device functions of
``multigrid_tpu_torch/csrc/dg_pencil.cuh``, each written once.  The other
kernels that apply A call them: ``dg_pencil_high.cu`` runs the header's
pencil body over the in-place layout, and ``dg_cg_f64.cu`` (solver_dg's
z march) calls the phases between its own loads and its store of q.
These tests read the sources, so a second copy of a sweep, a flux or the
operator's tables in either file fails on the CPU, without a compiler or
a card.
"""

import re
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "multigrid_tpu_torch" / "csrc"
HEADER = "dg_pencil.cuh"
CALLERS = ("dg_pencil_high.cu", "dg_cg_f64.cu")

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
