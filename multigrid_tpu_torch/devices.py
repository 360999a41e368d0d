"""The device an entry point runs on.

Every solver, operator and driver of the port takes ``device`` and defaults
to ``"cuda"``: the port is meant for the card, and the CPU runs only when a
caller asks for it (the tests do, to compare with the JAX package).
"""

from __future__ import annotations

import subprocess

import torch


def resolve(device="cuda") -> torch.device:
    """``torch.device(device)``, a bare ``"cuda"`` with the current card's
    index (tensors report theirs, and the wrappers compare devices); raises
    at once when CUDA is asked for and there is no card, instead of failing
    later inside a tensor call."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def driver_device(device: str) -> torch.device:
    """The device of an experiment driver's ``--device``: on the card the
    card line is printed first; without a card, ``cuda`` raises with the
    way out."""
    try:
        dev = resolve(device)
    except RuntimeError as e:
        raise RuntimeError(f"{e}; pass --device cpu to run on the CPU") from e
    if dev.type == "cuda":
        print(f"# card: {card_line()}")
    return dev
