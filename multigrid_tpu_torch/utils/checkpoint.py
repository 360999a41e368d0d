"""Solver-state checkpoint/resume.

Twin of ``multigrid_tpu/utils/checkpoint.py``, in the same format, so that
each package reads the other's files: an npz of named arrays plus a JSON
metadata dict stored as bytes under ``__metadata__``.  The JAX twin
compresses the npz; this one stores it as it is (``np.savez``), which
``np.load`` and so both ``load_state`` read all the same: float64
solver state hardly compresses (a 1.08 GB CG solution of poisson_cube at
135M dofs by 5%, at about 40 times the time; chip_smoke.py on an
H100 host).  ``state`` may nest
dicts, lists and tuples of tensors, arrays and numbers; they are flattened
with path-joined keys ("outer/cg/x", list items by index, None skipped, as
``jax.tree_util`` flattens them) and restored as a flat dict of numpy
arrays keyed the same way.  Card tensors are copied to the host
(``.cpu().numpy()``).  The reference keeps no solver state on disk
(SURVEY.md §5).
"""

from __future__ import annotations

import json

import numpy as np
import torch

_META_KEY = "__metadata__"


def _leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(state, prefix: str = "", out=None) -> dict:
    out = {} if out is None else out
    if isinstance(state, dict):
        items = ((str(k), state[k]) for k in sorted(state))
    elif isinstance(state, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(state))
    else:
        if prefix == _META_KEY:
            raise ValueError(f"state key {_META_KEY!r} is reserved")
        out[prefix] = _leaf(state)
        return out
    for k, v in items:
        if v is not None:
            _flatten(v, f"{prefix}/{k}" if prefix else k, out)
    return out


def save_state(path: str, state: dict, metadata: dict | None = None):
    """Write ``state`` and ``metadata`` to ``path`` (an npz)."""
    arrays = _flatten(state)
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(metadata or {}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_state(path: str):
    """``(state, metadata)``: the flat dict of numpy arrays and the
    metadata dict."""
    data = np.load(path)
    meta = json.loads(bytes(data[_META_KEY]).decode()) if _META_KEY in data else {}
    state = {k: data[k] for k in data.files if k != _META_KEY}
    return state, meta
