"""CG vector kernels: wrappers of ``csrc/cg_vec.cu`` with their plain
PyTorch versions and launch counters.

Replaces ``multigrid_tpu/ops/pallas_pairvec.py`` (K3 ``pair_axpy_kernel``
and K3' ``pair_dot_kernel``).  On the node grid in native fp64 there are no
(hi, lo) pairs and no duplicate-slot weights:

* ``cg_update``: x += alpha p and r -= alpha q in place, returning |r|^2;
* ``cg_dot``: a . b;
* ``cg_xpay``: p = z + beta p in place.

The in-place updates keep CG at five full vectors (x, r, p, q, z).  Each
wrapper runs the plain version for CPU tensors and launches the kernel for
CUDA tensors (or raises).  ``LAUNCHES[name]`` counts the device kernels
launched: a reduction is two (the partial sums, then one block that
finishes them), ``cg_xpay`` one.
"""

from __future__ import annotations

import torch

from .. import _build

LAUNCHES = {"cg_update": 0, "cg_dot": 0, "cg_xpay": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(tensors, name: str) -> torch.device:
    dev = tensors[0].device
    n = tensors[0].numel()
    for t in tensors:
        if t.dtype != torch.float64 or t.device != dev or t.numel() != n \
                or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous float64 tensors of one "
                             "size on one device")
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    return dev


def _scratch(dev: torch.device):
    """Partial sums and the 0-d result of one reduction."""
    return (torch.empty(_build.REDUCTION_BLOCKS, dtype=torch.float64, device=dev),
            torch.empty((), dtype=torch.float64, device=dev))


def cg_update_plain(x, r, p, q, alpha: float) -> torch.Tensor:
    x.add_(p, alpha=alpha)
    r.sub_(q, alpha=alpha)
    return torch.dot(r.reshape(-1), r.reshape(-1))


def cg_update(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
              q: torch.Tensor, alpha: float) -> torch.Tensor:
    """In place: x += alpha p, r -= alpha q.  Returns |r|^2 (0-d tensor)."""
    if x.device.type == "cpu":
        return cg_update_plain(x, r, p, q, alpha)
    dev = _check((x, r, p, q), "cg_update")
    partial, out = _scratch(dev)
    LAUNCHES["cg_update"] += _build.launch(
        "cg_update", x.data_ptr(), r.data_ptr(), p.data_ptr(), q.data_ptr(),
        float(alpha), x.numel(), partial.data_ptr(), out.data_ptr(),
        _build.stream_handle(dev))
    return out


def cg_dot_plain(a, b) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def cg_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f64 ``a . b`` (0-d tensor)."""
    if a.device.type == "cpu":
        return cg_dot_plain(a, b)
    dev = _check((a, b), "cg_dot")
    partial, out = _scratch(dev)
    LAUNCHES["cg_dot"] += _build.launch(
        "cg_dot", a.data_ptr(), b.data_ptr(), a.numel(), partial.data_ptr(),
        out.data_ptr(), _build.stream_handle(dev))
    return out


def cg_xpay_plain(p, z, beta: float) -> torch.Tensor:
    return p.mul_(beta).add_(z)


def cg_xpay(p: torch.Tensor, z: torch.Tensor, beta: float) -> torch.Tensor:
    """In place: p = z + beta p.  Returns p."""
    if p.device.type == "cpu":
        return cg_xpay_plain(p, z, beta)
    dev = _check((p, z), "cg_xpay")
    LAUNCHES["cg_xpay"] += _build.launch(
        "cg_xpay", p.data_ptr(), z.data_ptr(), float(beta), p.numel(),
        _build.stream_handle(dev))
    return p
