"""D-ReLU row thresholding by row-wise binary search (the paper's Sec. 3.1).

Replaces ``drelu_pallas`` (``src/repro/kernels/drelu_topk.py``): per row,
bisect the value range for 64 steps, counting survivors ``x >= mid``, then
keep ``x >= th`` (ties kept).  CUDA source: ``csrc/drelu_bisect.cu``.  The
kernel is bit-exact against :func:`drelu_bisect_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.drspmm import _on_card

N_ITERS = 64


def drelu_bisect_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """The bisection in plain PyTorch (fp32, step for step the kernel's)."""
    lo = x.min(dim=1).values
    hi = x.max(dim=1).values
    for _ in range(N_ITERS):
        mid = 0.5 * (lo + hi)
        cnt = (x >= mid[:, None]).sum(dim=1)
        take_hi = cnt > k
        lo = torch.where(take_hi, mid, lo)
        hi = torch.where(take_hi, hi, mid)
    return torch.where(x >= hi[:, None], x, torch.zeros_like(x))


def drelu_bisect(x: torch.Tensor, k: int) -> torch.Tensor:
    """Dense D-ReLU of an fp32 (N, D) matrix via the bisection kernel."""
    n, d = x.shape
    if k >= d:
        return x
    if not _on_card(x):
        return drelu_bisect_plain(x, k)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("drelu_bisect takes a contiguous float32 matrix")
    if d > 256:
        raise ValueError(f"row width {d} outside the kernel's range (1..256)")
    out = torch.empty_like(x)
    lib = _lib()
    rc = lib.drelu_bisect(_build.ptr(x), _build.ptr(out), n, d, k,
                          _build.stream_of(out))
    _build.check(lib, rc, "drelu_bisect")
    drelu_bisect.launches += 1
    return out


drelu_bisect.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library("drelu_bisect")
    fn = lib.drelu_bisect
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
