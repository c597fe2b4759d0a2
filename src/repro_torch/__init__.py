"""PyTorch + CUDA port of the DR-CircuitGNN reproduction.

Mirrors ``repro`` module for module (``repro_torch/kernels/drspmm.py`` is
the counterpart of ``repro/kernels/drspmm.py``).  The port never imports
JAX: host-side packing is numpy, device code is PyTorch plus hand-written
CUDA kernels for Hopper (``csrc/``), built at first use.

Entry points (the model, the serve engine, ``collate_graphs``) run on the
card by default and raise when no card is present unless the caller asks
for the CPU with ``device="cpu"``; on the CPU every kernel wrapper runs its
plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The ``torch.device`` an entry point runs on.  A CUDA device without
    a visible card raises instead of silently degrading to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is visible; "
            f"pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
