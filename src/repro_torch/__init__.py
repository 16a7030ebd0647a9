"""PyTorch / CUDA port of the HarMoEny reproduction.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``configs/``, ``core/``, ``models/``, ``serve/``, ``kernels/``)
and never imports it or JAX.  Entry points run on the CUDA device unless
the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when CUDA is asked for (explicitly or by default) and
    no GPU is present — the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev
