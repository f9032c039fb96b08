"""Device resolution for the port's entry points.

The port runs on a CUDA device unless the caller asks for another one. It
never falls back to the CPU on its own: with no card and no explicit
``device="cpu"`` an entry point raises.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """Returns ``torch.device(device)``, defaulting to ``"cuda"``; a CUDA
    device without an index becomes the current one.

    Raises:
        RuntimeError: CUDA was asked for (explicitly or by default) and no
            CUDA device is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gradslam_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
