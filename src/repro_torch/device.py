"""Where the port runs.

Every entry point (``init_model``, ``init_router``, the bridge,
``TryageEngine``) takes a ``device``.  Left unset it means the card:
with no CUDA device present that is an error, never a quiet switch to
the CPU.  Tests and references pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the current CUDA
    device, and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port on the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # "cuda" names the current card; compare equal to its tensors'
        return torch.device("cuda", torch.cuda.current_device())
    return device


def module_device(module: torch.nn.Module) -> torch.device:
    """The single device holding every parameter of ``module``."""
    devs = {p.device for p in module.parameters()}
    if len(devs) != 1:
        raise ValueError(f"module parameters span devices {sorted(map(str, devs))}")
    return devs.pop()
