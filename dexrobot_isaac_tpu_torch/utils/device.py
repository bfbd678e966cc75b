"""The entry points' device rule: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device, with the card's index filled in, so that it
    compares equal to a tensor's device. Raises when CUDA is asked for and
    missing: there is no silent CPU fallback."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the plain "
                "versions on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
