"""The reference's device rule."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
