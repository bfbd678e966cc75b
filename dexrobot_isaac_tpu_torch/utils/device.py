"""The entry points' device rule: CUDA unless the caller asks for the CPU;
and the helpers the measurement tools share."""

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


def synchronize(device: torch.device) -> None:
    """Waits for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_name(device: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), or the CPU."""
    if device.type == "cuda":
        from dexrobot_isaac_tpu_torch.utils import kernel_build

        return kernel_build.card()
    return "the host's CPU"


def split_device(argv, default="cuda"):
    """(positional arguments, device) of a tool's argv with `device=...`."""
    device, pos = default, []
    for a in argv:
        if a.startswith("device="):
            device = a.split("=", 1)[1]
        else:
            pos.append(a)
    return pos, device
