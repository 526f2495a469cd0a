"""The device the port's entry points run on."""

from __future__ import annotations

import torch

#: the entry points' default: the card
DEFAULT_DEVICE = "cuda"


def resolve_device(device: torch.device | str = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``.  The entry points run on the card
    unless the caller names another device; asking for CUDA (the default)
    where PyTorch sees no card raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "navtech_radar_slam_torch runs on a CUDA GPU unless told otherwise, "
            "and torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return dev
