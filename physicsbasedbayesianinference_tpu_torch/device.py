"""Where the port's constructors put what they make.

The rule of the port: the card unless the caller asks for the CPU. A
constructor that takes ``device=None`` resolves it here, when it is called:
an explicit ``device`` wins; a tensor the caller hands in keeps the device
it is on; everything else (numbers, lists, numpy arrays, fresh zeros) goes
to :func:`default_device`.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA device when there is one, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def resolve_device(device=None, like=None) -> torch.device:
    """``device`` if given, else ``like``'s device if it is a tensor, else
    :func:`default_device`."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    return default_device()
