"""Where the port's constructors put what they make.

The rule of the port: the card unless the caller asks for the CPU. A
constructor that takes ``device=None`` resolves it here, when it is called:
an explicit ``device`` wins; a tensor the caller hands in keeps the device
it is on; everything else (numbers, lists, numpy arrays, fresh zeros) goes
to :func:`default_device`, which is the card, or the device a caller named
for the whole process with :func:`set_default_device` (the CPU tests name
the CPU so). Without a card and without such a request it raises: the port
never moves to the CPU because it found no card.
"""

from __future__ import annotations

from typing import Optional

import torch

_requested: Optional[torch.device] = None


def set_default_device(device) -> None:
    """Make ``device`` (``"cpu"``, ``"cuda"``, a ``torch.device``) the
    default of every constructor and entry point of the process called
    without one; ``None`` goes back to the card."""
    global _requested
    _requested = None if device is None else torch.device(device)


def default_device() -> torch.device:
    """The device :func:`set_default_device` named, else the CUDA device.
    Raises where neither was named and there is no CUDA device."""
    if _requested is not None:
        return _requested
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device, and the CPU was not asked for: pass "
            "device='cpu' (or CPU tensors), or call "
            "physicsbasedbayesianinference_tpu_torch.device."
            "set_default_device('cpu') once for the process")
    return torch.device("cuda")


def resolve_device(device=None, like=None) -> torch.device:
    """``device`` if given, else ``like``'s device if it is a tensor, else
    :func:`default_device`."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    return default_device()
