"""The port's CPU tests ask for the CPU through this module.

A test module asks by importing the fixture ``cpu_requested``: for that
module's tests it names the CPU as the default device
(``device.set_default_device``'s setting), so what they build without a
``device`` lands there, and it puts the setting back when the module's
tests end. What a module builds while pytest collects it (the names of its
parameters) it builds inside ``cpu()``. Importing sets nothing, so the
tests of other modules collected in the same session (the card's, in
``test_torch_cuda.py``) keep the card. The port never takes the CPU by
itself: without a card and without a request its constructors and entry
points raise."""

import contextlib

import pytest
import torch

from physicsbasedbayesianinference_tpu_torch import device


@contextlib.contextmanager
def cpu():
    """The CPU as the default device inside the block, and only there."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(device, "_requested", torch.device("cpu"))
        yield


@pytest.fixture(autouse=True, scope="module")
def cpu_requested():
    with cpu():
        yield
