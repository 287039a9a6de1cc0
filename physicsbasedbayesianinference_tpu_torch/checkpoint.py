"""Checkpoint / resume for long sampling runs (port of the JAX package's
``checkpoint.py``, with ``torch.save`` in place of orbax).

A state (dataclasses such as ``HMCState`` and the SMC carry, dicts, tuples
and lists of them, tensors on any device, Python numbers) is flattened into
one dict of CPU tensors and plain values keyed by its path (``"state.
ensemble.q"``) and written with ``torch.save``; ``restore`` loads it with
``torch.load(weights_only=True)`` and rebuilds it in the structure of a
template, each tensor checked against the template's shape and dtype and
put on the template tensor's device. The port's random keys are ``(seed,
t)`` integers, so no key needs packing.

Each step is one directory ``<directory>/<step>/state.pt``, written under a
temporary name and renamed into place, so a half-written step is never the
latest; the oldest steps beyond ``max_to_keep`` are deleted after a save.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Optional

import torch

_FILE = "state.pt"
_SCALARS = (bool, int, float, str, type(None))


def _flatten(tree: Any, prefix: str, out: dict, copy: bool = True) -> None:
    """``out[path] = leaf`` for every leaf of ``tree``; tensors copied to
    the host with ``copy``."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _flatten(getattr(tree, f.name), f"{prefix}{f.name}.", out, copy)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out, copy)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out, copy)
    elif isinstance(tree, torch.Tensor):
        t = tree.detach()
        if copy:  # a copy of its own: a view would save its base storage
            t = t.cpu() if t.device.type != "cpu" else t.clone()
        out[prefix[:-1]] = t
    elif isinstance(tree, _SCALARS):
        out[prefix[:-1]] = tree
    else:
        raise TypeError(f"cannot checkpoint {prefix[:-1]!r} of type "
                        f"{type(tree).__name__}")


def _rebuild(template: Any, prefix: str, flat: dict) -> Any:
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), f"{prefix}{f.name}.",
                             flat)
            for f in dataclasses.fields(template) if f.init})
    if isinstance(template, dict):
        return {k: _rebuild(v, f"{prefix}{k}.", flat)
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, f"{prefix}{i}.", flat)
                              for i, v in enumerate(template))
    key = prefix[:-1]
    if key not in flat:
        raise ValueError(f"checkpoint has no entry {key!r}")
    value = flat[key]
    if isinstance(template, torch.Tensor):
        if not isinstance(value, torch.Tensor) or (
                value.shape != template.shape
                or value.dtype != template.dtype):
            got = (f"{tuple(value.shape)} {value.dtype}"
                   if isinstance(value, torch.Tensor)
                   else type(value).__name__)
            raise ValueError(
                f"checkpoint entry {key!r} is {got}, the template wants "
                f"{tuple(template.shape)} {template.dtype}")
        return value.to(template.device)
    if type(value) is not type(template):
        raise ValueError(f"checkpoint entry {key!r} is {value!r}, the "
                         f"template wants a {type(template).__name__}")
    return value


@dataclasses.dataclass
class CheckpointManager:
    """Numbered checkpoints under ``directory`` with retention: any state
    of dataclasses, dicts, sequences, tensors and Python numbers
    round-trips."""

    directory: str
    max_to_keep: int = 3

    def __post_init__(self):
        self.directory = os.path.abspath(self.directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def steps(self) -> list:
        """The complete steps, ascending."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.exists(
                          os.path.join(self.directory, name, _FILE)))

    def save(self, step: int, state: Any, *, force: bool = False) -> None:
        """Write ``state`` as step ``step``; an existing step is replaced
        with ``force`` and refused without it."""
        final = self._path(step)
        if os.path.exists(final) and not force:
            raise FileExistsError(f"checkpoint step {step} exists in "
                                  f"{self.directory} (force=True replaces)")
        flat: dict = {}
        _flatten(state, "", flat)
        tmp = os.path.join(self.directory, f".tmp-{int(step)}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(flat, os.path.join(tmp, _FILE))
        if os.path.exists(final):
            old = f"{tmp}-old"
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)
        for old_step in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(old_step))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """The state of ``step`` (the latest by default) in the structure of
        ``template`` (a freshly built state: its tensors' shapes and dtypes
        must match, and give the devices)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        flat = torch.load(os.path.join(self._path(step), _FILE),
                          map_location="cpu", weights_only=True)
        expected: dict = {}
        _flatten(template, "", expected, copy=False)
        extra = sorted(set(flat) - set(expected))
        if extra:
            raise ValueError(f"checkpoint step {step} has entries the "
                             f"template lacks: {extra}")
        return _rebuild(template, "", flat)

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX interface."""
