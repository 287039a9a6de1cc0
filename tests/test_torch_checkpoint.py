"""Checkpoints of the torch port (``CheckpointManager``, ``torch.save``):
round trips of the samplers' states, the checks ``restore`` makes against
its template, retention, and that a half-written entry is never the
latest."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import physicsbasedbayesianinference_tpu_torch as pt
from physicsbasedbayesianinference_tpu_torch import smc
from physicsbasedbayesianinference_tpu_torch.checkpoint import (
    CheckpointManager)
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp


def _leaves(tree):
    """(path, leaf) pairs of a state, in order."""
    out = []

    def walk(x, path):
        if hasattr(x, "__dataclass_fields__"):
            for name in x.__dataclass_fields__:
                walk(getattr(x, name), f"{path}.{name}")
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}.{k}")
        else:
            out.append((path, x))
    walk(tree, "")
    return out


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, path
            assert torch.equal(x, y), path
        else:
            assert type(x) is type(y) and x == y, path


def _states():
    q = torch.randn(32, 3, generator=torch.Generator().manual_seed(0))
    target = tp.make_standard_normal(3)
    hmc_state = pt.build_hmc_kernel(target, num_steps=2).init(q, mass=0.5)
    m = smc.build_smc_machinery(target, 32, torch.float32, num_dims=3,
                                max_stages=4, device="cpu")
    carry = m["body"](m["init_carry"](9, 3.0 * q))
    pt_state = {"q": q.expand(4, 32, 3).clone(), "u": torch.rand(4, 32),
                "g": torch.randn(4, 32, 3)}
    return {"hmc": hmc_state, "smc": carry, "pt": pt_state}


@pytest.mark.parametrize("kind", ["hmc", "smc", "pt"])
def test_round_trip(tmp_path, kind):
    state = _states()[kind]
    mgr = CheckpointManager(str(tmp_path))
    payload = {"schema": 1, "state": state, "n": 12, "tau": 0.5}
    mgr.save(3, payload)
    assert mgr.latest_step() == 3
    template = {"schema": 0, "state": _zeros_like(state), "n": 0,
                "tau": 0.0}
    back = mgr.restore(template)
    _assert_same(back, payload)
    if kind == "smc":  # the carry's Python ints come back as saved
        assert back["state"].stage == 1 and back["state"].seed == 9


def _zeros_like(state):
    if isinstance(state, dict):
        return {k: torch.zeros_like(v) for k, v in state.items()}
    return dataclasses.replace(state, **{
        f.name: (torch.zeros_like(getattr(state, f.name))
                 if isinstance(getattr(state, f.name), torch.Tensor)
                 else _zeros_like(getattr(state, f.name))
                 if dataclasses.is_dataclass(getattr(state, f.name))
                 else getattr(state, f.name))
        for f in dataclasses.fields(state)})


def test_restore_checks_the_template(tmp_path):
    state = _states()["pt"]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"schema": 1, "state": state})
    ok = {"schema": 0, "state": _zeros_like(state)}
    mgr.restore(ok)
    bad_shape = {"schema": 0, "state": dict(ok["state"],
                                            q=torch.zeros(4, 33, 3))}
    bad_dtype = {"schema": 0, "state": dict(ok["state"],
                                            u=torch.zeros(4, 32,
                                                          dtype=torch.float64))}
    bad_number = {"schema": 0.0, "state": ok["state"]}
    more_than_saved = {"schema": 0, "state": dict(ok["state"],
                                                  extra=torch.zeros(1))}
    less_than_saved = {"schema": 0, "state": {
        k: v for k, v in ok["state"].items() if k != "g"}}
    for template, match in ((bad_shape, "wants"), (bad_dtype, "wants"),
                            (bad_number, "wants"),
                            (more_than_saved, "no entry"),
                            (less_than_saved, "lacks")):
        with pytest.raises(ValueError, match=match):
            mgr.restore(template)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(ok)
    with pytest.raises(TypeError, match="cannot checkpoint"):
        mgr.save(2, {"fn": len})


def test_retention_and_replacement(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, {"x": torch.full((2,), float(step))})
    assert mgr.steps() == [3, 4]
    with pytest.raises(FileExistsError):
        mgr.save(4, {"x": torch.zeros(2)})
    mgr.save(4, {"x": torch.zeros(2)}, force=True)
    assert mgr.steps() == [3, 4]
    assert torch.equal(mgr.restore({"x": torch.ones(2)})["x"],
                       torch.zeros(2))
    assert torch.equal(mgr.restore({"x": torch.ones(2)}, 3)["x"],
                       torch.full((2,), 3.0))
    assert sorted(os.listdir(tmp_path)) == ["3", "4"]


def test_a_half_written_entry_is_never_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, {"x": torch.ones(2)})
    # a save cut short: its temporary directory, complete or not, and a
    # numbered directory without its file
    os.makedirs(tmp_path / ".tmp-9-123")
    torch.save({"x": torch.zeros(2)}, tmp_path / ".tmp-9-123" / "state.pt")
    os.makedirs(tmp_path / "7")
    assert mgr.latest_step() == 5
    assert torch.equal(mgr.restore({"x": torch.zeros(2)})["x"],
                       torch.ones(2))
    # a view saves only its own elements
    big = torch.arange(1000.0)
    mgr.save(6, {"x": big[:2]})
    size = os.path.getsize(tmp_path / "6" / "state.pt")
    assert size < 2000
    np.testing.assert_array_equal(
        mgr.restore({"x": torch.zeros(2)})["x"].numpy(), [0.0, 1.0])
