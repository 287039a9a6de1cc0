"""The result line's format, from a run of the bench config driven on the
CPU at a small size."""

import json

import pytest

from portbench import harness
from portbench.tests.helpers import cpu_run, fused_on_cpu, small_cell


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(monkeypatch, trace):
    fused_on_cpu(monkeypatch)
    run = cpu_run(small_cell("stdnormal.hmc"), trace=trace)
    checks = run.check()
    line = json.loads(json.dumps(harness.result_line(run, checks,
                                                     bool(trace))))
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert list(line)[-1] == "checks"
    assert line["attempted"] == len(run.jobs) >= 1 and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes",
            "power_limit"} <= set(line["device"])
    cell = run.cell
    want = cell["per_layer"] if trace else cell["end_to_end"]
    names = {m["name"] for m in want}
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        b = line["breakdown"]
        assert set(b) == {"device_ops", "idle_gaps"}
        assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    else:  # every end-to-end metric of the cell
        assert set(line["metrics"]) == names
        assert {"walker_transitions_per_s", "setup_s"} <= names
