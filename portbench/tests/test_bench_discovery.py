"""Everything a cell needs is a file the harness finds by the names in
``BENCHMARK.json``, and ``BENCHMARK.json`` keeps to the benchmark's
contract: its keys, names, units, bounds and sizes."""

import json
import re

import pytest

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 65536


def test_entries_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == want, e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e and group in ("configs", "workloads"):
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve(cell):
    c = harness.load_cell(cell)
    assert c["file"]["why"] == c["why"]
    assert {"draw_gap"} <= set(c["file"]["limits"])
    for kind, name in (("entries", c["cfg"]["sampler"]),
                       ("configs", c["cfg"]["model"]),
                       ("ports", c["cfg"]["model"]),
                       ("counts", c["cfg"]["count"])):
        assert (harness.HERE / kind / f"{name}.py").exists(), (kind, name)
    assert c["cfg"]["name"] == c["config"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert hasattr(harness.load_module("metrics", m["name"]), "read")
    # every cell reports setup_s, another end-to-end metric, a per-layer one
    assert "setup_s" in {m["name"] for m in c["end_to_end"]}
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]


def test_config_files_are_under_paths_and_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("portbench/configs/")
        assert (harness.ROOT / f).exists()


def test_every_metric_file_is_named():
    """No metric file lies unused, and none is listed in code."""
    named = {m["name"] for g in ("end_to_end", "per_layer")
             for m in BENCH[g]}
    files = {p.stem for p in (harness.HERE / "metrics").glob("*.py")}
    assert files == named
