"""BENCHMARK.json and the files it names: every configuration, cell, traffic
mix and kind, and per-layer metric loads, keeps to the contract's names and
units, and agrees with BENCHMARK.json."""

import json
import os
import re

import pytest

from portbench import check, spec

BENCH = spec.benchmark()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    # a full check of 24 cells fits its 43,200 s
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_unique():
    groups = [BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"] + BENCH["per_layer"]]
    for group in groups:
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        for n in names:
            assert spec.NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert spec.NAME.match(w["config"]) and spec.NAME.match(w["traffic"])
        assert LINE.match(w["why"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    data = spec.load_json(spec.ROOT, cfg["file"])
    assert data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"] == []
    assert cfg["source"].startswith("https://huggingface.co/openai/whisper-large-v3")
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1
    cell = spec.cell(w["name"])
    assert {k: cell.workload[k] for k in ("config", "traffic", "chips", "why")} == {k: w[k] for k in ("config", "traffic", "chips", "why")}
    assert set(cell.workload["limits"]) <= set(check.NUMBERS) and cell.workload["limits"]
    kind = cell.kind
    for fn in ("prepare", "warm", "window", "profiled"):
        assert callable(getattr(kind, fn))
    e2e = spec.end_to_end_for(BENCH, w["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert spec.per_layer_for(BENCH, w["name"])


def test_end_to_end():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"rtfx", "latency_p95_s", "latency_p50_s", "setup_s"}
    assert "workloads" not in e2e["setup_s"] and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer(m):
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    mod = spec.metric(m["name"])
    assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.WORKLOADS) == (m["unit"], m["layer"], m["moves"], m["workloads"])
    assert callable(mod.read)
    for cell in m["workloads"]:
        assert m["moves"] in {e["name"] for e in spec.end_to_end_for(BENCH, cell)}
    assert m["name"].split(".")[-1] == {"rtfx": "offline", "latency_p95_s": "serve"}[m["moves"]]


def test_every_file_is_named():
    """Each data file under the folder belongs to an entry of BENCHMARK.json
    (or is a traffic kind a mix names)."""
    here = spec.HERE
    cells = {w["name"] for w in BENCH["workloads"]}
    assert {f[:-5] for f in os.listdir(os.path.join(here, "workloads"))} == cells
    assert {f[:-5] for f in os.listdir(os.path.join(here, "configs"))} == {c["name"] for c in BENCH["configs"]}
    assert {f[:-3] for f in os.listdir(os.path.join(here, "metrics")) if f.endswith(".py")} == {m["name"] for m in BENCH["per_layer"]}
    mixes = {w["traffic"] for w in BENCH["workloads"]}
    kinds = {spec.load_json(here, "traffic", f"{m}.json")["kind"] for m in mixes}
    files = set(os.listdir(os.path.join(here, "traffic"))) - {"__pycache__"}
    assert files == {f"{m}.json" for m in mixes} | {f"{k}.py" for k in kinds}
