"""The benchmark's data, found by name: BENCHMARK.json at the checkout's
root, and under this folder a file per configuration
(`configs/<config>.json`), cell (`workloads/<cell>.json`), traffic mix
(`traffic/<mix>.json`), traffic kind (`traffic/<kind>.py`) and per-layer
metric (`metrics/<name>.py`). Adding one of them edits no other file."""

import functools
import importlib.util
import json
import os
import re
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "whisper_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    workload: dict  # workloads/<cell>.json: config, traffic, chips, why, limits
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<mix>.json: kind and parameters

    @functools.cached_property
    def kind(self):
        """The traffic kind's module, traffic/<kind>.py."""
        return _module(os.path.join(HERE, "traffic", f"{self.mix['kind']}.py"), f"portbench_traffic_{self.mix['kind']}")


def cell(name: str, data: str = HERE) -> Cell:
    """The cell `name` from the data files under `data` (this folder; the
    tests give their own)."""
    if not NAME.match(name):
        raise ValueError(f"not a cell name: {name!r}")
    w = load_json(data, "workloads", f"{name}.json")
    return Cell(
        name=name,
        workload=w,
        config=load_json(data, "configs", f"{w['config']}.json"),
        mix=load_json(data, "traffic", f"{w['traffic']}.json"),
    )


def metric(name: str):
    """The per-layer metric's reader module, metrics/<name>.py: UNIT,
    LAYER, MOVES, WORKLOADS and read(ctx) -> a number or None."""
    if not NAME.match(name):
        raise ValueError(f"not a metric name: {name!r}")
    return _module(os.path.join(HERE, "metrics", f"{name}.py"), "portbench_metric_" + name.replace(".", "_"))


def per_layer_for(bench: dict, cell_name: str):
    """The per-layer metrics BENCHMARK.json gives this cell, in its order."""
    return [m for m in bench["per_layer"] if cell_name in m.get("workloads", [cell_name])]


def end_to_end_for(bench: dict, cell_name: str):
    return [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def forbidden_loaded(module_names) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN_MODULES, compared whole: `whisper_tpu_torch` is not
    `whisper_tpu`."""
    return sorted(m for m in module_names if m.split(".", 1)[0] in FORBIDDEN_MODULES)
