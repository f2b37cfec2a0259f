"""The benchmark's own tests: `python -m pytest portbench/tests -q` from the
checkout's root. Tests marked `cuda` need a card and skip elsewhere; the
card is looked for inside the `card` fixture, never at import."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this machine")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def bench_for_tiny():
    """BENCHMARK.json with the tiny test cells added to every metric."""
    from portbench import spec

    bench = spec.benchmark()
    tiny = ["tiny.batch", "tiny.serve"]
    widen = lambda ms: [dict(m, workloads=m.get("workloads", []) + tiny) if "workloads" in m else m for m in ms]  # noqa: E731
    return dict(bench, end_to_end=widen(bench["end_to_end"]), per_layer=widen(bench["per_layer"]))
