"""The command: with no card it prints no result and exits 2; in a
directory holding only BENCHMARK.json and the benchmark's folder (no
program) it does the same, even where a card is reported."""

import os
import shutil
import subprocess
import sys

from portbench import spec

ARGS = ["portbench/run.py", "--workload", "turbo.batch16.beam5", "--seed", "2147483700", "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    out = subprocess.run([sys.executable, *ARGS], cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    fake_card = (
        "import sys, runpy, torch\n"
        "torch.cuda.is_available = lambda: True\n"
        "torch.cuda.device_count = lambda: 1\n"
        "sys.argv = %r\n"
        "runpy.run_path('portbench/run.py', run_name='__main__')\n"
    ) % ARGS
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", fake_card], cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 2 and out.stdout == ""
    assert "not in this checkout" in out.stderr
