"""`python -m whisper_tpu_torch.export_pipeline` (the counterpart of
tools/export_pipeline.py) on the CPU: from a `.npz` written by save_model it
writes the files export.export_pipeline writes for the same model, byte for
byte (no AOT compile on the CPU); from a registry name with random weights
it writes the seeded model's weights; its flags are the JAX tool's plus
--device, --compute-dtype and --cache-dir."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import whisper_tpu_torch
from whisper_tpu_torch import export, export_pipeline
from whisper_tpu_torch.models.dims import MODEL_DIMS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)


def _tool(*args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "whisper_tpu_torch.export_pipeline", *args],
        capture_output=True, text=True, env=env, cwd=str(cwd), timeout=300,
    )  # fmt: skip
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_tool_writes_what_export_pipeline_writes(synth_checkpoint, tmp_path):
    model = whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)
    npz = str(tmp_path / "tiny.npz")
    whisper_tpu_torch.save_model(model, npz)
    stdout = _tool(
        "--checkpoint", npz, "--out", str(tmp_path / "tool"), "--device", "cpu",
        "--compute-dtype", "float32", "--beam-size", "3", "--sample-len", "100", "--no-build",
        cwd=tmp_path,
    )  # fmt: skip
    assert "exported pipeline" in stdout and "native runner" not in stdout

    again = whisper_tpu_torch.load_model(npz, device="cpu", compute_dtype=torch.float32)
    export.export_pipeline(str(tmp_path / "api"), again, beam_size=3, sample_len=100)
    files = sorted(os.listdir(tmp_path / "api"))
    assert sorted(os.listdir(tmp_path / "tool")) == files
    for name in ("pipeline.txt", "encoder.params.bin", "decoder.params.bin") + tuple(
        f"{g}.export.pt2" for g in ("encoder", "cross_kv", "prefill", "step_greedy", "step_beam", "filters")
    ):
        assert name in files
    for name in files:
        mine = (tmp_path / "tool" / name).read_bytes()
        if name == "timings.json":  # export seconds; no compile on the CPU
            timings = json.loads(mine)
            assert set(timings) == set(json.loads((tmp_path / "api" / name).read_bytes()))
            assert all(set(t) == {"export_s"} for t in timings.values())
        else:
            assert mine == (tmp_path / "api" / name).read_bytes(), name
    manifest = (tmp_path / "tool" / "pipeline.txt").read_text().splitlines()
    assert "beam_size 3" in manifest and "sample_len 100" in manifest


def test_tool_random_weights_from_a_registry_name(tmp_path):
    out = tmp_path / "tool"
    _tool("--model", "tiny", "--random-weights", "--out", str(out), "--device", "cpu", "--no-build", cwd=tmp_path)
    model = whisper_tpu_torch.load_model(None, dims=MODEL_DIMS["tiny"], device="cpu")
    assert model.compute_dtype == torch.bfloat16
    ref = tmp_path / "ref"
    ref.mkdir()
    export._write_params_blob(str(ref), "encoder", model.params["encoder"])
    export._write_params_blob(str(ref), "decoder", model.params["decoder"])
    for name in ("encoder.params.bin", "decoder.params.bin"):
        assert (out / name).read_bytes() == (ref / name).read_bytes(), name
    assert f"n_mels {MODEL_DIMS['tiny'].n_mels}" in (out / "pipeline.txt").read_text()
    shutil.rmtree(out)  # ~360 MB of bf16 graphs and blobs


def test_tool_flags_and_defaults(monkeypatch):
    seen = {}

    def fake_export(out, model, **kw):
        seen.update(out=out, device=model.device.type, dtype=model.compute_dtype, **kw)

    monkeypatch.setattr(export, "export_pipeline", fake_export)
    monkeypatch.setattr(whisper_tpu_torch, "load_model", lambda name, **kw: seen.update(load=(name, kw)) or _Stub())
    export_pipeline.main([
        "--checkpoint", "m.npz", "--out", "o", "--language", "de", "--task", "translate",
        "--beam-size", "4", "--sample-len", "200", "--weights", "int8", "--device", "cpu",
        "--cache-dir", "c", "--no-build",
    ])  # fmt: skip
    assert seen["load"] == ("m.npz", dict(compute_dtype=torch.bfloat16, device="cpu"))
    assert (seen["out"], seen["language"], seen["task"]) == ("o", "de", "translate")
    assert (seen["beam_size"], seen["sample_len"], seen["weights"], seen["cache_dir"]) == (4, 200, "int8", "c")
    with pytest.raises(SystemExit):
        export_pipeline.main(["--out", "o"])  # no model named
    monkeypatch.setattr(sys, "argv", ["x", "--checkpoint", "m.npz", "--out", "o", "--no-build"])
    seen.clear()
    export_pipeline.main()
    assert seen["load"][1]["device"] == "cuda"  # the card unless the CPU is asked for


class _Stub:
    device = torch.device("cpu")
    compute_dtype = torch.bfloat16
