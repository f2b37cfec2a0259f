"""The port's real-weight drill (whisper_tpu_torch/validate_real.py) on the
contract of the JAX drill (tests/test_eval_wer.py): offline every section
reports a clean skip, the exit code is 0 and the report is written; and its
speculative-acceptance section, on the synthetic checkpoint with a draft
of the same dims at 0.9 of its weights' scale, equals tools/validate_real.py's
on the same checkpoints at float32 on the CPU: the per-window acceptance
and rounds at K = 4 and 8 exactly."""

import functools
import json
import os
import sys

import pytest
import torch

from whisper_tpu_torch import validate_real

TOOLS = os.path.join(os.path.dirname(__file__), os.pardir, "tools")
sys.path.insert(0, TOOLS)

torch.set_num_threads(1)

SECTIONS = ("e2e_tests", "wer", "longform", "int8_wer_delta", "speculative_acceptance")


@pytest.fixture
def empty_cache(tmp_path, monkeypatch):
    """The registry's cache an empty directory, and a network probe that
    says no without contacting anything (its calls counted)."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    probes = []
    monkeypatch.setattr(validate_real, "network_up", lambda *a, **k: probes.append(a) or False)
    return probes


@pytest.mark.parametrize("offline", [False, True], ids=["probed", "offline"])
def test_offline_every_section_skips(empty_cache, tmp_path, capsys, offline):
    out_path = tmp_path / "report.json"
    argv = ["--out", str(out_path), "--librispeech", str(tmp_path / "no_such_split"), "--draft", "d"]
    rc = validate_real.main(argv + (["--offline"] if offline else []))
    assert rc == 0
    assert len(empty_cache) == (0 if offline else 1)  # --offline never probes
    report = json.loads(out_path.read_text())
    assert json.loads(capsys.readouterr().out) == report
    assert report["network"] is False and report["device"] == "cuda"
    assert report["checkpoints"] == {
        m: {"status": "skipped", "reason": "no network and not cached"} for m in ("tiny.en", "turbo")
    }
    for section in SECTIONS:
        assert report[section]["status"] == "skipped" and report[section]["reason"], (section, report[section])
    assert report["longform"]["reason"] == "tiny.en not cached"


def test_sections_skip_for_their_own_reasons(empty_cache, monkeypatch, tmp_path):
    """With a checkpoint cached the WER sections skip only for the missing
    split, and the acceptance section for the missing draft."""
    monkeypatch.setattr(validate_real, "cached", lambda name: True)
    assert validate_real.run_wer("", "tiny.en", 5)["reason"].startswith("no --librispeech path")
    assert validate_real.run_wer(str(tmp_path / "x"), "tiny.en", 5)["reason"].endswith("not found")
    assert validate_real.run_wer_int8_delta("", "tiny.en", 5)["status"] == "skipped"
    assert validate_real.run_spec_acceptance("tiny.en", "")["reason"].startswith("no --draft")
    missing = str(tmp_path / "draft")
    assert validate_real.run_spec_acceptance("tiny.en", missing) == {"status": "skipped", "reason": f"{missing} not found"}


def test_failed_section_fails_the_drill(empty_cache, monkeypatch, tmp_path):
    monkeypatch.setattr(validate_real, "run_longform", lambda *a: {"status": "failed", "problems": ["x"]})
    assert validate_real.main(["--offline", "--out", str(tmp_path / "r.json")]) == 1
    assert json.loads((tmp_path / "r.json").read_text())["longform"]["status"] == "failed"


def test_spec_acceptance_matches_the_tool(synth_checkpoint, tmp_path, monkeypatch):
    from oracle import save_reference_checkpoint

    import validate_real as jax_validate_real
    import whisper_tpu
    from whisper_tpu.models.dims import ModelDimensions as JaxDims

    dims = JaxDims(80, 1500, 128, 2, 2, 51865, 448, 128, 2, 2)  # tests/conftest.py's tiny_dims
    draft = save_reference_checkpoint(str(tmp_path / "draft.pt"), dims, seed=11, scale=0.45)
    monkeypatch.setattr(validate_real, "cached", lambda name: True)
    monkeypatch.setattr(jax_validate_real, "cached", lambda name: True)
    # the JAX drill loads at its default bfloat16: float32 here, as the port's
    monkeypatch.setattr(whisper_tpu, "load_model", functools.partial(whisper_tpu.load_model, compute_dtype="float32"))
    want = jax_validate_real.run_spec_acceptance(synth_checkpoint, draft)
    got = validate_real.run_spec_acceptance(synth_checkpoint, draft, device="cpu", dtype="float32")
    assert got["status"] == want["status"] == "ok"
    for k in ("k4", "k8"):
        assert got[k]["acceptance"] == want[k]["acceptance"]
        assert got[k]["rounds"] == want[k]["rounds"]
        assert len(got[k]["acceptance"]) == 3 and got[k]["seconds"] > 0 and got[k]["speedup_vs_plain"] > 0
        assert all(0.0 < a < 1.0 for a in got[k]["acceptance"])  # some drafts accepted, some not
    assert got["plain_seconds"] > 0
