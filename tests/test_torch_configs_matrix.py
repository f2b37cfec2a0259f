"""whisper_tpu_torch.config_matrix, the port's run of the repo's five
published configurations: its records at 2-layer stand-ins on the CPU
(computing in float32 here: the CPU's bfloat16 products would make
configuration 2's six attempts minutes long), and a failed
configuration's record and exit code."""

import json

import pytest
import torch

from whisper_tpu_torch import config_matrix
from whisper_tpu_torch.tokenizer import LANGUAGES

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

LADDER = [0.0, 0.2, 0.4, 0.6, 0.8, 1.0]


def _records(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


def test_scaled_configs_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(config_matrix, "COMPUTE_DTYPE", torch.float32)
    assert config_matrix.main(["--scaled", "--configs", "1,2", "--device", "cpu"]) == 0
    one, two = _records(capsys)
    for n, rec in ((1, one), (2, two)):
        assert rec["config"] == n and rec["ok"] and rec["name"] == config_matrix.CONFIGS[n][1]
        assert rec["scaled"] and rec["device"] == "cpu" and rec["dtype"] == "float32"
        assert rec["segments"] > 0 and rec["windows"] == 1 and rec["wall_s"] > 0
        assert rec["recaptures"] == rec["captures"] == 0  # nothing captures on the CPU
        assert rec["ms_per_token"] > 0 and rec["steps"] == 224 * rec["engine_runs"]
        assert "max_memory_allocated" not in rec
    # tiny.en greedy at T = 0 on jfk.flac: English, one attempt
    assert one["model"] == "tiny.en" and one["language"] == "en"
    assert one["temperatures"] == [0.0] and one["engine_runs"] == 1
    # base detects a language and climbs the whole ladder on random weights
    assert two["model"] == "base" and two["language"] in LANGUAGES
    assert two["temperatures"] == LADDER and two["engine_runs"] == 6


def test_scaled_dims_cut_depth_only():
    from whisper_tpu_torch.models.dims import MODEL_DIMS

    for name, _ in config_matrix.CONFIGS.values():
        full, cut = MODEL_DIMS[name], config_matrix.scaled_dims(MODEL_DIMS[name])
        assert (cut.n_audio_layer, cut.n_text_layer) == (2, 2)
        assert (cut.n_audio_state, cut.n_text_state, cut.n_vocab, cut.n_mels) == (
            full.n_audio_state, full.n_text_state, full.n_vocab, full.n_mels,
        )  # fmt: skip


def test_a_failed_config_prints_its_record_and_exits_1(capsys):
    """On a machine without a card the default device fails: the record
    says so, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid here")
    assert config_matrix.main(["--configs", "1"]) == 1
    (rec,) = _records(capsys)
    assert rec["config"] == 1 and not rec["ok"] and "CUDA is not available" in rec["error"]
    assert "segments" not in rec


def test_unknown_config_is_an_error():
    with pytest.raises(SystemExit):
        config_matrix.main(["--configs", "6", "--device", "cpu"])
