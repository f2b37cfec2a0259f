"""The plain reference agrees with the program at tiny dims on the CPU
(both float32): its log-mel with the program's host mel, and its logits with
the served tokens of a whole run of each traffic kind."""

import os
import time

import numpy as np
import pytest
import torch

from portbench import harness, inputs, spec
from portbench.reference.whisper_f32 import Reference

DATA = os.path.join(spec.HERE, "tests", "data")


def test_mel_matches_the_program():
    from whisper_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram

    rng = np.random.default_rng(4)
    audio = inputs.synth_audio(7.3, rng, inputs.syllables(rng))
    cfg = spec.load_json(DATA, "configs", "tiny.json")
    ref = Reference(inputs.make_params(cfg, 0, "cpu", torch.float32), n_audio_head=2, n_text_head=2, n_mels=80)
    ours = ref.log_mel(audio).numpy()
    theirs = log_mel_spectrogram(audio, 80, padding=N_SAMPLES)
    assert ours.shape == theirs.shape
    assert np.abs(ours - theirs).max() < 2e-4


@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.serve"])
def test_run_agrees_with_the_reference(cell, bench_for_tiny):
    """A whole run on the CPU: the program in float32 against the float32
    reference reads both numbers near 0, under the tiny cells' limits."""
    result, numbers = harness.run(cell, 2**31 + 11, 2.0 if cell == "tiny.serve" else 0.5, False, t_start=time.perf_counter(), device="cpu", data=DATA, bench=bench_for_tiny)
    assert result["correct"] and result["failed"] == 0
    assert numbers["bad_windows"] == 0 and numbers["checked_windows"] >= 2
    assert numbers["token_gap"] == 0.0 and numbers["avg_logprob_gap"] < 1e-4
    assert set(result) == {"correct", "attempted", "failed", "metrics", "device", "check"}
    assert list(result)[-1] == "check"
    assert "setup_s" in result["metrics"]


def test_traced_run_reads_its_metrics(bench_for_tiny):
    """--trace 1 on the CPU: the window's own metrics are read, the
    device's are left out (no device kernel), and a breakdown is given."""
    result, _ = harness.run("tiny.serve", 7, 1.0, True, t_start=time.perf_counter(), device="cpu", data=DATA, bench=bench_for_tiny)
    m = result["metrics"]
    assert {"submit_ms.serve", "round_occupancy_pct.serve", "recaptures.serve", "encoder_ms_per_window.serve", "mfu_pct.serve"} <= set(m)
    # read from the device's trace: nothing to read on the CPU
    assert "device_idle_pct.serve" not in m and "decode_ms_per_step.serve" not in m
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert 0 < m["round_occupancy_pct.serve"]["value"] <= 100


@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.serve"])
def test_reference_decodes_what_the_program_serves(cell):
    """The control's decode (check.decode) is the traffic's own: the float32
    reference in the program's place decodes each sampled window to the
    tokens the program served (beam search at tiny.batch, greedy at
    tiny.serve), with the mean log-probability it reported."""
    from portbench import check

    ctx = harness.setup(cell, 2**31 + 13, 2.0 if cell == "tiny.serve" else 0.5, "cpu", data=DATA)
    rec = harness.measure(ctx, False)
    windows = check.sample(ctx, rec["window"]["served"], np.random.default_rng(0))
    assert len(windows) >= 2
    cfg = ctx.config
    ref = Reference(ctx.params, n_audio_head=cfg["encoder_attention_heads"], n_text_head=cfg["decoder_attention_heads"], n_mels=cfg["num_mel_bins"])
    tokens, avg = check.decode(ref, ctx, check._encode(ref, ctx, windows))
    assert tokens.tolist() == [w.tokens for w in windows]
    assert np.abs(avg.numpy() - [w.avg_logprob for w in windows]).max() < 1e-4
