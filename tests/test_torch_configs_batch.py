"""Four streams through transcribe_batch at beam 5, T = 0, at the large-v3
layout (V = 51866, 128 mels, timestamps from 50365): configuration 5 of
whisper_tpu_torch.config_matrix at 2 layers and width 128, the port
against the JAX package on one synthetic checkpoint in float32. A round
decodes the four streams' windows as one 20-row beam search (A = 4,
G = 5) on the engine's loop body."""

import numpy as np
import pytest
import torch

import whisper_tpu
import whisper_tpu_torch
from whisper_tpu_torch import engine
from whisper_tpu_torch.config_matrix import synth_speech

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def v3_checkpoint(tmp_path_factory):
    from oracle import save_reference_checkpoint
    from whisper_tpu.models.dims import ModelDimensions

    dims = ModelDimensions(128, 1500, 128, 2, 2, 51866, 448, 128, 2, 2)
    path = tmp_path_factory.mktemp("v3") / "synth_v3.pt"
    return save_reference_checkpoint(str(path), dims, seed=31, scale=0.5)


def test_four_stream_beam5_batch_matches_jax(v3_checkpoint):
    from whisper_tpu.batch import transcribe_batch as jax_batch

    jax_model = whisper_tpu.load_model(v3_checkpoint, compute_dtype="float32")
    model = whisper_tpu_torch.load_model(v3_checkpoint, device="cpu", compute_dtype=torch.float32)
    streams = [synth_speech(10.0, seed=s) for s in range(4)]
    # 140 tokens a row cross the loop's 128-slot phase edge; random weights
    # never emit EOT, and the full 224 would double the file's time
    kw = dict(language="en", beam_size=5, temperature=0.0, sample_len=140)
    ref = jax_batch(jax_model, streams, **kw)
    history = engine.model_engine(model).history
    history.clear()
    mine = whisper_tpu_torch.transcribe_batch(model, streams, **kw)
    assert len(mine) == len(ref) == 4
    for i, (m, r) in enumerate(zip(mine, ref)):
        assert m["text"] == r["text"], i
        assert len(m["segments"]) == len(r["segments"]) > 0, i
        for a, b in zip(m["segments"], r["segments"]):
            assert a["tokens"] == b["tokens"], i
            for key in ("id", "seek", "temperature", "text"):
                assert a[key] == b[key], (i, key)
            for key in ("start", "end"):
                assert abs(a[key] - b[key]) <= 1e-6, (i, key)
            assert abs(a["avg_logprob"] - b["avg_logprob"]) < 1e-4, i
    # the streams' first windows went through one 20-row beam search
    first = history[0]
    assert first.beam_search and first.loop == "program" and first.program[:2] == (4, 5)
    assert first.program[3] == 256 and first.steps == 140
