"""The port's sharded-serving bench (whisper_tpu_torch/serve_bench.py)
against the JAX package's FusedEngine, float32 on the CPU with the
synthetic checkpoint, and every load and latency tool's command line.

- serve_bench: --virtual 2 (two gloo ranks, at tp 2 and at dp 2) gives
  the single-device engine's tokens and the JAX FusedEngine's on the same
  mel under the JAX tool's keywords; one rank in the command's own process
  over gloo prints the tool's keys; a --tp that does not divide the world
  raises before any rank starts;
- every tool: main() parses the JAX tool's arguments, its environment
  switches turned into options, and without --device it runs on the card
  (here, without one, that is an error before any work).

Tolerances: tokens exactly."""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from whisper_tpu.engine_fused import FusedEngine as JaxFusedEngine
from whisper_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from whisper_tpu_torch import serve_bench, tool_common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 16

TOOLS = [
    "throughput_bench", "continuous_bench", "streaming_latency", "soak_server", "spec_bench", "graph_bench",
    "trace_ops", "serve_bench",
]  # fmt: skip


def _opts(checkpoint, **kw):
    return dict(dict(model=checkpoint, compute_dtype="float32", device_type="cpu", dp=None, tp=2, streams=2,
                     beam=5, steps=STEPS, trials=1, skip_single=False), **kw)  # fmt: skip


@pytest.fixture(scope="module")
def jax_tokens(tpu_model):
    """The JAX FusedEngine's tokens on the tool's mel (2 streams) under the
    JAX tool's keywords."""
    tok = jax_get_tokenizer(True, language="en", task="transcribe")
    mel = (np.random.RandomState(0).randn(2, 80, 3000) * 0.5).astype(np.float32)
    ck, cv = tpu_model.cross_kv(tpu_model.encode(mel))
    init = np.tile(np.array([list(tok.sot_sequence)], np.int32), (2, 1))
    kw = dict(
        sot_index=0, suppress_ids=[tok.eot], blank_ids=tok.encode(" ") + [tok.eot],
        max_initial_ts_index=50, sample_len=STEPS, n_group=5, beam_search=True, max_candidates=5,
        use_timestamps=True, temperature=0.0, eot=tok.eot, timestamp_begin=tok.timestamp_begin,
        no_timestamps=tok.no_timestamps, no_speech=tok.no_speech,
    )  # fmt: skip
    out = JaxFusedEngine(tpu_model).run(init, ck, cv, **kw)
    return np.asarray(out[0])[:, : int(out[1])], kw


def test_mel_and_keywords_are_the_tools(jax_tokens):
    from whisper_tpu_torch.tokenizer import get_tokenizer

    mel = serve_bench.mel_batch(2, 80)
    assert np.array_equal(mel, (np.random.RandomState(0).randn(2, 80, 3000) * 0.5).astype(np.float32))
    tok = get_tokenizer(True, language="en", task="transcribe")
    assert tool_common.beam_kwargs(tok, 5, STEPS) == jax_tokens[1]


@pytest.mark.parametrize("dp, tp", [(1, 2), (2, 1)])
def test_virtual_world_matches_single_and_jax(synth_checkpoint, jax_tokens, dp, tp):
    """Two gloo ranks on the CPU: the sharded engine's tokens equal the
    single-device engine's and the JAX FusedEngine's; the record has the
    tool's keys (the body runs uncaptured over gloo)."""
    out = serve_bench.launch(_opts(synth_checkpoint, tp=tp), virtual=2)
    keys = {"metric", "platform", "streams", "steps", "sharded_decode_s", "sharded_ms_per_step",
            "aggregate_x_realtime", "single_device_decode_s", "sharding_overhead_x"}  # fmt: skip
    assert keys <= set(out)
    assert out["metric"] == f"serve_{synth_checkpoint}_dp{dp}_tp{tp}_2streams_bs5"
    assert (out["world"], out["backend"], out["platform"], out["sharded_captured"]) == (2, "gloo", "cpu", False)
    assert out["tokens_equal_single"] is True
    assert np.array_equal(out["tokens"]["sharded"], out["tokens"]["single"])
    assert np.array_equal(out["tokens"]["sharded"], jax_tokens[0])


def test_one_rank_in_process(synth_checkpoint):
    """No --virtual and no torchrun: one rank in the command's own process
    (gloo with --device cpu), which prints the record."""
    out = subprocess.run(
        [sys.executable, "-m", "whisper_tpu_torch.serve_bench", "--device", "cpu", "--tp", "1", "--model",
         synth_checkpoint, "--steps", "4", "--trials", "1", "--streams", "1", "--skip-single"],
        capture_output=True, text=True, cwd=ROOT, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"),
    )  # fmt: skip
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert (rec["world"], rec["backend"], rec["streams"], rec["steps"]) == (1, "gloo", 1, 4)
    assert "single_device_decode_s" not in rec and "tokens" not in rec


@pytest.mark.parametrize("argv", [["--device", "cpu"], ["--device", "cpu", "--tp", "3"], ["--virtual", "3"]])
def test_tp_that_does_not_divide_the_world_raises(argv):
    """The JAX default --tp 2 at one rank, tp 3 at one, tp 2 over three
    virtual ranks: a clear error, before any rank starts."""
    with pytest.raises(ValueError, match="does not divide the world"):
        serve_bench.main(argv)


# ---- every tool's command line ------------------------------------------------

OPTIONS = {  # the JAX tool's arguments, environment switches as options
    "throughput_bench": ["--model", "--streams", "--seconds", "--greedy", "--trials"],
    "continuous_bench": ["slots", "n_requests", "--model"],  # BENCH_MODEL
    "streaming_latency": ["seconds", "--model"],  # BENCH_MODEL
    "soak_server": ["requests", "slots", "--wave", "--http", "--model"],  # SOAK_WAVE, SOAK_HTTP, SOAK_MODEL
    "spec_bench": ["ks", "--target", "--draft"],  # SPEC_TARGET, SPEC_DRAFT
    "graph_bench": ["--model", "--beam", "--trials", "--steps", "--greedy", "--no-timestamps", "--peak-tflops",
                    "--peak-gbs"],  # fmt: skip
    "trace_ops": ["model", "n_iters", "--what"],  # TRACE_WHAT
    "serve_bench": ["--model", "--dp", "--tp", "--virtual", "--streams", "--beam", "--steps", "--trials",
                    "--skip-single"],  # fmt: skip
}


@pytest.mark.parametrize("tool", TOOLS)
def test_main_parses_the_tools_options(tool, capsys):
    main = importlib.import_module(f"whisper_tpu_torch.{tool}").main
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    text = capsys.readouterr().out
    for opt in OPTIONS[tool] + ["--device"]:
        assert opt in text, (tool, opt)
    assert "default: the card" in text or "cuda" in text


@pytest.mark.parametrize("tool", TOOLS)
def test_main_runs_on_the_card_by_default(tool):
    """Without --device each tool builds its model on the card: without one
    that is an error, raised before any work."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid here")
    main = importlib.import_module(f"whisper_tpu_torch.{tool}").main
    argv = ["--tp", "1"] if tool == "serve_bench" else []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
