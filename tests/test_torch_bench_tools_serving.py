"""The port's batch and serving load tools (whisper_tpu_torch/
throughput_bench.py, continuous_bench.py, streaming_latency.py,
soak_server.py) against the JAX package's modules that tools/ of those
names run, float32 on the CPU with the synthetic checkpoint. The JAX tools
themselves are not imported (at import they point JAX's compile cache into
the repo and parse sys.argv): their framework-free formulas are restated
here from their source.

- throughput_bench: synth_audio is bit-equal to the JAX formula; the
  tool's keywords are the JAX tool's (beam 5, or greedy with --greedy;
  T = 0, no conditioning, gates off), and transcribe_batch under its
  --greedy keywords (two 5 s streams) and under its default beam-5
  keywords (one 3 s stream, the window cut to 24 tokens: the port's beam 5
  on the CPU takes ~20 s a full window here) gives the JAX package's text
  and segments;
- continuous_bench: the workload and the warm-up clips are bit-equal to
  the JAX formula; each ticket of a timed pass equals the JAX
  ContinuousBatcher's under the tool's options; the record has the tool's
  keys plus the engine's captures and re-captures;
- streaming_latency: partial count and final text equal the JAX
  StreamingTranscriber's over the same 1 s feeds;
- soak_server: a short soak over each transport answers every request
  with text and leaves the server and its batcher empty.

Tolerances: tokens, text and counts exactly; segment times within 1e-6 s."""

import numpy as np
import pytest
import torch

import whisper_tpu_torch
from whisper_tpu.batch import transcribe_batch as jax_transcribe_batch
from whisper_tpu.continuous import ContinuousBatcher as JaxContinuousBatcher
from whisper_tpu.streaming import StreamingTranscriber as JaxStreamingTranscriber
from whisper_tpu_torch import continuous_bench, soak_server, streaming_latency, throughput_bench

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

JAX_TOOL_KEYS = {  # the keys the JAX tools print
    "continuous": {
        "model", "slots", "requests", "audio_seconds", "rounds", "makespan_s", "aggregate_rtfx",
        "latency_mean_s", "latency_p95_s", "submit_overhead_s", "phases_s", "warm_pass", "warmup_s",
    },
    "throughput": {"metric", "value", "unit", "p50_batch_latency_s", "warmup_s", "streams"},
    "streaming": {"model", "chunks_fed", "partials", "first_partial_s", "partial_feed_p50_s", "warmup_s"},
    "soak": {
        "metric", "transport", "model", "backend", "requests", "slots", "wave", "ok", "errors", "wall_s",
        "rss_start_mb", "rss_end_mb", "rss_growth_tail_mb_per_100req", "state_empty_after_drain",
    },
}  # fmt: skip


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


def _same_segments(mine, ref):
    assert mine["text"] == ref["text"]
    assert [s["tokens"] for s in mine["segments"]] == [s["tokens"] for s in ref["segments"]]
    for a, b in zip(mine["segments"], ref["segments"]):
        assert (a["id"], a["seek"], a["text"]) == (b["id"], b["seek"], b["text"])
        assert abs(a["start"] - b["start"]) < 1e-6 and abs(a["end"] - b["end"]) < 1e-6


# ---- throughput_bench ---------------------------------------------------------


def _jax_synth_audio(seconds, seed, sr=16000):
    # tools/throughput_bench.py synth_audio
    rng = np.random.RandomState(seed)
    n = seconds * sr
    x = rng.randn(n).astype(np.float32) * 0.2
    env = 0.5 * (1 + np.sin(2 * np.pi * (2.0 + seed * 0.3) * np.arange(n) / sr))
    return (x * env).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synth_audio_is_the_tools(seed):
    a, b = throughput_bench.synth_audio(3, seed), _jax_synth_audio(3, seed)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_throughput_keywords_are_the_tools():
    kw = dict(language="en", temperature=0.0, condition_on_previous_text=False, no_speech_threshold=None,
              logprob_threshold=None, compression_ratio_threshold=None)  # fmt: skip
    assert throughput_bench.decode_kwargs(True) == kw
    assert throughput_bench.decode_kwargs(False) == dict(kw, beam_size=5)


def test_throughput_batch_matches_jax(tpu_model, torch_model):
    """Two 5 s streams at the tool's --greedy keywords: the port's
    transcribe_batch (the record's last timed call) gives the JAX package's
    text and segments; the record has the tool's keys and the port's."""
    out = throughput_bench.run(torch_model, streams=2, seconds=5, greedy=True, trials=1)
    assert JAX_TOOL_KEYS["throughput"] <= set(out)
    assert {"captures", "recaptures", "program_keys", "max_memory_allocated", "device"} <= set(out)
    assert out["metric"] == f"throughput_{torch_model.name}_2streams_greedy"
    assert out["unit"] == "aggregate_x_realtime_per_chip" and out["value"] > 0
    assert out["engine_runs"] >= 1 and out["recaptures"] == 0 and out["device"] == "cpu"
    kw = throughput_bench.decode_kwargs(True)
    ref = jax_transcribe_batch(tpu_model, [_jax_synth_audio(5, seed=i) for i in range(2)], **kw)
    assert len(out["results"]) == 2
    for mine, want in zip(out["results"], ref):
        _same_segments(mine, want)


def test_throughput_batch_matches_jax_at_beam5(tpu_model, torch_model, monkeypatch):
    """One 3 s stream at the tool's default keywords (beam 5), the window
    cut to 24 tokens to keep the CPU's beam short: the port's
    transcribe_batch gives the JAX package's text and segments."""
    tool_kwargs = throughput_bench.decode_kwargs
    monkeypatch.setattr(throughput_bench, "decode_kwargs", lambda greedy: dict(tool_kwargs(greedy), sample_len=24))
    out = throughput_bench.run(torch_model, streams=1, seconds=3, trials=1)
    assert out["metric"] == f"throughput_{torch_model.name}_1streams_bs5" and out["recaptures"] == 0
    kw = dict(tool_kwargs(False), sample_len=24)
    assert kw["beam_size"] == 5
    (ref,) = jax_transcribe_batch(tpu_model, [_jax_synth_audio(3, seed=0)], **kw)
    (mine,) = out["results"]
    _same_segments(mine, ref)


# ---- continuous_bench ---------------------------------------------------------


def _jax_workload(n_req, seed=0):
    # tools/continuous_bench.py workload
    rng = np.random.RandomState(seed)
    lengths_s = [30 if i % 2 else 60 for i in range(n_req)]
    audios = [(rng.randn(sec * 16000) * 0.1).astype(np.float32) for sec in lengths_s]
    return rng, lengths_s, audios


def test_workload_is_the_tools():
    (r1, l1, a1), (r2, l2, a2) = continuous_bench.workload(5), _jax_workload(5)
    assert l1 == l2 == [60, 30, 60, 30, 60]
    assert all(x.dtype == np.float32 and np.array_equal(x, y) for x, y in zip(a1, a2))
    # prepare_batcher's warm-up clips continue the same stream
    assert np.array_equal(r1.randn(100), r2.randn(100))


def test_continuous_tickets_match_jax(tpu_model, torch_model):
    """run_serving_bench at 2 slots, 3 requests: each ticket of its second
    timed pass equals the JAX ContinuousBatcher's under the tool's options
    on the same audio; the record has the tool's keys plus the engine's
    captures, re-captures and program keys per pass and in total."""
    out = continuous_bench.run_serving_bench(torch_model, 2, 3)
    assert JAX_TOOL_KEYS["continuous"] <= set(out)
    for rec in (out, out["warm_pass"]):
        assert {"captures", "recaptures", "program_keys"} <= set(rec)
        assert rec["recaptures"] == 0 and rec["program_keys"] >= 1
        assert set(rec["phases_s"]) == {"mel", "decode", "apply"}
    assert {"captures_total", "recaptures_total", "program_keys_total"} <= set(out)
    assert out["audio_seconds"] == 150 and out["requests"] == 3 and out["slots"] == 2

    _, _, audios = _jax_workload(3)
    cb = JaxContinuousBatcher(tpu_model, slots=2, language="en", temperature=0.0, no_speech_threshold=None,
                              condition_on_previous_text=False, sample_len=64)  # fmt: skip
    tickets = [cb.submit(a) for a in audios]
    cb.drain()
    for mine, t in zip(out["results"], tickets):
        _same_segments(mine, cb.result(t))


# ---- streaming_latency --------------------------------------------------------


def test_streaming_latency_matches_jax(tpu_model, torch_model):
    """4 s of 1 s feeds: the partials the port's tool counts and the flushed
    text equal the JAX StreamingTranscriber's over the same feeds."""
    out = streaming_latency.run(torch_model, 4)
    assert JAX_TOOL_KEYS["streaming"] <= set(out)
    audio = streaming_latency.stream_audio(4)
    assert np.array_equal(audio, (np.random.RandomState(0).randn(4 * 16000) * 0.1).astype(np.float32))
    st = JaxStreamingTranscriber(tpu_model, language="en", temperature=0.0, no_speech_threshold=None,
                                 partial_hop_s=1.0)  # fmt: skip
    partials = 0
    for i in range(4):
        partials += any(s.get("partial") for s in st.feed(audio[i * 16000 : (i + 1) * 16000]))
    st.flush()
    assert out["partials"] == partials > 0
    assert out["text"] == st.result["text"]
    assert out["first_partial_s"] > 0 and out["partial_feed_p50_s"] > 0


# ---- soak_server --------------------------------------------------------------


@pytest.mark.parametrize("http", [False, True])
def test_soak_answers_every_request_and_drains(torch_model, http):
    """6 requests in waves of 3 over 2 slots: every answer carries text,
    the RSS samples are there (no card: no device memory), and the drained
    server and batcher hold nothing."""
    out = soak_server.run(torch_model, 6, 2, 3, http=http)
    assert JAX_TOOL_KEYS["soak"] <= set(out)
    assert out["transport"] == ("http" if http else "unix-socket")
    assert (out["ok"], out["errors"]) == (6, 0)
    assert out["state_empty_after_drain"] is True
    assert out["rss_start_mb"] > 0 and out["device_mem_start_mb"] is None
    assert out["backend"] == "cpu"


def test_soak_tail_slope():
    """The tail fit leaves out the first third and needs three samples."""
    assert soak_server.tail_slope_per_100([(4, 1.0), (8, 2.0)]) is None
    samples = [(4, 100.0), (8, 90.0), (12, 10.0), (16, 10.5), (20, 11.0), (24, 11.5)]
    assert soak_server.tail_slope_per_100(samples) == pytest.approx(12.5)


def test_soak_synthetic_model_is_the_tools():
    m = soak_server.synthetic_model("cpu")
    assert m.name == "synthetic-tiny" and m.compute_dtype == torch.float32
    d = m.dims
    assert (d.n_mels, d.n_audio_state, d.n_audio_layer, d.n_text_state, d.n_text_layer, d.n_vocab) == (
        80, 128, 2, 128, 2, 51865,
    )  # fmt: skip
