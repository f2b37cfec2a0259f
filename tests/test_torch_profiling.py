"""The port's profiling.py against the JAX package's: the same call gives the
same span names, the same steady-state counts and one first call per name
(the engine, the host loop, language detection, word timestamps and a draft
model); report() rows, maybe_block, trace(), the CLI's report and thread
safety. float32 on the CPU, the synthetic checkpoint."""

import sys
import threading

import numpy as np
import pytest
import torch

import whisper_tpu_torch
from whisper_tpu import profiling as jax_profiling
from whisper_tpu.models import Whisper as JaxWhisper
from whisper_tpu.models.dims import ModelDimensions as JaxDims
from whisper_tpu_torch import frontend, profiling
from whisper_tpu_torch.models.dims import ModelDimensions
from whisper_tpu_torch.models.params import params_from_jax

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

DRAFT_DIMS = dict(
    n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=1, n_audio_layer=1,
    n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=1, n_text_layer=1,
)  # fmt: skip


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def drafts():
    """The same random draft in both packages."""
    jax_draft = JaxWhisper(JaxDims(**DRAFT_DIMS), params=None, name="draft", compute_dtype="float32")
    port_draft = whisper_tpu_torch.Whisper(
        ModelDimensions(**DRAFT_DIMS), params_from_jax(jax_draft.params), device="cpu",
        compute_dtype=torch.float32,
    )  # fmt: skip
    return jax_draft, port_draft


@pytest.fixture(autouse=True)
def clean_profiling():
    jax_profiling.reset()
    profiling.reset()
    yield
    profiling.set_sync(False)
    jax_profiling.reset()
    profiling.reset()


def _counts(module):
    """{name: steady calls}, after checking one first call per name."""
    summary = module.summary()
    assert all(s["first_call_s"] > 0.0 for s in summary.values()), summary
    return {name: s["steady_calls"] for name, s in summary.items()}


CASES = {
    "greedy-engine": dict(beam_size=None),
    "beam5-engine": dict(beam_size=5),
    "greedy-host-loop": dict(beam_size=None, host_loop=True),
    "beam5-host-loop": dict(beam_size=5, host_loop=True),
    "detect-language": dict(beam_size=None, language=None),
    "word-timestamps": dict(beam_size=None, word_timestamps=True),
    "draft": dict(beam_size=None, draft=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_summary_matches_jax(tpu_model, torch_model, drafts, jfk_audio, monkeypatch, case):
    kw = dict(CASES[case])
    host_loop = kw.pop("host_loop", False)
    draft = kw.pop("draft", False)
    kw.setdefault("language", "en")
    monkeypatch.setattr(tpu_model, "use_fused_decode", not host_loop, raising=False)
    monkeypatch.setattr(torch_model, "use_fused_decode", not host_loop)
    if draft:
        tpu_model.set_draft_model(drafts[0], k=4)
        torch_model.set_draft_model(drafts[1], k=4)
    try:
        ref = tpu_model.transcribe(jfk_audio, temperature=0.0, verbose=None, **kw)
        mine = torch_model.transcribe(jfk_audio, temperature=0.0, verbose=None, **kw)
    finally:
        tpu_model.set_draft_model(None)
        torch_model.set_draft_model(None)
    assert mine["text"] == ref["text"]
    want = _counts(jax_profiling)
    assert _counts(profiling) == want
    spans = {"fused_decode_spec" if draft else "fused_decode"} if not host_loop else {"decode_step"}
    assert spans <= set(want) and "encoder" in want


def test_encode_with_cross_kv_is_one_encoder_span_and_encode_clip_none(torch_model, tpu_model):
    mel = (np.random.RandomState(5).randn(1, 80, 3000) * 0.5).astype(np.float32)
    for _ in range(2):
        torch_model.encode_with_cross_kv(mel)
        tpu_model.encode_with_cross_kv(mel)
    assert _counts(profiling) == _counts(jax_profiling) == {"encoder": 1}
    profiling.reset()
    frontend.encode_clip(torch_model, np.zeros(16000, np.float32))
    assert profiling.summary() == {}


def test_report_rows(torch_model):
    mel = np.zeros((1, 80, 3000), np.float32)
    for _ in range(3):
        xa = torch_model.encode(mel)
    torch_model.cross_kv(xa)
    lines = profiling.report().splitlines()
    assert lines[0].split() == ["graph", "first(s)", "calls", "total(s)", "mean(ms)"]
    summary = profiling.summary()
    assert [line.split()[0] for line in lines[1:]] == sorted(summary) == ["cross_kv", "encoder"]
    for line in lines[1:]:
        name, first, calls, total, mean = line.split()
        s = summary[name]
        assert float(first) == round(s["first_call_s"], 3)
        assert int(calls) == s["steady_calls"] == {"encoder": 2, "cross_kv": 0}[name]
        assert float(total) == round(s["steady_total_s"], 3)
        assert float(mean) == round(s["steady_mean_ms"], 2)


def test_disabled_records_nothing(torch_model, monkeypatch):
    monkeypatch.setattr(profiling, "enabled", False)
    torch_model.encode(np.zeros((1, 80, 3000), np.float32))
    profiling.record("x", 1.0)
    assert profiling.summary() == {}


def test_maybe_block_is_a_no_op_on_cpu_tensors(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("synchronized for a CPU tensor")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    x = torch.ones(3)
    for on in (False, True):
        profiling.set_sync(on)
        assert profiling.sync_for_timing is on
        assert profiling.maybe_block(x) is x
        pair = (x, x)
        assert profiling.maybe_block(pair) is pair
        assert profiling.maybe_block(None) is None


@pytest.mark.cuda
def test_maybe_block_waits_for_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    x = torch.ones(3, device="cuda")
    profiling.set_sync(False)
    profiling.maybe_block(x)
    assert calls == []
    profiling.set_sync(True)
    profiling.maybe_block((x, None))
    assert calls == [x.device]


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").iterdir())
    assert [f.name for f in files] == ["trace.json"] and files[0].stat().st_size > 0
    assert '"traceEvents"' in files[0].read_text()


def test_cli_prints_the_report(synth_checkpoint, jfk_flac_path, tmp_path, monkeypatch, capsys):
    from whisper_tpu_torch import cli

    model = whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)
    whisper_tpu_torch.save_model(model, str(tmp_path / "tiny.npz"))
    monkeypatch.setattr(
        sys, "argv",
        ["whisper-tpu-torch", jfk_flac_path, "--model", str(tmp_path / "tiny.npz"), "--device", "cpu",
         "--compute_dtype", "float32", "--language", "en", "--temperature", "0",
         "--temperature_increment_on_fallback", "None", "--beam_size", "None", "--verbose", "False",
         "--profile_sync", "True", "--output_format", "txt", "--output_dir", str(tmp_path / "out")],
    )  # fmt: skip
    cli.cli()
    assert profiling.sync_for_timing is True
    out = capsys.readouterr().out
    assert profiling.REPORT_HEADER in out
    rows = out.split(profiling.REPORT_HEADER, 1)[1].splitlines()[2:]
    assert {row.split()[0] for row in rows} == {"encoder", "fused_decode"}


def test_record_from_four_threads_sums_exactly():
    n = 2000
    barrier = threading.Barrier(4)

    def work():
        barrier.wait()
        for _ in range(n):
            profiling.record("span", 0.25)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    s = profiling.summary()["span"]
    assert s["first_call_s"] == 0.25
    assert s["steady_calls"] == 4 * n - 1
    assert s["steady_total_s"] == 0.25 * (4 * n - 1)
