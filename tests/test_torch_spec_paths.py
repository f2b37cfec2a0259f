"""The port's product paths with a draft model (Whisper.set_draft_model):
decode(), transcribe() and the ContinuousBatcher give the plain engine's
results, beam search ignores the draft, set_draft_model validates, the CLI
wires --weights and --draft_model, and encode_clip_spec gives both models'
cross-K/V (the integration half of tests/test_speculative.py and
tests/test_continuous.py's draft case, held in the port). float32 on the
CPU, the synthetic checkpoint; the draft is the JAX package's random draft
of tests/test_speculative.py, carried over by its numpy weights."""

import numpy as np
import pytest
import torch

import whisper_tpu_torch
from whisper_tpu.models import Whisper as JaxWhisper
from whisper_tpu.models.dims import ModelDimensions as JaxDims
from whisper_tpu_torch import frontend
from whisper_tpu_torch.continuous import ContinuousBatcher
from whisper_tpu_torch.decoding import DecodingOptions, decode
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
def mel():
    return (np.random.RandomState(7).randn(80, 3000) * 0.6).astype(np.float32)


@pytest.fixture(scope="module")
def draft_model():
    jax_draft = JaxWhisper(JaxDims(**DRAFT_DIMS), params=None, name="spec-draft", compute_dtype="float32")
    return whisper_tpu_torch.Whisper(
        ModelDimensions(**DRAFT_DIMS), params_from_jax(jax_draft.params), device="cpu",
        compute_dtype=torch.float32,
    )  # fmt: skip


def test_decode_with_draft_matches_plain(torch_model, draft_model, mel):
    opts = DecodingOptions(language="en", temperature=0.0, sample_len=30)
    plain = decode(torch_model, mel, opts)
    torch_model.set_draft_model(draft_model, k=4)
    try:
        spec = decode(torch_model, mel, opts)
        assert torch_model._spec_engine is not None and torch_model._spec_engine.history
    finally:
        torch_model.set_draft_model(None)
    assert spec.tokens == plain.tokens and spec.text == plain.text
    assert abs(spec.avg_logprob - plain.avg_logprob) < 1e-3
    assert abs(spec.no_speech_prob - plain.no_speech_prob) < 1e-4


def test_decode_beam_ignores_draft(torch_model, draft_model, mel):
    opts = DecodingOptions(language="en", beam_size=2, sample_len=16)
    torch_model.set_draft_model(draft_model, k=4)
    try:
        with_draft = decode(torch_model, mel, opts)
        assert torch_model._spec_engine is None  # never built
    finally:
        torch_model.set_draft_model(None)
    assert with_draft.tokens == decode(torch_model, mel, opts).tokens


def test_transcribe_with_draft_matches_plain(torch_model, draft_model, jfk_audio):
    """The seek rules and the fallback ladder over the speculative engine:
    equal text and segment tokens (the t > 0 retries run the plain engine
    and draw the same seeds)."""
    np.random.seed(3)
    plain = torch_model.transcribe(jfk_audio, language="en", verbose=None)
    torch_model.set_draft_model(draft_model, k=4)
    try:
        np.random.seed(3)
        spec = torch_model.transcribe(jfk_audio, language="en", verbose=None)
    finally:
        torch_model.set_draft_model(None)
    assert spec["text"] == plain["text"]
    assert [s["tokens"] for s in spec["segments"]] == [s["tokens"] for s in plain["segments"]]


def test_continuous_with_draft_matches_plain(torch_model, draft_model, jfk_audio):
    def run():
        cb = ContinuousBatcher(torch_model, slots=2, language="en", temperature=0.0)
        t1 = cb.submit(jfk_audio)
        t2 = cb.submit(jfk_audio[16000 * 2 :])
        cb.drain()
        return [cb.result(t) for t in (t1, t2)]

    plain = run()
    torch_model.set_draft_model(draft_model, k=4)
    try:
        spec = run()
        assert torch_model._spec_engine.history  # the rounds went through it
    finally:
        torch_model.set_draft_model(None)
    for a, b in zip(spec, plain):
        assert a["text"] == b["text"]
        assert [s["tokens"] for s in a["segments"]] == [s["tokens"] for s in b["segments"]]


def test_set_draft_model_validation(torch_model, draft_model):
    wrong_mels = whisper_tpu_torch.Whisper(
        ModelDimensions(**dict(DRAFT_DIMS, n_mels=128)), device="cpu", compute_dtype=torch.float32
    )
    torch_model.set_draft_model(draft_model, k=3)
    try:
        with pytest.raises(ValueError, match="n_mels"):
            torch_model.set_draft_model(wrong_mels)
        assert torch_model.draft_model is draft_model and torch_model.draft_k == 3
        assert "draft_model" not in dict(torch_model.named_modules())  # not a submodule
    finally:
        torch_model.set_draft_model(None)  # clearing always works
    assert torch_model.draft_model is None and torch_model._spec_engine is None


def test_one_engine_per_model_and_mode(torch_model, draft_model, mel):
    """"bf16" and "" name one mode, so switching between them keeps the
    model's engine; a run with int8 weights and a draft quantizes each
    decoder once: the speculative engine reads the models' own cached
    engines."""
    from whisper_tpu_torch.engine import model_engine
    from whisper_tpu_torch.quant import check_weights_mode

    assert check_weights_mode("bf16") == check_weights_mode("") == ""
    opts = DecodingOptions(language="en", temperature=0.0, sample_len=8)
    torch_model.decode_weights = ""
    decode(torch_model, mel, opts)
    plain = torch_model._fused_engine
    torch_model.decode_weights = "bf16"
    try:
        decode(torch_model, mel, opts)
        assert torch_model._fused_engine is plain and model_engine(torch_model, "bf16") is plain
        torch_model.decode_weights = "int8"
        torch_model.set_draft_model(draft_model, k=2)
        decode(torch_model, mel, opts)
        spec = torch_model._spec_engine
        assert spec.weights == "int8" and spec._target is torch_model._fused_engine
        assert spec._draft is draft_model._fused_engine and spec._draft.weights == "int8"
    finally:
        torch_model.set_draft_model(None)
        torch_model.decode_weights = ""


def test_encode_clip_spec(torch_model, draft_model, jfk_audio):
    ck, cv, dck, dcv, n = frontend.encode_clip_spec(torch_model, draft_model, jfk_audio)
    want = frontend.encode_clip(draft_model, jfk_audio)
    assert n == want[2] == 1
    assert torch.equal(dck, want[0]) and torch.equal(dcv, want[1])
    assert torch.equal(ck, frontend.encode_clip(torch_model, jfk_audio)[0])
    assert tuple(dck.shape) == (1, 1, 1, 64, 1500)


def test_cli_wires_weights_and_draft(monkeypatch, tmp_path, synth_checkpoint, jfk_flac_path):
    """--weights int8 reaches the model's decode_weights, --draft_model and
    --draft_k its draft, loaded on the same device and dtype."""
    import sys

    from whisper_tpu_torch import cli
    from whisper_tpu_torch.models.whisper import Whisper

    seen = []

    def transcribe(self, audio, **kw):
        seen.append((self.decode_weights, self.draft_model, self.draft_k, self.device))
        raise RuntimeError("stop after the model is set up")

    monkeypatch.setattr(Whisper, "transcribe", transcribe)
    monkeypatch.setattr(sys, "argv", [
        "whisper-tpu-torch", jfk_flac_path, "--model", synth_checkpoint, "--device", "cpu",
        "--compute_dtype", "float32", "--weights", "int8", "--draft_model", synth_checkpoint,
        "--draft_k", "3", "--output_dir", str(tmp_path),
    ])  # fmt: skip
    cli.cli()
    (weights, draft, k, device), = seen
    assert weights == "int8" and k == 3 and device.type == "cpu"
    assert draft.device.type == "cpu" and draft.compute_dtype == torch.float32


@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_servers_take_weights(synth_checkpoint, weights):
    """The servers' shared arguments carry --weights to the model they load
    (the JAX servers' WHISPER_TPU_WEIGHTS switch, as an argument)."""
    from whisper_tpu_torch import server

    seen = []

    class Stop(Exception):
        pass

    def make_server(model, args, kw):
        seen.append(model.decode_weights)
        raise Stop

    argv = ["--model", synth_checkpoint, "--device", "cpu", "--weights", weights]
    with pytest.raises(Stop):
        server.serve_main(argv, "test", lambda p: None, make_server)
    assert seen == [{"bf16": "", "int8": "int8"}[weights]]  # the canonical mode
