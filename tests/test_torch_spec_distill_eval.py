"""The port's distilled-draft evaluation (whisper_tpu_torch/spec_distill_eval.py)
against the parts of the JAX package that tools/spec_distill_eval.py runs,
float32 on the CPU with the synthetic checkpoint as the target and a
1-layer, 64-wide student (the tool itself is not imported: at import it
points JAX's persistent compile cache into the repo).

- the teacher-path labels of 2 clips equal the JAX FusedEngine's tokens
  under the tool's decode options (its whole-clip frontend, encode_clip);
- the label manifest (token ids, mel_padding) distills to the JAX
  run_distill's loss history;
- the port's SpeculativeEngine with the port-distilled draft, and with the
  random control draft, gives the JAX SpeculativeEngine's tokens and
  last_stats (draft_acceptance, rounds) when the draft's weights are
  carried across;
- main() at tiny dims prints the tool's keys;
- a cached manifest or draft is reused only by a run with the same inputs:
  other clips, another compute dtype, other training records or other
  distill options make a new one.

Tolerances: tokens and last_stats exactly; summed log-probabilities 2e-3
absolute (tests/test_torch_speculative.py's); the loss history rtol 1e-4,
atol 1e-5 (tests/test_torch_distill.py's)."""

import json

import numpy as np
import pytest
import torch

import whisper_tpu_torch
from whisper_tpu.distill import run_distill as jax_run_distill
from whisper_tpu.engine_fused import FusedEngine as JaxFusedEngine
from whisper_tpu.frontend import encode_clip as jax_encode_clip
from whisper_tpu.models import Whisper as JaxWhisper
from whisper_tpu.models.dims import ModelDimensions as JaxDims
from whisper_tpu.speculative import SpeculativeEngine as JaxSpeculativeEngine
from whisper_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from whisper_tpu_torch import spec_distill_eval as sde
from whisper_tpu_torch.distill import run_distill
from whisper_tpu_torch.frontend import encode_clip_spec
from whisper_tpu_torch.models.dims import MODEL_DIMS, ModelDimensions
from whisper_tpu_torch.models.params import map_tree
from whisper_tpu_torch.speculative import SpeculativeEngine

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

STUDENT = dict(
    n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=1, n_audio_layer=1,
    n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=1, n_text_layer=1,
)  # fmt: skip
CLIPS = 2
SAMPLE_LEN = 40  # the tool's 96 cut for the CPU; the options are otherwise its own
DISTILL = dict(steps=2, batch_size=2, learning_rate=1e-3, max_tokens=48)


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("spec_distill"))


@pytest.fixture(scope="module")
def manifest(torch_model, workdir):
    return sde.label_clips(torch_model, workdir, CLIPS, SAMPLE_LEN, log=lambda *_: None)


@pytest.fixture(scope="module")
def distilled(torch_model, manifest, workdir):
    """The port's run_distill over the label manifest: (its history, the
    student loaded from its directory)."""
    out_dir = f"{workdir}/draft"
    history = run_distill(torch_model, ModelDimensions(**STUDENT), manifest, out_dir=out_dir,
                          log=lambda *_: None, **DISTILL)  # fmt: skip
    return history, whisper_tpu_torch.load_model(out_dir, device="cpu", compute_dtype=torch.float32)


def _jax_kwargs():
    """The tool's decode_kw (its 99-language tokenizer is the synthetic
    checkpoint's)."""
    tok = jax_get_tokenizer(True, language="en", task="transcribe")
    kw = dict(
        sot_index=0, suppress_ids=[tok.eot], blank_ids=tok.encode(" ") + [tok.eot],
        max_initial_ts_index=50, sample_len=SAMPLE_LEN, use_timestamps=False, temperature=0.0,
        eot=tok.eot, timestamp_begin=tok.timestamp_begin, no_timestamps=tok.no_timestamps,
        no_speech=tok.no_speech,
    )  # fmt: skip
    return np.array([list(tok.sot_sequence_including_notimestamps)], np.int32), kw


def _to_jax(model):
    """A port model's weights in the JAX package (float32 numpy leaves)."""
    dims = JaxDims(**model.dims.__dict__)
    return JaxWhisper(dims, params=map_tree(model.params, lambda _, v: v.numpy()), compute_dtype="float32")


def test_decode_options_are_the_tools(torch_model):
    initial, kw = _jax_kwargs()
    tok = sde.eval_tokenizer(torch_model)
    assert np.array_equal(sde.initial_tokens(tok), initial)
    assert sde.decode_kwargs(tok, SAMPLE_LEN) == kw


def test_teacher_path_labels_match_jax(tpu_model, manifest):
    """Each clip's label is the JAX FusedEngine's greedy path on the clip's
    int16 samples (the tool's pad_pcm), EOT suppressed: SAMPLE_LEN tokens."""
    initial, kw = _jax_kwargs()
    engine = JaxFusedEngine(tpu_model)
    for i, rec in enumerate(manifest):
        audio = sde.synth_speech(sde.TRAIN_SEED + i)
        ck, cv, n = jax_encode_clip(tpu_model, sde.pcm16(audio))
        assert n == 1
        out = engine.run(initial, ck, cv, n_group=1, beam_search=False, max_candidates=0, **kw)
        want = [int(t) for t in np.asarray(out[0])[0, initial.shape[1] : int(out[1])]]
        assert rec["tokens"] == want and len(want) == SAMPLE_LEN
        assert rec["mel_padding"] == 30 * sde.SR and rec["audio"].endswith(f"clip{i:03d}.wav")
        # the WAV holds the samples the labels were made from
        wav = whisper_tpu_torch.load_audio(rec["audio"])
        assert np.array_equal(wav, sde.pcm16(audio))


def test_label_manifest_distills_like_jax(tpu_model, manifest, distilled, workdir):
    """The token-labeled records (ids, mel_padding) train the same student
    in both packages: equal loss histories."""
    want = jax_run_distill(tpu_model, JaxDims(**STUDENT), manifest, out_dir=f"{workdir}/jax_draft",
                           log=lambda *_: None, **DISTILL)  # fmt: skip
    np.testing.assert_allclose(distilled[0], want, rtol=1e-4, atol=1e-5)
    assert np.isfinite(distilled[0]).all()


@pytest.mark.parametrize("kind", ["distilled", "random"])
def test_spec_with_eval_drafts_matches_jax(tpu_model, torch_model, distilled, kind):
    """SpeculativeEngine at K = 4 on the training clip and the held-out one
    with the port-distilled draft (and the control draft), its weights
    carried into the JAX package: the JAX SpeculativeEngine's tokens,
    n_tokens and last_stats."""
    draft = distilled[1] if kind == "distilled" else sde.control_draft(torch_model, ModelDimensions(**STUDENT))
    jax_draft = _to_jax(draft)
    initial, kw = _jax_kwargs()
    accepted = []
    for _, seed in sde.SPLITS:
        audio = sde.pcm16(sde.synth_speech(seed))
        ck, cv, dck, dcv, _ = encode_clip_spec(torch_model, draft, audio)
        jck, jcv, _ = jax_encode_clip(tpu_model, audio)
        jdck, jdcv, _ = jax_encode_clip(jax_draft, audio)
        jeng = JaxSpeculativeEngine(tpu_model, jax_draft, k=4)
        want = jeng.run(initial, jck, jcv, jdck, jdcv, **kw)
        eng = SpeculativeEngine(torch_model, draft, k=4)
        got = eng.run(initial, ck, cv, dck, dcv, **kw)
        assert int(got[1]) == int(want[1])
        assert np.array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=0, atol=2e-3)
        assert eng.last_stats == jeng.last_stats
        accepted.append(eng.last_stats["draft_acceptance"][0])
    assert all(0.0 <= a <= 1.0 for a in accepted)


def test_main_prints_the_tools_keys(synth_checkpoint, tmp_path, capsys, monkeypatch):
    """2 clips, 2 steps at batch 2, K = 4, one timed trial: a plain line and
    a distilled and a random line per split, each with the tool's keys and
    values in range; a summary on stderr; the run's files in --workdir."""
    monkeypatch.setitem(MODEL_DIMS, "student", ModelDimensions(**STUDENT))
    monkeypatch.setattr(sde, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(sde, "N_TRIALS", 1)
    rc = sde.main(["4", "--target", synth_checkpoint, "--draft", "student", "--device", "cpu",
                   "--clips", "2", "--steps", "2", "--batch", "2", "--workdir", str(tmp_path)])  # fmt: skip
    assert rc == 0
    out, err = capsys.readouterr()
    lines = [json.loads(line) for line in out.splitlines()]
    assert [(ln["engine"], ln["split"], ln["K"]) for ln in lines] == [
        (engine, split, k) for split, _ in sde.SPLITS
        for engine, k in (("fused_greedy", None), ("speculative_distilled", 4), ("speculative_random", 4))
    ]  # fmt: skip
    keys = {"engine", "split", "K", "p50_decode_s", "tokens_per_s"}
    for ln in lines:
        assert keys <= set(ln) and ln["p50_decode_s"] > 0 and ln["tokens_per_s"] > 0
        if ln["K"] is not None:
            assert {"speedup_vs_fused", "acceptance", "rounds", "tokens_equal", "common_prefix"} <= set(ln)
            assert 0.0 <= ln["acceptance"] <= 1.0 and min(ln["rounds"]) >= 1
            assert ln["tokens_equal"] == (ln["common_prefix"] == sde.SAMPLE_LEN)  # float32: equal
            assert ln["tokens_equal"]
    summary = json.loads(err.strip().splitlines()[-1][2:])
    assert summary["distill"]["cached"] is False and summary["distill"]["step_ms_p50"] > 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files[:2] == ["clip000.wav", "clip001.wav"] and any(f.startswith("draft_student_") for f in files)


def test_cached_stages_are_keyed_by_their_inputs(torch_model, manifest, workdir, monkeypatch):
    """In the workdir that holds the 2-clip manifest: a 1-clip run labels
    anew (its record equal to the 2-clip manifest's first); a bf16 target
    names another manifest; a draft trained on 1 record is reused by the
    same call and not by one on 2 records or with another learning rate."""
    said = []
    one = sde.label_clips(torch_model, workdir, 1, SAMPLE_LEN, log=said.append)
    assert not said and one == manifest[:1]
    assert sde.label_clips(torch_model, workdir, CLIPS, SAMPLE_LEN, log=said.append) == manifest and said
    f32 = sde.manifest_path(torch_model, workdir, CLIPS, SAMPLE_LEN)
    monkeypatch.setattr(torch_model, "compute_dtype", torch.bfloat16)
    assert sde.manifest_path(torch_model, workdir, CLIPS, SAMPLE_LEN) != f32
    monkeypatch.undo()

    student, kw = ModelDimensions(**STUDENT), dict(max_tokens=48)
    runs = [
        sde.distill_draft(torch_model, student, records, steps=1, batch=1, workdir=workdir,
                          log=lambda *_: None, **dict(kw, **extra))  # fmt: skip
        for records, extra in ((one, {}), (one, {}), (manifest, {}), (one, dict(learning_rate=1e-3)))
    ]  # fmt: skip
    assert [r["cached"] for r in runs] == [False, True, False, False]
    assert runs[0]["dir"] == runs[1]["dir"] and len({runs[0]["dir"], runs[2]["dir"], runs[3]["dir"]}) == 3
