"""The port's draft distillation (whisper_tpu_torch/distill.py) against the
JAX package's (whisper_tpu/distill.py), float32 on the CPU with the
synthetic checkpoint as the target, and the contract of
tests/test_distill.py held in the port: a distilled draft attaches and
leaves speculative tokens equal to plain greedy's, pseudo-labeling fills
only missing text, zero steps are refused.

Tolerances: draft_dims and the student's initial tree exactly;
distill_loss and its ce / kl within 1e-5 relative; a run_distill loss
history (same seed, so the same student) rtol 1e-4, atol 1e-5, the
tolerance of the JAX package's sharded test."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu_torch
from whisper_tpu import distill as jax_distill
from whisper_tpu.models.dims import MODEL_DIMS as JAX_DIMS
from whisper_tpu.models.dims import ModelDimensions as JaxDims
from whisper_tpu.models.params import init_random_params as jax_init_random_params
from whisper_tpu_torch import distill
from whisper_tpu_torch.finetune import batches
from whisper_tpu_torch.models.dims import MODEL_DIMS, ModelDimensions
from whisper_tpu_torch.models.params import flatten_tree, init_random_params_host, map_tree
from whisper_tpu_torch.parallel.train import device_batch
from whisper_tpu_torch.tokenizer import get_tokenizer

torch.set_num_threads(1)

STUDENT = dict(
    n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=1, n_audio_layer=1,
    n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=1, n_text_layer=1,
)  # fmt: skip
TEXTS = ["ask not what your country can do", "my fellow americans"]


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


def _records(jfk):
    return [{"audio": jfk, "text": t} for t in TEXTS]


@pytest.mark.parametrize("preset", ["tiny", "base", "large-v3"])
def test_draft_dims_match_jax(preset):
    turbo = MODEL_DIMS["turbo"]
    d = distill.draft_dims(turbo, preset)
    assert d.__dict__ == jax_distill.draft_dims(JAX_DIMS["turbo"], preset).__dict__
    assert d.n_vocab == 51866 and d.n_mels == 128
    assert d.n_text_state == MODEL_DIMS[preset].n_text_state
    assert distill.draft_dims(turbo, ModelDimensions(**STUDENT)).n_text_state == 64


def test_student_init_matches_jax(tiny_dims):
    want = dict(flatten_tree(jax_init_random_params(tiny_dims, seed=5)))
    got = dict(flatten_tree(init_random_params_host(ModelDimensions(**tiny_dims.__dict__), seed=5)))
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == torch.float32 and np.array_equal(v.numpy(), want[k]), k


def test_distill_loss_matches_jax(torch_model, tpu_model, jfk_flac_path):
    tok = get_tokenizer(True, language="en", task="transcribe")
    batch = next(batches(_records(jfk_flac_path), tok, n_mels=80, batch_size=2, max_tokens=48))
    student = init_random_params_host(ModelDimensions(**STUDENT), seed=0)
    kw = dict(heads_s=(1, 1), heads_t=(2, 2), alpha=0.3, tau=1.5)
    want, want_aux = jax_distill.distill_loss(
        jax_init_random_params(JaxDims(**STUDENT), seed=0), tpu_model.params,
        {k: jnp.asarray(v) for k, v in batch.items()}, **kw,
    )  # fmt: skip
    params = map_tree(student, lambda _, v: v.requires_grad_(True))
    loss, aux = distill.distill_loss(params, torch_model.params, device_batch(batch, "cpu"), **kw)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for k in ("ce", "kl"):
        assert not aux[k].requires_grad
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]), rtol=1e-5)
    loss.backward()
    assert all(v.grad is not None for _, v in flatten_tree(params))
    assert all(v.grad is None for _, v in flatten_tree(torch_model.params))


def test_run_distill_history_matches_jax_and_draft_attaches(
    torch_model, tpu_model, tmp_path, jfk_flac_path
):
    """4 steps at lr 1e-3 on two examples: the loss histories agree and
    fall; the student's checkpoint loads, has the student's width, and as
    a draft leaves the target's greedy tokens as they were."""
    records = _records(jfk_flac_path)
    kw = dict(steps=4, batch_size=2, learning_rate=1e-3, max_tokens=48, log=lambda *_: None)
    want = jax_distill.run_distill(tpu_model, JaxDims(**STUDENT), records, out_dir=str(tmp_path / "j"), **kw)
    lines = []
    got = distill.run_distill(
        torch_model, ModelDimensions(**STUDENT), records, out_dir=str(tmp_path / "p"),
        **dict(kw, log=lines.append),
    )  # fmt: skip
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert got[-1] < got[0]
    assert len(lines) == 4 and all(" ce " in ln and " kl " in ln for ln in lines)

    draft = whisper_tpu_torch.load_model(str(tmp_path / "p"), device="cpu", compute_dtype=torch.float32)
    assert draft.dims.n_text_state == 64
    mel = whisper_tpu_torch.log_mel_spectrogram(jfk_flac_path, 80, padding=480000)[:, :3000]
    opts = dict(language="en", temperature=0.0, sample_len=12, fp16=False)
    plain = torch_model.decode(mel, **opts)
    torch_model.set_draft_model(draft, k=3)
    try:
        spec = torch_model.decode(mel, **opts)
    finally:
        torch_model.set_draft_model(None)
    assert spec.tokens == plain.tokens and spec.text == plain.text


def test_pseudo_label_fills_only_missing_text(torch_model, tpu_model):
    """Audio-only records get the target's temperature-0 transcript (the JAX
    package's, on the same weights); labeled ones are kept as they are."""
    audio = (np.random.RandomState(3).randn(32000) * 0.1).astype(np.float32)
    recs = [{"audio": audio}, {"audio": audio, "text": "kept"}, {"audio": audio, "tokens": [5]}]
    got = distill.pseudo_label(torch_model, recs, language="en")
    want = jax_distill.pseudo_label(tpu_model, recs[:1], language="en")
    assert got[0]["text"] == want[0]["text"]
    assert got[1:] == recs[1:]
    assert "text" not in recs[0]


def test_zero_steps_refused(torch_model, tmp_path):
    with pytest.raises(ValueError, match="steps"):
        distill.run_distill(
            torch_model, "tiny", [{"audio": "unused.wav", "text": "x"}], steps=0, batch_size=1,
            out_dir=str(tmp_path / "draft"),
        )  # fmt: skip
    assert not (tmp_path / "draft").exists()


def test_main_on_cpu(tmp_path, synth_checkpoint, jfk_flac_path, capsys, monkeypatch):
    """The CLI with one unlabeled record: pseudo-labeled, distilled into a
    student of the given preset (here a 1-layer, 64-wide one), saved."""
    monkeypatch.setitem(distill.MODEL_DIMS, "student", ModelDimensions(**STUDENT))
    path = tmp_path / "m.jsonl"
    recs = [{"audio": jfk_flac_path, "text": TEXTS[0]}, {"audio": jfk_flac_path}]
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    out = tmp_path / "draft"
    distill.main(
        [str(path), "--model", synth_checkpoint, "--draft", "student", "--device", "cpu",
         "--steps", "1", "--batch", "2", "--max_tokens", "24", "--out", str(out)]
    )  # fmt: skip
    assert "draft checkpoint at" in capsys.readouterr().out
    meta = json.loads((out / "dims.json").read_text())
    assert meta["step"] == 1 and meta["n_text_state"] == 64 and meta["n_vocab"] == 51865


STUDENT_TP = dict(STUDENT, n_audio_head=2, n_text_head=2)  # heads tp = 2 divides
TEXTS4 = TEXTS + ["ask not", "what you can do for your country"]


def _distill_world(ckpt, records, out_dir):
    """run_distill on a (dp=2, tp=2) world: this rank's history, log lines
    and the gathered student of the last checkpoint."""
    from whisper_tpu_torch.parallel import make_mesh, sharding

    model = whisper_tpu_torch.load_model(ckpt, device="cpu", compute_dtype=torch.float32)
    mesh = make_mesh(dp=2, tp=2, device_type="cpu")
    captured, lines = {}, []
    gather = sharding.gather_params

    def capture(params, mesh):
        tree = gather(params, mesh)
        captured["tree"] = {k: v.numpy().copy() for k, v in flatten_tree(tree)}
        return tree

    sharding.gather_params = capture
    history = distill.run_distill(
        model, ModelDimensions(**STUDENT_TP), records, steps=2, batch_size=4, out_dir=out_dir,
        mesh=mesh, max_tokens=48, log=lines.append,
    )  # fmt: skip
    return history, lines, captured["tree"]


def test_distill_sharded_matches_jax(tpu_model, mesh8, synth_checkpoint, tmp_path, jfk_flac_path):
    """Batch 4 of records with different token counts on (dp=2, tp=2), the
    f32 teacher split over tp: the CE and KL means over the global batch,
    the history equal on every rank and within rtol 1e-4 of the JAX
    package's single-device and sharded histories; rank 0's checkpoint is
    the gathered student."""
    from whisper_tpu_torch.checkpoint import load_checkpoint
    from whisper_tpu_torch.parallel.launch import spawn

    records = [{"audio": jfk_flac_path, "text": t} for t in TEXTS4]
    kw = dict(steps=2, batch_size=4, max_tokens=48, log=lambda *_: None)
    single = jax_distill.run_distill(tpu_model, JaxDims(**STUDENT_TP), records, out_dir=str(tmp_path / "j1"), **kw)
    sharded = jax_distill.run_distill(
        tpu_model, JaxDims(**STUDENT_TP), records, out_dir=str(tmp_path / "j2"), mesh=mesh8, **kw
    )
    out = str(tmp_path / "p")
    ranks = spawn(_distill_world, 4, synth_checkpoint, records, out, device_type="cpu")
    history, lines, tree = ranks[0]
    for h, ln, t in ranks[1:]:
        assert h == history and ln == lines
        assert all(np.array_equal(t[k], v) for k, v in tree.items())
    np.testing.assert_allclose(history, single, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(history, sharded, rtol=1e-4, atol=1e-5)
    assert len(lines) == 2 and all(" ce " in ln and " kl " in ln for ln in lines)
    params, dims, step = load_checkpoint(out)
    assert step == 2 and dims.n_text_head == 2 and dims.n_text_state == 64
    flat = dict(flatten_tree(params))
    assert flat.keys() == tree.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(v.numpy(), tree[k], err_msg=k)
