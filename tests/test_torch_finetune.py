"""The port's fine-tuning (whisper_tpu_torch/finetune.py, parallel/train.py,
graphs.decoder_forward) against the JAX package's (whisper_tpu/finetune.py,
parallel/train.py, graphs.decoder_forward), float32 on the CPU on the
synthetic checkpoint unless stated, and the contract of
tests/test_finetune.py held in the port.

Tolerances: make_example / batches tokens exactly, mel within 1e-5;
decoder_forward logits within 1e-5; loss_fn within 1e-5 relative (measured
equal); the gradients of one loss_fn call rtol 1e-4, atol 1e-6 (measured
2.8e-7 at worst); AdamW updates on identical gradients within 1e-7 plus
one float32 ulp (rtol 2^-23) of optax.adamw's: the two apply the bias
corrections in other orders, which moves a value of 1-2 by one ulp
(1.19e-7); a run_finetune loss history rtol
1e-4, atol 1e-5, the tolerance of the JAX package's sharded test; in
bf16, loss_fn within 2e-3 relative of the JAX package's bf16 loss, a
quarter of bf16's epsilon (each bf16 product rounds its result, and the
two libraries' CPU products sum in other orders; measured 1.7e-5)."""

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import whisper_tpu
import whisper_tpu_torch
from whisper_tpu import finetune as jax_finetune
from whisper_tpu.models import graphs as jg
from whisper_tpu.parallel.train import loss_fn as jax_loss_fn
from whisper_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from whisper_tpu_torch import finetune
from whisper_tpu_torch.models import graphs
from whisper_tpu_torch.models.params import flatten_tree, map_tree
from whisper_tpu_torch.parallel.train import device_batch, loss_fn, make_train_step
from whisper_tpu_torch.tokenizer import get_tokenizer

torch.set_num_threads(1)

TEXTS = [
    "ask not what your country can do",
    "my fellow americans",
    "ask not",
    "what you can do for your country",
]


def _records(jfk, n=2):
    return [{"audio": jfk, "text": t} for t in TEXTS[:n]]


def _write_manifest(tmp_path, records, name="manifest.jsonl"):
    path = tmp_path / name
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    return str(path)


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def tokenizers():
    return (
        get_tokenizer(True, language="en", task="transcribe"),
        jax_get_tokenizer(True, language="en", task="transcribe"),
    )


@pytest.fixture(scope="module")
def batch(jfk_flac_path, tokenizers):
    return next(
        finetune.batches(_records(jfk_flac_path), tokenizers[0], n_mels=80, batch_size=2, max_tokens=48)
    )


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _trainable(params):
    return map_tree(params, lambda _, v: v.detach().clone().requires_grad_(True))


def _flat_np(tree):
    return {k: np.asarray(v, dtype=np.float32) for k, v in flatten_tree(tree)}


def test_make_example_and_batches_match_jax(jfk_flac_path, tokenizers):
    """Examples from text (one holding a special-token string, which
    encodes as plain text), from ids and with mel padding; the shuffled
    batch order of a seed."""
    tok, jtok = tokenizers
    records = _records(jfk_flac_path, 4) + [
        {"audio": jfk_flac_path, "text": "a literal <|it|> and <|0.00|> in the text"},
        {"audio": jfk_flac_path, "tokens": [1000, 2000, 3000], "mel_padding": 480000},
    ]
    for rec in records:
        mel, tokens = finetune.make_example(rec, tok, 80, 24)
        jmel, jtokens = jax_finetune.make_example(rec, jtok, 80, 24)
        np.testing.assert_array_equal(tokens, jtokens)
        assert tokens.dtype == np.int32 and mel.shape == (80, 3000)
        np.testing.assert_allclose(mel, np.asarray(jmel), atol=1e-5)
    assert (tokens == finetune.PAD_ID).sum() > 0

    kw = dict(n_mels=80, batch_size=2, max_tokens=24, seed=5)
    ours = finetune.batches(records, tok, **kw)
    theirs = jax_finetune.batches(records, jtok, **kw)
    for _ in range(4):  # past the first shuffle
        a, b = next(ours), next(theirs)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_allclose(a["mel"], b["mel"], atol=1e-5)


def test_manifest_and_batch_size_refusals(tmp_path, jfk_flac_path, tokenizers):
    path = _write_manifest(tmp_path, [{"audio": jfk_flac_path}])
    with pytest.raises(ValueError, match="audio\\+text"):
        finetune.load_manifest(path)
    assert finetune.load_manifest(path, require_text=False) == [{"audio": jfk_flac_path}]
    (tmp_path / "empty.jsonl").write_text("\n")
    with pytest.raises(ValueError, match="empty manifest"):
        finetune.load_manifest(str(tmp_path / "empty.jsonl"))
    it = finetune.batches(_records(jfk_flac_path, 1), tokenizers[0], n_mels=80, batch_size=2, max_tokens=24)
    with pytest.raises(ValueError, match="< batch 2"):
        next(it)


def test_decoder_forward_matches_jax(torch_model, tpu_model, batch):
    inputs = np.maximum(batch["tokens"][:, :-1], 0)
    mel = batch["mel"]
    xa = tpu_model._encode(tpu_model.params["encoder"], jnp.asarray(mel))
    ck, cv = tpu_model._cross_kv(tpu_model.params["decoder"], xa)
    want = jg.decoder_forward(tpu_model.params["decoder"], jnp.asarray(inputs), ck, cv, n_head=2)
    with torch.no_grad():
        p = torch_model.params
        pxa = graphs.encode(p["encoder"], torch.from_numpy(mel), n_head=2)
        pck, pcv = graphs.cross_kv(p["decoder"], pxa, n_head=2)
        got = graphs.decoder_forward(p["decoder"], torch.from_numpy(inputs), pck, pcv, n_head=2)
    assert got.dtype == torch.float32 and got.shape == (2, 47, 51865)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_loss_and_gradients_match_jax(torch_model, tpu_model, batch):
    jloss, jgrads = jax.value_and_grad(partial(jax_loss_fn, n_audio_head=2, n_text_head=2))(
        tpu_model.params, _jax_batch(batch)
    )
    params = _trainable(torch_model.params)
    loss = loss_fn(params, device_batch(batch, "cpu"), n_audio_head=2, n_text_head=2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = _flat_np(jgrads)
    got = {k: v.grad for k, v in flatten_tree(params)}
    assert got.keys() == want.keys()
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_pad_positions_leave_the_loss(torch_model, batch):
    """Padding past the last target changes nothing; a row of nothing but
    pad divides by one, not zero."""
    params = torch_model.params
    b = device_batch(batch, "cpu")
    wider = dict(b, tokens=torch.cat([b["tokens"], torch.full((2, 8), -100, dtype=b["tokens"].dtype)], 1))
    with torch.no_grad():
        a = loss_fn(params, b, n_audio_head=2, n_text_head=2)
        w = loss_fn(params, wider, n_audio_head=2, n_text_head=2)
        empty = loss_fn(params, dict(b, tokens=torch.full_like(b["tokens"], -100)), n_audio_head=2, n_text_head=2)
    np.testing.assert_allclose(float(w), float(a), rtol=1e-6)
    assert float(empty) == 0.0


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_matches_optax_on_identical_gradients(steps):
    """The optimizer alone: the same gradients (drawn from a seed) into
    optax.adamw and the port's AdamW, on a tree holding a bias, a
    LayerNorm-like leaf of ones and a position embedding."""
    rng = np.random.RandomState(3)
    tree = {
        "w": rng.randn(6, 5).astype(np.float32) * 0.02,
        "ln_g": np.ones(5, np.float32),
        "pos_emb": rng.randn(4, 5).astype(np.float32),
    }
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in tree.items()} for _ in range(steps)]
    tx = optax.adamw(1e-3, weight_decay=0.01)
    jparams = {k: jnp.asarray(v) for k, v in tree.items()}
    jstate = tx.init(jparams)
    for g in grads:
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)

    from whisper_tpu_torch.parallel.train import init_train_state

    state = init_train_state({k: torch.from_numpy(v) for k, v in tree.items()}, 1e-3, 0.01)
    for g in grads:
        for k, p in state.params.items():
            p.grad = torch.from_numpy(g[k])
        state.opt_state.step()
    for k, p in state.params.items():
        np.testing.assert_allclose(
            p.detach().numpy(), np.asarray(jparams[k]), rtol=2**-23, atol=1e-7, err_msg=k
        )


def test_train_step_leaves_the_model_alone(torch_model, batch):
    init_state, train_step = make_train_step(torch_model.dims, learning_rate=1e-3)
    before = {k: v.clone() for k, v in flatten_tree(torch_model.params)}
    state = init_state(torch_model.params)
    state, loss = train_step(state, batch)
    assert state.step == 1 and loss.dim() == 0 and not loss.requires_grad
    for k, v in flatten_tree(state.params):
        assert v.grad is None and v.dtype == before[k].dtype, k
    moved = [k for k, v in flatten_tree(state.params) if not torch.equal(v.detach(), before[k])]
    assert "decoder/tok_emb" in moved
    for k, v in flatten_tree(torch_model.params):
        assert torch.equal(v, before[k]), k
    for name, buf in torch_model.named_buffers():
        assert torch.equal(buf, before[name.replace("__", "/")]), name


@pytest.fixture(scope="module")
def runs(torch_model, tpu_model, tmp_path_factory, jfk_flac_path):
    """One 4-step run_finetune of each package at lr 1e-3 on two examples,
    with a held-out batch of the other two evaluated every 2 steps; the
    port's with a checkpoint every 2 steps. Returns (JAX history and lines,
    port history and lines, the port's checkpoint directory)."""
    records = _records(jfk_flac_path, 4)
    kw = dict(
        steps=4, batch_size=2, learning_rate=1e-3, max_tokens=48, eval_manifest=records[2:],
        eval_every=2,
    )  # fmt: skip
    tmp = tmp_path_factory.mktemp("finetune")
    jlines, plines = [], []
    want = jax_finetune.run_finetune(tpu_model, records[:2], out_dir=str(tmp / "j"), log=jlines.append, **kw)
    got = finetune.run_finetune(
        torch_model, records[:2], out_dir=str(tmp / "p"), log=plines.append, checkpoint_every=2, **kw
    )
    return (want, jlines), (got, plines), tmp / "p"


def test_run_finetune_history_matches_jax(runs):
    """The loss histories agree and fall."""
    (want, _), (got, lines), _ = runs
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert got[-1] < got[0]
    assert [ln for ln in lines if "  loss " in ln] == [
        f"step {i}/4  loss {v:.4f}" for i, v in enumerate(got, 1)
    ]


def test_run_finetune_eval_lines_match_jax(runs):
    """eval_loss lines every eval_every steps, equal to the JAX package's."""
    (_, jlines), (_, plines), _ = runs
    evals = [ln for ln in plines if "eval_loss" in ln]
    jevals = [ln for ln in jlines if "eval_loss" in ln]
    assert [ln.split("  ")[0] for ln in evals] == ["step 2/4", "step 4/4"]
    assert len(jevals) == 2
    np.testing.assert_allclose(
        [float(ln.rsplit(" ", 1)[-1]) for ln in evals],
        [float(ln.rsplit(" ", 1)[-1]) for ln in jevals],
        rtol=1e-3,  # printed to four decimals
    )


def test_run_finetune_checkpoints_load_and_decode(runs, torch_model, jfk_flac_path):
    """A checkpoint every checkpoint_every steps before the last, and the
    final one; load_model of the directory reads the last and decodes."""
    out = runs[2]
    assert sorted(os.listdir(out)) == ["dims.json", "state_2.pt", "state_4.pt"]
    ft = whisper_tpu_torch.load_model(str(out), device="cpu", compute_dtype=torch.float32)
    assert not torch.equal(ft.params["decoder"]["tok_emb"], torch_model.params["decoder"]["tok_emb"])
    mel = whisper_tpu_torch.log_mel_spectrogram(jfk_flac_path, 80, padding=480000)[:, :3000]
    r = ft.decode(mel, language="en", temperature=0.0, sample_len=8, fp16=False)
    assert isinstance(r.text, str) and len(r.tokens) > 0


def test_non_finite_loss_refused(synth_checkpoint, tmp_path, jfk_flac_path):
    model = whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)
    model.params["decoder"]["ln_g"].fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite loss at step 1"):
        finetune.run_finetune(
            model, _records(jfk_flac_path), steps=2, batch_size=2, out_dir=str(tmp_path / "c"),
            max_tokens=24, log=lambda *_: None,
        )  # fmt: skip
    assert not (tmp_path / "c").exists()


def test_bf16_loss_matches_jax(synth_checkpoint, batch):
    jm = whisper_tpu.load_model(synth_checkpoint, compute_dtype="bfloat16")
    pm = whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.bfloat16)
    want = float(jax_loss_fn(jm.params, _jax_batch(batch), n_audio_head=2, n_text_head=2))
    params = _trainable(pm.params)
    loss = loss_fn(params, device_batch(batch, "cpu"), n_audio_head=2, n_text_head=2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want, rtol=2e-3)
    for k, v in flatten_tree(params):
        assert v.grad.dtype == v.dtype and torch.isfinite(v.grad).all(), k
    assert params["decoder"]["tok_emb"].dtype == torch.bfloat16
    assert params["decoder"]["ln_g"].dtype == torch.float32


def test_main_on_cpu(tmp_path, synth_checkpoint, jfk_flac_path, capsys):
    manifest = _write_manifest(tmp_path, _records(jfk_flac_path))
    out = tmp_path / "ckpt"
    finetune.main(
        [manifest, "--model", synth_checkpoint, "--device", "cpu", "--steps", "2", "--batch", "2",
         "--max_tokens", "24", "--lr", "1e-3", "--out", str(out)]
    )  # fmt: skip
    assert "final loss" in capsys.readouterr().out
    meta = json.loads((out / "dims.json").read_text())
    assert meta["step"] == 2 and meta["n_text_state"] == 128
    state = torch.load(out / "state_2.pt", weights_only=True)
    assert state["decoder/tok_emb"].dtype == torch.bfloat16  # load_model's default dtype


# the shapes graphs.matmul_f32 gets on the training path: the logits head
# (2-D), attention scores (3-D batch), and batch dims that broadcast
MATMUL_SHAPES = [
    ((6, 64), (64, 5)),
    ((2, 3, 4, 64), (2, 3, 64, 5)),
    ((2, 3, 4, 64), (3, 64, 5)),
    ((2, 1, 4, 64), (1, 3, 64, 5)),
]


def _bf16_operands(sa, sb, device="cpu", requires_grad=True):
    rng = np.random.RandomState(len(sa) + len(sb))
    a, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)).bfloat16() for s in (sa, sb))
    return a.to(device).requires_grad_(requires_grad), b.to(device).requires_grad_(requires_grad)


@pytest.mark.parametrize("sa, sb", MATMUL_SHAPES)
def test_matmul_f32_function_on_meta(sa, sb):
    """cuBLAS's out_dtype products have meta kernels and no CPU ones: on
    the meta device the Function's output is float32 of the broadcast
    shape, and its gradients have the operands' shapes and dtypes."""
    a = torch.empty(sa, device="meta", dtype=torch.bfloat16, requires_grad=True)
    b = torch.empty(sb, device="meta", dtype=torch.bfloat16, requires_grad=True)
    y = graphs._MatmulF32.apply(a, b)
    assert y.dtype == torch.float32
    assert y.shape == (*torch.broadcast_shapes(sa[:-2], sb[:-2]), sa[-2], sb[-1])
    ga, gb = torch.autograd.grad(y, (a, b), torch.empty_like(y))
    assert (ga.shape, ga.dtype, gb.shape, gb.dtype) == (a.shape, a.dtype, b.shape, b.dtype)


@pytest.mark.parametrize("sa, sb", MATMUL_SHAPES)
def test_matmul_f32_backward_equals_the_widened_form(monkeypatch, sa, sb):
    """The Function's backward on the CPU, its forward swapped for the
    widened product: each gradient equals the widened form's bit for bit
    (float32 products, float32 sums over broadcast dims, one rounding)."""
    monkeypatch.setattr(graphs, "_mm_f32", lambda a, b: a.float() @ b.float())
    a, b = _bf16_operands(sa, sb)
    y = graphs._MatmulF32.apply(a, b)
    g = torch.from_numpy(np.random.RandomState(1).randn(*y.shape).astype(np.float32))
    got = torch.autograd.grad(y, (a, b), g)
    want = torch.autograd.grad(a.float() @ b.float(), (a, b), g)
    for x, w in zip(got, want):
        assert x.dtype == torch.bfloat16 and torch.equal(x, w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: cuBLAS's out_dtype product has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sa, sb", MATMUL_SHAPES)
def test_matmul_f32_gradient_on_card(cuda_device, sa, sb):
    """On the card matmul_f32 goes through the Function where a gradient is
    wanted: forward bit-equal to the product without autograd, gradients
    within one bf16 ulp of the widened form's."""
    a, b = _bf16_operands(sa, sb, cuda_device)
    y = graphs.matmul_f32(a, b)
    with torch.no_grad():
        assert torch.equal(y, graphs.matmul_f32(a, b))
    g = torch.randn(y.shape, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(0))
    got = torch.autograd.grad(y, (a, b), g)
    want = torch.autograd.grad(a.float() @ b.float(), (a, b), g)
    for x, w in zip(got, want):
        assert x.dtype == torch.bfloat16
        ulp = torch.finfo(torch.bfloat16).eps * w.float().abs().clamp(min=2**-126)
        assert ((x.float() - w.float()).abs() <= ulp).all()
