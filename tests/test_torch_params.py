"""Port parameters vs the JAX package's: the same checkpoint gives the same
tensors (the layouts are identical, so the comparison is exact)."""

import numpy as np
import pytest
import torch

import whisper_tpu
import whisper_tpu_torch
from whisper_tpu_torch.models.params import init_random_params, params_from_jax

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_trees_equal(port, jax_tree):
    a, b = dict(_flat(port)), dict(_flat(jax_tree))
    assert a.keys() == b.keys()
    for key in a:
        want = np.asarray(b[key]).astype(np.float32)
        got = a[key].float().cpu().numpy()
        assert got.shape == want.shape, key
        assert np.array_equal(got, want), key


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


def test_pt_load_matches_jax(torch_model, tpu_model):
    _assert_trees_equal(torch_model.params, tpu_model.params)
    assert torch_model.dims.__dict__ == tpu_model.dims.__dict__


def test_params_from_jax_matches_pt_load(torch_model, tpu_model):
    _assert_trees_equal(params_from_jax(tpu_model.params), tpu_model.params)
    _assert_trees_equal(torch_model.params, params_from_jax(tpu_model.params))


def test_params_from_jax_carries_a_quantized_tree(tpu_model):
    """A JAX quantize_decoder tree comes over with its int8 leaves int8 and
    its '@scale' leaves float32, values equal; the other leaves as float32."""
    from whisper_tpu.quant import quantize_decoder

    qtree = quantize_decoder(tpu_model.params["decoder"])
    port = params_from_jax(qtree)
    for key, leaf in _flat(qtree):
        got, want = dict(_flat(port))[key], np.asarray(leaf)
        if want.dtype == np.int8:
            assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want), key
        else:
            assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want.astype(np.float32)), key
    assert port["blocks"]["attn_q_w@scale"].dtype == torch.float32
    assert port["tok_emb"].dtype == torch.int8


def test_npz_load_matches_jax(tpu_model, tmp_path):
    path = str(tmp_path / "model.npz")
    whisper_tpu.save_model(tpu_model, path)
    model = whisper_tpu_torch.load_model(path, device="cpu", compute_dtype=torch.float32)
    _assert_trees_equal(model.params, tpu_model.params)


def test_random_init_is_seeded(tiny_dims):
    from whisper_tpu.models.params import init_random_params as jax_init

    a = init_random_params(tiny_dims, seed=3, dtype=torch.float32)
    b = init_random_params(tiny_dims, seed=3, dtype=torch.float32)
    c = init_random_params(tiny_dims, seed=4, dtype=torch.float32)
    for (ka, va), (_, vb), (_, vc) in zip(_flat(a), _flat(b), _flat(c)):
        assert torch.equal(va, vb), ka
        if ka.endswith("_w") or ka.endswith("tok_emb"):
            assert not torch.equal(va, vc), ka
    # same tree and shapes as the JAX package's random init
    shapes = {k: tuple(np.shape(v)) for k, v in _flat(jax_init(tiny_dims, seed=0))}
    assert {k: tuple(v.shape) for k, v in _flat(a)} == shapes


def test_bfloat16_model_keeps_layernorm_f32(synth_checkpoint):
    model = whisper_tpu_torch.load_model(synth_checkpoint, device="cpu")
    assert model.compute_dtype == torch.bfloat16
    dec = model.params["decoder"]
    assert dec["blocks"]["attn_q_w"].dtype == torch.bfloat16
    assert dec["blocks"]["attn_ln_g"].dtype == torch.float32
    assert dec["ln_b"].dtype == torch.float32
    assert all(t.device.type == "cpu" for t in model.buffers())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_save_params_npz_is_read_by_jax(synth_checkpoint, tmp_path, dtype):
    """The JAX `load_params_npz` reads the port's file leaf for leaf (a
    bfloat16 tree is written as float32, its values exactly)."""
    from whisper_tpu.models.params import load_params_npz as jax_load

    model = whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=dtype)
    path = str(tmp_path / "params.npz")
    whisper_tpu_torch.save_params_npz(model.params, path)
    back = jax_load(path)
    _assert_trees_equal(model.params, back)
    assert all(v.dtype == np.float32 for _, v in _flat(back))


def test_load_params_npz_reads_jax_save(tpu_model, tmp_path):
    """The port's `load_params_npz` reads the JAX `save_params_npz` file
    leaf for leaf, an int8 decoder tree's dtypes included."""
    from whisper_tpu.models.params import save_params_npz as jax_save
    from whisper_tpu.quant import quantize_decoder

    tree = {"dense": tpu_model.params, "int8": quantize_decoder(tpu_model.params["decoder"])}
    path = str(tmp_path / "jax.npz")
    jax_save(tree, path)
    mine = whisper_tpu_torch.load_params_npz(path)
    want, got = dict(_flat(tree)), dict(_flat(mine))
    assert got.keys() == want.keys()
    for key, leaf in want.items():
        leaf = np.asarray(leaf)
        assert got[key].dtype == leaf.dtype and np.array_equal(got[key], leaf), key
    # and the port writes back the same file's leaves
    again = str(tmp_path / "port.npz")
    whisper_tpu_torch.save_params_npz(mine, again)
    for key, leaf in dict(_flat(whisper_tpu_torch.load_params_npz(again))).items():
        assert leaf.dtype == got[key].dtype and np.array_equal(leaf, got[key]), key
