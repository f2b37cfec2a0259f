"""The port's checkpoint directories (whisper_tpu_torch/checkpoint.py) and
`load_model` of one: dims.json as the JAX package writes it, state_{step}.pt
as a torch.save of the flat tree read with weights_only, round trips in
float32 and bf16 (bit for bit), step selection, and a directory that
decodes the same tokens as the model whose parameters it holds."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import whisper_tpu_torch
from whisper_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from whisper_tpu_torch.models.dims import MODEL_DIMS
from whisper_tpu_torch.models.params import flatten_tree, init_random_params_host

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip(tmp_path, torch_model, dtype):
    model = whisper_tpu_torch.load_model(
        None, device="cpu", dims=torch_model.dims, compute_dtype=dtype, seed=4
    )
    save_checkpoint(str(tmp_path), model.params, model.dims, step=7)
    params, dims, step = load_checkpoint(str(tmp_path))
    assert dims == model.dims and step == 7
    want = dict(flatten_tree(model.params))
    got = dict(flatten_tree(params))
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == want[k].dtype and v.device.type == "cpu", k
        assert torch.equal(v, want[k]), k
    assert got["decoder/ln_g"].dtype == torch.float32  # LayerNorm leaves stay float32
    assert not any(name.endswith(".tmp") for name in os.listdir(tmp_path))


def test_dims_json_is_the_jax_packages(tmp_path, tiny_dims):
    """The port writes dims.json field for field as whisper_tpu.checkpoint
    does, so each package's directory names its model the same way."""
    from whisper_tpu.checkpoint import save_checkpoint as jax_save
    from whisper_tpu.models.params import init_random_params as jax_init

    jax_save(str(tmp_path / "jax"), jax_init(tiny_dims, seed=0), tiny_dims, step=3)
    save_checkpoint(str(tmp_path / "port"), init_random_params_host(tiny_dims, 0), tiny_dims, step=3)
    want = json.loads((tmp_path / "jax" / "dims.json").read_text())
    assert json.loads((tmp_path / "port" / "dims.json").read_text()) == want


def test_step_selection(tmp_path):
    dims = MODEL_DIMS["tiny"]
    a = {"decoder": {"ln_g": torch.zeros(4)}}
    b = {"decoder": {"ln_g": torch.ones(4)}}
    save_checkpoint(str(tmp_path), a, dims, step=2)
    save_checkpoint(str(tmp_path), b, dims, step=4)
    params, _, step = load_checkpoint(str(tmp_path))
    assert step == 4 and torch.equal(params["decoder"]["ln_g"], torch.ones(4))
    params, _, step = load_checkpoint(str(tmp_path), step=2)
    assert step == 2 and torch.equal(params["decoder"]["ln_g"], torch.zeros(4))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), step=3)


class _Payload:
    pass


def test_loading_is_weights_only(tmp_path):
    """A state file holding anything but tensors and containers is refused:
    loading never runs a pickled object's code."""
    save_checkpoint(str(tmp_path), {"x": torch.zeros(2)}, MODEL_DIMS["tiny"], step=0)
    torch.save({"x": _Payload()}, tmp_path / "state_0.pt")
    with pytest.raises(pickle.UnpicklingError):
        load_checkpoint(str(tmp_path))


def test_load_model_of_a_directory_decodes_the_same_tokens(tmp_path, torch_model):
    out = tmp_path / "ckpt"
    save_checkpoint(str(out), torch_model.params, torch_model.dims, step=1)
    loaded = whisper_tpu_torch.load_model(str(out), device="cpu", compute_dtype=torch.float32)
    assert loaded.dims == torch_model.dims and loaded.name == str(out)
    for k, v in flatten_tree(loaded.params):
        assert torch.equal(v, dict(flatten_tree(torch_model.params))[k]), k
    mel = (np.random.RandomState(7).randn(80, 3000) * 0.6).astype(np.float32)
    kw = dict(language="en", temperature=0.0, sample_len=12, fp16=False)
    assert loaded.decode(mel, **kw).tokens == torch_model.decode(mel, **kw).tokens


def test_load_model_needs_dims_json(tmp_path):
    """A directory is a checkpoint only with its dims.json."""
    (tmp_path / "state_0.pt").write_bytes(b"")
    with pytest.raises(RuntimeError, match="not found"):
        whisper_tpu_torch.load_model(str(tmp_path), device="cpu")
