"""The native runner's decode loop on an English-only pipeline (the gpt2
encoding: V = 51864, EOT 50256, timestamps from 50363, the one-token SOT
sequence, so sample_begin is 1), with the twin and the checks of
tests/test_torch_runner_loop.py, which runs them on the multilingual
synthetic checkpoint:

- the export's English-only manifest as the runner reads it (the gpt2 rank
  file, sample_begin, the specials, loop.txt at P = 1, the masks);
(a) the twin equals the JAX package's fused_decode under the export's
    FusedConfig at greedy and beam 5 over a decode that crosses the 128-
    and 256-slot phase edges: tokens equal, summed log-probabilities
    within rtol = 1e-4.

A file of its own so that each file's exports and JAX compiles stay within
about a minute and a half on one CPU worker."""

import os

import pytest
import torch
from test_torch_export import _Exported, _manifest
from test_torch_runner_loop import _masks, check_twin_matches_jax, export_for, mel  # noqa: F401 (fixture)

import whisper_tpu_torch
from whisper_tpu_torch.export import loop_manifest

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def en_models(tmp_path_factory):
    """An English-only synthetic checkpoint (the gpt2 encoding: V = 51864,
    EOT 50256, a one-token SOT sequence) in both packages, float32."""
    import whisper_tpu
    from oracle import save_reference_checkpoint
    from whisper_tpu.models.dims import ModelDimensions

    dims = ModelDimensions(80, 1500, 128, 2, 2, 51864, 448, 128, 2, 2)
    path = save_reference_checkpoint(str(tmp_path_factory.mktemp("en") / "synth_en.pt"), dims, seed=21, scale=0.5)
    port = whisper_tpu_torch.load_model(path, device="cpu", compute_dtype=torch.float32)
    return port, whisper_tpu.load_model(path, compute_dtype="float32")


@pytest.fixture(scope="module")
def en_pipeline(en_models, tmp_path_factory):
    """({"bf16": the English-only pipeline}, {"bf16": its programs}, the
    window's cross-K/V through its encoder)."""
    pdir = export_for(en_models[0], tmp_path_factory, "bf16")
    run = _Exported(pdir)
    return {"bf16": pdir}, {"bf16": run}, run


def test_en_pipeline_manifest(en_pipeline):
    """The export's English-only layout, as the runner reads it: the gpt2
    rank file, sample_begin 1 with the one SOT token, the specials, and
    loop.txt's phases for P = 1."""
    pdir = en_pipeline[0]["bf16"]
    m = _manifest(pdir)
    assert (m["n_vocab"], m["eot"], m["n_text_tokens"], m["timestamp_begin"]) == ("51864", "50256", "50256", "50363")
    assert (m["sample_begin"], m["initial_tokens"], m["tiktoken"]) == ("1", "50257", "gpt2.tiktoken")
    ranks = open(os.path.join(pdir, "gpt2.tiktoken")).read().splitlines()
    assert len(ranks) == 50256 and ranks[-1].endswith(" 50255")  # every text token, none special
    assert not os.path.exists(os.path.join(pdir, "multilingual.tiktoken"))
    assert open(os.path.join(pdir, "loop.txt")).read() == loop_manifest(1, int(m["sample_len"]))
    smask, bmask = _masks(pdir, suppress_eot=False)
    assert smask.size == bmask.size == 51864 and not smask[50256] and bmask[50256]
    assert not smask[50363:].any()  # the timestamps are the filters' business


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam5"])
def test_twin_matches_jax_fused_decode_en(en_models, en_pipeline, mel, beam):
    """(a) on the English-only pipeline: P = 1, so the decode of
    CROSSING_LEN steps ends past slot 256 as well."""
    pipelines, exported, run = en_pipeline
    (xa,) = run("encoder", torch.from_numpy(mel))
    check_twin_matches_jax(pipelines, exported, en_models[1], mel, run("cross_kv", xa), "bf16", beam)
