"""beam_size=5 / best_of=5 with the default temperature ladder
(configuration 3 of whisper_tpu_torch.config_matrix: beam search at T = 0,
five draws a window at T > 0) at the multilingual pre-v3 layout on a 33 s
clip, the port against the JAX package: the checks of
test_torch_configs_ladder.py."""

import numpy as np
import pytest
import torch

import whisper_tpu_torch
from test_torch_configs_ladder import SAMPLE_LEN, check_engine, check_host_loops

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

BEST_OF = dict(language="en", beam_size=5, best_of=5, sample_len=SAMPLE_LEN)


@pytest.fixture(scope="module")
def torch_model(synth_checkpoint):
    return whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def clip(jfk_audio):
    return np.tile(jfk_audio, 3)  # 33 s: two windows


def test_best_of_ladder_host_loops_match_jax(tpu_model, torch_model, clip, monkeypatch):
    check_host_loops(tpu_model, torch_model, clip, BEST_OF, monkeypatch)


def test_best_of_ladder_on_the_engine(tpu_model, torch_model, clip, monkeypatch):
    check_engine(tpu_model, torch_model, clip, BEST_OF, monkeypatch)
