"""The native runner's decode loop on an int8 pipeline
(export_pipeline(weights="int8"): prefill and the steps take the quantized
decoder and quantize the cross-K/V inside the graph), with the twin and
the checks of tests/test_torch_runner_loop.py, which runs them at float32:

(a) the twin equals the JAX package's fused_decode under the export's
    FusedConfig (quantize_ckv) at greedy and beam 5 over a decode that
    crosses the 128- and 256-slot phase edges: tokens equal, summed
    log-probabilities within rtol = 1e-4;
(d) each window's step package, run eagerly, within rtol = atol = 1e-5 of
    the whole-cache step on the same inputs; the window graphs' specs and
    loop.txt.

A file of its own so that each file's exports and JAX compiles stay within
about a minute on one CPU worker."""

import pytest
import torch
from test_torch_runner_loop import (  # noqa: F401 (fixtures)
    WINDOW_GRAPHS,
    check_twin_matches_jax,
    check_window_graph_specs,
    check_window_step,
    ckv,
    export_for,
    exported,
    mel,
    torch_model,
)

torch.set_num_threads(1)

MODES = ("int8",)


@pytest.fixture(scope="module")
def pipelines(torch_model, tmp_path_factory):
    return {weights: export_for(torch_model, tmp_path_factory, weights) for weights in MODES}


@pytest.mark.parametrize("weights", MODES)
@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam5"])
def test_twin_matches_jax_fused_decode_across_phases(pipelines, exported, tpu_model, mel, ckv, weights, beam):
    check_twin_matches_jax(pipelines, exported, tpu_model, mel, ckv, weights, beam)


@pytest.mark.parametrize("weights", MODES)
@pytest.mark.parametrize("name", WINDOW_GRAPHS)
def test_window_step_matches_whole_cache_step(exported, ckv, weights, name):
    check_window_step(exported, ckv, weights, name)


@pytest.mark.parametrize("weights", MODES)
def test_window_graph_specs(pipelines, weights):
    check_window_graph_specs(pipelines, weights)
