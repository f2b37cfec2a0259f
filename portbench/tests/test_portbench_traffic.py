"""The traffic generators: the same seed gives the same inputs, every seed
the same work, and the open loop offers its rate."""

import numpy as np
import pytest

from portbench import inputs, spec
from portbench.work import expected_seeks

SERVE = spec.cell("turbo.serve8.greedy")
serve = SERVE.kind


@pytest.mark.parametrize("seconds", [10.0, 30.0])
def test_schedule_rate_and_work(seconds):
    mix = SERVE.mix
    a1, l1 = serve.schedule(mix, seconds, np.random.default_rng(2**31 + 5))
    a2, l2 = serve.schedule(mix, seconds, np.random.default_rng(2**31 + 5))
    a3, l3 = serve.schedule(mix, seconds, np.random.default_rng(12))
    assert np.array_equal(a1, a2) and np.array_equal(l1, l2)
    n = round(mix["rate_per_s"] * seconds)
    assert len(a1) == len(a3) == n
    assert a1[0] == 0.0 and np.all(np.diff(a1) > 0) and a1[-1] < seconds
    assert np.isclose(n / (a1[-1] + (seconds - a1[-1])), mix["rate_per_s"])
    # the same lengths and gaps, in another order
    assert np.allclose(np.sort(l1), np.sort(l3)) and not np.array_equal(l1, l3)
    assert np.allclose(np.sort(np.diff(np.append(a1, seconds))), np.sort(np.diff(np.append(a3, seconds))))
    assert l1.min() >= mix["min_seconds"] and l1.max() <= mix["max_seconds"]
    assert abs(np.median(l1) - mix["median_seconds"]) < 1.0


def test_gaps_are_exponential():
    arrivals, _ = serve.schedule(dict(SERVE.mix, rate_per_s=50.0), 100.0, np.random.default_rng(3))
    gaps = np.diff(arrivals)
    assert abs(gaps.mean() * 50.0 - 1.0) < 0.02
    assert abs(np.std(gaps) / gaps.mean() - 1.0) < 0.1  # the coefficient of variation of Poisson gaps


def test_audio_deterministic_and_pcm():
    pool = inputs.syllables(np.random.default_rng(1))
    a = inputs.synth_audio(3.0, np.random.default_rng(99), pool)
    b = inputs.synth_audio(3.0, np.random.default_rng(99), pool)
    c = inputs.synth_audio(3.0, np.random.default_rng(100), pool)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert len(a) == 48000 and a.dtype == np.float32
    assert np.array_equal(a * 32768.0, np.round(a * 32768.0))


@pytest.mark.parametrize("name", ["turbo.batch16.beam5", "turbo.serve8.greedy"])
def test_prepare_deterministic(name):
    from types import SimpleNamespace

    cell = spec.cell(name)
    ctx1 = SimpleNamespace(seed=2**31 + 77, seconds=2.0, mix=cell.mix, config=cell.config)
    ctx2 = SimpleNamespace(seed=2**31 + 77, seconds=2.0, mix=cell.mix, config=cell.config)
    cell.kind.prepare(ctx1)
    cell.kind.prepare(ctx2)
    assert len(ctx1.audios) == len(ctx2.audios)
    assert all(np.array_equal(x, y) for x, y in zip(ctx1.audios, ctx2.audios))
    assert ctx1.longest and ctx1.expected == ctx2.expected


def test_expected_seeks():
    assert expected_seeks(60 * 16000) == [0, 3000]
    assert expected_seeks(62 * 16000) == [0, 3000, 6000]
    assert expected_seeks(int(60.5 * 16000)) == [0, 3000]  # a half-second tail is dropped
    lengths = spec.cell("turbo.batch16.beam5").mix["stream_seconds"]
    assert sum(len(expected_seeks(s * 16000)) for s in lengths) == 71


def test_params_layout_matches_the_program():
    """The harness's tree has every leaf of the program's own tree, in its
    shapes, and draws from the seed."""
    import torch

    from whisper_tpu_torch.models.params import flatten_tree, init_random_params

    cfg = spec.load_json(spec.HERE, "tests", "data", "configs", "tiny.json")
    dims = inputs.dims_of(cfg)
    ours = dict(flatten_tree(inputs.make_params(cfg, 5, "cpu", torch.float32)))
    theirs = dict(flatten_tree(init_random_params(dims, seed=0, dtype=torch.float32)))
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: tuple(v.shape) for k, v in theirs.items()}
    again = dict(flatten_tree(inputs.make_params(cfg, 5, "cpu", torch.float32)))
    other = dict(flatten_tree(inputs.make_params(cfg, 6, "cpu", torch.float32)))
    assert all(torch.equal(ours[k], again[k]) for k in ours)
    assert not torch.equal(ours["decoder/tok_emb"], other["decoder/tok_emb"])
