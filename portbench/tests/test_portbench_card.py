"""The controls on the card, at each cell's own size (marked `cuda`: they
skip elsewhere). The fp8 reference in the program's place must fail each
cell's comparison, on three seeds, while the program on the same seeds
passes it. `portbench/limits.py` takes the same readings over more seeds;
its output is what PERF.md's limits were set from.

    python -m pytest portbench/tests/test_portbench_card.py -q   # on a card
"""

import pytest

from portbench import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_fails(cell, card):
    from portbench import check, limits

    lim = spec.cell(cell).workload["limits"]
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        r = limits.reading(cell, seed, 3.0, fp8=True)
        ok, _ = check.verdict(r, lim)
        assert ok, r
        control = {n: r[f"control_{n}"] for n in check.NUMBERS}
        control["bad_windows"] = 0
        assert not check.verdict(control, lim)[0], r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["turbo.batch16.beam5", "turbo.serve8.greedy"])
def test_half_batch_fails_on_the_card(cell, card, monkeypatch):
    """Half of each round's windows left out, their results standing in for
    the rest, at the cell's own size: `correct` comes out false."""
    from whisper_tpu_torch import batch

    from portbench import check, limits

    decode = batch._decode_window_batch

    def half(model, mels, prompts, *args, **kwargs):
        keep = max(1, len(prompts) // 2)
        out = decode(model, mels[:keep], prompts[:keep], *args, **kwargs)
        return [out[i % keep] for i in range(len(prompts))]

    monkeypatch.setattr(batch, "_decode_window_batch", half)
    lim = spec.cell(cell).workload["limits"]
    for seed in (2**31 + 111, 2**31 + 112, 2**31 + 113):
        r = limits.reading(cell, seed, 3.0)
        assert not check.verdict(r, lim)[0], r
