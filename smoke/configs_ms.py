"""Where the decode step of each published configuration goes on the card.

    python3 smoke/configs_ms.py [CONFIGS]      # default 1,2,3,4,5

For each configuration of whisper_tpu_torch.config_matrix, at full width
with seeded random bf16 weights: its call once (config_matrix.run_config's
record, which captures the engine's graphs), then decode() of its first
window at temperature 0 in its mode on a model built the same way
(greedy for 1 and 2, beam 5 for 3 and 4, beam 5 over the four streams'
first windows for 5):

  * `wall_ms_per_step`: the engine's host wall of a run over its steps,
    three runs of the whole window (224 steps), their median and all three;
  * from a profiled run cut to 48 steps (graphs captured before it),
    between the first and the last update launch: the device-busy ms a
    step (the union of the kernels' intervals), the idle share against the
    wall, the kernels a step and the five kernels with the most device
    time a step;
  * `bound_ms_per_step`: the bytes a step must move over 3.35 TB/s (the
    H100 SXM data sheet): the decoder's weights read once, the window's
    cross-K/V read once, the self-attention cache's 128-slot window read
    and one slot written per row, the logits written and read once.

One JSON line per configuration, each with the card's name and power
limit. Any failed check raises.
"""

import gc
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from smoke.trace_stats import busy_between_updates  # noqa: E402
from whisper_tpu_torch import DecodingOptions, config_matrix, decode, load_audio  # noqa: E402
from whisper_tpu_torch.kernels import build  # noqa: E402
from whisper_tpu_torch.models.params import flatten_tree  # noqa: E402
from whisper_tpu_torch.ops.stft import device_mel_full, device_mel_window  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
PROFILE_STEPS = 48
WINDOW = 128  # the cache phase of a window's first 125 steps
MODE = {1: (None, 1), 2: (None, 1), 3: (5, 1), 4: (5, 1), 5: (5, 4)}  # config: (beam_size, audios)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )  # fmt: skip
    return out.stdout.strip().splitlines()[0]


def first_windows(model, n):
    """The configuration's first window(s) on the card: (n_mels, 3000), or
    (4, n_mels, 3000) for the four streams of configuration 5."""
    if n == 1:
        clips = [load_audio(config_matrix.JFK)]
    else:
        clips = [config_matrix.synth_speech(10.0, seed=s) for s in range(MODE[n][1])]
    mels = [device_mel_window(device_mel_full(c, model.dims.n_mels, model.device)[0], 0, 3000) for c in clips]
    return mels[0] if len(mels) == 1 else torch.stack(mels)


def step_bytes(model, rows, audios):
    """Bytes one step must move at the 128-slot window (see the module's
    docstring)."""
    d, L, el = model.dims.n_text_state, model.dims.n_text_layer, model.compute_dtype.itemsize
    weights = sum(t.numel() * t.element_size() for _, t in flatten_tree(model.params["decoder"]))
    cross = L * 2 * audios * model.dims.n_audio_ctx * d * el
    cache = L * 2 * rows * (WINDOW + 1) * d * el
    logits = 2 * rows * model.dims.n_vocab * 4
    return weights + cross + cache + logits


def profile_config(n, card):
    from torch.profiler import ProfilerActivity, profile

    record, _ = config_matrix.run_config(n, "cuda")
    if not record["ok"]:
        raise AssertionError(f"configuration {n}: {record['error']}")
    model = config_matrix.build(config_matrix.CONFIGS[n][0], False, "cuda")
    beam, audios = MODE[n]
    window = first_windows(model, n)
    opts = DecodingOptions(language="en", temperature=0.0, beam_size=beam)
    walls = []
    for _ in range(3):
        decode(model, window, opts)
        run = model._fused_engine.history[-1]
        walls.append(run.seconds / run.steps * 1e3)
    short = DecodingOptions(language="en", temperature=0.0, beam_size=beam, sample_len=PROFILE_STEPS)
    decode(model, window, short)  # the short window's graphs, before the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode(model, window, short)
        torch.cuda.synchronize()
    update = "beam_update_kernel" if beam else "greedy_argmax_kernel"
    span = busy_between_updates(prof, update)
    lo, hi, steps = span["lo"], span["hi"], span["steps"]
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and lo <= e.time_range.start < hi:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    rows = audios * (beam or 1)
    nbytes = step_bytes(model, rows, audios)
    wall = statistics.median(walls)
    busy = span["busy_us"] / steps / 1e3
    out = dict(
        config=n, model=record["model"], record=record, rows=rows, wall_ms_per_step=wall,
        wall_ms_per_step_runs=walls, device_busy_ms_per_step=busy, device_idle_share=1 - busy / wall,
        kernels_per_step=span["kernels"] / steps, profiled_steps=steps,
        top_kernels_ms_per_step={name[:80]: us / steps / 1e3 for name, us in top},
        step_bytes=nbytes, bound_ms_per_step=nbytes / HBM_BYTES_PER_S * 1e3, card=card,
    )  # fmt: skip
    del model  # it and its cached engine hold each other: collect both
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("configs_ms: CUDA is not available; this script runs only on a card")
    wanted = [int(c) for c in (sys.argv[1] if len(sys.argv) > 1 else "1,2,3,4,5").split(",")]
    build.load_library()
    card = card_line()
    for n in wanted:
        print(json.dumps(profile_config(n, card)), flush=True)


if __name__ == "__main__":
    main()
