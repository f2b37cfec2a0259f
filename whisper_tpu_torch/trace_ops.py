"""Device-op profile of the frontend or the captured decode (the
counterpart of tools/trace_ops.py): runs the selected program N times under
torch.profiler and prints the device time per iteration in total, by
category and for the top 40 ops, so optimization work targets measured
sinks instead of guesses.

  --what frontend   `frontend.encode_clip` of a 2-window int16 clip (log-mel,
                    encoder, cross-K/V);
  --what decode     the captured beam-5 decode of the frontend's two
                    windows, 96 steps with EOT suppressed (every iteration
                    does the same work): the bench's headline configuration.

Categories are by kernel name: GEMM, attention and softmax, the repo's
kernels (`csrc/`: the update kernels, DTW, median), copy and memset,
elementwise, reduction, other. On the card a trace with no device op is a
fault (exit 1). With --device cpu there is no device: the rows are the
CPU's aten ops by self time, categorized alike.

  python -m whisper_tpu_torch.trace_ops [model=turbo] [n_iters=10] [--what frontend|decode]
         [--device cuda]
"""

import argparse
import json
import re
import sys
import time
from collections import defaultdict
from typing import List, Optional

import numpy as np
import torch

from .tool_common import beam_kwargs, build_model, clip_audio, device_name

N_WINDOWS = 2
DECODE_STEPS = 96
TOP_OPS = 40

# (category, pattern over the kernel or op name), first match wins
CATEGORIES = (
    ("repo kernels (csrc)", r"wtt_|greedy_argmax_kernel|beam_update_kernel|dtw_trace_kernel|median_filter_kernel"),
    ("gemm", r"gemm|cutlass|cublas|nvjet|xmma|aten::(?:mm|bmm|addmm|baddbmm|matmul|linear|_convolution|convolution)$"),
    ("attention and softmax", r"softmax|attention|fmha|flash"),
    ("copy and memset", r"memcpy|memset|copy|fill|aten::(?:zero_|zeros|clone|contiguous|index_put_|index_copy_)$"),
    ("reduction", r"reduce|aten::(?:sum|mean|max|min|argmax|amax|var|std|norm)$"),
    ("elementwise", r"elementwise|aten::(?:add|add_|sub|mul|mul_|div|gelu|where|exp|log|neg|clamp|masked_fill|"
                    r"masked_fill_|pow|sqrt|rsqrt|abs|maximum|minimum|sin|cos)$"),
)  # fmt: skip


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name, re.IGNORECASE):
            return cat
    return "other"


def op_rows(prof, cuda: bool):
    """[(name, category, total us, occurrences)] by total time: the CUDA
    kernels and copies of the trace on the card; the CPU's aten ops by self
    time elsewhere."""
    total, count = defaultdict(float), defaultdict(int)
    if cuda:
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                total[e.name] += e.time_range.elapsed_us()
                count[e.name] += 1
    else:
        for e in prof.key_averages():
            if e.key.startswith("aten::") and e.self_cpu_time_total > 0:
                total[e.key] += e.self_cpu_time_total
                count[e.key] += e.count
    rows = [(name, category(name), us, count[name]) for name, us in total.items()]
    return sorted(rows, key=lambda r: -r[2])


def run(model, n_iters: int = 10, what: str = "frontend") -> dict:
    """Profile `n_iters` runs of the program. Returns the totals, the
    categories and the top ops (ms per iteration, occurrences per
    iteration), the device op count, the warm-ups' seconds."""
    from torch.profiler import ProfilerActivity, profile

    from .engine import FusedEngine
    from .frontend import encode_clip
    from .tokenizer import get_tokenizer

    if what not in ("frontend", "decode"):
        raise ValueError(f"--what is frontend or decode, not {what!r}")
    cuda = model.device.type == "cuda"
    audio = clip_audio(N_WINDOWS)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    ck, cv, n = encode_clip(model, audio)
    sync()
    warm = {"frontend_s": time.perf_counter() - t0}
    if n != N_WINDOWS:
        raise RuntimeError(f"the clip gave {n} windows, not {N_WINDOWS}")

    if what == "decode":
        engine = FusedEngine(model)
        tok = get_tokenizer(model.is_multilingual, num_languages=model.num_languages, language="en",
                            task="transcribe")  # fmt: skip
        initial = np.tile(np.array([list(tok.sot_sequence)], dtype=np.int32), (N_WINDOWS, 1))
        run_kw = beam_kwargs(tok, 5, DECODE_STEPS)

        def once():
            engine.run(initial, ck, cv, **run_kw)  # numpy outputs: the run has ended on the card

        t0 = time.perf_counter()
        once()
        warm["decode_s"] = time.perf_counter() - t0
    else:

        def once():
            encode_clip(model, audio)
            sync()

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        for _ in range(n_iters):
            once()
        sync()
    traced_s = time.perf_counter() - t0
    rows = op_rows(prof, cuda)
    total = sum(r[2] for r in rows)
    by_cat = defaultdict(float)
    for _, cat, us, _ in rows:
        by_cat[cat] += us
    return {
        "model": model.name,
        "what": what,
        "iters": n_iters,
        "rows_from": "device kernels" if cuda else "cpu aten ops (self time)",
        "device_ops": len(rows) if cuda else 0,
        "total_ms_per_iter": total / n_iters / 1e3,
        "by_category_ms_per_iter": {
            cat: us / n_iters / 1e3 for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1])
        },
        "top_ops": [
            {"name": name, "category": cat, "ms_per_iter": us / n_iters / 1e3, "per_iter": occ / n_iters}
            for name, cat, us, occ in rows[:TOP_OPS]
        ],
        "warmup": warm,
        "traced_s": traced_s,
        "device": device_name(model.device),
    }


def print_report(out: dict) -> None:
    n = out["iters"]
    print(f"\ntotal {out['rows_from']} time: {out['total_ms_per_iter']:.3f} ms/iter over {n} iters")
    print("\nby category (ms/iter):")
    for cat, ms in out["by_category_ms_per_iter"].items():
        print(f"  {ms:8.3f}  {cat}")
    print(f"\ntop {TOP_OPS} ops (ms/iter, occurrences/iter):")
    for r in out["top_ops"]:
        print(f"  {r['ms_per_iter']:8.3f}  {r['per_iter']:6.1f}x  [{r['category']}] {r['name'][:110]}")


def main(argv: Optional[List[str]] = None, model=None) -> int:
    """The command. `model`: an already loaded model in place of the
    positional's. Exits 1 when a trace on the card holds no device op."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("model", nargs="?", default="turbo", help="registry name of the dims (seeded random bf16 weights)")
    ap.add_argument("n_iters", nargs="?", type=int, default=10)
    ap.add_argument("--what", default="frontend", choices=["frontend", "decode"])
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    if model is None:
        model = build_model(args.model, args.device)
    out = run(model, args.n_iters, args.what)
    print_report(out)
    print(json.dumps(out), flush=True)
    if model.device.type == "cuda" and not out["device_ops"]:
        print("the profiler captured no device op on the card", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
