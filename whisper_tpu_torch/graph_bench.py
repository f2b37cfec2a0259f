"""Per-graph latency and roofline (the counterpart of
tools/graph_bench.py): times encoder, cross_kv, prefill, decode_step, the
captured fused decode, a bare step loop and the word-timestamp alignment
replay one at a time on synthetic inputs, first call and steady state.

Steady state is the median over --trials of a chain of 10 calls between
two CUDA events (host clock on the CPU), divided by 10. The first call is
host-clocked to a synchronize; it includes the graph's first use (cuBLAS
handles, the fused loop's captures), but not the kernels' build, which is
done and timed apart first (`kernel_build_s`).

  * fused_decode: `FusedEngine.run` for --steps tokens at beam --beam (or
    --greedy), EOT suppressed, timestamp rules on unless --no-timestamps:
    prefill and step 0 eager, then the loop body replayed from its CUDA
    graphs;
  * raw_step_loop: --steps bare steps of `graphs.decode_step_fixed` and an
    argmax, no filters, at the engine's cache window for those steps (the
    beam rows reordered by the identity as the engine's beam body does),
    captured as one CUDA graph (the counterpart of the JAX tool's
    while_loop): loop mechanics and the step against the decoding logic;
  * align_replay: `Whisper.alignment_replay` of a 7-token sequence
    (prefill with the alignment heads, token probabilities, the cost
    matrix through the median-filter kernel).

Each graph gets a roofline row: its FLOPs (torch.utils.flop_counter over
the same call; it stands in for XLA's cost_analysis, and the port has no
compiler byte estimate, so `xla_mb_accessed` is null) and the analytic
bytes its math must move (weights read once, caches read and written,
operands in, results out; the JAX tool's formulas) against the card's
peaks give the least time, max(FLOPs / peak, bytes / bandwidth), and the
measured steady time's share of it. "mxu" in the keys names the tensor
cores' peak. The peaks default to one H100 SXM's data sheet (989 bf16
TFLOP/s dense, 3.35 TB/s); the card's name and power limit are read at
run time and printed beside them.

  python -m whisper_tpu_torch.graph_bench [--model turbo] [--beam 5] [--trials 10]
         [--steps 96] [--greedy] [--no-timestamps] [--peak-tflops 989] [--peak-gbs 3350]
         [--device cuda]
"""

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .models import graphs
from .tool_common import build_model, card_line, device_name, synchronize

PEAK_TFLOPS = 989.0  # one H100 SXM, bf16 dense (NVIDIA data sheet)
PEAK_GBS = 3350.0  # its HBM3
CHAIN = 10  # calls per steady-state sample


def flop_counter():
    """torch's FlopCounterMode, with a bmm formula that takes the out_dtype
    overload's extra argument (the port's float32 products of bf16
    operands, graphs._mm_f32)."""
    from torch.utils.flop_counter import FlopCounterMode, bmm_flop

    def bmm_any(a_shape, b_shape, *args, out_shape=None, **kwargs):
        return bmm_flop(a_shape, b_shape)

    return FlopCounterMode(display=False, custom_mapping={torch.ops.aten.bmm: bmm_any})


def count_flops(fn) -> float:
    with flop_counter() as counter:
        fn()
    return float(counter.get_total_flops())


def time_fn(fn, trials: int, device):
    """(first call s, steady s a call)."""
    cuda = torch.device(device).type == "cuda"
    synchronize(device)
    t0 = time.perf_counter()
    fn()
    synchronize(device)
    first = time.perf_counter() - t0
    times = []
    for _ in range(trials):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CHAIN):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / CHAIN)
        else:
            t0 = time.perf_counter()
            for _ in range(CHAIN):
                fn()
            times.append((time.perf_counter() - t0) / CHAIN)
    return first, float(np.median(times))


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def tree_nbytes(tree) -> int:
    from .models.params import flatten_tree

    if isinstance(tree, torch.Tensor):
        return nbytes(tree)
    return sum(nbytes(t) for _, t in flatten_tree(tree))


def analytic_floors(enc, dec, mel_b, xa_b, ckv_b, cache_b, kv_out_b, beam, n_vocab) -> Dict[str, int]:
    """The bytes each graph's math must move (tools/graph_bench.py's
    formulas): weights read once, caches read and written, operands in,
    results out. `enc` / `dec`: the parameter trees; the rest byte counts
    of the mel, the audio features, the cross-K/V pair, one beam cache, the
    prefill's K/V, and the beam and vocabulary sizes."""
    blocks = dec["blocks"]
    cross_w = tree_nbytes({k: v for k, v in blocks.items() if k in ("cross_k_w", "cross_v_w", "cross_v_b")})
    floors = {
        "encoder": tree_nbytes(enc) + mel_b + xa_b,
        "cross_kv": cross_w + xa_b + ckv_b,
        # prefill embeds its rows (a gather, not the table) and has no
        # logits head: weights once, cross-K/V once, the kv block out
        "prefill": tree_nbytes(blocks) + ckv_b + kv_out_b,
        "decode_step": tree_nbytes(dec) + 2 * cache_b + ckv_b + beam * n_vocab * 4,
        "align_replay": tree_nbytes(blocks) + ckv_b + kv_out_b + nbytes(dec["tok_emb"]),
    }
    floors["decode_tok(fused)"] = floors["decode_step"]
    return floors


def roofline_row(steady_s: float, flops: float, floor_bytes: float, peak_tflops: float, peak_gbs: float) -> dict:
    """One graph's roofline: compute and bytes bounds, which binds, and the
    bound's share of the measured steady time."""
    t_mxu = flops / (peak_tflops * 1e12)
    t_hbm = floor_bytes / (peak_gbs * 1e9)
    t_sol = max(t_mxu, t_hbm)
    return {
        "steady_ms": steady_s * 1e3,
        "gflop": flops / 1e9,
        "xla_mb_accessed": None,  # no compiler byte estimate in the port
        "floor_mb": floor_bytes / 1e6,
        "mxu_bound_ms": t_mxu * 1e3,
        "hbm_bound_ms": t_hbm * 1e3,
        "bound": "mxu" if t_mxu >= t_hbm else "hbm",
        "pct_of_roofline": 100.0 * t_sol / steady_s if steady_s > 0 else 0.0,
    }


class RawStepLoop:
    """`steps` bare decoder steps (graphs.decode_step_fixed at `window`,
    then argmax; beam rows reordered by the identity), on static buffers;
    on CUDA captured once as one graph. A call resets the cache to the
    prefill's, the tokens to zeros and the slot to n_initial, then runs or
    replays the steps; it returns the last tokens."""

    def __init__(self, model, kv, ck, cv, n_group: int, steps: int, n_initial: int, window: int):
        self.model, self.ck, self.cv = model, ck, cv
        self.steps, self.n_initial, self.window = steps, n_initial, window
        dev = model.device
        self.cache0 = model.kv_to_cache_grouped(kv, n_group)
        self.cache = self.cache0.clone()
        self.toks = torch.zeros(n_group, dtype=torch.int32, device=dev)
        self.pos = torch.full((1,), n_initial, dtype=torch.int32, device=dev)
        self.src = torch.arange(n_group, device=dev) if n_group > 1 else None
        self.graph = None
        if dev.type == "cuda":
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._reset()
                self._body()  # warm-up: the products' handles and workspaces
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._body()

    @torch.inference_mode()
    def _body(self):
        dec = self.model.params["decoder"]
        for _ in range(self.steps):
            logits, _ = graphs.decode_step_fixed(
                dec, self.toks, self.pos, self.cache, self.src, self.ck, self.cv,
                n_head=self.model.dims.n_text_head, window=self.window,
            )  # fmt: skip
            self.toks.copy_(logits.argmax(dim=-1))
            self.pos.add_(1)

    @torch.inference_mode()
    def _reset(self):
        self.cache.copy_(self.cache0)
        self.toks.zero_()
        self.pos.fill_(self.n_initial)

    def __call__(self):
        self._reset()
        if self.graph is None:
            self._body()
        else:
            self.graph.replay()
        return self.toks


def run(model, beam: int = 5, trials: int = 10, steps: int = 96, greedy: bool = False,
        timestamps: bool = True, peak_tflops: float = PEAK_TFLOPS, peak_gbs: float = PEAK_GBS) -> dict:  # fmt: skip
    """Time and price every graph. Returns {"timings", "roofline",
    "kernel_build_s", "per_token_fused_ms", "peaks", "card", "device"}."""
    from .engine import FusedEngine, _last_window
    from .kernels import build
    from .tokenizer import get_tokenizer

    dev = model.device
    cuda = dev.type == "cuda"
    dims = model.dims
    tok = get_tokenizer(model.is_multilingual, num_languages=model.num_languages, language="en",
                        task="transcribe")  # fmt: skip
    engine = FusedEngine(model)
    kernel_build_s = None
    if cuda:
        t0 = time.perf_counter()
        build.load_library()
        kernel_build_s = time.perf_counter() - t0

    results = {}
    mel = torch.zeros((1, dims.n_mels, 3000), dtype=torch.float32, device=dev)
    results["encoder"] = time_fn(lambda: model.encode(mel), trials, dev)
    xa = model.encode(mel)
    results["cross_kv"] = time_fn(lambda: model.cross_kv(xa), trials, dev)
    ck, cv = model.cross_kv(xa)
    first3 = [tok.sot, tok.sot + 1, tok.transcribe]
    tokens = np.array([first3], dtype=np.int32)
    results["prefill"] = time_fn(lambda: model.prefill(tokens, 3, ck, cv), trials, dev)
    _, kv = model.prefill(tokens, 3, ck, cv)

    zeros_b, rows_b = np.zeros(beam, np.int32), np.arange(beam)

    def one_step():
        cache = model.kv_to_cache_grouped(kv, beam)
        return model.decode_step(zeros_b, 3, cache, rows_b, ck, cv)[0]

    results["decode_step"] = time_fn(one_step, trials, dev)

    beam_search = not greedy
    n_group = beam if beam_search else 1
    run_kw = dict(
        sot_index=0, suppress_ids=[tok.eot], blank_ids=[tok.eot], max_initial_ts_index=50,
        sample_len=steps, n_group=n_group, beam_search=beam_search, max_candidates=n_group,
        use_timestamps=timestamps, temperature=0.0, eot=tok.eot, timestamp_begin=tok.timestamp_begin,
        no_timestamps=tok.no_timestamps, no_speech=tok.no_speech,
    )  # fmt: skip
    fused_key = f"fused_decode[{steps} steps]"
    results[fused_key] = time_fn(lambda: engine.run(first3, ck, cv, **run_kw)[0], max(2, trials // 2), dev)

    raw_key = f"raw_step_loop[{steps} steps]"
    t0 = time.perf_counter()
    raw = RawStepLoop(model, kv, ck, cv, n_group, steps, 3, _last_window(3, steps))
    synchronize(dev)
    raw_build_s = time.perf_counter() - t0
    first, steady = time_fn(raw, max(2, trials // 2), dev)
    results[raw_key] = (first + raw_build_s, steady)

    text = tok.encode(" and so on")
    align_tokens = np.array([first3 + text], dtype=np.int32)
    n_align = align_tokens.shape[1]
    # row i reports the probability of the token after it (timing.py's rows)
    row_ids = np.zeros(n_align, dtype=np.int64)
    row_ids[2 : 2 + len(text)] = text

    def align():
        return model.alignment_replay(align_tokens, n_align, ck, cv, row_ids, 3000, tok.eot)

    results["align_replay"] = time_fn(align, trials, dev)

    # ---- rooflines ------------------------------------------------------------
    flops = {
        "encoder": count_flops(lambda: model.encode(mel)),
        "cross_kv": count_flops(lambda: model.cross_kv(xa)),
        "prefill": count_flops(lambda: model.prefill(tokens, 3, ck, cv)),
        "decode_step": count_flops(one_step),
        "align_replay": count_flops(align),
    }
    flops["decode_tok(fused)"] = flops["decode_step"]
    cache5 = model.kv_to_cache_grouped(kv, beam)
    floors = analytic_floors(
        model.params["encoder"], model.params["decoder"], nbytes(mel), nbytes(xa),
        nbytes(ck) + nbytes(cv), nbytes(cache5), nbytes(kv), beam, dims.n_vocab,
    )  # fmt: skip
    measured = {name: results[name][1] for name in flops if name in results}
    # the fused loop's time a token is the step graph's in production (its
    # body = step + update), without the standalone step's dispatch
    measured["decode_tok(fused)"] = results[fused_key][1] / steps
    roofline = {
        name: roofline_row(measured[name], flops[name], floors[name], peak_tflops, peak_gbs) for name in flops
    }
    return {
        "model": model.name,
        "beam": beam,
        "greedy": greedy,
        "timings": {k: {"first_s": f, "steady_ms": s * 1e3} for k, (f, s) in results.items()},
        "per_token_fused_ms": results[fused_key][1] / steps * 1e3,
        "roofline": roofline,
        "kernel_build_s": kernel_build_s,
        "raw_loop_capture_s": raw_build_s,
        "peaks": {"tflops": peak_tflops, "gbs": peak_gbs},
        "card": card_line() if cuda else None,
        "device": device_name(dev),
    }


def print_tables(out: dict) -> None:
    print(f"\nmodel={out['model']} beam={out['beam']} device={out['device']} card={out['card']}")
    if out["kernel_build_s"] is not None:
        print(f"kernels' build (first CUDA use): {out['kernel_build_s']:.2f} s")
    print(f"{'graph':<26} {'first(s)':>10} {'steady(ms)':>12}")
    for name, t in out["timings"].items():
        print(f"{name:<26} {t['first_s']:>10.2f} {t['steady_ms']:>12.3f}")
    print(f"{'per-token (fused)':<26} {'':>10} {out['per_token_fused_ms']:>12.3f}")
    p = out["peaks"]
    print(
        f"\nroofline vs peaks {p['tflops']:.0f} bf16 TFLOP/s, {p['gbs']:.0f} GB/s (FLOPs: "
        f"torch.utils.flop_counter; floorMB: analytic traffic the math requires; SoL% = max(compute, "
        f"bytes) bound / measured)"
    )
    print(f"{'graph':<18} {'steady(ms)':>10} {'GFLOP':>8} {'floorMB':>8} {'mxu(ms)':>8} {'hbm(ms)':>8} "
          f"{'bound':>6} {'SoL%':>6}")  # fmt: skip
    for name, r in out["roofline"].items():
        print(
            f"{name:<18} {r['steady_ms']:>10.3f} {r['gflop']:>8.2f} {r['floor_mb']:>8.1f} "
            f"{r['mxu_bound_ms']:>8.3f} {r['hbm_bound_ms']:>8.3f} {r['bound']:>6} {r['pct_of_roofline']:>6.1f}"
        )


def main(argv: Optional[List[str]] = None, model=None) -> int:
    """The command. `model`: an already loaded model in place of --model's."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="turbo", help="registry name of the dims (seeded random bf16 weights)")
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--steps", type=int, default=96, help="fused decode steps")
    ap.add_argument("--greedy", action="store_true", help="fused greedy instead of beam")
    ap.add_argument("--no-timestamps", action="store_true", help="disable timestamp rules")
    ap.add_argument("--peak-tflops", type=float, default=PEAK_TFLOPS,
                    help="card peak bf16 TFLOP/s (default: H100 SXM, dense)")  # fmt: skip
    ap.add_argument("--peak-gbs", type=float, default=PEAK_GBS, help="card peak HBM GB/s (default: H100 SXM)")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    if model is None:
        model = build_model(args.model, args.device)
    out = run(model, args.beam, args.trials, args.steps, args.greedy, not args.no_timestamps,
              args.peak_tflops, args.peak_gbs)  # fmt: skip
    print_tables(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
