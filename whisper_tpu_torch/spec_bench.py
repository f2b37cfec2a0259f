"""Speculative-decoding bench (the counterpart of tools/spec_bench.py):
turbo verifies, a tiny-class draft proposes.

Real acceptance needs real weights, which cannot be downloaded here. What
random weights can measure is the acceptance bracket:

  * accept1, the upper bound: every id but one text token is suppressed,
    so both models' filtered argmax is that token at every position; every
    draft is accepted and a round takes K + 1 tokens;
  * accept0, the lower bound: only EOT is suppressed, and an independently
    seeded draft almost never matches the target's argmax; a round verifies
    one token plus the bonus.

A 60 s int16 clip goes through `frontend.encode_clip_spec` (each model's
mel, encoder and cross-K/V of the clip's two windows); then per bracket the
plain captured `FusedEngine` and `SpeculativeEngine` at each K decode the
two windows at T = 0 without timestamps, SAMPLE_LEN tokens, one warm run
(its graphs) and N_TRIALS timed runs (median). One JSON line per
configuration with the JAX tool's keys; `measured_acceptance` is the mean
of `SpeculativeEngine.last_stats["draft_acceptance"]` (accept1 reads 1.0
at K = 4). The port adds whether every draft of the run was accepted
(`all_accepted`: every round but one cut by SAMPLE_LEN took K + 1 tokens),
whether its tokens equal the plain engine's, its rounds, whether it
replayed captured graphs, and the device.

The draft is the draft name's dims with the target's vocabulary (a real
deployment uses a v3-vocab tiny or distil checkpoint), seeded apart from
the target, in the target's compute dtype (bf16 as in the JAX tool). In
bf16 the verify pass's products, of other shapes than the step's, can part
accept0's tokens from the plain engine's where the target's top two are
nearly tied; at float32 (a caller's float32 models, main(model=, draft=))
they equal them. The tokenizer
is the target's own (its language count): the JAX tool's default one is
one task token off at turbo.

  python -m whisper_tpu_torch.spec_bench [K ...]   (default: 4 8)
         [--target turbo] [--draft tiny] [--device cuda]

Exits 1 when an accept1 run did not accept every draft.
"""

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .tool_common import build_model, clip_audio, device_name

CLIP_SECONDS = 60
SAMPLE_LEN = 96
N_TRIALS = 5


def draft_model(target, name: str, device, seed: int = 1):
    """The draft name's dims with the target's vocabulary, seeded random
    weights in the target's compute dtype."""
    from .models.dims import MODEL_DIMS
    from .models.whisper import Whisper

    dims = dataclasses.replace(MODEL_DIMS[name], n_vocab=target.dims.n_vocab)
    return Whisper(dims, None, name=name, device=device, compute_dtype=target.compute_dtype, seed=seed)


def bracket_kwargs(tok, n_vocab: int, sample_len: int) -> Dict[str, dict]:
    """The engines' keywords of the two brackets (the JAX tool's)."""
    one_tok = tok.encode(" and")[0]
    base = dict(
        sot_index=0,
        blank_ids=tok.encode(" ") + [tok.eot],
        max_initial_ts_index=50,
        sample_len=sample_len,
        use_timestamps=False,
        temperature=0.0,
        eot=tok.eot,
        timestamp_begin=tok.timestamp_begin,
        no_timestamps=tok.no_timestamps,
        no_speech=tok.no_speech,
    )
    return {
        "accept1": dict(base, suppress_ids=[i for i in range(n_vocab) if i != one_tok]),
        "accept0": dict(base, suppress_ids=[tok.eot]),
    }


def all_accepted(stats) -> bool:
    """Whether every round of a run took K + 1 tokens but a last one cut by
    sample_len: every draft was accepted. `draft_acceptance` counts the
    drafts of that cut round as rejected, so it reads 1.0 only when
    sample_len - 1 is a multiple of K + 1 (96 tokens at K = 4; at K = 8 the
    upper bracket reads 84 / 88)."""
    k = stats["k"]
    return all(r == -(-(e - 1) // (k + 1)) for r, e in zip(stats["rounds"], stats["emitted"]))


def run(model, draft, ks=(4, 8), trials: Optional[int] = None) -> dict:
    """Both brackets on the plain engine and at each K. Returns {"records":
    one per configuration, "frontend_s", "tokens": {(engine, bracket, K):
    each window's decoded ids} (not printed)}."""
    from .engine import FusedEngine
    from .frontend import encode_clip_spec
    from .speculative import SpeculativeEngine
    from .tokenizer import get_tokenizer

    trials = N_TRIALS if trials is None else trials
    cuda = model.device.type == "cuda"
    tok = get_tokenizer(model.is_multilingual, num_languages=model.num_languages, language="en",
                        task="transcribe")  # fmt: skip
    n_windows = CLIP_SECONDS // 30
    audio = clip_audio(n_windows)

    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck, cv, dck, dcv, n = encode_clip_spec(model, draft, audio)
    if cuda:
        torch.cuda.synchronize()
    t_frontend = time.perf_counter() - t0
    if n != n_windows:
        raise RuntimeError(f"the {CLIP_SECONDS} s clip gave {n} windows, not {n_windows}")

    initial = np.tile(np.array([list(tok.sot_sequence)], np.int32), (n_windows, 1))
    ni = initial.shape[1]
    brackets = bracket_kwargs(tok, model.dims.n_vocab, SAMPLE_LEN)

    def timed(fn):
        fn()  # warm-up: the loop's graphs are captured here
        times = []
        for _ in range(trials):
            t0 = time.perf_counter()
            out = fn()  # numpy outputs: the run has ended on the card
            times.append(time.perf_counter() - t0)
        return float(np.median(times)), out

    def decoded(out):
        return [out[0][a, ni : int(out[1])].tolist() for a in range(n_windows)]

    fe = FusedEngine(model)
    rows, tokens, fused = [], {}, {}
    for label, kw in brackets.items():
        p50, out = timed(lambda: fe.run(initial, ck, cv, n_group=1, beam_search=False, max_candidates=0, **kw))
        fused[label] = (p50, out)
        tokens[("fused_greedy", label, None)] = decoded(out)
        rows.append(dict(engine="fused_greedy", bracket=label, K=None, p50=p50, n=int(out[1]),
                         captured=fe.history[-1].captured))  # fmt: skip
    for k in ks:
        se = SpeculativeEngine(model, draft, k=k)
        for label, kw in brackets.items():
            p50, out = timed(lambda: se.run(initial, ck, cv, dck, dcv, **kw))
            f_out = fused[label][1]
            tokens[("speculative", label, k)] = decoded(out)
            rows.append(dict(
                engine="speculative", bracket=label, K=k, p50=p50, n=int(out[1]),
                captured=se.history[-1].captured,
                acceptance=float(np.mean(se.last_stats["draft_acceptance"])),
                rounds=se.last_stats["rounds"],
                all_accepted=all_accepted(se.last_stats),
                tokens_equal_fused=bool(int(out[1]) == int(f_out[1]) and np.array_equal(out[0], f_out[0])),
            ))  # fmt: skip

    records = []
    for r in rows:
        n_tokens = (r["n"] - ni) * n_windows
        spec = r["engine"] == "speculative"
        records.append({
            "engine": r["engine"],
            "bracket": r["bracket"],
            "K": r["K"],
            "p50_decode_s": r["p50"],
            "tokens": n_tokens,
            "tokens_per_s": n_tokens / r["p50"],
            "vs_fused": fused[r["bracket"]][0] / r["p50"] if spec else 1.0,
            "measured_acceptance": r.get("acceptance"),
            "frontend_s": t_frontend,
            "tokens_equal_fused": r.get("tokens_equal_fused", True),
            "rounds": r.get("rounds"),
            "all_accepted": r.get("all_accepted"),
            "captured": r["captured"],
            "device": device_name(model.device),
        })  # fmt: skip
    return {"records": records, "frontend_s": t_frontend, "tokens": tokens}


def main(argv: Optional[List[str]] = None, model=None, draft=None) -> int:
    """The command. `model`, `draft`: already loaded models in place of
    --target's and --draft's."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("ks", nargs="*", type=int, help="draft lengths K (default: 4 8)")
    ap.add_argument("--target", default="turbo", help="registry name of the target's dims")
    ap.add_argument("--draft", default="tiny", help="registry name of the draft's dims (vocabulary: the target's)")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    if model is None:
        model = build_model(args.target, args.device)
    if draft is None:
        draft = draft_model(model, args.draft, model.device)
    out = run(model, draft, args.ks or [4, 8])
    for rec in out["records"]:
        print(json.dumps(rec), flush=True)
    upper = [r for r in out["records"] if r["bracket"] == "accept1" and r["engine"] == "speculative"]
    return 0 if all(r["all_accepted"] for r in upper) else 1


if __name__ == "__main__":
    sys.exit(main())
