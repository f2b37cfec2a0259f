"""How `correct` is decided: the windows the timed path served, held to the
plain float32 reference (reference/whisper_f32.py) computed again from the
same audio and weights.

Every served window must be there, once for each time its audio was
served, with exactly sample_len tokens (`bad_windows`, an exact count). A
sample of the windows, drawn from the seed with a window of the longest
audio in it (its last, the shortest), goes through the reference: the
log-mel, the encoder, and the decoder teacher-forced over the initial
tokens and the served tokens, with the decode's filters (the suppressed
ids, the blank ids at the first position). Three numbers, in nats; a
cell compares those its file gives a limit (those its control separates
from sound runs), and the run prints all three:

  token_gap         the widest gap by which a served token's log-probability
                    lies below the reference's k-th best at its position,
                    k = the candidates a beam extends per row (beam + 1) or
                    1 for greedy: a token no sound decoder could have chosen
  token_gap_mean    the same gaps' mean over every sampled token
  avg_logprob_gap   the widest gap between a window's mean log-probability
                    as the program reports it and the reference's for the
                    same tokens

`control=True` also reads them for the fp8 reference in the program's
place: it decodes each sampled window itself, as the cell's traffic does
(greedy, or a beam search of beam + 1 candidates a beam), and its tokens
and the mean log-probability it reports go through the same numbers
against the float32 reference, as the served windows do.
"""

import dataclasses
from collections import Counter

import numpy as np
import torch

from portbench import inputs
from portbench.reference.whisper_f32 import Reference
from portbench.work import clock

NUMBERS = ("token_gap", "token_gap_mean", "avg_logprob_gap")


def structure(ctx, served) -> int:
    """Windows missing, extra or of the wrong length."""
    bad = 0
    for audio, times in ctx.times.items():
        want = Counter({s: times for s in ctx.expected[audio]})
        got = Counter(w.seek for w in served if w.audio == audio)
        bad += sum(((want - got) + (got - want)).values())
    bad += sum(1 for w in served if w.audio not in ctx.times)
    bad += sum(1 for w in served if len(w.tokens) != ctx.mix["sample_len"])
    return bad


def sample(ctx, served, rng: np.random.Generator):
    """check_windows of the served windows: the last window of a longest
    audio, the rest drawn from rng."""
    full = [w for w in served if len(w.tokens) == ctx.mix["sample_len"]]
    if not full:
        return []
    longest = [w for w in full if w.audio in ctx.longest]
    first = max(longest, key=lambda w: w.seek) if longest else full[0]
    rest = [w for w in full if w is not first]
    k = min(len(rest), ctx.mix["check_windows"] - 1)
    picks = rng.choice(len(rest), size=k, replace=False) if k else []
    return [first] + [rest[i] for i in sorted(picks)]


def _filter(cfg, logits: torch.Tensor, first: bool) -> torch.Tensor:
    """The decode's logit filters, in place: the suppressed ids, and at the
    first sampled position the blank ids and EOT."""
    logits[..., inputs.suppress_ids(cfg)] = float("-inf")
    if first:
        logits[..., cfg["tokens"]["blank"] + [cfg["tokens"]["eot"]]] = float("-inf")
    return logits


def _filtered_logprobs(ref: Reference, ctx, windows, xa) -> torch.Tensor:
    """(N, L, V) float32 log-probabilities of each window's positions
    under the decode's filters."""
    cfg = ctx.config
    init = inputs.initial_tokens(cfg)
    toks = torch.tensor([init + w.tokens[:-1] for w in windows])
    logits = ref.logits(xa, toks)[:, len(init) - 1 :]
    _filter(cfg, logits, False)
    _filter(cfg, logits[:, 0], True)
    return torch.log_softmax(logits, dim=-1)


def _encode(ref: Reference, ctx, windows):
    mels = {}
    for w in windows:
        if w.audio not in mels:
            mels[w.audio] = ref.log_mel(ctx.audios[w.audio])
    return ref.encode(torch.stack([ref.window(mels[w.audio], w.seek, w.size) for w in windows]))


def _candidates(mix) -> int:
    """The candidates a row extends each step: beam + 1 in a beam search
    (the k-th best a served token may be), 1 for greedy."""
    return mix["beam_size"] + 1 if mix.get("beam_size") else 1


def decode(ref: Reference, ctx, xa: torch.Tensor) -> tuple:
    """The reference in the program's place: each window's sample_len
    tokens decoded as the traffic decodes them, greedy or a beam search
    (each beam's beam + 1 best continuations, the best `beam` sums kept;
    EOT is suppressed, so every beam runs to sample_len and the best sum
    is served). Returns (tokens (A, L), the mean log-probability it would
    report (A,), over the tokens and the EOT)."""
    cfg, n = ctx.config, ctx.mix["sample_len"]
    G, k = ctx.mix.get("beam_size") or 1, _candidates(ctx.mix)
    A, dev = xa.shape[0], xa.device
    init = inputs.initial_tokens(cfg)
    cross = ref.cross_kv(xa)
    toks = torch.tensor(init, device=dev).repeat(A * G, 1)
    sums = torch.full((A, G), float("-inf"), device=dev)
    sums[:, 0] = 0.0  # the beams start as one: the first step fans it out
    rows = torch.arange(A, device=dev)[:, None] * G
    for i in range(n):
        lp = torch.log_softmax(_filter(cfg, ref.logits(cross, toks, last=True), i == 0), dim=-1)
        top, ids = lp.topk(k, dim=-1)  # (A * G, k)
        sums, pick = (sums.reshape(-1, 1) + top).reshape(A, G * k).topk(G, dim=-1)
        src = (rows + pick // k).reshape(-1)
        toks = torch.cat([toks[src], ids.reshape(A, G * k).gather(1, pick).reshape(-1, 1)], dim=1)
    best = sums.argmax(-1)
    tokens = toks.reshape(A, G, -1)[torch.arange(A, device=dev), best, len(init) :]
    return tokens, sums.gather(1, best[:, None])[:, 0] / (n + 1)


def _gaps(ref: Reference, ctx, windows, xa) -> dict:
    """The numbers of `windows` (their tokens and the mean
    log-probabilities they report) against the float32 reference."""
    lp = _filtered_logprobs(ref, ctx, windows, xa)
    served = torch.tensor([w.tokens for w in windows], device=lp.device)[..., None]
    served_lp = lp.gather(-1, served)[..., 0]  # (N, L)
    n = served_lp.shape[-1] + 1  # the mean's denominator: the tokens and the EOT
    reported = torch.tensor([w.avg_logprob for w in windows], device=lp.device)
    kth = lp.topk(_candidates(ctx.mix), dim=-1).values[..., -1]
    gap = (kth - served_lp).clamp(min=0)
    avg_gap = (reported - served_lp.sum(-1) / n).abs().amax()
    return {"token_gap": float(gap.amax()), "token_gap_mean": float(gap.mean()), "avg_logprob_gap": float(avg_gap)}


def numbers(ctx, windows, control: bool = False) -> dict:
    """The numbers over `windows`; with `control`, also the fp8
    reference's, decoding the same windows in the program's place
    (`control_<number>`)."""
    cfg = ctx.config
    dims = dict(n_audio_head=cfg["encoder_attention_heads"], n_text_head=cfg["decoder_attention_heads"], n_mels=cfg["num_mel_bins"])
    ref = Reference(ctx.params, **dims)
    xa = _encode(ref, ctx, windows)
    out = _gaps(ref, ctx, windows, xa)
    if control:
        low = Reference(ctx.params, precision="fp8", **dims)
        tokens, avg = decode(low, ctx, _encode(low, ctx, windows))
        decoded = [dataclasses.replace(w, tokens=t, avg_logprob=float(a)) for w, t, a in zip(windows, tokens.tolist(), avg.tolist())]
        out.update({f"control_{k}": v for k, v in _gaps(ref, ctx, decoded, xa).items()})
    return out


def compare(ctx, served, rng: np.random.Generator, control: bool = False) -> dict:
    """Every number of the comparison, with the sample's size and the
    reference's seconds."""
    t0 = clock()
    out = {"bad_windows": structure(ctx, served)}
    windows = sample(ctx, served, rng)
    if windows:
        with torch.no_grad():
            out.update(numbers(ctx, windows, control))
    out["checked_windows"] = len(windows)
    # windows of different audio decode different tokens: the check can see a wrong audio's
    out["distinct_token_strings"] = len({tuple(w.tokens) for w in windows})
    out["checked_tokens"] = sum(len(w.tokens) for w in windows)
    out["reference_s"] = clock() - t0
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): each number the cell's file gives
    a limit at or under it (a cell compares only the numbers its control
    separates); a number missing (no window to compare) is a failure."""
    rows = [("bad_windows", numbers.get("bad_windows"), 0)]
    rows += [(n, numbers.get(n), limits[n]) for n in NUMBERS if n in limits]
    ok = all(v is not None and np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
