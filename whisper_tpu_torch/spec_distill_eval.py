"""Train a draft against a frozen target and measure speculative decoding's
acceptance and speed with it (the counterpart of tools/spec_distill_eval.py).

The design is the JAX tool's. Acceptance is argmax agreement along the
target's greedy decode path under the engine's filters, so the labels come
from that path: the target's captured engine decodes each synthetic clip
(greedy, no timestamps, EOT suppressed, the clip's mel on the device) and
its token ids label the manifest (`record["tokens"]`; BPE does not
round-trip generated text), with `mel_padding` making the training window
normalize like the decode window. `distill.run_distill` trains a student of
the draft preset's size against the frozen target on that manifest. Then,
on one clip the student trained on and one it never saw, the plain captured
engine's median decode time, and `SpeculativeEngine` at each K with the
distilled draft and with a random-init control draft of the same dims.

The target is random (a registry name builds seeded random weights at that
name's dims, as the JAX tool does; a checkpoint path loads it). Its argmax
is a deterministic but unstructured function of the input, so a student can
agree with it only on audio it trained on: in-sample acceptance shows the
whole mechanism (distill -> agreement -> speed), held-out acceptance is
expected near 0 here (real weights generalize; random ones cannot). The
decode options use the target's own tokenizer (the JAX tool takes the
99-language one for every model, which shifts turbo's task tokens by one).

Every stage is seeded. The label manifest and the trained draft are kept in
--workdir and reused by a later run only where everything that feeds them is
the same: each name ends in a digest of the target (name, dims, compute
dtype, device type), the clips and sample_len, and for the draft also its
size, every training record with its labels, the steps, the batch and the
distill options.

Usage:
    python -m whisper_tpu_torch.spec_distill_eval [K ...]      # default K = 4 8
        [--steps 400] [--clips 16] [--batch 8] [--target turbo] [--draft tiny]
        [--workdir DIR] [--device cuda]

The models compute in bf16 and each time is the median of 5 timed calls,
as in the JAX tool.

Output: one JSON line per split for the plain engine and per (split, K,
draft) for the speculative one, with the JAX tool's keys (engine, split, K,
p50_decode_s, tokens_per_s, speedup_vs_fused, acceptance) and, on the
plain lines, the distinct ids of the target's path (distinct_tokens: a
random target that repeats a few ids on any input lets a student agree
with it on held-out audio too); on the speculative lines, the rounds a row
and the tokens' agreement with the plain engine's (tokens_equal,
common_prefix). Progress and a summary (label
and distill seconds, the distill step's ms) go to stderr as "# " lines.
"""

import argparse
import hashlib
import json
import os
import re
import sys
import time
import wave
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_WORKDIR = os.path.join(ROOT, "spec_distill_work")

SR = 16000
CLIP_S = 20  # <= 30 s: one training window per clip (finetune.make_example)
N_TRIALS = 5
COMPUTE_DTYPE = torch.bfloat16  # the models' compute dtype, as the JAX tool's
SAMPLE_LEN = 96
TRAIN_SEED = 100  # clip i of the manifest is synth_speech(TRAIN_SEED + i)
SPLITS = (("train_clip", TRAIN_SEED), ("heldout_clip", 999))  # (split, clip seed)
CONTROL_SEED = 1  # the control draft's weights (the student starts from seed 0)


# synth_speech and write_wav: copied from tools/spec_distill_eval.py
# (framework-free)
def synth_speech(seed: int, seconds: int = CLIP_S) -> np.ndarray:
    """Speech-shaped noise (1/f tilt + 3 Hz AM), distinct per seed."""
    from scipy.signal import lfilter

    rng = np.random.RandomState(seed)
    n = seconds * SR
    x = rng.randn(n).astype(np.float32)
    y = lfilter([0.03], [1.0, -0.97], x.astype(np.float64))
    env = 0.5 * (1 + np.sin(2 * np.pi * (2.0 + (seed % 5) * 0.5) * np.arange(n) / SR))
    return (y * env * 4.0).astype(np.float32)


def write_wav(path: str, audio: np.ndarray) -> None:
    pcm = np.clip(audio * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())


def pcm16(audio: np.ndarray) -> np.ndarray:
    """The clip as write_wav stores it and the JAX tool decodes it (int16
    by truncation), read back as i / 32768: the labels, the training mel
    and the eval decode all see these samples."""
    q = np.clip(np.asarray(audio) * 32768.0, -32768, 32767).astype(np.int16)
    return q.astype(np.float32) / 32768.0


def eval_tokenizer(model):
    from .tokenizer import get_tokenizer

    return get_tokenizer(
        model.is_multilingual, num_languages=model.num_languages, language="en", task="transcribe"
    )


def decode_kwargs(tok, sample_len: int = SAMPLE_LEN) -> Dict:
    """The eval decode configuration (the JAX tool's decode_kw): labels are
    made under exactly these options, so training and eval walk the same
    teacher path. EOT is suppressed, so every run decodes sample_len
    tokens."""
    return dict(
        sot_index=0, suppress_ids=[tok.eot], blank_ids=tok.encode(" ") + [tok.eot],
        max_initial_ts_index=50, sample_len=sample_len, use_timestamps=False, temperature=0.0,
        eot=tok.eot, timestamp_begin=tok.timestamp_begin, no_timestamps=tok.no_timestamps,
        no_speech=tok.no_speech,
    )  # fmt: skip


def initial_tokens(tok) -> np.ndarray:
    return np.array([list(tok.sot_sequence_including_notimestamps)], np.int32)


def path_tokens(out, n_initial: int) -> List[int]:
    """Row 0's decoded tokens of an engine's output tuple."""
    return [int(t) for t in out[0][0, n_initial : int(out[1])]]


def common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def plain_run(model, ck, cv, sample_len: int = SAMPLE_LEN):
    """The model's cached (on the card: captured) engine on one clip's
    cross-K/V under the eval decode options."""
    from .engine import model_engine

    tok = eval_tokenizer(model)
    return model_engine(model).run(
        initial_tokens(tok), ck, cv, n_group=1, beam_search=False, max_candidates=0,
        **decode_kwargs(tok, sample_len),
    )  # fmt: skip


def teacher_path_tokens(model, audio: np.ndarray, sample_len: int = SAMPLE_LEN) -> List[int]:
    """The target's greedy token path for one clip under the eval options."""
    from .frontend import encode_clip

    ck, cv, _ = encode_clip(model, pcm16(audio))
    tok = eval_tokenizer(model)
    return path_tokens(plain_run(model, ck, cv, sample_len), initial_tokens(tok).shape[1])


def model_tag(model) -> str:
    """The model's name as a file-name part (a checkpoint path's base name)."""
    return re.sub(r"[^A-Za-z0-9._-]", "_", os.path.basename(str(model.name)))


def digest(**parts) -> str:
    """A short digest of everything that feeds a cached stage."""
    return hashlib.sha1(json.dumps(parts, sort_keys=True, default=str).encode()).hexdigest()[:12]


def target_key(model) -> Dict:
    return dict(target=str(model.name), dims=vars(model.dims), dtype=str(model.compute_dtype),
                device=torch.device(model.device).type)  # fmt: skip


def manifest_path(model, workdir: str, clips: int, sample_len: int = SAMPLE_LEN) -> str:
    key = digest(**target_key(model), clips=clips, sample_len=sample_len, seed=TRAIN_SEED)
    return os.path.join(workdir, f"manifest_{model_tag(model)}_{clips}clips_{sample_len}_{key}.jsonl")


def draft_dir(model, draft, records: List[dict], *, steps: int, batch: int, workdir: str, **distill_kw) -> str:
    name = draft if isinstance(draft, str) else "custom"
    key = digest(**target_key(model), draft=draft if isinstance(draft, str) else vars(draft),
                 records=records, steps=steps, batch=batch, distill_kw=distill_kw)  # fmt: skip
    return os.path.join(workdir, f"draft_{name}_{model_tag(model)}_{steps}steps_b{batch}_{key}")


def label_clips(model, workdir: str, clips: int, sample_len: int = SAMPLE_LEN, log=print) -> List[dict]:
    """The synthetic manifest labeled with the target's decode path: one
    record a clip (the WAV's path, the token ids, mel_padding of 30 s),
    written to and reused from workdir (manifest_path)."""
    from .finetune import load_manifest

    path = manifest_path(model, workdir, clips, sample_len)
    if os.path.exists(path):
        log(f"reusing cached manifest {path}")
        return load_manifest(path)
    manifest = []
    for i in range(clips):
        audio = synth_speech(TRAIN_SEED + i)
        wav = os.path.join(workdir, f"clip{i:03d}.wav")
        write_wav(wav, audio)
        manifest.append({
            "audio": wav,
            "tokens": teacher_path_tokens(model, audio, sample_len),
            "mel_padding": 30 * SR,  # normalize like the decode window
        })  # fmt: skip
    with open(path, "w") as f:
        for rec in manifest:
            f.write(json.dumps(rec) + "\n")
    return manifest


class StepTimes:
    """run_distill's log: passes each line on and keeps the host clock of
    each step's line (it follows the host read of that step's loss)."""

    def __init__(self, log):
        self.log, self.times = log, []

    def __call__(self, line):
        if "  loss " in line:
            self.times.append(time.perf_counter())
        self.log(line)

    def step_ms(self) -> List[float]:
        return [(b - a) * 1e3 for a, b in zip(self.times, self.times[1:])]


def distill_draft(model, draft, manifest: List[dict], *, steps: int, batch: int, workdir: str,
                  log=print, **distill_kw) -> Dict:
    """run_distill of a `draft`-sized student (a preset name or dims)
    against the frozen target over the manifest, into workdir (draft_dir;
    reused when there). Returns its directory, loss history, seconds and the
    ms of each step after the first (the host clock between step lines)."""
    from .distill import run_distill

    out_dir = draft_dir(model, draft, manifest, steps=steps, batch=batch, workdir=workdir, **distill_kw)
    if os.path.isdir(out_dir):
        log(f"reusing cached draft {out_dir}")
        return dict(dir=out_dir, cached=True)
    clock = StepTimes(log)
    t0 = time.perf_counter()
    history = run_distill(model, draft, manifest, steps=steps, batch_size=batch, out_dir=out_dir,
                          log=clock, **distill_kw)  # fmt: skip
    step_ms = clock.step_ms()
    return dict(
        dir=out_dir, cached=False, history=history, seconds=time.perf_counter() - t0,
        first_step_s=clock.times[0] - t0, step_ms=step_ms,
        step_ms_p50=float(np.median(step_ms)) if step_ms else None,
    )  # fmt: skip


def control_draft(model, draft):
    """An untrained control: the student's dims, independent random
    weights (CONTROL_SEED), on the target's device and dtype."""
    from .distill import draft_dims
    from .models.whisper import Whisper

    return Whisper(draft_dims(model.dims, draft), None, name="random", device=model.device,
                   compute_dtype=model.compute_dtype, seed=CONTROL_SEED)  # fmt: skip


def timed(run: Callable, trials: int):
    """A warm-up call (it captures on the card), then the median host wall
    of `trials` calls; the engines return host arrays, so each call ends
    with its results on the host. Returns (median s, the last output)."""
    run()
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        out = run()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def evaluate(model, draft, control, ks: Sequence[int], trials: Optional[int] = None,
             sample_len: int = SAMPLE_LEN, emit: Callable = print) -> List[Dict]:
    """The plain captured engine's median decode time on each split's clip,
    then SpeculativeEngine at each K with the distilled and the control
    draft: one record each (also passed to `emit` as it comes). `trials`
    timed calls a median (N_TRIALS by default)."""
    from .frontend import encode_clip, encode_clip_spec
    from .speculative import SpeculativeEngine

    trials = trials or N_TRIALS
    tok = eval_tokenizer(model)
    initial, kw = initial_tokens(tok), decode_kwargs(tok, sample_len)
    P = initial.shape[1]
    lines = []

    def put(line):
        lines.append(line)
        emit(line)

    for split, seed in SPLITS:
        audio = pcm16(synth_speech(seed))
        ck, cv, dck, dcv, _ = encode_clip_spec(model, draft, audio)
        rck, rcv, _ = encode_clip(control, audio)
        p50_base, out = timed(lambda: plain_run(model, ck, cv, sample_len), trials)
        plain = path_tokens(out, P)
        put({"engine": "fused_greedy", "split": split, "K": None, "p50_decode_s": p50_base,
             "tokens_per_s": sample_len / p50_base, "distinct_tokens": len(set(plain))})  # fmt: skip
        for k in ks:
            for kind, d, dk, dv in (("distilled", draft, dck, dcv), ("random", control, rck, rcv)):
                se = SpeculativeEngine(model, d, k=k)
                p50, out = timed(lambda: se.run(initial, ck, cv, dk, dv, **kw), trials)
                got = path_tokens(out, P)
                put({
                    "engine": f"speculative_{kind}", "split": split, "K": k, "p50_decode_s": p50,
                    "tokens_per_s": sample_len / p50, "speedup_vs_fused": p50_base / p50,
                    "acceptance": float(np.mean(se.last_stats["draft_acceptance"])),
                    "rounds": se.last_stats["rounds"], "tokens_equal": got == plain,
                    "common_prefix": common_prefix(got, plain),
                })  # fmt: skip
    return lines


def run(model, draft="tiny", *, ks: Sequence[int] = (4, 8), steps: int = 400, clips: int = 16,
        batch: int = 8, workdir: str = DEFAULT_WORKDIR, trials: Optional[int] = None,
        sample_len: int = SAMPLE_LEN, extra_records: Sequence[dict] = (), log=print,
        emit: Callable = print, **distill_kw) -> Dict:
    """The whole evaluation for a target model and a draft (a preset name
    or dims): label the clips, distill, load the draft on the target's
    device and dtype, evaluate. `extra_records` join the training manifest
    (records without labels are pseudo-labeled by run_distill). Returns the
    manifest, each stage's seconds, the distill record and the lines."""
    from . import load_model

    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    manifest = label_clips(model, workdir, clips, sample_len, log)
    labels_s = time.perf_counter() - t0
    distilled = distill_draft(model, draft, manifest + list(extra_records), steps=steps, batch=batch,
                              workdir=workdir, log=log, **distill_kw)  # fmt: skip
    student = load_model(distilled["dir"], device=model.device, compute_dtype=model.compute_dtype)
    control = control_draft(model, draft)
    t = time.perf_counter()
    lines = evaluate(model, student, control, ks, trials, sample_len, emit)
    return dict(manifest=manifest, labels_s=labels_s, distill=distilled, eval_s=time.perf_counter() - t,
                lines=lines, seconds=time.perf_counter() - t0)  # fmt: skip


def build_target(target: str, device):
    """A registry name: seeded random weights at its dims (the JAX tool's
    target; nothing is downloaded). Anything else: load_model's path. Both
    compute in COMPUTE_DTYPE."""
    from . import load_model
    from .models.dims import MODEL_DIMS
    from .models.whisper import Whisper

    if target in MODEL_DIMS:
        return Whisper(MODEL_DIMS[target], None, name=target, device=device, compute_dtype=COMPUTE_DTYPE)
    return load_model(target, device=device, compute_dtype=COMPUTE_DTYPE)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("ks", nargs="*", type=int, default=None, help="draft lengths K (default 4 8)")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--clips", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--target", default="turbo", help="registry name (random weights) or checkpoint")
    ap.add_argument("--draft", default="tiny", help="the student's size preset")
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)

    def log(msg):
        # the first step, every hundredth and the pseudo-labeling, as the JAX tool
        if "00/" in msg or msg.startswith("step 1/") or "pseudo" in msg or "reusing" in msg:
            print(f"# {msg}", file=sys.stderr, flush=True)

    def emit(line):
        print(json.dumps(line), flush=True)

    t0 = time.perf_counter()
    model = build_target(args.target, args.device)
    out = run(
        model, args.draft, ks=args.ks or [4, 8], steps=args.steps, clips=args.clips, batch=args.batch,
        workdir=args.workdir, log=log, emit=emit,
    )  # fmt: skip
    d = out["distill"]
    summary = dict(labels_s=out["labels_s"], eval_s=out["eval_s"], run_s=time.perf_counter() - t0,
                   distill={k: d[k] for k in ("cached", "seconds", "first_step_s", "step_ms_p50") if k in d})  # fmt: skip
    if "history" in d:
        summary["distill"].update(loss_first=d["history"][0], loss_last=d["history"][-1])
    print(f"# {json.dumps(summary)}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
