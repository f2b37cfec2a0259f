"""Word error rate of the port's transcripts (the counterpart of
tools/eval_wer.py): a self-contained Levenshtein WER over normalized words
(EnglishTextNormalizer for English, BasicTextNormalizer otherwise), no
jiwer.

  python -m whisper_tpu_torch.eval_wer --ref ref.txt --hyp hyp.txt [--language en]
  python -m whisper_tpu_torch.eval_wer --ref-dir refs/ --audio-dir wavs/ --model tiny.en
  python -m whisper_tpu_torch.eval_wer --librispeech .../LibriSpeech/test-clean --model turbo [--limit 100]

In the second form each refs/<name>.txt is compared against transcribe()
of <audio-dir>/<name>.*. The third walks the official LibriSpeech layout
(<spk>/<chap>/<spk>-<chap>-<utt>.flac beside <spk>-<chap>.trans.txt
reference lines; data/README.md has the dataset's recipe). The model loads
on the card unless --device says otherwise; `--weights int8` decodes with
weight-only int8 (load_model's weights mode), `--temperature 0` pins the
fallback ladder for deterministic runs. One "WER x  (n ref words)" line an
utterance, then "overall WER: x over n words".
"""

import argparse
import os
import sys
from typing import List, Optional, Tuple

import numpy as np


# word_error_rate: copied from tools/eval_wer.py (framework-free)
def word_error_rate(ref_words, hyp_words) -> float:
    """Levenshtein distance over words / reference length."""
    n, m = len(ref_words), len(hyp_words)
    if n == 0:
        return float(m > 0)
    prev = np.arange(m + 1)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, dtype=np.int64)
        cur[0] = i
        for j in range(1, m + 1):
            sub = prev[j - 1] + (ref_words[i - 1] != hyp_words[j - 1])
            cur[j] = min(sub, prev[j] + 1, cur[j - 1] + 1)
        prev = cur
    return float(prev[m]) / n


def librispeech_items(root: str, limit: Optional[int] = None) -> List[Tuple[str, str]]:
    """(flac path, reference text) of every utterance under a LibriSpeech
    split root that its chapter's trans.txt names, in walk order."""
    items = []
    for dirpath, _, files in sorted(os.walk(root)):
        refs = {}
        for f in files:
            if f.endswith(".trans.txt"):
                with open(os.path.join(dirpath, f)) as fh:
                    for line in fh:
                        utt, _, text = line.strip().partition(" ")
                        refs[utt] = text
        for f in sorted(files):
            if f.endswith(".flac") and f[: -len(".flac")] in refs:
                items.append((os.path.join(dirpath, f), refs[f[: -len(".flac")]]))
    return items[:limit] if limit else items


def ref_dir_items(ref_dir: str, audio_dir: str) -> List[Tuple[str, str]]:
    """(audio path, reference text) for each <name>.txt of ref_dir whose
    <name>.* is in audio_dir; the others are reported and skipped."""
    items = []
    for fname in sorted(os.listdir(ref_dir)):
        if not fname.endswith(".txt"):
            continue
        stem = fname[:-4]
        audio = next(
            (os.path.join(audio_dir, f) for f in sorted(os.listdir(audio_dir)) if f.rsplit(".", 1)[0] == stem),
            None,
        )
        if audio is None:
            print(f"skipping {stem}: no matching audio", file=sys.stderr)
            continue
        with open(os.path.join(ref_dir, fname)) as fh:
            items.append((audio, fh.read()))
    return items


def score(pairs, language: str = "en") -> Tuple[List[Tuple[float, int]], Optional[float], int]:
    """Each (reference, hypothesis) pair's WER and reference words after the
    language's normalizer, and the overall WER (None when no reference has
    a word) over all reference words."""
    from .normalizers import BasicTextNormalizer, EnglishTextNormalizer

    normalizer = EnglishTextNormalizer() if language == "en" else BasicTextNormalizer()
    per, total_err, total_words = [], 0.0, 0
    for ref, hyp in pairs:
        r, h = normalizer(ref).split(), normalizer(hyp).split()
        wer = word_error_rate(r, h)
        per.append((wer, len(r)))
        total_err += wer * len(r)
        total_words += len(r)
    return per, (total_err / total_words if total_words else None), total_words


def main(argv: Optional[List[str]] = None, model=None) -> int:
    """The command. `model`: an already loaded model to transcribe with in
    place of --model's (its engines take --weights all the same)."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ref", help="reference transcript file")
    ap.add_argument("--hyp", help="hypothesis transcript file")
    ap.add_argument("--ref-dir", help="directory of <name>.txt references")
    ap.add_argument("--audio-dir", help="directory of audio files to transcribe")
    ap.add_argument(
        "--librispeech", help="LibriSpeech split root (e.g. .../LibriSpeech/test-clean); uses the "
        "official *.trans.txt references",
    )  # fmt: skip
    ap.add_argument("--limit", type=int, help="evaluate at most N utterances")
    ap.add_argument("--model", default="tiny.en")
    ap.add_argument("--language", default="en")
    ap.add_argument(
        "--dtype", default="bfloat16", help="compute dtype of the model (float32 to match CPU-reference "
        "transcripts exactly)",
    )  # fmt: skip
    ap.add_argument(
        "--temperature", help="decode temperature(s), comma-separated ('0' disables the fallback "
        "ladder); default: the standard 0..1.0 ladder",
    )  # fmt: skip
    ap.add_argument(
        "--weights", default="", choices=["", "int8"],
        help="decode-weight mode ('int8': weight-only quantized decode, for the bf16-vs-int8 WER delta)",
    )  # fmt: skip
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)

    transcribe_kw = {}
    if args.temperature is not None:
        temps = tuple(float(t) for t in args.temperature.split(","))
        transcribe_kw["temperature"] = temps[0] if len(temps) == 1 else temps

    if args.ref and args.hyp:
        with open(args.ref) as r, open(args.hyp) as h:
            pairs = [(r.read(), h.read())]
    else:
        if args.librispeech:
            items = librispeech_items(args.librispeech, args.limit)
            if not items:
                ap.error(f"no LibriSpeech utterances found under {args.librispeech}")
        elif args.ref_dir and args.audio_dir:
            items = ref_dir_items(args.ref_dir, args.audio_dir)
        else:
            ap.error("provide --ref/--hyp, --ref-dir/--audio-dir, or --librispeech")
        print(f"evaluating {len(items)} utterances with {args.model if model is None else model.name}",
              file=sys.stderr)  # fmt: skip
        pairs = transcribe_items(model, args, items, transcribe_kw)

    per, overall, total_words = score(pairs, args.language)
    for wer, n in per:
        print(f"WER {wer:.4f}  ({n} ref words)")
    if overall is not None:
        print(f"\noverall WER: {overall:.4f} over {total_words} words")
    return 0


def transcribe_items(model, args, items, transcribe_kw) -> List[Tuple[str, str]]:
    """(reference, transcript) of each item, with `model` or --model's,
    decoding in --weights' mode."""
    from . import load_model
    from .quant import check_weights_mode

    weights = check_weights_mode(args.weights)
    if model is None:
        model = load_model(args.model, device=args.device, compute_dtype=args.dtype, weights=weights)
    before, model.decode_weights = model.decode_weights, weights
    try:
        pairs = []
        for i, (audio, ref) in enumerate(items):
            result = model.transcribe(audio, language=args.language, verbose=None, **transcribe_kw)
            pairs.append((ref, result["text"]))
            if (i + 1) % 50 == 0:
                print(f"  {i + 1}/{len(items)}", file=sys.stderr)
    finally:
        model.decode_weights = before
    return pairs


if __name__ == "__main__":
    sys.exit(main())
