"""Command line: `whisper-tpu-torch AUDIO... [flags]` or
`python -m whisper_tpu_torch AUDIO... [flags]`.

The flag surface of whisper_tpu/cli.py, with `--device` (default cuda; the
model runs on the card unless the caller asks for the CPU) and
`--compute_dtype` read as a torch dtype. `--parallel True` transcribes all
the files together through transcribe_batch; otherwise each file goes
through transcribe() in turn. Each file's transcript is written as txt,
vtt, srt, tsv and json (or the one `--output_format`). After each file (and
after the batch) the cumulative per-graph report of profiling.py is
printed; `--profile_sync True` makes its spans wait for the card.
"""

import argparse
import os
import traceback
import warnings
from timeit import default_timer as timer

import numpy as np
import torch

from . import profiling
from .tokenizer import LANGUAGES, TO_LANGUAGE_CODE
from .utils import get_writer, optional_float, optional_int, str2bool

# the options transcribe_batch takes; the others are transcribe()'s only
_BATCH_OPTIONS = (
    "language", "task", "compression_ratio_threshold", "logprob_threshold",
    "no_speech_threshold", "condition_on_previous_text", "word_timestamps",
    "prepend_punctuations", "append_punctuations", "beam_size", "patience", "best_of",
    "length_penalty", "suppress_tokens",
)  # fmt: skip


def _valid_model_name(name):
    from .models.registry import available_models

    if name in available_models() or os.path.exists(name):
        return name
    raise ValueError(f"model should be one of {available_models()} or a path to a checkpoint")


def cli():
    # fmt: off
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("audio", nargs="+", type=str, help="audio file(s) to transcribe")
    parser.add_argument("--model", default="turbo", type=_valid_model_name, help="name of the Whisper model to use, or a local .pt / .npz checkpoint")
    parser.add_argument("--model_dir", type=str, default=None, help="the path to save model files; uses ~/.cache/whisper by default")
    parser.add_argument("--device", type=str, default="cuda", help="device to run the model on: cuda (a card is required) or cpu")
    parser.add_argument("--output_dir", "-o", type=str, default=".", help="directory to save the outputs")
    parser.add_argument("--output_format", "-f", type=str, default="all", choices=["txt", "vtt", "srt", "tsv", "json", "all"], help="format of the output file")
    parser.add_argument("--verbose", type=str2bool, default=True, help="whether to print out progress and debug messages")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"], help="the model's compute dtype")
    parser.add_argument("--weights", type=str, default="bf16", choices=["bf16", "int8"], help="decode-loop weight storage: int8 decodes with weight-only quantized weights (not held token-equal to bf16)")
    parser.add_argument("--draft_model", type=str, default=None, help="optional draft model for speculative greedy decoding (it must share the model's vocabulary and n_mels); the tokens are those of plain greedy")
    parser.add_argument("--draft_k", type=int, default=4, help="tokens drafted per speculative round (with --draft_model)")
    parser.add_argument("--profile_sync", type=str2bool, default=False, help="make the per-graph timing report's spans wait for the card (device time, at a wait per graph)")

    parser.add_argument("--task", type=str, default="transcribe", choices=["transcribe", "translate"], help="transcribe (X->X) or translate (X->English)")
    parser.add_argument("--language", type=str, default=None, choices=sorted(LANGUAGES.keys()) + sorted([k.title() for k in TO_LANGUAGE_CODE.keys()]), help="language spoken in the audio; None performs language detection")

    parser.add_argument("--temperature", type=float, default=0, help="temperature to use for sampling")
    parser.add_argument("--best_of", type=optional_int, default=5, help="number of candidates when sampling with non-zero temperature")
    parser.add_argument("--beam_size", type=optional_int, default=5, help="number of beams in beam search, only applicable when temperature is zero")
    parser.add_argument("--patience", type=float, default=None, help="optional patience value in beam decoding (arxiv:2204.05424); 1.0 is conventional beam search")
    parser.add_argument("--length_penalty", type=float, default=None, help="optional token length penalty coefficient (alpha, arxiv:1609.08144); simple length normalization by default")

    parser.add_argument("--suppress_tokens", type=str, default="-1", help="comma-separated token ids to suppress; '-1' suppresses most special characters except common punctuation")
    parser.add_argument("--initial_prompt", type=str, default=None, help="optional text to provide as a prompt for the first window")
    parser.add_argument("--carry_initial_prompt", type=str2bool, default=False, help="prepend initial_prompt to every internal decode() call")

    parser.add_argument("--condition_on_previous_text", type=str2bool, default=True, help="provide the previous output as a prompt for the next window")

    parser.add_argument("--temperature_increment_on_fallback", type=optional_float, default=0.2, help="temperature increment when decoding fails the quality gates")
    parser.add_argument("--compression_ratio_threshold", type=optional_float, default=2.4, help="gzip compression ratio above which decoding is treated as failed")
    parser.add_argument("--logprob_threshold", type=optional_float, default=-1.0, help="average log probability below which decoding is treated as failed")
    parser.add_argument("--no_speech_threshold", type=optional_float, default=0.6, help="<|nospeech|> probability above which (with failed logprob) a segment is silence")
    parser.add_argument("--word_timestamps", type=str2bool, default=False, help="extract word-level timestamps via cross-attention DTW")
    parser.add_argument("--prepend_punctuations", type=str, default="\"'“¿([{-", help="with --word_timestamps: merge these punctuations with the next word")
    parser.add_argument("--append_punctuations", type=str, default="\"'.。,，!！?？:：”)]}、", help="with --word_timestamps: merge these punctuations with the previous word")
    parser.add_argument("--highlight_words", type=str2bool, default=False, help="(requires --word_timestamps) underline each word as it is spoken in srt/vtt")
    parser.add_argument("--max_line_width", type=optional_int, default=None, help="(requires --word_timestamps) max characters per subtitle line")
    parser.add_argument("--max_line_count", type=optional_int, default=None, help="(requires --word_timestamps) max lines per subtitle segment")
    parser.add_argument("--max_words_per_line", type=optional_int, default=None, help="(requires --word_timestamps, no effect with --max_line_width) max words per subtitle segment")
    parser.add_argument("--clip_timestamps", type=str, default="0", help="comma-separated start,end,... timestamps (seconds) of clips to process")
    parser.add_argument("--parallel", type=str2bool, default=False, help="transcribe all input files together in batched rounds (transcribe_batch); incompatible with --clip_timestamps and --initial_prompt; the hallucination option is ignored")
    parser.add_argument("--hallucination_silence_threshold", type=optional_float, help="(requires --word_timestamps) skip silences longer than this (seconds) on suspected hallucinations")
    # fmt: on
    args = parser.parse_args().__dict__
    model_name: str = args.pop("model")
    model_dir: str = args.pop("model_dir")
    device: str = args.pop("device")
    output_dir: str = args.pop("output_dir")
    output_format: str = args.pop("output_format")
    compute_dtype = getattr(torch, args.pop("compute_dtype"))
    weights: str = args.pop("weights")
    draft_name: str = args.pop("draft_model")
    draft_k: int = args.pop("draft_k")
    profiling.set_sync(args.pop("profile_sync"))
    os.makedirs(output_dir, exist_ok=True)

    if model_name.endswith(".en") and args["language"] not in {"en", "English"}:
        if args["language"] is not None:
            warnings.warn(
                f"{model_name} is an English-only model but received "
                f"'{args['language']}'; using English instead."
            )
        args["language"] = "en"

    temperature = args.pop("temperature")
    if (increment := args.pop("temperature_increment_on_fallback")) is not None:
        temperature = tuple(np.arange(temperature, 1.0 + 1e-6, increment))
    else:
        temperature = [temperature]

    from . import load_model

    model = load_model(
        model_name, download_root=model_dir, compute_dtype=compute_dtype, device=device,
        weights=weights,
    )  # fmt: skip
    if draft_name is not None:
        draft = load_model(
            draft_name, download_root=model_dir, compute_dtype=compute_dtype, device=device
        )
        model.set_draft_model(draft, k=draft_k)

    writer = get_writer(output_format, output_dir)
    word_options = ["highlight_words", "max_line_count", "max_line_width", "max_words_per_line"]
    if not args["word_timestamps"]:
        for option in word_options:
            if args[option]:
                parser.error(f"--{option} requires --word_timestamps True")
    if args["max_line_count"] and not args["max_line_width"]:
        warnings.warn("--max_line_count has no effect without --max_line_width")
    if args["max_words_per_line"] and args["max_line_width"]:
        warnings.warn("--max_words_per_line has no effect with --max_line_width")
    writer_args = {arg: args.pop(arg) for arg in word_options}

    parallel = args.pop("parallel")
    audio_paths = args.pop("audio")
    if parallel and len(audio_paths) > 1:
        from .batch import transcribe_batch

        if args.get("clip_timestamps", "0") not in ("0", ""):
            parser.error("--parallel does not support --clip_timestamps")
        if args.get("initial_prompt") is not None:
            parser.error("--parallel does not support --initial_prompt")
        batch_args = {k: v for k, v in args.items() if k in _BATCH_OPTIONS and v is not None}
        start = timer()
        results = transcribe_batch(model, audio_paths, temperature=temperature, **batch_args)
        print(f"transcribe_batch() of {len(audio_paths)} files took {timer() - start: .3f}s")
        profiling.print_report()
        for audio_path, result in zip(audio_paths, results):
            writer(result, audio_path, **writer_args)
        return

    for audio_path in audio_paths:
        try:
            start = timer()
            result = model.transcribe(audio_path, temperature=temperature, **args)
            print("---------------------------")
            print(f"transcribe() took {timer() - start: .3f}s")
            profiling.print_report()
            writer(result, audio_path, **writer_args)
        except Exception:
            traceback.print_exc()
            print(f"Skipping {audio_path} due to an error (see traceback above)")


if __name__ == "__main__":
    cli()
