"""One-command export: a model -> the native runner's pipeline directory, and
the runner built (the counterpart of tools/export_pipeline.py).

    python -m whisper_tpu_torch.export_pipeline --model turbo --out DIR
    python -m whisper_tpu_torch.export_pipeline --checkpoint model.npz --out DIR
    python -m whisper_tpu_torch.export_pipeline --model tiny --random-weights --out DIR
    RUNNER DIR audio.flac [--beam]      (RUNNER: the path this prints)

It loads the model on `--device` (cuda unless the CPU is asked for), writes
every file export.export_pipeline writes (the graphs as torch.export
programs, AOT-compiled by AOTInductor when the model is on the card, with
Inductor's caches in `--cache-dir`), then builds the native runner
(runtime/build.build_runner) unless `--no-build`, and prints its path.
"""

import argparse

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m whisper_tpu_torch.export_pipeline")
    ap.add_argument("--model", default=None, help="registry name (downloads)")
    ap.add_argument("--checkpoint", default=None, help="local .pt / .npz checkpoint or checkpoint directory")
    ap.add_argument("--out", required=True)
    ap.add_argument("--language", default="en")
    ap.add_argument("--task", default="transcribe")
    ap.add_argument("--beam-size", type=int, default=5)
    ap.add_argument("--sample-len", type=int, default=446)
    ap.add_argument("--weights", default="bf16", choices=["bf16", "int8"], help="decode-loop weight storage (int8 = weight-only quantized)")
    ap.add_argument("--random-weights", action="store_true", help="seeded random weights at the model's dims (offline testing)")
    ap.add_argument("--no-build", action="store_true", help="skip building the native runner")
    ap.add_argument("--device", default="cuda", help="device to export and compile for: cuda (a card is required) or cpu (no AOT compile)")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"], help="the model's compute dtype")
    ap.add_argument("--cache-dir", default=None, help="Inductor's and Triton's cache directory (runtime_config.configure_compile_cache)")
    args = ap.parse_args(argv)

    from . import load_model
    from .export import export_pipeline
    from .models.dims import MODEL_DIMS

    dtype = getattr(torch, args.compute_dtype)
    if args.checkpoint:
        model = load_model(args.checkpoint, compute_dtype=dtype, device=args.device)
    elif args.random_weights:
        dims = MODEL_DIMS[args.model or "turbo"]
        model = load_model(None, dims=dims, compute_dtype=dtype, device=args.device)
    elif args.model:
        model = load_model(args.model, compute_dtype=dtype, device=args.device)
    else:
        ap.error("one of --model / --checkpoint / --random-weights required")

    export_pipeline(
        args.out, model, language=args.language, task=args.task, sample_len=args.sample_len,
        beam_size=args.beam_size, weights=args.weights, cache_dir=args.cache_dir,
    )  # fmt: skip
    print(f"exported pipeline -> {args.out}")

    if not args.no_build:
        from .runtime.build import build_runner

        print(f"native runner: {build_runner()}")


if __name__ == "__main__":
    main()
