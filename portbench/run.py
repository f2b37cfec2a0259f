"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It measures `whisper_tpu_torch` (the
checkout's own copy) on one card: with --trace 0 the cell's end-to-end
metrics, with --trace 1 its per-layer metrics, and in both the comparison
with the float32 reference that decides `correct`. The last line of
standard output is the result; the last lines of standard error are the
numbers compared, each beside its limit. With no card, or fewer cards than
the cell asks for, or JAX or the JAX package loaded once the window has
closed, it prints no result and exits with 2.

The program's caches live in the checkout: the kernels' library in
whisper_tpu_torch/_build/ (the program's own), the CUDA, Triton and
extension caches under _portbench_cache/.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "_portbench_cache")
for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_TF"] = "0"
sys.path.insert(0, ROOT)


def fail(message: str) -> int:
    print(f"portbench: {message}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import spec

    chips = spec.load_json(spec.HERE, "workloads", f"{args.workload}.json")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return fail(f"the cell needs {chips} CUDA device(s); this machine has none or fewer")
    try:
        import whisper_tpu_torch
    except ImportError as e:
        return fail(f"the program is not in this checkout: {e}")
    if not os.path.abspath(whisper_tpu_torch.__file__).startswith(ROOT + os.sep):
        return fail(f"whisper_tpu_torch was loaded from {whisper_tpu_torch.__file__}, outside the checkout")

    from portbench import harness

    result, _ = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    loaded = spec.forbidden_loaded(sys.modules)
    if loaded:
        return fail(f"JAX or the JAX package was loaded: {', '.join(loaded)}")
    print(json.dumps(result), flush=True)
    for name, row in result["check"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
