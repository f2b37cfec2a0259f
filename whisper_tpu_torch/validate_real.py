"""Real-weight readiness drill (the counterpart of tools/validate_real.py):
one command that produces the real-checkpoint evidence the port can give
once official weights, and for the WER sections LibriSpeech, are on the
machine.

    python -m whisper_tpu_torch.validate_real [--models tiny.en,turbo]
        [--librispeech PATH] [--limit 100] [--draft DIR] [--device cuda]
        [--offline] [--out validate_real_torch_report.json]

It (1) uses each requested official checkpoint when the registry's cache
holds it, and downloads it through `registry.download_checkpoint` when a
network is up (`--offline` skips the probe: no host is contacted), (2) runs
the real-checkpoint E2E pytest contract (tests/test_torch_real_checkpoint.py:
the canonical jfk transcript, word timings, beam 5, language detection),
(3) measures WER over a LibriSpeech split through whisper_tpu_torch.eval_wer
when --librispeech names one, and the bf16-vs-int8 WER delta on the same
utterances, (4) runs a long-form structural check (repeated-clip audio:
monotone segments, the repeated canonical phrase, the seek reaching the end)
and (5) measures a trained draft's speculative acceptance (--draft, a
whisper_tpu_torch.distill directory) against plain greedy. Without weights,
each section reports "skipped" with its reason; the report is always
written, and the exit code is 0 unless a section that ran failed.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JFK = os.path.join(ROOT, "tests", "data", "jfk.flac")
E2E_TESTS = os.path.join(ROOT, "tests", "test_torch_real_checkpoint.py")
OK = ("ok", "passed", "skipped", "cached", "downloaded")


def network_up(timeout: float = 5.0) -> bool:
    """Whether the registry's tiny.en URL answers a HEAD request."""
    import urllib.request

    from .models.registry import _MODELS

    try:
        req = urllib.request.Request(_MODELS["tiny.en"], method="HEAD")
        urllib.request.urlopen(req, timeout=timeout)
        return True
    except Exception:
        return False


def cached(name: str) -> bool:
    from .models.registry import _MODELS, default_download_root

    path = os.path.join(default_download_root(), os.path.basename(_MODELS[name]))
    return os.path.isfile(path)


def ensure_checkpoint(name: str, net: bool) -> dict:
    if cached(name):
        return {"status": "cached"}
    if not net:
        return {"status": "skipped", "reason": "no network and not cached"}
    from .models.registry import download_checkpoint

    t0 = time.perf_counter()
    try:
        download_checkpoint(name)
        return {"status": "downloaded", "seconds": time.perf_counter() - t0}
    except Exception as e:  # noqa: BLE001 — report, don't crash the drill
        return {"status": "error", "error": str(e)}


def run_e2e_tests() -> dict:
    """The E2E contract in a pytest process of its own. The repo's
    tests/conftest.py imports JAX, which the card's machine lacks, so it is
    left out; the file needs none of its fixtures."""
    cmd = [sys.executable, "-m", "pytest", E2E_TESTS, "-q", "--no-header", "--noconftest",
           "-p", "no:cacheprovider"]  # fmt: skip
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
    tail = (proc.stdout or "").strip().splitlines()[-1:] or [""]
    return {"status": "passed" if proc.returncode == 0 else "failed", "summary": tail[0]}


def eval_wer_command(librispeech: str, model: str, limit: int, device: str, *extra) -> List[str]:
    return [sys.executable, "-m", "whisper_tpu_torch.eval_wer", "--librispeech", librispeech,
            "--model", model, "--limit", str(limit), "--device", device, *extra]  # fmt: skip


def run_module(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT))  # fmt: skip


def run_wer(librispeech: str, model: str, limit: int, device: str = "cuda") -> dict:
    if not librispeech:
        return {"status": "skipped", "reason": "no --librispeech path (see data/README.md for the recipe)"}
    if not os.path.isdir(librispeech):
        return {"status": "skipped", "reason": f"{librispeech} not found"}
    proc = run_module(eval_wer_command(librispeech, model, limit, device))
    return {"status": "ok" if proc.returncode == 0 else "failed",
            "output": (proc.stdout or "").strip().splitlines()[-3:]}  # fmt: skip


def run_wer_int8_delta(librispeech: str, model: str, limit: int, device: str = "cuda") -> dict:
    """bf16 against int8 WER on the same utterances, greedy at T = 0 so that
    the delta is the quantization's, not the sampler's."""
    if not librispeech or not os.path.isdir(librispeech):
        return {"status": "skipped", "reason": "no LibriSpeech path (see data/README.md)"}

    def one(weights: str):
        extra = ["--temperature", "0"] + (["--weights", weights] if weights else [])
        proc = run_module(eval_wer_command(librispeech, model, limit, device, *extra))
        if proc.returncode != 0:
            return None
        for line in reversed((proc.stdout or "").splitlines()):
            if line.startswith("overall WER:"):
                return float(line.split()[2])
        return None

    bf16, int8 = one(""), one("int8")
    if bf16 is None or int8 is None:
        return {"status": "failed", "bf16_wer": bf16, "int8_wer": int8}
    return {"status": "ok", "bf16_wer": bf16, "int8_wer": int8, "delta": int8 - bf16}


def run_spec_acceptance(model_name: str, draft_path: str, device: str = "cuda", dtype: str = "bfloat16") -> dict:
    """A trained draft's acceptance over real-audio windows (jfk six times:
    3 windows, greedy with timestamps, 224 tokens) at K = 4 and 8, and the
    speedup of each against plain greedy on the same windows (host wall of
    one run after a warm-up)."""
    if not cached(model_name):
        return {"status": "skipped", "reason": f"{model_name} not cached"}
    if not draft_path:
        return {"status": "skipped", "reason": "no --draft checkpoint (train one: whisper_tpu_torch.distill)"}
    if not os.path.exists(draft_path):
        return {"status": "skipped", "reason": f"{draft_path} not found"}
    import numpy as np

    from . import load_model
    from .audio import N_FRAMES, load_audio, log_mel_spectrogram, pad_or_trim
    from .engine import FusedEngine
    from .speculative import SpeculativeEngine
    from .tokenizer import get_tokenizer

    model = load_model(model_name, device=device, compute_dtype=dtype)
    draft = load_model(draft_path, device=device, compute_dtype=dtype)
    tok = get_tokenizer(model.is_multilingual, num_languages=model.num_languages, language="en",
                        task="transcribe")  # fmt: skip
    long_audio = np.concatenate([load_audio(JFK)] * 6)  # 66 s -> 3 windows
    mel = np.asarray(log_mel_spectrogram(long_audio, model.dims.n_mels))
    windows = np.stack(
        [pad_or_trim(mel[:, s : s + N_FRAMES], N_FRAMES) for s in range(0, mel.shape[-1], N_FRAMES)]
    ).astype(np.float32)
    ck, cv = model.cross_kv(model.encode(windows))
    dck, dcv = draft.cross_kv(draft.encode(windows))
    initial = np.tile(np.array([list(tok.sot_sequence)], np.int32), (windows.shape[0], 1))
    kwargs = dict(
        sot_index=0, suppress_ids=list(tok.non_speech_tokens), blank_ids=tok.encode(" ") + [tok.eot],
        max_initial_ts_index=50, sample_len=224, use_timestamps=True, temperature=0.0, eot=tok.eot,
        timestamp_begin=tok.timestamp_begin, no_timestamps=tok.no_timestamps, no_speech=tok.no_speech,
    )  # fmt: skip

    def seconds(run):
        run()  # warm-up (the captures)
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0

    out = {}
    for k in (4, 8):
        eng = SpeculativeEngine(model, draft, k=k)
        spec_s = seconds(lambda: eng.run(initial, ck, cv, dck, dcv, **kwargs))
        out[f"k{k}"] = {"acceptance": eng.last_stats["draft_acceptance"], "rounds": eng.last_stats["rounds"],
                        "seconds": spec_s}  # fmt: skip
    plain = FusedEngine(model)
    plain_s = seconds(lambda: plain.run(initial, ck, cv, n_group=1, beam_search=False, max_candidates=1,
                                        **kwargs))  # fmt: skip
    for k in (4, 8):
        out[f"k{k}"]["speedup_vs_plain"] = plain_s / max(out[f"k{k}"]["seconds"], 1e-9)
    out["plain_seconds"] = plain_s
    out["status"] = "ok"
    return out


def run_longform(model_name: str, device: str = "cuda") -> dict:
    """Long-form structural check on ~3.5 min of repeated jfk audio."""
    if not cached(model_name):
        return {"status": "skipped", "reason": f"{model_name} not cached"}
    import numpy as np

    from . import load_model
    from .audio import load_audio

    model = load_model(model_name, device=device)
    long_audio = np.concatenate([load_audio(JFK)] * 19)  # ~3.5 minutes
    t0 = time.perf_counter()
    res = model.transcribe(long_audio, language="en", temperature=0.0, verbose=None)
    secs = time.perf_counter() - t0
    segs = res["segments"]
    starts = [s["start"] for s in segs]
    problems = []
    if starts != sorted(starts):
        problems.append("segment starts not monotone")
    if res["text"].lower().count("fellow americans") < 10:
        problems.append("repeated canonical phrase mostly missing")
    if segs and segs[-1]["end"] < len(long_audio) / 16000 - 30:
        problems.append("final segment ends >30 s before the audio does")
    return {"status": "ok" if not problems else "failed", "seconds": secs, "segments": len(segs),
            "problems": problems}  # fmt: skip


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--models", default="tiny.en,turbo")
    ap.add_argument("--librispeech", default="", help="a LibriSpeech split root (data/README.md)")
    ap.add_argument("--limit", type=int, default=100)
    ap.add_argument("--draft", default="", help="a distilled draft directory (whisper_tpu_torch.distill) "
                    "for the speculative acceptance section")  # fmt: skip
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--offline", action="store_true", help="do not probe the network (download nothing)")
    ap.add_argument("--out", default="validate_real_torch_report.json")
    args = ap.parse_args(argv)

    models = [m.strip() for m in args.models.split(",") if m.strip()]
    net = False if args.offline else network_up()
    report = {
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "network": net,
        "device": args.device,
        "checkpoints": {m: ensure_checkpoint(m, net) for m in models},
    }
    no_weights = {"status": "skipped", "reason": "no checkpoints available"}
    any_weights = any(cached(m) for m in models)
    report["e2e_tests"] = run_e2e_tests() if any_weights else no_weights
    report["wer"] = run_wer(args.librispeech, models[0], args.limit, args.device) if any_weights else no_weights
    report["longform"] = run_longform(models[0], args.device)
    report["int8_wer_delta"] = (
        run_wer_int8_delta(args.librispeech, models[0], args.limit, args.device) if any_weights else no_weights
    )
    report["speculative_acceptance"] = run_spec_acceptance(models[0], args.draft, args.device)

    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    sections = ("e2e_tests", "wer", "longform", "int8_wer_delta", "speculative_acceptance")
    statuses = [report[s]["status"] for s in sections] + [c["status"] for c in report["checkpoints"].values()]
    return 0 if all(s in OK for s in statuses) else 1


if __name__ == "__main__":
    sys.exit(main())
