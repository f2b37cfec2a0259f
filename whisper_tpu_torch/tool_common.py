"""Helpers shared by the load and latency tools (throughput_bench,
continuous_bench, streaming_latency, soak_server, spec_bench, graph_bench,
trace_ops, serve_bench): the model a tool measures, the card it runs on,
the JAX tools' synthetic clip and beam engine keywords, and what the
engine's runs recorded."""

import subprocess

import numpy as np
import torch


def build_model(name: str, device, compute_dtype=torch.bfloat16, seed: int = 0):
    """Seeded random weights at registry name `name`'s dims on `device`, or
    the checkpoint at path `name` loaded there."""
    from . import load_model
    from .models.dims import MODEL_DIMS
    from .models.whisper import Whisper

    if name in MODEL_DIMS:
        return Whisper(MODEL_DIMS[name], None, name=name, device=device, compute_dtype=compute_dtype, seed=seed)
    return load_model(name, device=device, compute_dtype=compute_dtype)


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )  # fmt: skip
    return out.stdout.strip().splitlines()[0]


def clip_audio(n_windows: int) -> np.ndarray:
    """The JAX tools' int16 clip (seeded noise at 3000), n_windows * 30 s,
    as the float32 samples i / 32768 that the frontend uploads as int16."""
    rng = np.random.RandomState(0)
    audio = (rng.randn(n_windows * 480000) * 3000).astype(np.int16)
    return audio.astype(np.float32) / 32768.0


def beam_kwargs(tok, beam: int, steps: int) -> dict:
    """The JAX tools' beam engine keywords: `steps` tokens at beam `beam`,
    EOT suppressed, the timestamp rules on."""
    return dict(
        sot_index=0, suppress_ids=[tok.eot], blank_ids=tok.encode(" ") + [tok.eot],
        max_initial_ts_index=50, sample_len=steps, n_group=beam, beam_search=True, max_candidates=beam,
        use_timestamps=True, temperature=0.0, eot=tok.eot, timestamp_begin=tok.timestamp_begin,
        no_timestamps=tok.no_timestamps, no_speech=tok.no_speech,
    )  # fmt: skip


def engine_counts(runs) -> dict:
    """What engine runs (engine.EngineRun) recorded: runs, captures,
    re-captures (a graph made again after its buffers were dropped past
    engine.MAX_PROGRAMS) and the distinct program keys."""
    return dict(
        engine_runs=len(runs),
        captures=sum(r.captures for r in runs),
        recaptures=sum(r.recaptures for r in runs),
        program_keys=len({r.program for r in runs}),
    )
