"""What a window served, as the comparison reads it: one record per decoded
30 s window of an audio, taken from a transcribe()-schema result (with no
timestamps, a window is one segment: its seek, its tokens, its mean
log-probability)."""

import time
from dataclasses import dataclass
from typing import List

import numpy as np

HOP = 160
N_FRAMES = 3000
MIN_TAIL_FRAMES = 100  # a sub-second tail is not decoded (batch.py _Stream.done)


@dataclass
class Served:
    audio: int  # the traffic's audio index
    seek: int  # the window's first frame
    size: int  # frames of audio in the window (3000, or the tail)
    tokens: List[int]
    avg_logprob: float
    longest: bool = False  # the audio is the traffic's longest


def windows_of(result: dict, audio: int, n_samples: int) -> List[Served]:
    content = n_samples // HOP
    return [
        Served(audio, int(s["seek"]), min(N_FRAMES, content - int(s["seek"])), [int(t) for t in s["tokens"]], float(s["avg_logprob"]))
        for s in result["segments"]
    ]


def expected_seeks(n_samples: int) -> List[int]:
    """The seeks of every window of an audio, each advancing 30 s; a tail
    under a second is dropped, as transcribe_batch and the batcher drop it."""
    content = n_samples // HOP
    return list(range(0, max(content - MIN_TAIL_FRAMES + 1, 0), N_FRAMES))


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def clock() -> float:
    return time.perf_counter()


def stratified(n: int, rng: np.random.Generator) -> np.ndarray:
    """The n quantile levels (i + 0.5) / n in an order drawn from rng: every
    seed gets the same set of draws, in another order."""
    return rng.permutation((np.arange(n) + 0.5) / n)
