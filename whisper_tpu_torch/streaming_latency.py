"""First-partial streaming latency on the card (the counterpart of
tools/streaming_latency.py).

Feeds 1 s chunks into a `StreamingTranscriber(partial_hop_s=1.0)` and
measures the wall time of each feed() that produced a partial: how long
after audio arrives a listener sees advisory text. A first transcriber fed
one chunk warms the window decode and the mel beforehand. The record adds
the flushed transcript's text and the device to the JAX tool's keys.

  python -m whisper_tpu_torch.streaming_latency [seconds=12] [--model turbo] [--device cuda]

The model has seeded random bf16 weights at the registry name's dims.
"""

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np

from .tool_common import build_model, device_name

OPTIONS = dict(language="en", temperature=0.0, no_speech_threshold=None, partial_hop_s=1.0)


def stream_audio(seconds: int) -> np.ndarray:
    """The JAX tool's stream: seeded noise at 0.1."""
    rng = np.random.RandomState(0)
    return (rng.randn(seconds * 16000) * 0.1).astype(np.float32)


def run(model, seconds: int = 12) -> dict:
    from .streaming import StreamingTranscriber

    audio = stream_audio(seconds)
    # warmup: the window decode and the mel outside the measurement
    t_w = time.perf_counter()
    warm = StreamingTranscriber(model, **OPTIONS)
    warm.feed(audio[:16000])
    warm_s = time.perf_counter() - t_w

    st = StreamingTranscriber(model, **OPTIONS)
    partial_feed_s = []
    first_partial_s = None
    t0 = time.perf_counter()
    for i in range(seconds):
        t_f = time.perf_counter()
        out = st.feed(audio[i * 16000 : (i + 1) * 16000])
        dt = time.perf_counter() - t_f
        if any(s.get("partial") for s in out):
            partial_feed_s.append(dt)
            if first_partial_s is None:
                first_partial_s = time.perf_counter() - t0
    st.flush()
    return {
        "model": model.name,
        "chunks_fed": seconds,
        "partials": len(partial_feed_s),
        # wall from stream start to the first advisory text
        "first_partial_s": first_partial_s if first_partial_s is not None else -1.0,
        # steady per-partial decode cost (the re-decode of the open padded
        # window each hop)
        "partial_feed_p50_s": float(np.median(partial_feed_s)) if partial_feed_s else -1.0,
        "warmup_s": warm_s,
        "text": st.result["text"],
        "device": device_name(model.device),
    }


def main(argv: Optional[List[str]] = None, model=None) -> int:
    """The command. `model`: an already loaded model in place of --model's."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("seconds", nargs="?", type=int, default=12)
    ap.add_argument("--model", default="turbo", help="registry name of the dims (seeded random bf16 weights)")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    if model is None:
        model = build_model(args.model, args.device)
    print(json.dumps(run(model, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
