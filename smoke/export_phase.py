"""chip_smoke.py's export phase alone on the card, for iterating on the
export, the AOTInductor compiles and the native runner without the phases
before it.

    python3 smoke/export_phase.py

Builds the kernels, makes the smoke's turbo model (seeded random bf16
weights) and runs chip_smoke.export_runtime_phase: the runner's build, the
tiny float32 / int8 and turbo pipelines exported and compiled, every
runner check and the export tool's. Prints the phase's lines as the smoke
does, then its seconds and the runner's update launches. Exits non-zero
where a check fails, as the smoke does."""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(card, flush=True)
    t = time.perf_counter()
    smoke.build.load_library()
    print(json.dumps({"build_s": time.perf_counter() - t}), flush=True)
    model = smoke.Whisper(smoke.MODEL_DIMS["turbo"], None, device="cuda", compute_dtype=torch.bfloat16, seed=0)
    jfk = smoke.load_audio(smoke.JFK_PATH)
    t = time.perf_counter()
    launches = smoke.export_runtime_phase(model, jfk, card)
    print(json.dumps({"export_phase_s": time.perf_counter() - t, "launches": launches}), flush=True)


if __name__ == "__main__":  # the phase spawns compile workers: a file with a main guard
    main()
