"""The mesh's decode loop over gloo, two ranks sharing one card: ms a token
and a host profile of a pass.

    python3 smoke/mesh_gloo_ms.py [ROOT] [SAMPLE_LEN] [OUT_DIR]

Imports whisper_tpu_torch from ROOT (default: this checkout; give another
checkout, e.g. a `git archive` of the parent, to compare two versions of
the port on one card, each in its own process) and builds its kernels.
Then, in each rank of a world of two over gloo on the card, on
chip_smoke.py's (b) model (turbo width, the encoder cut to 8 layers,
float32 with TF32 off, seeded random weights) and the first two 30 s
windows of tests/data/jfk.flac tiled to 60 s, the engine run that decode()
makes at SAMPLE_LEN tokens (default 128), greedy and beam 5 at T = 0:

  * `ms`: DataParallelEngine at dp = 2 and at tp = 2, the wall ms a token
    (the run's seconds over its steps) of REPS runs after one warm-up, in
    the loop the checkout's mesh engine runs (`loop`: "program" when it
    runs the loop body, else "eager"); where that is the body, also the
    host loop of the same checkout (`eager_loop = True`, "eager") in the
    same process, in the order body, eager, eager, body; the plain
    single-device engine beside them;
  * `profile`: one run of each of those loops at dp = 2 and tp = 2, greedy,
    under torch.profiler (CPU and CUDA; one untimed session first): per
    step, the kernels launched from the host (cudaLaunchKernel and
    friends), the gloo all-reduces (`c10d::allreduce_`) and their host ms,
    the host ms outside them, the union of the kernels' intervals on the
    card (device-busy), and the host ops of the most self time (`top`:
    name, calls and self ms a step; a collective's wait for the card shows
    there). The profiler slows the host, so these are read against each
    other, not against `ms`;
  * `allreduce_ms`: the host ms of one gloo all-reduce of 1 x 1280 float32
    on the card over the tp group (the median of 100), which drifts
    between runs.

Prints one JSON line with both ranks' results and the card's name and
power limit; given OUT_DIR, also writes it to OUT_DIR/mesh_gloo_ms_<n>.json.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
SAMPLE_LEN = int(sys.argv[2]) if len(sys.argv) > 2 else 128
OUT_DIR = sys.argv[3] if len(sys.argv) > 3 else None
REPS = 3
TOP = 10
ENCODER_LAYERS = 8
sys.path.insert(0, ROOT)

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def engine_call(model, mel, beam_size):
    """The arguments and keywords of the engine run that decode() makes."""
    from whisper_tpu_torch import DecodingOptions, decode
    from whisper_tpu_torch import engine as engine_module

    calls = []
    run = engine_module.FusedEngine.run

    def watched(self, *args, **kw):
        calls.append((args, kw))
        return run(self, *args, **kw)

    engine_module.FusedEngine.run = watched
    try:
        decode(model, mel, DecodingOptions(language="en", temperature=0.0, beam_size=beam_size,
                                           sample_len=SAMPLE_LEN))  # fmt: skip
    finally:
        engine_module.FusedEngine.run = run
    return calls[-1]


def ms_per_token(engine, args, kw):
    engine.run(*args, **kw)
    torch.cuda.synchronize()
    run = engine.history[-1]
    return run.seconds / run.steps * 1e3


def profile_run(engine, args, kw):
    """Per step of one profiled run: host launches, the all-reduces' host
    ms, the host ms outside them, device-busy ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.run(*args, **kw)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    steps = engine.history[-1].steps
    events = prof.events()
    launches = sum(e.name in LAUNCHES for e in events)
    reduce_ms = sum(e.cpu_time_total for e in events if e.name == "c10d::allreduce_") / 1e3
    reduces = sum(e.name == "c10d::allreduce_" for e in events)
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events if e.device_type == torch.autograd.DeviceType.CUDA
    )  # fmt: skip
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        start = max(start, end)
        if stop > start:
            busy += stop - start
            end = stop
    top = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:TOP]
    return dict(
        top=[(a.key, a.count / steps, a.self_cpu_time_total / 1e3 / steps) for a in top],
        steps=steps, wall_ms_per_step=wall / steps, launches_per_step=launches / steps,
        allreduces_per_step=reduces / steps, allreduce_host_ms_per_step=reduce_ms / steps,
        host_ms_outside_allreduce_per_step=(wall - reduce_ms) / steps,
        device_busy_ms_per_step=busy / 1e3 / steps,
    )  # fmt: skip


def rank(audio):
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.engine import FusedEngine
    from whisper_tpu_torch.kernels import build
    from whisper_tpu_torch.models.dims import MODEL_DIMS
    from whisper_tpu_torch.models.whisper import Whisper
    from whisper_tpu_torch.ops.stft import device_mel_full, device_mel_window
    from whisper_tpu_torch.parallel import DataParallelEngine, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load_library()
    dev = torch.device("cuda")
    dims = dataclasses.replace(MODEL_DIMS["turbo"], n_audio_layer=ENCODER_LAYERS)
    model = Whisper(dims, None, device=dev, compute_dtype=torch.float32, seed=0)
    full, _ = device_mel_full(audio, model.dims.n_mels, dev)
    mel = torch.stack([device_mel_window(full, seek, 3000) for seek in (0, 3000)])
    meshes = {k: make_mesh(**{k[:2]: 2}) for k in ("dp2", "tp2")}
    own = "eager" if DataParallelEngine.eager_loop else "program"
    loops = (own,) if own == "eager" else ("program", "eager", "eager", "program")
    out = {"loop": own, "ms": {}, "profile": {}}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):  # the profiler's own start-up
        (mel[:, :8, :8] @ mel[:, :8, :8].mT).sum().item()
    for beam in (None, 5):
        what = "beam5" if beam else "greedy"
        args, kw = engine_call(model, mel, beam)
        plain = FusedEngine(model)
        ms_per_token(plain, args, kw)
        out["ms"][f"{what}_plain"] = [ms_per_token(plain, args, kw) for _ in range(REPS)]
        for name, mesh in meshes.items():
            engine = DataParallelEngine(model, mesh)
            for loop in loops:
                engine.eager_loop = loop == "eager"
                ms_per_token(engine, args, kw)  # warm-up (the program's first run sizes its buffers)
                out["ms"].setdefault(f"{what}_{name}_{loop}", []).extend(
                    ms_per_token(engine, args, kw) for _ in range(REPS)
                )
            if beam is None:
                for loop in dict.fromkeys(loops):
                    engine.eager_loop = loop == "eager"
                    out["profile"][f"{name}_{loop}"] = profile_run(engine, args, kw)
    tp = meshes["tp2"].get_group("tp")
    x = torch.ones((1, 1, 1280), device=dev)
    times = []
    for i in range(101):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.distributed.all_reduce(x, group=tp)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["allreduce_ms"] = statistics.median(times[1:])
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("mesh_gloo_ms: CUDA is not available")
    from whisper_tpu_torch import load_audio
    from whisper_tpu_torch.kernels import build
    from whisper_tpu_torch.parallel.launch import spawn

    build.load_library()  # once, before the ranks load it
    jfk = load_audio(os.path.join(ROOT, "tests", "data", "jfk.flac"))
    audio = np.tile(jfk, 6)[: 60 * 16000]
    t0 = time.perf_counter()
    ranks = spawn(rank, 2, audio, device_type="cuda", backend="gloo", timeout=1200)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()  # fmt: skip
    line = json.dumps(dict(root=ROOT, sample_len=SAMPLE_LEN, card=card, seconds=time.perf_counter() - t0,
                           ranks=ranks))  # fmt: skip
    print(line)
    if OUT_DIR:
        os.makedirs(OUT_DIR, exist_ok=True)
        n = len([f for f in os.listdir(OUT_DIR) if f.startswith("mesh_gloo_ms_")])
        with open(os.path.join(OUT_DIR, f"mesh_gloo_ms_{n}.json"), "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
