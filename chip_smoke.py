"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build the CUDA kernels from whisper_tpu_torch/csrc/ with nvcc (sm_90a),
     and beside them the smoke's own empty kernel (smoke/empty_kernel.cu);
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's widths. The update kernels (V = 51866, T = 448), in
     clusters of the size they use on the card, on float32 logits, on
     bf16-rounded logits, on logits with planted ties (equal maxima in a
     row, equal candidates across beams, equal maxima on both sides of
     every chunk edge), with whole chunks suppressed, and with all but four
     ids suppressed; greedy at B = 1, 2, 4, 5, 8 and beam at (A, G) = (1, 1),
     (1, 2), (2, 5), (3, 5), (4, 5), (1, 8), so odd rows too (B = 4 and
     A = 4 are the batch phase's shapes); on inputs that start
     4 bytes past an 8-byte boundary (offset views: the scalar-load build):
     ids, sources, token buffers and pools exactly, scores within 1e-5;
     then 1,000 back-to-back launches alternating two inputs, compared
     after the last; and the odd-vocabulary build (V = 51865) on randn and
     edge ties. Each update kernel's device ms and ms per call, beside the
     device ms of the empty kernel at the same launch shape and at one CTA,
     and torch.topk(logits, K) on the same rows. The DTW trace at the main
     path's shapes, at N + 1 = 1024 (the limit), at N + 1 and M + 1 off
     multiples of 32, at M < 32 and at one cell, on randn and on
     integer-valued (tied) costs: trace and path bit for bit; then 1,000
     back-to-back launches. The median filter at 40 heads x 224 rows x 1500
     frames, width 7, reflecting at 1500 and at 551, on randn, on a coarse
     grid and on rows with planted NaN, +-inf and +-0: exactly equal, NaN
     where NaN (widths 3, 5 and 13 likewise on 300 rows); at T = 1499 and
     1502 and on an offset view 4 bytes past a 16-byte boundary (the
     scalar-load build); then 1,000 back-to-back launches. The greedy
     kernel's per-row-length launch (the speculative host loop's): its verify
     layout at B = 5, 10 and 20 (A = 1, 2 and 4 audios of K + 1 = 5 rows at
     lengths n[a] + j) and its draft-step layout at B = 1, 2 and 4 (one
     history per row at its own length, verified tokens past it), rows at
     distinct lengths with one at sample_begin, timestamp rules on and off,
     chunk-edge ties, offset views, 1,000 back-to-back launches; its device
     ms beside the scalar launch's at B = 1, 2, 5 and 20 (at B = 1 on the
     same inputs). The update kernels' loop-state launches (the captured
     loop's: lengths, step and live read from a device array) on every
     scalar case and offset case, at live = 0 (nothing written: outputs
     and pools as they were), 1,000 back-to-back launches, and their
     device ms beside the scalar launch's on the same inputs. The greedy
     kernel's per-row launch at the loop state (the captured speculative
     round's: lengths from a (B,) array, sample_begin and live from the
     state array) on every per-row case above, at live = 0 on every third,
     1,000 back-to-back launches, its device ms beside the per-row launch
     on the same inputs at B = 1, 5 and 20. Time kernel and
     plain version on the device (the profiler's kernel records) and per
     call with the host's work (CUDA events, median of the calls); time
     `unfold(...).median(-1)` beside the median filter, the empty kernel at
     each word-timing kernel's launch shape, and the DTW's chain floor (one
     thread, N + M - 1 dependent steps of a cell's arithmetic);
  3. check that the graphs' float32 products of bf16 operands (logits,
     attention scores) are summed in float32 on the card and not rounded
     to bf16 (within 1e-4 of the float64 product);
  4. decode greedy and beam 5 at tiny dims in float32 on the card (the
     engine's captured loop) and on the CPU (the same body, eagerly) with
     the same seeded weights, with the model's weights and
     with int8 weights: equal tokens, avg_logprob within 1e-3; transcribe() jfk with word timestamps on both: equal words,
     times within 1e-6 s; and jfk, 8 s of silence, jfk twice with
     hallucination_silence_threshold=2.0: each window's segments and words
     as aligned, and the kept segments, equal (times within 1e-6 s); and
     transcribe_batch with conditioning of a 33 s jfk stream and 35 s of
     noise, whose second round has two prompts, on the engine (one call per
     prompt) and on the host loop (use_fused_decode off): the same loops and
     equal tokens on the card and the CPU, and on both loops;
  configs. the repo's published configurations (BASELINE.json): (a) the
     update kernels at the English-only layout (V = 51864, EOT 50256,
     timestamps from 50363, sample_begin 1): the greedy kernel's scalar,
     loop-state, per-row and per-row loop-state launches at B = 1 and 5,
     the beam kernel's scalar and loop-state launches at (A, G) = (1, 5)
     and (4, 5), and at (4, 5) at large-v3's layout too, on randn logits,
     EOT-heavy rows and chunk-edge ties, exact against the plain versions;
     (b) an English-only model at tiny dims in float32 on the card and on
     the CPU: greedy and beam-5 decode() tokens equal, transcribe(jfk,
     language=None, word_timestamps=True) in English with equal words,
     decode(language=None) raising on both; (c) configurations 1 (tiny.en
     greedy on jfk), 2 (base, language detection and the ladder), 3 (small
     at beam 5 / best_of 5 with the ladder) and 5 (large-v3, four streams
     through transcribe_batch at beam 5) at full width through
     whisper_tpu_torch.config_matrix, each model freed before the next:
     each ok, no re-capture, its launches equal its engine's records and
     its loop-state kernel launched, configuration 1 in English, 2 in a
     language of LANGUAGES, 5 with four results each with segments; each
     record (ms a token, wall s, captures, peak memory) logged with the
     card line. Configuration 4 (turbo at beam 5 with word timestamps) is
     phase 5's beam5_t0 and words_greedy_t0 runs, logged after them;
  4b. the decode loop as a captured program (engine.py): one turbo window
     at greedy T = 0, beam 5 and a T = 0.7 draw (seed 7) through the
     captured loop, the same body uncaptured and the eager host loop: the
     captured tokens (and draws) equal the uncaptured body's, launches
     equal each run's record; per step the wall, device-busy, idle share,
     kernels, the update's device ms; replays, done reads, captures and
     their seconds, peak memory; the update launches in each profiled
     run's trace equal its record and the kernels' counters;
  4c. the done read's lag (engine.DONE_LAG) at 0, 1, 2, 4, 8 and 16 on
     a greedy turbo window that ends early (a seeded suppression set) and
     on a whole one: wall, replays after every row was done, done reads;
     outputs equal at every lag;
  5. transcribe() a 60 s clip (tests/data/jfk.flac tiled) at turbo width
     with seeded random bf16 weights: greedy with the default temperature
     ladder, beam 5 at temperature 0, greedy at temperature 0 with word
     timestamps, and its first 20 s with word timestamps and
     hallucination_silence_threshold=2.0. Check that the update kernels'
     launch counts equal the temperature-0 updates of their mode, that the
     DTW and median kernels launch once per aligned window, and that every
     word is finite, ordered and in its window; print the replay's share of
     the wall time, and time the cross-K/V each replay computes;
  5b. the batch phase at turbo width: transcribe_batch of four streams at
     T = 0 with conditioning (round 1 one fused greedy call at B = 4, round
     2 the three unfinished streams, every prompt group on the engine),
     beside transcribe() of the same streams one after another;
     transcribe_chunked of 120 s at beam 5 (one fused call at A = 4);
     transcribe_batch of two streams with word timestamps. Check that the
     update kernels launch once per step of each fused temperature-0 loop,
     the DTW and median kernels once per aligned window, that two identical
     streams give identical tokens, and that every segment and word is
     finite and ordered; print the RTFx of batch and sequential. Beside
     them, not checked: each stream's row of the batched mel against its
     own whole-file mel, batch against sequential tokens with the same
     seeded weights at float32, and the engine's and the host loop's ms per
     step on the same windows at B = 1 and B = 4;
  5c. the CLI: `python -m whisper_tpu_torch --device cuda --parallel True
     --profile_sync True` in a subprocess on two files with a tiny model
     written by save_model; all five outputs of each file present, and the
     per-graph timing report in its stdout with the "encoder" and
     "fused_decode" spans;
  layers. smoke/layers_ms.py's measure() in this process, on the main
     path's model (no second process and turbo load): transcribe() of the 60 s clip at turbo width, greedy and
     beam 5 at T = 0, with profiling.set_sync(True): each span's summary,
     the encoder + cross-K/V span, per window the engine's run (the
     fused_decode span) and its ms a step, and transcribe()'s wall less
     its spans; the clip's synchronized log-mel ms; the engine's ms a step
     with sync off beside profiling disabled; one traced window
     (profiling.trace()), whose Chrome trace must hold the greedy update
     kernel's events; its times carry the profiler sessions run before;
  bf16_rows: one turbo bf16 window through encode, cross_kv, prefill, the
     logits and one decode_step at B = 1 and as row 0 of B = 4, beside
     three other audios and beside three copies of itself: per output the
     max abs difference and equality, the first output that differs, and
     whether rows interact; probes of conv1 and of one GEMM at M = 1500
     against M = 6000 (reported, not checked);
  5d. StreamingTranscriber over the 60 s clip, greedy at T = 0: 1 s chunks
     with a partial every 5 s, and 7 s chunks with word timestamps. Finals,
     partials, seconds per final window, the latency from the feed() that
     completes a window to its finals, and each final window's mel against
     the whole-file mel's window. The finals against transcribe() of the
     same audio: reported in bf16, equal (tokens; words within 1e-6 s) with
     the same seeded weights at float32;
  5e. ContinuousBatcher(slots=2) at T = 0 with conditioning: the 60 s clip
     and its first 23 s, one round, then its last 53 s and jfk; and a
     beam-5 run of two requests. Rounds and rows, the batcher's stats,
     aggregate RTFx; each ticket against transcribe(), reported in bf16 and
     equal at float32;
  5f. the unix-socket server (three concurrent jfk.flac clients, a bad
     request, a pcm16 live session) and the HTTP server (three concurrent
     uploads, /healthz, /metrics, an s16 live session), serve_forever on a
     thread: every reply equal to transcribe() or to the batcher's result
     for the same requests, the wall time per request, and every server
     thread ended after shutdown(). The update kernels launch once per
     step of each fused T = 0 loop and the word-timing kernels once per
     aligned window in 5d-5f, and each kernel launches there (beam in 5e);
  card vs CPU at tiny dims: streaming finals (7 s chunks, words) and a
     batcher run with two prompts in a round, equal on card and CPU;
  5g. int8 weights and speculative decoding at turbo width: the decoder
     weight bytes in each mode; int8 on the card against the CPU (the
     quantized decoder and cross-K/V equal, each int8 read of the graphs
     on the same inputs within 1e-4, the cross-attention output within
     1e-3; a prefill and a step's logits reported); the speculative
     engine (a tiny-class draft with turbo's vocabulary and mels, K = 4)
     on one window (cut to 128 tokens with the random draft), its round
     captured and uncaptured (the body run eagerly), beside the plain
     captured engine, with a random draft and with a one-token vocabulary
     (every draft accepted), in bf16 and at float32, and the eager host
     loop in the float32 random-draft bracket: rounds, acceptance, tokens
     per round, ms per token (plain and captured: the median of two runs
     after an untimed one; the body and the eager loop one run), replays,
     captures and their seconds, launches checked on every run against its
     record (one scalar greedy launch, then K + 2 per-row loop-state
     launches a round pass, or the eager loop's per-row launch a draft
     step and a verify round); the captured round's outputs equal the
     uncaptured body's, and at float32 its tokens equal the eager loop's
     and the plain engine's; one
     profiled captured run per draft (per replayed round: device-busy ms,
     its span and idle share, kernels; host ms of a replay and of a done
     read; the trace's greedy launches against the record); one more
     captured run per bracket with each replay between CUDA events (the
     graph's span a replay and a token, the host ms of its call, the wall
     outside the graphs); then
     transcribe() of the clip and a ContinuousBatcher(slots=2) round with a
     draft at float32, equal to the plain ones. The main path also runs the
     clip at T = 0 plainly and with the bf16 draft installed (the captured
     round), whose launches its check counts;
  train. fine-tuning, checkpoints and distillation: graphs.matmul_f32's
     autograd Function on bf16 operands at turbo width (logits head,
     encoder and cross-attention scores, a broadcast K): forward equal to
     the product without autograd, gradients within one bf16 ulp of the
     widened form's; at tiny dims in float32, one model on the card and on
     the CPU: one loss_fn's gradients (rtol 1e-4, atol 1e-6), 4-step
     run_finetune and run_distill loss histories (rtol 1e-4), and the
     card's distilled draft attached with speculative tokens equal to plain
     greedy's; run_finetune of the turbo model, 4 steps at batch 2 (losses
     finite and falling, ms a step, peak memory, the checkpoint's bytes,
     save and load seconds), load_model of its directory decoding one
     window at T = 0 (a greedy launch a step); a turbo step's forward and
     backward with the stacked weights split by unbind and by select, in
     turns; the eval phase: whisper_tpu_torch.spec_distill_eval at a cut
     size (2 clips labeled by the target's captured greedy path, 8 distill
     steps at batch 2 with one more record pseudo-labeled by the target,
     K = 4 and 8, 1 timed trial): losses finite and falling, each label
     equal to a second captured run's tokens, every line's acceptance in
     [0, 1] with a round a row, the launches (rows 1b and 1c) equal to the
     records; the distilled and random drafts' acceptance, speedup and bf16
     token agreement reported; the greedy launches of these decodes count on
     the main path;
  eval tools. whisper_tpu_torch.eval_wer's --ref-dir form on jfk.flac against
     the turbo model's own T = 0 transcript (overall WER 0.0000), and with
     --weights int8 (reported); whisper_tpu_torch.validate_real --offline:
     exit 0, every weight section skipped with a reason, the report read
     back; the transcribes' launches count on the main path;
  bench tools. the load and latency tools (whisper_tpu_torch/<tool>.py)
     through their run() cores, the turbo model passed in, the counts set
     to 0 before each: continuous_bench at 4 slots and 4 requests (its
     captures, re-captures and program keys logged), throughput_bench at
     two 30 s streams, beam 5, one trial, streaming_latency over 6 s,
     soak_server with its synthetic model on the card (24 requests in
     waves of 4 over the unix socket: errors 0, the drained server
     empty), spec_bench at K = 4, one trial (accept1's acceptance 1.0;
     where accept0's bf16 tokens part from the plain engine's, both within
     the top three of a prefill's log-probs there), and on float32 models
     (every speculative token the plain engine's, in both brackets),
     graph_bench with 3 trials, trace_ops of the captured beam-5 decode, 2
     iterations (device ops seen), and serve_bench at a world of one over
     NCCL (dp 1, tp 1, two streams, one trial; its body captured, tokens
     equal to the single engine's): each tool's seconds and launches, each
     tool's kernel launched; the launches count on the main path;
  parallel. the mesh (whisper_tpu_torch/parallel/), ranks spawned from
     here after the build (parallel/launch.py); the mesh's engines run the
     loop programs, with the collectives inside the body: (a) a world of
     one over NCCL, the turbo bf16 model transcribing the clip greedy, at
     beam 5 (T = 0) and greedy with the 5g draft, plain and under
     set_mesh(make_mesh()) in turns: the mesh's loop bodies and rounds
     captured and replayed, tokens equal to the plain model's, launches
     held to the records; (a') one NCCL all-reduce and one
     all_gather_into_tensor captured in a CUDA graph and replayed, equal
     to the uncaptured collectives; one fine-tune step with and without
     the mesh, equal losses, and one NCCL all-reduce's host ms; (b) two
     ranks sharing the card over gloo, turbo width with the encoder cut to
     8 of 32 layers, float32, TF32 off: DataParallelEngine at dp = 2 and
     tp = 2 on two windows, greedy and beam 5, the body run uncaptured
     (gloo), tokens, steps and beam pools equal to the plain engine's,
     the same passes on both ranks; the speculative engine at dp = 2
     (plain greedy's tokens; its round uses no group, so it captures);
     sp_encode at sp = 2 and pp_encode at pp = 2 within 1e-3 of encode; a
     2-step tp = 2 fine-tune within rtol 1e-4 of the single-device losses;
     transcribe(jfk, word_timestamps=True) at tp = 2, words and times equal
     to the plain model's; a gloo all-reduce's host ms; (c) where the
     machine has two cards or more, a world of two over NCCL, one card a
     rank, dp = 2 and tp = 2 greedy, captured, tokens equal to the plain
     engine's (on one card a line says it did not run). Per-rank ms per
     token beside the plain engine's, each part's seconds; the mesh runs'
     launches, summed over the ranks, count on the main path;
  6. profile one greedy window and one beam-5 window of decode() at turbo
     width, each with bf16 weights and then with int8 weights (launches,
     the common prefix of their tokens, and where they part, each mode's
     top-two gap there and the logits' difference between the modes); per
     run: wall time,
     device-busy time, kernels, the update kernel's
     device time and the host's blocked read of the `completed` flag, per
     step of the engine's loop; then one turbo train step at batch 2 (wall,
     device-busy ms, idle share, kernels, the five longest by name);
  export. torch.export, AOTInductor and the native runner
     (whisper_tpu_torch/export.py, runtime/aoti.py, csrc/wtt_transcribe.cpp,
     csrc/wtt_graph.cpp): the runner built with g++ while three pipelines
     are exported and AOT-compiled (tiny float32 and tiny English-only
     int8 at V = 51864 and sample_begin 1, and turbo bf16 at the main
     path's weights, in a spawned process each, started with the build
     after the card-vs-CPU comparisons so that they run beside the card's
     phases; each with the step packages at the cache windows 128, 256 and
     448 that loop.txt names; each graph's export and cold-compile
     seconds, a second load of the turbo encoder from the package cache);
     at tiny dims on jfk the captured runner's tokens equal the captured
     engine's on the same mel bytes over 445 tokens, through every phase
     (greedy and beam 5 at T = 0, English-only int8 greedy, and the ladder's accepted
     draw at its temperature and seed), and a pipeline missing one package
     makes it exit non-zero; each turbo package against the same function
     run eagerly on the same inputs (max |diff| / max |ref|, step 0's
     argmax equal, the step's cache written in place, each step package's
     device ms and kernels per call); the 60 s clip greedy and beam 5
     through the captured runner at T = 0 and its first window through
     --no-capture (tokens equal), the first window against the captured
     engine (common prefix; where they part, the eager top-two gap) with
     the runner's ms per token, replays, captures and their seconds, done
     reads and launches beside the engine's first and second runs; jfk
     through the runner's ladder, and --serve answering jfk twice with that
     run's tokens, the second request capturing nothing; then the
     one-command tool (`python -m whisper_tpu_torch.export_pipeline
     --checkpoint tiny.npz --no-build`, into the phase's compile cache),
     whose pipeline gives the runner the tiny float32 pipeline's tokens (its
     timings.json, with each graph's cached flag, printed). Every runner
     attempt is held to its counts (check_attempt, with loop.txt's done
     lag): at T = 0 one scalar launch (step 0, counted at the C ABI call)
     and one loop-state launch a replay or uncaptured pass (counted on the
     card by the kernel); they count on the main path;
  7. print the engines' captures in this process and their seconds, the
     kernels line, the card's name and power limit, and the result line
     {"ok": true, "device": {...}}.
Every launch check holds the update kernels' counts to what the engines'
records say they launched (engine_want): a captured loop's step 0
scalar, each replay and uncaptured pass at the loop state; a speculative
run's step 0 scalar, K + 2 per-row loop-state launches a round pass; the
host loops (the captured-loop phase's and 5g's float32 eager variant) once
a step (per-row for the speculative one). The
loop-state launches are counted on the card by the kernels themselves (a
replay makes no Python call).
Exits non-zero, printing no result, where CUDA is not available.
"""

import concurrent.futures
import contextlib
import copy
import ctypes
import dataclasses
import importlib
import io
import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available; this script runs only on a card")

from whisper_tpu_torch import DecodingOptions, decode, load_audio, profiling, save_model  # noqa: E402
from whisper_tpu_torch import batch as batch_module  # noqa: E402
from whisper_tpu_torch import transcribe_batch, transcribe_chunked  # noqa: E402
from whisper_tpu_torch.decoding import DecodingTask  # noqa: E402
from whisper_tpu_torch.engine import FusedEngine, model_engine  # noqa: E402
from whisper_tpu_torch.kernels import build  # noqa: E402
from whisper_tpu_torch.models.dims import MODEL_DIMS, ModelDimensions  # noqa: E402
from whisper_tpu_torch.models import graphs  # noqa: E402
from whisper_tpu_torch.models.params import flatten_tree, init_random_params  # noqa: E402
from whisper_tpu_torch.models.whisper import Whisper  # noqa: E402
from whisper_tpu_torch.ops import beam_kernel as bk  # noqa: E402
from whisper_tpu_torch.ops import dtw, median  # noqa: E402
from whisper_tpu_torch.quant import DECODER_QUANT_KEYS, quantize_cross_kv, quantize_decoder  # noqa: E402
from whisper_tpu_torch.speculative import SpeculativeEngine  # noqa: E402
from smoke.layers_ms import measure as layers_measure  # noqa: E402
from smoke.trace_stats import busy_between_updates  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = torch.device("cuda")
V, T = 51866, 448
N_FRAMES = 3000  # frames of a 30 s window
TS_BEGIN, EOT, NO_TS = 50365, 50257, 50364  # large-v3 / turbo vocabulary
SAMPLE_BEGIN = 3
SCORE_TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
REPS = 50  # calls per kernel timing
EMPTY = {}  # the empty kernel's nvcc process ("nvcc"), then its library ("lib")


def log(msg):
    print(msg, flush=True)


def host_cpu() -> str:
    """The host's CPU model and core count: the compiles and the CPU halves
    of the card-against-CPU phases run on it, so the smoke's seconds vary
    with it."""
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")), "unknown")
    except OSError:
        model = "unknown"
    return f"{model} x {os.cpu_count()}"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )  # fmt: skip
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, reps=REPS, warmup=5) -> float:
    """Median time of one call, host work included: CUDA events recorded
    around each single call (after `warmup` calls)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=REPS, kernel=None, attempts=3, warmup=5):
    """Device time per call from the profiler's CUDA kernel records: of the
    kernels whose name contains `kernel`, or of every kernel the call ran,
    after `warmup` calls. Returns (ms per call, kernels per call). The
    profiler has, in rare runs, kept no record of a short kernel at all;
    such a profile is taken again, up to `attempts` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and (
                kernel is None or kernel in e.name
            ):
                us += e.time_range.elapsed_us()
                n += 1
        if n:
            return us / reps / 1e3, n / reps
        log(json.dumps({"phase": "profiler_empty", "kernel": kernel, "attempt": attempt}))
    raise RuntimeError(f"the profiler recorded no CUDA kernel in {attempts} profiles")


def kernel_ms(fn, wrapper, name, reps=REPS, counter="launches"):
    """Device ms per launch of the kernel `name`: the mean of the profiler's
    records of it (the profiler may drop a few records of a short kernel),
    after checking on the wrapper's count (`counter`, the name of its
    attribute, or of a loop-state kernel's count on the card in
    bk.state_launches()) that each call launches it once."""

    def count():
        return bk.state_launches()[counter] if counter.endswith("_state") else getattr(wrapper, counter)

    before = count()
    fn()
    if count() != before + 1:
        raise AssertionError(f"{name}: {count() - before} launches per call")
    per_call_ms, per_call = device_ms(fn, reps, kernel=name)
    if not 0 < per_call <= 1:
        raise AssertionError(f"{name}: the profiler saw {per_call} launches per call")
    return per_call_ms / per_call


# ---- phase 1: the smoke's own empty kernel ---------------------------------

EMPTY_SRC = os.path.join(ROOT, "smoke", "empty_kernel.cu")
EMPTY_LIB = os.path.join(ROOT, "smoke", "_build", "empty_kernel.so")


def start_empty_build():
    """Start nvcc on smoke/empty_kernel.cu, to run beside the port's build."""
    os.makedirs(os.path.dirname(EMPTY_LIB), exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", EMPTY_LIB, EMPTY_SRC]
    EMPTY["nvcc"] = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def empty_lib():
    """The empty kernel's library: waits for the build (started here if it
    was not started yet) and loads it."""
    if "lib" not in EMPTY:
        if "nvcc" not in EMPTY:
            start_empty_build()
        proc = EMPTY.pop("nvcc")
        out = proc.communicate(timeout=300)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {EMPTY_SRC}:\n{out}")
        lib = ctypes.CDLL(EMPTY_LIB)
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        lib.wtt_empty_kernel.argtypes = [c_int, c_int, c_ptr]
        lib.wtt_empty_grid.argtypes = [c_int, c_int, c_int, c_int, c_ptr]
        lib.wtt_chain.argtypes = [ctypes.c_double, c_int, c_ptr, c_ptr]
        for fn in (lib.wtt_empty_kernel, lib.wtt_empty_grid, lib.wtt_chain):
            fn.restype = c_int
        EMPTY["lib"] = lib
    return EMPTY["lib"]


# ---- phase 2: kernels vs plain versions --------------------------------------


def chunk_edges(C, W=2):
    """The first ids of chunks 1..C-1 when the kernels split a row of V ids
    into C chunks (update_common.cuh:chunk_bounds, units of W ids: 2 for
    float2 loads, 1 for the scalar-load build)."""
    n = -(-V // C)
    n += -n % W
    return [c * n for c in range(1, C) if c * n < V]


def offset_view(t):
    """A copy of `t` as a contiguous view whose data starts 4 bytes past an
    8-byte boundary: the update kernels must then take their scalar-load
    build (float2 loads from it would fault)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    if view.data_ptr() % 8 != 4:
        raise AssertionError("the offset view is 8-byte aligned")
    return view


def offset_inputs(args, which, logits_at, pens_at):
    """`args` with the logits (`which` = "logits"), the suppress vector
    ("suppress") or both and the begin vector ("all") as offset views;
    `logits_at` and `pens_at` are their positions in `args`."""
    args = list(args)
    if which in ("logits", "all"):
        args[logits_at] = offset_view(args[logits_at])
    if which in ("suppress", "all"):
        args[pens_at] = offset_view(args[pens_at])
    if which == "all":
        args[pens_at + 1] = offset_view(args[pens_at + 1])
    return tuple(args)


def penalties(use_ts, suppressed=None, allowed=None):
    """The penalty vectors; `suppressed` ids are also set to -inf, and with
    `allowed` every other id is."""
    sup, beg = bk.build_penalty_vectors(
        V, [1, 2, 3, 11, 220], [220, EOT], use_timestamps=use_ts, no_timestamps=NO_TS,
        timestamp_begin=TS_BEGIN, max_initial_ts_index=50,
    )  # fmt: skip
    if suppressed is not None:
        sup[suppressed] = -np.inf
    if allowed is not None:
        keep = sup[allowed]
        sup[:] = -np.inf
        sup[allowed] = keep
    return torch.from_numpy(sup).to(DEV), torch.from_numpy(beg).to(DEV)


def masks(mode, C, W=2):
    """Extra suppression for the modes that empty whole stretches of a row:
    `masked_chunk` suppresses all of chunk 0, the rank-0 CTA's (where a large
    logit is planted), and chunk 1 too where it ends below EOT (a row with
    no finite logit is not a state the decoder reaches: the plain version
    gives NaN there); `sparse` allows four ids only (two text ids in the
    first and the last chunk, two timestamps), so most of a row's top-K is
    -inf and most chunks are empty."""
    edges = chunk_edges(C, W) + [V]
    if mode == "masked_chunk":
        hi = edges[1] if len(edges) > 2 and edges[1] < EOT else edges[0]
        return dict(suppressed=np.arange(0, min(hi, EOT)))
    if mode == "sparse":
        last = edges[-2] if C > 1 else 1000
        return dict(allowed=[7, last + 3, TS_BEGIN + 40, V - 1])
    return {}


def history(rng, rows, n_tokens, step, G):
    tokens = rng.randint(100, 5000, size=(rows, T)).astype(np.int32)
    if step > 0:
        tokens[1 % rows, 4] = TS_BEGIN + 10
        tokens[1 % rows, 5] = TS_BEGIN + 10
        tokens[2 % rows, n_tokens - 1] = TS_BEGIN + 30  # mid-pair
        tokens[3 % rows, n_tokens - 2] = TS_BEGIN + 7  # pair just closed
        tokens[3 % rows, n_tokens - 1] = TS_BEGIN + 12
    else:
        tokens = np.repeat(tokens[::G], G, axis=0)
    return torch.from_numpy(tokens).to(DEV)


def bf16_rounded(logits):
    """The logits rounded to bf16's grid (and back): many exact ties."""
    return torch.from_numpy(logits).bfloat16().float().numpy()


def plant_edge_ties(logits, C, rows, W=2):
    """Equal maxima on both sides of every chunk edge e (ids e-1 and e); in
    odd rows id e-1 of the first edge sits just below them, so the lowest
    tied id is the first id of chunk 1 and wins over ties further up."""
    edges = chunk_edges(C, W) or [V // 2]
    for r in range(rows):
        top = logits[r].max() + 1.0
        for e in edges:
            logits[r, [e - 1, e]] = top
        if r % 2:
            logits[r, edges[0] - 1] = top - 1e-3


def plant_masked(logits):
    """A logit far above the rest inside the suppressed chunk 0."""
    logits[:, 10] += 20.0


GREEDY_CASES = [
    # (rows, n_tokens, use_ts, mode)
    (1, 3, True, "randn"), (1, 40, True, "randn"), (5, 8, True, "randn"),
    (5, 12, True, "ts_mass"), (5, 10, False, "randn"), (1, 9, False, "randn"),
    (1, 3, True, "bf16"), (5, 20, True, "bf16"), (1, 3, True, "ties"),
    (5, 14, True, "ties"), (5, 9, False, "ties"),
    # chunk edges, empty chunks, and B = 2 and 8
    (2, 8, True, "randn"), (8, 12, True, "ts_mass"), (1, 9, False, "edge_ties"),
    (2, 10, False, "edge_ties"), (5, 14, True, "edge_ties"), (8, 9, False, "edge_ties"),
    (1, 12, True, "masked_chunk"), (5, 9, False, "masked_chunk"), (2, 9, False, "sparse"),
    (8, 14, True, "sparse"),
    # B = 4: a round of transcribe_batch over four streams
    (4, 3, True, "randn"), (4, 14, True, "ts_mass"), (4, 9, False, "edge_ties"),
    (4, 12, True, "bf16"),
    # B = 3: a batcher round of three concurrent server requests (B = 2 above)
    (3, 3, True, "randn"), (3, 14, True, "ts_mass"), (3, 9, False, "edge_ties"),
    (3, 12, True, "bf16"),
]  # fmt: skip


def greedy_case(seed, rows, n_tokens, use_ts, mode, C, W=2):
    rng = np.random.RandomState(seed)
    tokens = history(rng, rows, n_tokens, 1 if n_tokens > 4 else 0, 1)
    logits = rng.randn(rows, V).astype(np.float32)
    if mode == "ts_mass":
        logits[0, TS_BEGIN + 40 :] += 4.0  # the timestamp-mass rule fires
    elif mode == "bf16":
        logits = bf16_rounded(logits)
    elif mode == "ties":
        # equal maxima in every row; row 0's lowest tied id (11) is
        # suppressed, so the next tied id must win
        for r in range(rows):
            ids = rng.choice(np.arange(400, TS_BEGIN), size=3, replace=False)
            logits[r, ids] = logits[r].max() + 1.0
        logits[0, 11] = logits[0].max()
    elif mode == "edge_ties":
        plant_edge_ties(logits, C, rows, W)
    elif mode == "masked_chunk":
        plant_masked(logits)
    pens = penalties(use_ts, **masks(mode, C, W))
    args = (torch.from_numpy(logits).to(DEV), tokens, n_tokens, SAMPLE_BEGIN, *pens)
    kw = dict(use_timestamps=use_ts, eot=EOT, timestamp_begin=TS_BEGIN)
    return args, kw


def same_greedy(args, kw, out, what):
    ptok, plp = bk.greedy_argmax_plain(*args, **kw)
    torch.cuda.synchronize()
    tok, lp = out
    if not torch.equal(tok, ptok):
        raise AssertionError(f"greedy_argmax ids differ ({what}): {tok.tolist()} {ptok.tolist()}")
    e = (lp - plp).abs().max().item()
    if not e <= SCORE_TOL:
        raise AssertionError(f"greedy_argmax log-prob differs by {e} ({what})")
    return e


# (rows, n_tokens, use_ts, mode, the inputs given as offset views)
GREEDY_OFFSET_CASES = [
    (5, 14, True, "randn", "logits"), (5, 9, False, "edge_ties", "suppress"),
    (2, 3, True, "ties", "all"), (8, 12, True, "masked_chunk", "all"),
]  # fmt: skip


def check_greedy():
    """Every case, then the offset-view cases (scalar-load build); then
    1,000 back-to-back launches alternating two inputs, compared after the
    last; then the timings at the main path's shape, one row past the first
    step."""
    err, C = 0.0, bk.cluster_sizes(1, V)[0]
    for seed, case in enumerate(GREEDY_CASES):
        args, kw = greedy_case(seed, *case, C)
        err = max(err, same_greedy(args, kw, bk.greedy_argmax(*args, **kw), f"{case}, C={C}"))
    for seed, (*case, which) in enumerate(GREEDY_OFFSET_CASES, 50):
        args, kw = greedy_case(seed, *case, C, W=1)
        args = offset_inputs(args, which, 0, 4)
        what = f"{case}, {which} offset, C={C}"
        err = max(err, same_greedy(args, kw, bk.greedy_argmax(*args, **kw), what))
    x = greedy_case(101, 5, 14, True, "randn", C)
    y = greedy_case(102, 5, 14, True, "edge_ties", C)
    for _ in range(500):
        out_x = bk.greedy_argmax(*x[0], **x[1])
        out_y = bk.greedy_argmax(*y[0], **y[1])
    err = max(err, same_greedy(*x, out_x, "launch 999"), same_greedy(*y, out_y, "launch 1000"))
    args, kw = greedy_case(99, 1, 60, True, "randn", C)
    n_hist = 60 - SAMPLE_BEGIN + 2
    nbytes = 4 * (V + V + n_hist) + 8  # logits, suppress, history; tok + lp
    return timings(
        lambda: bk.greedy_argmax(*args, **kw), lambda: bk.greedy_argmax_plain(*args, **kw),
        bk.greedy_argmax, "greedy_argmax_kernel", err, nbytes, C,
        lambda: torch.topk(args[0], 1, dim=-1),
    )  # fmt: skip


def loop_state(n_tokens, sample_begin, step, live=1):
    """The decode loop's state array on the card (ops/beam_kernel.py)."""
    return torch.tensor([n_tokens, sample_begin, step, live], dtype=torch.int32, device=DEV)


def greedy_state_call(args, kw, step=1, live=1):
    """The loop-state launch on a scalar case's inputs, into fresh outputs
    holding sentinels (-1, 7.0)."""
    logits, tokens, n_tokens, sample_begin, sup, beg = args
    B = logits.shape[0]
    outs = (torch.full((B,), -1, dtype=torch.int32, device=DEV), torch.full((B,), 7.0, device=DEV))
    state = loop_state(n_tokens, sample_begin, step, live)
    return bk.greedy_argmax_state(logits, tokens, state, sup, beg, *outs, **kw)


def check_greedy_state():
    """The loop-state launch (wtt_greedy_argmax_state, the captured loop's)
    on every case and offset case of check_greedy, with its lengths read
    from the state array; at live = 0 on the first cases, which must leave
    the outputs as they were; 1,000 back-to-back launches alternating two
    inputs; then the timings at the main path's shape beside the scalar
    launch on the same inputs."""
    err, C = 0.0, bk.cluster_sizes(1, V)[0]
    for seed, case in enumerate(GREEDY_CASES):
        args, kw = greedy_case(seed, *case, C)
        err = max(err, same_greedy(args, kw, greedy_state_call(args, kw), f"state {case}, C={C}"))
        if seed < 8:
            tok, lp = greedy_state_call(args, kw, live=0)
            torch.cuda.synchronize()
            if not ((tok == -1).all() and (lp == 7.0).all()):
                raise AssertionError(f"greedy_argmax_state wrote at live = 0 ({case})")
    for seed, (*case, which) in enumerate(GREEDY_OFFSET_CASES, 50):
        args, kw = greedy_case(seed, *case, C, W=1)
        args = offset_inputs(args, which, 0, 4)
        what = f"state {case}, {which} offset, C={C}"
        err = max(err, same_greedy(args, kw, greedy_state_call(args, kw), what))
    x = greedy_case(101, 5, 14, True, "randn", C)
    y = greedy_case(102, 5, 14, True, "edge_ties", C)
    for _ in range(500):
        out_x = greedy_state_call(*x)
        out_y = greedy_state_call(*y)
    err = max(err, same_greedy(*x, out_x, "state launch 999"), same_greedy(*y, out_y, "state launch 1000"))
    args, kw = greedy_case(99, 1, 60, True, "randn", C)
    logits, tokens, n_tokens, sample_begin, sup, beg = args
    state = loop_state(n_tokens, sample_begin, 40)
    outs = (torch.empty(1, dtype=torch.int32, device=DEV), torch.empty(1, device=DEV))
    n_hist = 60 - SAMPLE_BEGIN + 2
    # logits, suppress, history, state (n_tokens != sample_begin: no begin
    # vector); tok + lp and the launch counter
    nbytes = 4 * (V + V + n_hist) + 16 + 8 + 8
    out = timings(
        lambda: bk.greedy_argmax_state(logits, tokens, state, sup, beg, *outs, **kw),
        lambda: bk.greedy_argmax_plain(*args, **kw), bk.greedy_argmax, "greedy_argmax_kernel",
        err, nbytes, C, lambda: torch.topk(logits, 1, dim=-1), counter="greedy_argmax_state",
    )  # fmt: skip
    out["scalar_ms"] = kernel_ms(lambda: bk.greedy_argmax(*args, **kw), bk.greedy_argmax, "greedy_argmax_kernel")
    return out


# (audios A, draft width K, use_ts, mode): A * (K + 1) rows, the verify
# pass's layout (each audio's history repeated over its K + 1 positions at
# lengths n[a] + j); A = 1, 2 and 4 give the main path's B = 5, 10 and 20
GREEDY_ROWS_CASES = [
    (1, 4, True, "randn"), (1, 4, False, "randn"), (1, 4, True, "ts_mass"),
    (1, 4, True, "edge_ties"), (1, 4, False, "bf16"), (4, 4, True, "randn"),
    (4, 4, False, "edge_ties"), (4, 4, True, "ts_mass"), (4, 4, True, "bf16"),
    (4, 4, False, "sparse"), (4, 4, True, "masked_chunk"), (2, 4, True, "edge_ties"),
]  # fmt: skip


def rows_case(seed, A, K, use_ts, mode, C, W=2, at_begin=True, shift=0):
    """A * (K + 1) rows at per-row lengths: audio a's history at length
    n[a] + j in row a * (K + 1) + j, the lengths of the audios distinct and,
    `at_begin`, audio 0 at SAMPLE_BEGIN (so its row 0 takes the begin
    penalty). Audio a's history is of kind (a + shift) % 4: 1, its last
    token a timestamp (mid pair); 2, a pair just closed; 3, a timestamp in
    its past only; every history holds timestamps past its row's length,
    which the rules must not read (the verified tokens a rolled-back draft
    row has not fed again). K = 0 is the draft step's layout: A rows, one
    history each at its own length."""
    rng = np.random.RandomState(seed)
    B = A * (K + 1)
    offsets = list(rng.choice(200, A - 1, replace=False))
    n_audio = [SAMPLE_BEGIN] + [SAMPLE_BEGIN + 1 + o for o in offsets]
    if not at_begin:
        n_audio[0] = SAMPLE_BEGIN + 1 + rng.choice([o for o in range(200) if o not in offsets])
    hist = rng.randint(100, 5000, size=(A, T)).astype(np.int32)
    for a, n in enumerate(n_audio):
        hist[a, n + K + 2 :: 7] = TS_BEGIN + 60  # beyond every row's length
        kind = (a + shift) % 4
        if kind == 1:
            hist[a, n - 1] = TS_BEGIN + 30
        elif kind == 2:
            hist[a, n - 2], hist[a, n - 1] = TS_BEGIN + 7, TS_BEGIN + 12
        elif kind == 3:
            hist[a, SAMPLE_BEGIN + 1] = TS_BEGIN + 20
    tokens = torch.from_numpy(np.repeat(hist, K + 1, axis=0)).to(DEV)
    lengths = np.asarray([n + j for n in n_audio for j in range(K + 1)], np.int32)
    logits = rng.randn(B, V).astype(np.float32)
    if mode == "ts_mass":
        logits[:, TS_BEGIN + 40 :] += 4.0
    elif mode == "bf16":
        logits = bf16_rounded(logits)
    elif mode == "edge_ties":
        plant_edge_ties(logits, C, B, W)
    elif mode == "masked_chunk":
        plant_masked(logits)
    pens = penalties(use_ts, **masks(mode, C, W))
    n_rows = torch.from_numpy(lengths).to(DEV)
    args = (torch.from_numpy(logits).to(DEV), tokens, n_rows, SAMPLE_BEGIN, *pens)
    kw = dict(use_timestamps=use_ts, eot=EOT, timestamp_begin=TS_BEGIN)
    return args, kw


GREEDY_ROWS_OFFSET_CASES = [
    (1, 4, True, "randn", "logits"), (4, 4, False, "edge_ties", "all"),
    (4, 4, True, "masked_chunk", "suppress"),
]  # fmt: skip

# (rows A, use_ts, mode, a row at SAMPLE_BEGIN, history kind shift): the
# draft steps' layout (rows_case at K = 0), one history per audio at its
# own length p_d + 1; B = 1 is transcribe()'s draft step, B = 2 the
# batcher's at two slots, B = 4 transcribe_batch's of four streams
GREEDY_DRAFT_CASES = [
    (1, True, "randn", True, 0), (1, True, "randn", False, 1), (1, True, "ts_mass", False, 2),
    (1, True, "edge_ties", False, 3), (1, False, "bf16", False, 0), (1, True, "bf16", False, 2),
    (1, True, "masked_chunk", True, 0), (1, False, "sparse", False, 1),
    (1, False, "edge_ties", True, 0), (2, True, "randn", True, 0), (2, True, "ts_mass", False, 2),
    (2, False, "edge_ties", True, 0), (2, True, "edge_ties", False, 1), (2, True, "bf16", False, 3),
    (2, False, "sparse", True, 0), (2, True, "masked_chunk", False, 2), (4, True, "randn", True, 0),
    (4, False, "edge_ties", False, 1),
]  # fmt: skip
GREEDY_DRAFT_OFFSET_CASES = [
    (1, True, "randn", False, 1, "logits"), (1, False, "edge_ties", True, 0, "all"),
    (2, True, "masked_chunk", False, 2, "suppress"), (2, True, "ts_mass", True, 0, "all"),
]  # fmt: skip


def rows_cases(C):
    """Every per-row case as (args, kw, what): the verify cases, the
    draft-step cases, then the offset-view cases of both (scalar-load
    build)."""
    for seed, case in enumerate(GREEDY_ROWS_CASES, 200):
        yield (*rows_case(seed, *case, C), f"rows {case}")
    for seed, (A, use_ts, mode, at_begin, shift) in enumerate(GREEDY_DRAFT_CASES, 500):
        args, kw = rows_case(seed, A, 0, use_ts, mode, C, at_begin=at_begin, shift=shift)
        yield args, kw, f"draft step {(A, use_ts, mode, at_begin, shift)}, lengths {args[2].tolist()}"
    for seed, (*case, which) in enumerate(GREEDY_ROWS_OFFSET_CASES, 250):
        args, kw = rows_case(seed, *case, C, W=1)
        yield offset_inputs(args, which, 0, 4), kw, f"rows {case}, {which} offset"
    for seed, (A, use_ts, mode, at_begin, shift, which) in enumerate(GREEDY_DRAFT_OFFSET_CASES, 550):
        args, kw = rows_case(seed, A, 0, use_ts, mode, C, W=1, at_begin=at_begin, shift=shift)
        what = f"draft step {(A, use_ts, mode, at_begin, shift)}, {which} offset"
        yield offset_inputs(args, which, 0, 4), kw, what


def check_greedy_rows():
    """The per-row-length greedy launch (the speculative host loop's draft
    steps and verify pass, a comparison variant) against the plain version
    on the same lengths: every case of rows_cases, 1,000 back-to-back launches
    alternating two inputs; then its device ms at B = 5 and 20 (verify)
    and B = 1 and 2 (draft step) beside the scalar launch on the same
    logits and history (all rows at one length), and the scalar launch at
    the main path's B = 1 (the row launch's B = 1 time is on the same
    inputs)."""
    err, C = 0.0, bk.cluster_sizes(1, V)[0]
    for args, kw, what in rows_cases(C):
        err = max(err, same_greedy(args, kw, bk.greedy_argmax(*args, **kw), what))
    x = rows_case(301, 4, 4, True, "randn", C)
    y = rows_case(302, 4, 4, True, "edge_ties", C)
    for _ in range(500):
        out_x = bk.greedy_argmax(*x[0], **x[1])
        out_y = bk.greedy_argmax(*y[0], **y[1])
    err = max(err, same_greedy(*x, out_x, "rows launch 999"), same_greedy(*y, out_y, "rows 1000"))

    out = dict(max_abs_err=err, cluster=C, rows_ms={}, scalar_ms={})
    for A in (1, 4):
        args, kw = rows_case(400 + A, A, 4, True, "randn", C)
        B = A * 5
        scalar = (args[0], args[1], 60, *args[3:])
        out["rows_ms"][B] = kernel_ms(
            lambda: bk.greedy_argmax(*args, **kw), bk.greedy_argmax, "greedy_argmax_kernel",
            counter="row_launches",
        )  # fmt: skip
        out["scalar_ms"][B] = kernel_ms(
            lambda: bk.greedy_argmax(*scalar, **kw), bk.greedy_argmax, "greedy_argmax_kernel"
        )
        if A == 4:
            # logits, suppress and begin, the histories to their lengths, lengths; tok + lp
            n_hist = int((args[2] - SAMPLE_BEGIN + 2).sum())
            nbytes = 4 * (B * V + 2 * V + n_hist + B) + 8 * B
            out.update(
                bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, ms=out["rows_ms"][B],
                call_ms=call_ms(lambda: bk.greedy_argmax(*args, **kw)),
                plain_ms=device_ms(lambda: bk.greedy_argmax_plain(*args, **kw))[0],
                plain_call_ms=call_ms(lambda: bk.greedy_argmax_plain(*args, **kw)),
                empty_ms=empty_ms(C, C),
                library_ms=device_ms(lambda: torch.topk(args[0], 1, dim=-1))[0],
            )  # fmt: skip
    args, kw = rows_case(402, 2, 0, True, "randn", C, at_begin=False)
    scalar = (args[0], args[1], 60, *args[3:])
    out["rows_ms"][2] = kernel_ms(
        lambda: bk.greedy_argmax(*args, **kw), bk.greedy_argmax, "greedy_argmax_kernel",
        counter="row_launches",
    )  # fmt: skip
    out["scalar_ms"][2] = kernel_ms(
        lambda: bk.greedy_argmax(*scalar, **kw), bk.greedy_argmax, "greedy_argmax_kernel"
    )
    args, kw = greedy_case(99, 1, 60, True, "randn", C)
    rows = (args[0], args[1], torch.tensor([60], dtype=torch.int32, device=DEV), *args[3:])
    out["scalar_ms"][1] = kernel_ms(
        lambda: bk.greedy_argmax(*args, **kw), bk.greedy_argmax, "greedy_argmax_kernel"
    )
    out["rows_ms"][1] = kernel_ms(
        lambda: bk.greedy_argmax(*rows, **kw), bk.greedy_argmax, "greedy_argmax_kernel",
        counter="row_launches",
    )  # fmt: skip
    return out


def rows_state_call(args, kw, live=1, outs=None, state=None):
    """The per-row launch at the loop state on a per-row case's inputs: the
    lengths on the card as given, sample_begin and live in a loop-state
    array (`state`, or a new one); into `outs`, or fresh outputs holding
    sentinels (-1, 7.0)."""
    logits, tokens, n_rows, sample_begin, sup, beg = args
    B = logits.shape[0]
    if outs is None:
        outs = (torch.full((B,), -1, dtype=torch.int32, device=DEV), torch.full((B,), 7.0, device=DEV))
    if state is None:
        state = loop_state(0, sample_begin, 0, live)
    return bk.greedy_argmax_rows_state(logits, tokens, n_rows, state, sup, beg, *outs, **kw)


def check_greedy_rows_state():
    """The per-row launch at the loop state (wtt_greedy_argmax_rows_state,
    the captured speculative round's draft and verify launches) on every
    case of rows_cases (verify B = 5, 10, 20; draft step B = 1, 2, 4;
    chunk-edge ties; offset views), and at live = 0 on every third case,
    which must leave the outputs as they were; 1,000 back-to-back launches
    alternating two inputs; then its device ms beside the per-row launch
    on the same inputs at the main path's B = 1 (draft step) and B = 5
    (verify, the kernels line's shape) and at B = 20, with the bound,
    the empty kernel at the launch's shape, the plain version and
    torch.topk at B = 5."""
    err, C = 0.0, bk.cluster_sizes(1, V)[0]
    for i, (args, kw, what) in enumerate(rows_cases(C)):
        err = max(err, same_greedy(args, kw, rows_state_call(args, kw), f"rows state {what}"))
        if i % 3 == 0:
            tok, lp = rows_state_call(args, kw, live=0)
            torch.cuda.synchronize()
            if not ((tok == -1).all() and (lp == 7.0).all()):
                raise AssertionError(f"greedy_argmax_rows_state wrote at live = 0 ({what})")
    x = rows_case(301, 4, 4, True, "randn", C)
    y = rows_case(302, 4, 4, True, "edge_ties", C)
    for _ in range(500):
        out_x = rows_state_call(*x)
        out_y = rows_state_call(*y)
    err = max(err, same_greedy(*x, out_x, "rows state 999"), same_greedy(*y, out_y, "rows state 1000"))

    out = dict(max_abs_err=err, cluster=C, state_ms={}, rows_ms={})
    for A, K in ((1, 0), (1, 4), (4, 4)):
        args, kw = rows_case(410 + A + K, A, K, True, "randn", C, at_begin=False)
        B = A * (K + 1)
        outs = (torch.empty(B, dtype=torch.int32, device=DEV), torch.empty(B, device=DEV))
        state = loop_state(0, SAMPLE_BEGIN, 0)
        launch = lambda: rows_state_call(args, kw, outs=outs, state=state)  # noqa: E731
        out["state_ms"][B] = kernel_ms(
            launch, bk.greedy_argmax, "greedy_argmax_kernel", counter="greedy_argmax_rows_state"
        )
        out["rows_ms"][B] = kernel_ms(
            lambda: bk.greedy_argmax(*args, **kw), bk.greedy_argmax, "greedy_argmax_kernel",
            counter="row_launches",
        )  # fmt: skip
        if B == 5:
            # logits, suppress, the histories to their lengths, lengths, state
            # (no row at sample_begin: no begin vector); tok + lp, counter
            n_hist = int((args[2] - SAMPLE_BEGIN + 2).sum())
            nbytes = 4 * (B * V + V + n_hist + B + bk.STATE_LEN) + 8 * B + 8
            plain = lambda: bk.greedy_argmax_plain(*args, **kw)  # noqa: E731
            out.update(
                bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, ms=out["state_ms"][B],
                call_ms=call_ms(launch), plain_ms=device_ms(plain)[0], plain_call_ms=call_ms(plain),
                empty_ms=empty_ms(B * C, C), library_ms=device_ms(lambda: torch.topk(args[0], 1, dim=-1))[0],
            )  # fmt: skip
    return out


def empty_ms(grid, cluster):
    """Device ms of one launch of the empty kernel on `grid` CTAs in
    clusters of `cluster`: the mean of the profiler's records of it."""
    lib, stream = empty_lib(), torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.wtt_empty_kernel(grid, cluster, stream)
        if rc:
            raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")

    per_call_ms, per_call = device_ms(launch, kernel="empty_kernel", attempts=6)
    return per_call_ms / per_call


def timings(kernel_fn, plain_fn, wrapper, kernel_name, err, nbytes, cluster, topk_fn,
            counter="launches"):  # fmt: skip
    """Device ms (profiler) and ms per call (CUDA events) of the kernel,
    which launches clusters of `cluster` CTAs, with the empty kernel's
    device ms at the same launch shape and at one CTA, `topk_fn`
    (torch.topk on the same rows, the library call beside the update,
    which it computes without the filters) and the plain version."""
    plain_ms, plain_kernels = device_ms(plain_fn)
    topk_ms, topk_kernels = device_ms(topk_fn)
    return dict(
        max_abs_err=err, ms=kernel_ms(kernel_fn, wrapper, kernel_name, counter=counter),
        call_ms=call_ms(kernel_fn), cluster=cluster, plain_ms=plain_ms,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, plain_call_ms=call_ms(plain_fn),
        plain_kernels_per_call=plain_kernels, bytes=nbytes, library_ms=topk_ms,
        topk_kernels_per_call=topk_kernels, empty_ms=empty_ms(cluster, cluster),
        empty_1cta_ms=empty_ms(1, 1),
    )  # fmt: skip


def planted_ties(A, G):
    """Logits whose candidates tie exactly, within a beam and across beams:
    -1e4 everywhere (exp underflows to 0, so every row's log-sum-exp is the
    log of a small integer whatever the summation order), 0.0 at a few
    tokens. In each audio, beams 0-2 are equal rows with four tokens tied,
    beam 3 ties EOT with a text token, beam 4 has one token; the rest of
    each beam's top-(G+1) ties at -1e4 and goes to the lowest ids."""
    logits = np.full((A * G, V), -1e4, np.float32)
    for a in range(A):
        rows = logits[a * G : (a + 1) * G]
        rows[: min(3, G), [600, 601, 900, 3000]] = 0.0
        if G > 3:
            rows[3, [650, EOT]] = 0.0
        if G > 4:
            rows[4, 800 + a] = 0.0
    return logits


BEAM_CASES = [
    # (A, G, n_tokens, step, use_ts, mode, fcount)
    (1, 5, 3, 0, True, "randn", 0), (1, 5, 40, 20, True, "randn", 0),
    (1, 5, 8, 3, True, "eot", 0), (1, 5, 10, 5, False, "eot", 0), (2, 5, 8, 3, True, "eot", 2),
    (2, 5, 9, 4, True, "eot", 4), (2, 5, 3, 0, False, "randn", 0), (1, 5, 3, 0, True, "bf16", 0),
    (2, 5, 30, 12, True, "bf16", 0), (1, 5, 3, 0, False, "ties", 0),
    (1, 5, 12, 6, False, "ties", 0), (2, 5, 12, 6, True, "ties", 1),
    # (A, G) = (1, 1), (1, 2), (2, 5), (3, 5), (1, 8); chunk edges, empty chunks
    (1, 1, 9, 4, True, "eot", 0), (1, 1, 3, 0, True, "randn", 0),
    (1, 2, 12, 6, True, "edge_ties", 0), (1, 2, 3, 0, False, "edge_ties", 0),
    (2, 5, 12, 6, False, "edge_ties", 0), (2, 5, 9, 4, False, "masked_chunk", 0),
    (3, 5, 10, 5, True, "eot", 1), (3, 5, 12, 6, True, "sparse", 0),
    (3, 5, 14, 7, True, "edge_ties", 0), (1, 8, 14, 7, True, "randn", 0),
    (1, 8, 12, 6, False, "edge_ties", 0), (1, 8, 9, 4, True, "masked_chunk", 0),
    # (A, G) = (4, 5): transcribe_chunked's four chunks at beam 5
    (4, 5, 3, 0, True, "randn", 0), (4, 5, 12, 6, True, "eot", 2),
    (4, 5, 14, 7, False, "edge_ties", 0), (4, 5, 12, 6, True, "ties", 1),
]  # fmt: skip


def beam_case(seed, A, G, n_tokens, step, use_ts, mode, fcount, C, MC=5, W=2):
    rng = np.random.RandomState(seed)
    tokens = history(rng, A * G, n_tokens, step, G)
    logits = rng.randn(A * G, V).astype(np.float32)
    sum_lp = (rng.randn(A * G) * (step > 0)).astype(np.float32)
    if mode == "eot":
        logits[:, EOT] += 12.0  # EOT candidates reach the pools
    elif mode == "bf16":
        logits = bf16_rounded(logits)
    elif mode == "ties":
        logits = planted_ties(A, G)
        sum_lp[:] = 0.0  # equal beams give equal candidates
    elif mode == "edge_ties":
        logits = np.repeat(logits[::G], G, axis=0)  # equal beams: ties across beams
        plant_edge_ties(logits, C, A * G, W)
        sum_lp[:] = 0.0
    elif mode == "masked_chunk":
        plant_masked(logits)
    sum_lp = torch.from_numpy(sum_lp).to(DEV)
    pool = [
        torch.zeros((A, MC, T + 1), dtype=torch.int32, device=DEV),
        torch.full((A, MC), float("-inf"), device=DEV),
        torch.zeros((A, MC), dtype=torch.int32, device=DEV),
        torch.full((A,), fcount, dtype=torch.int32, device=DEV),
    ]
    head = (torch.from_numpy(logits).to(DEV), tokens, sum_lp)
    tail = (n_tokens, SAMPLE_BEGIN, step, *penalties(use_ts, **masks(mode, C, W)))
    kw = dict(n_group=G, use_timestamps=use_ts, eot=EOT, timestamp_begin=TS_BEGIN)
    return head, pool, tail, kw


def same_beam(case, k, kpool, what):
    """The kernel's result `k` and pools `kpool` (from the fresh pools of
    `case`) against the plain version's; returns the largest score error."""
    head, pool, tail, kw = case
    pool = [p.clone() for p in pool]
    p = bk.beam_update_plain(*head, *pool, *tail, **kw)
    torch.cuda.synchronize()
    n = tail[0] + 1
    same = (
        torch.equal(k[0][:, :n], p[0][:, :n]) and torch.equal(k[1], p[1])
        and torch.equal(kpool[0], pool[0]) and torch.equal(kpool[2], pool[2])
        and torch.equal(kpool[3], pool[3])
    )  # fmt: skip
    if not same:
        raise AssertionError(f"beam_update differs ({what})")
    finite = torch.isfinite(pool[1])
    if not torch.equal(finite, torch.isfinite(kpool[1])):
        raise AssertionError(f"beam_update pool scores differ in which are finite ({what})")
    if not torch.equal(torch.isfinite(k[2]), torch.isfinite(p[2])):
        raise AssertionError(f"beam_update scores differ in which are finite ({what})")
    fin = torch.isfinite(p[2])
    e = max(
        (k[2][fin] - p[2][fin]).abs().max().item() if fin.any() else 0.0,
        (kpool[1][finite] - pool[1][finite]).abs().max().item() if finite.any() else 0.0,
    )
    if not e <= SCORE_TOL:
        raise AssertionError(f"beam_update scores differ by {e} ({what})")
    return e


# (A, G, n_tokens, step, use_ts, mode, fcount, the inputs given as offset views)
BEAM_OFFSET_CASES = [
    (2, 5, 12, 6, True, "eot", 1, "logits"), (3, 5, 14, 7, False, "edge_ties", 0, "all"),
    (1, 2, 3, 0, True, "randn", 0, "suppress"),
]  # fmt: skip


def check_beam():
    """Every case, then the offset-view cases (scalar-load build); then
    1,000 back-to-back launches alternating two inputs (neither collects an
    EOT, so the pools stay as they were), compared after the last; then the
    timings at the main path's shape: one audio, beam 5, mid-window."""
    err = 0.0
    cases = [(*c, None) for c in BEAM_CASES] + BEAM_OFFSET_CASES
    for seed, (A, G, n_tokens, step, use_ts, mode, fcount, which) in enumerate(cases):
        C = bk.cluster_sizes(G, V)[1] // G
        W = 1 if which else 2
        head, pool, tail, kw = beam_case(seed, A, G, n_tokens, step, use_ts, mode, fcount, C, W=W)
        if which:
            args = offset_inputs(head + tail, which, 0, 6)
            head, tail = args[:3], args[3:]
        case = (head, pool, tail, kw)
        kpool = [p.clone() for p in pool]
        k = bk.beam_update(*head, *kpool, *tail, **kw)
        what = f"{mode}, A={A}, G={G}, n_tokens={n_tokens}, step={step}, C={C}, offset={which}"
        err = max(err, same_beam(case, k, kpool, what))
        if mode in ("eot", "ties") and step > 0 and int(kpool[3].sum()) <= fcount * A:
            raise AssertionError(f"the EOT case put nothing into the pools ({what})")
    C = bk.cluster_sizes(5, V)[1] // 5
    x = beam_case(101, 3, 5, 14, 7, True, "randn", 0, C)
    y = beam_case(102, 3, 5, 14, 7, True, "edge_ties", 0, C)
    for case in (x, y):
        case[0][0][:, EOT] = float("-inf")  # no EOT candidate: the pools stay
    kx, ky = [p.clone() for p in x[1]], [p.clone() for p in y[1]]
    for _ in range(500):
        out_x = bk.beam_update(*x[0], *kx, *x[2], **x[3])
        out_y = bk.beam_update(*y[0], *ky, *y[2], **y[3])
    err = max(err, same_beam(x, out_x, kx, "launch 999"), same_beam(y, out_y, ky, "launch 1000"))
    head, pool, tail, kw = beam_case(99, 1, 5, 60, 40, True, "randn", 0, C)
    G = 5
    # logits, suppress, sum_lp, the source rows read and the new rows written
    nbytes = 4 * (G * V + V + G + 2 * G * T) + 8 * G + 4
    return timings(
        lambda: bk.beam_update(*head, *pool, *tail, **kw),
        lambda: bk.beam_update_plain(*head, *pool, *tail, **kw),
        bk.beam_update, "beam_update_kernel", err, nbytes, G * C,
        lambda: torch.topk(head[0], G + 1, dim=-1),
    )  # fmt: skip


def beam_state_call(case, kpool, live=1):
    """The loop-state launch on a scalar case's inputs and the pools
    `kpool`, into fresh outputs holding sentinels (-1, -1, 7.0)."""
    head, _, tail, kw = case
    n_tokens, sample_begin, step, sup, beg = tail
    B = head[0].shape[0]
    outs = (
        torch.full_like(head[1], -1), torch.full((B,), -1, dtype=torch.int32, device=DEV),
        torch.full((B,), 7.0, device=DEV),
    )  # fmt: skip
    state = loop_state(n_tokens, sample_begin, step, live)
    return bk.beam_update_state(*head, *kpool, state, sup, beg, *outs, **kw)


def check_beam_state():
    """The loop-state launch (wtt_beam_update_state) on every case and
    offset case of check_beam, n_tokens, sample_begin and step read from the
    state array; at live = 0 on every case, which must leave the pools and
    the outputs as they were; 1,000 back-to-back launches alternating two
    inputs; then the timings at the main path's shape beside the scalar
    launch on the same inputs."""
    err = 0.0
    cases = [(*c, None) for c in BEAM_CASES] + BEAM_OFFSET_CASES
    for seed, (A, G, n_tokens, step, use_ts, mode, fcount, which) in enumerate(cases):
        C = bk.cluster_sizes(G, V)[1] // G
        W = 1 if which else 2
        head, pool, tail, kw = beam_case(seed, A, G, n_tokens, step, use_ts, mode, fcount, C, W=W)
        if which:
            args = offset_inputs(head + tail, which, 0, 6)
            head, tail = args[:3], args[3:]
        case = (head, pool, tail, kw)
        what = f"state {mode}, A={A}, G={G}, n_tokens={n_tokens}, step={step}, C={C}, offset={which}"
        kpool = [p.clone() for p in pool]
        err = max(err, same_beam(case, beam_state_call(case, kpool), kpool, what))
        if mode in ("eot", "ties") and step > 0 and int(kpool[3].sum()) <= fcount * A:
            raise AssertionError(f"the EOT case put nothing into the pools ({what})")
        kpool = [p.clone() for p in pool]
        new_tokens, src, new_lp = beam_state_call(case, kpool, live=0)
        torch.cuda.synchronize()
        if not (all(torch.equal(a, b) for a, b in zip(kpool, pool)) and (new_tokens == -1).all()
                and (src == -1).all() and (new_lp == 7.0).all()):  # fmt: skip
            raise AssertionError(f"beam_update_state wrote at live = 0 ({what})")
    C = bk.cluster_sizes(5, V)[1] // 5
    x = beam_case(101, 3, 5, 14, 7, True, "randn", 0, C)
    y = beam_case(102, 3, 5, 14, 7, True, "edge_ties", 0, C)
    for case in (x, y):
        case[0][0][:, EOT] = float("-inf")  # no EOT candidate: the pools stay
    kx, ky = [p.clone() for p in x[1]], [p.clone() for p in y[1]]
    for _ in range(500):
        out_x = beam_state_call(x, kx)
        out_y = beam_state_call(y, ky)
    err = max(err, same_beam(x, out_x, kx, "state launch 999"), same_beam(y, out_y, ky, "state launch 1000"))
    head, pool, tail, kw = beam_case(99, 1, 5, 60, 40, True, "randn", 0, C)
    G = 5
    n_tokens, sample_begin, step, sup, beg = tail
    state = loop_state(n_tokens, sample_begin, step)
    outs = (torch.empty_like(head[1]), torch.empty(G, dtype=torch.int32, device=DEV),
            torch.empty(G, device=DEV))  # fmt: skip
    # logits, suppress, sum_lp, state (n_tokens != sample_begin: no begin
    # vector), the source rows read and the new rows written, the launch counter
    nbytes = 4 * (G * V + V + G + 2 * G * T) + 16 + 8 * G + 4 + 8
    out = timings(
        lambda: bk.beam_update_state(*head, *pool, state, sup, beg, *outs, **kw),
        lambda: bk.beam_update_plain(*head, *pool, *tail, **kw),
        bk.beam_update, "beam_update_kernel", err, nbytes, G * C,
        lambda: torch.topk(head[0], G + 1, dim=-1), counter="beam_update_state",
    )  # fmt: skip
    out["scalar_ms"] = kernel_ms(lambda: bk.beam_update(*head, *pool, *tail, **kw), bk.beam_update, "beam_update_kernel")
    return out


def check_odd_vocab():
    """The update kernels' scalar-load build (an odd V: a row of float32
    logits is then 4-byte aligned at odd rows) at the pre-v3 multilingual
    vocabulary (V = 51865, timestamps from 50364), on randn logits and on
    equal maxima on both sides of every greedy and beam chunk edge: greedy
    at B = 5, beam at (A, G) = (2, 5) with EOT candidates. Returns the
    largest score error."""
    Vo, ts_begin, A, G, n_tokens = 51865, 50364, 2, 5, 12
    sup, beg = bk.build_penalty_vectors(
        Vo, [1, 2, 3, 11, 220], [220, EOT], use_timestamps=True, no_timestamps=ts_begin - 1,
        timestamp_begin=ts_begin, max_initial_ts_index=50,
    )  # fmt: skip
    pens = (torch.from_numpy(sup).to(DEV), torch.from_numpy(beg).to(DEV))
    kw = dict(use_timestamps=True, eot=EOT, timestamp_begin=ts_begin)
    rng, err = np.random.RandomState(17), 0.0
    for mode in ("randn", "edge_ties"):
        logits = rng.randn(A * G, Vo).astype(np.float32)
        if mode == "edge_ties":
            for C in (bk.cluster_sizes(G, Vo)[0], bk.cluster_sizes(G, Vo)[1] // G):
                n = -(-Vo // C)
                for e in range(n, Vo, n):
                    logits[:, [e - 1, e]] = 14.0
        logits[G:, EOT] = 20.0  # above the ties: audio 1 collects EOT candidates
        tokens = history(rng, A * G, n_tokens, 6, G)
        lg = torch.from_numpy(logits).to(DEV)
        args = (lg[:G], tokens[:G], n_tokens, SAMPLE_BEGIN, *pens)
        err = max(err, same_greedy(args, kw, bk.greedy_argmax(*args, **kw), f"V={Vo}, {mode}"))
        sum_lp = torch.from_numpy(rng.randn(A * G).astype(np.float32)).to(DEV)
        pool = [
            torch.zeros((A, 5, T + 1), dtype=torch.int32, device=DEV),
            torch.full((A, 5), float("-inf"), device=DEV),
            torch.zeros((A, 5), dtype=torch.int32, device=DEV),
            torch.zeros((A,), dtype=torch.int32, device=DEV),
        ]
        case = ((lg, tokens, sum_lp), pool, (n_tokens, SAMPLE_BEGIN, 6, *pens), dict(kw, n_group=G))
        kpool = [p.clone() for p in pool]
        k = bk.beam_update(*case[0], *kpool, *case[2], **case[3])
        err = max(err, same_beam(case, k, kpool, f"V={Vo}, {mode}"))
        if int(kpool[3].sum()) == 0:
            raise AssertionError("the odd-vocabulary beam case put nothing into the pools")
    return err


# the English-only models' layout (the gpt2 encoding: tiny.en .. medium.en)
# and large-v3's, as (V, EOT, first timestamp, no-timestamps, sample_begin)
EN_LAYOUT = (51864, 50256, 50363, 50362, 1)
V3_LAYOUT = (V, EOT, TS_BEGIN, NO_TS, SAMPLE_BEGIN)


def layout_case(seed, layout, rows, n_tokens, G, mode, C, use_ts=True):
    """Inputs of one update at `layout`: randn logits over its V (`eot`:
    EOT lifted above the rest in every other row; `edge_ties`: equal maxima
    on both sides of every chunk edge of C chunks), a history whose rows
    end mid timestamp pair, with a pair just closed or in text (rows G
    apart equal at n_tokens == sample_begin, as a beam's first step), the
    penalty vectors and the kernels' keywords."""
    Vx, eot, ts_begin, no_ts, sb = layout
    rng = np.random.RandomState(seed)
    tokens = rng.randint(100, 5000, size=(rows, T)).astype(np.int32)
    if n_tokens > sb:
        tokens[1 % rows, n_tokens - 1] = ts_begin + 30  # mid pair
        tokens[2 % rows, n_tokens - 2 : n_tokens] = (ts_begin + 7, ts_begin + 12)  # pair closed
    else:
        tokens = np.repeat(tokens[::G], G, axis=0)
    logits = rng.randn(rows, Vx).astype(np.float32)
    if mode == "edge_ties":
        n = -(-Vx // C)
        n += n % 2
        for e in range(n, Vx, n):
            logits[:, [e - 1, e]] = 14.0
    elif mode == "eot":
        logits[::2, eot] = 20.0
    sup, beg = bk.build_penalty_vectors(
        Vx, [1, 2, 3, 11, 220], [220, eot], use_timestamps=use_ts, no_timestamps=no_ts,
        timestamp_begin=ts_begin, max_initial_ts_index=50,
    )  # fmt: skip
    pens = (torch.from_numpy(sup).to(DEV), torch.from_numpy(beg).to(DEV))
    kw = dict(use_timestamps=use_ts, eot=eot, timestamp_begin=ts_begin)
    lg = torch.from_numpy(logits).to(DEV)
    return lg, torch.from_numpy(tokens).to(DEV), pens, kw


def check_layout_vocab():
    """The update kernels at the English-only layout (V = 51864, EOT 50256,
    timestamps from 50363, sample_begin 1: an even V, so the float2 build)
    and, for the beam kernel at (A, G) = (4, 5), at large-v3's: the greedy
    kernel's scalar, loop-state, per-row and per-row loop-state launches at
    B = 1 and 5, the beam kernel's scalar and loop-state launches at
    (A, G) = (1, 5) and (4, 5), at the first sampled position (the begin
    vector) and past it, with and without timestamp rules, on randn logits,
    EOT-heavy rows and equal maxima on both sides of every chunk edge; ids,
    sources, tokens and pools exact against the plain versions, scores
    within SCORE_TOL. Returns the largest score error and the launches
    checked."""
    err, n = 0.0, 0
    for seed, (B, at, mode, use_ts) in enumerate([
        (1, 0, "randn", True), (1, 11, "edge_ties", True), (1, 11, "randn", False),
        (5, 0, "edge_ties", True), (5, 11, "randn", True), (5, 14, "eot", False),
        (5, 9, "edge_ties", False),
    ]):  # fmt: skip
        sb = EN_LAYOUT[4]
        C = bk.cluster_sizes(1, EN_LAYOUT[0])[0]
        lg, tokens, (sup, beg), kw = layout_case(seed, EN_LAYOUT, B, sb + at, 1, mode, C, use_ts)
        what = f"en layout greedy B={B}, n_tokens={sb + at}, {mode}, ts={use_ts}"
        args = (lg, tokens, sb + at, sb, sup, beg)
        err = max(err, same_greedy(args, kw, bk.greedy_argmax(*args, **kw), what))
        err = max(err, same_greedy(args, kw, greedy_state_call(args, kw), "state " + what))
        lengths = torch.tensor([sb + at + (r % 3) for r in range(B)], dtype=torch.int32, device=DEV)
        rows = (lg, tokens, lengths, sb, sup, beg)
        err = max(err, same_greedy(rows, kw, bk.greedy_argmax(*rows, **kw), "rows " + what))
        err = max(err, same_greedy(rows, kw, rows_state_call(rows, kw), "rows state " + what))
        n += 4
    for seed, (layout, A, at, mode, use_ts) in enumerate([
        (EN_LAYOUT, 1, 0, "randn", True), (EN_LAYOUT, 1, 11, "eot", True),
        (EN_LAYOUT, 1, 9, "edge_ties", False), (EN_LAYOUT, 4, 0, "edge_ties", True),
        (EN_LAYOUT, 4, 11, "eot", True), (EN_LAYOUT, 4, 12, "randn", False),
        (EN_LAYOUT, 4, 14, "edge_ties", True), (V3_LAYOUT, 4, 0, "randn", True),
        (V3_LAYOUT, 4, 11, "eot", True), (V3_LAYOUT, 4, 14, "edge_ties", False),
    ], 20):  # fmt: skip
        G, sb = 5, layout[4]
        C = bk.cluster_sizes(G, layout[0])[1] // G
        lg, tokens, pens, kw = layout_case(seed, layout, A * G, sb + at, G, mode, C, use_ts)
        rng = np.random.RandomState(seed)
        sum_lp = torch.from_numpy((rng.randn(A * G) * (at > 0)).astype(np.float32)).to(DEV)
        pool = [
            torch.zeros((A, 5, T + 1), dtype=torch.int32, device=DEV),
            torch.full((A, 5), float("-inf"), device=DEV),
            torch.zeros((A, 5), dtype=torch.int32, device=DEV),
            torch.zeros((A,), dtype=torch.int32, device=DEV),
        ]
        case = ((lg, tokens, sum_lp), pool, (sb + at, sb, at, *pens), dict(kw, n_group=G))
        what = f"V={layout[0]} beam A={A}, G={G}, n_tokens={sb + at}, {mode}, ts={use_ts}"
        kpool = [p.clone() for p in pool]
        k = bk.beam_update(*case[0], *kpool, *case[2], **case[3])
        err = max(err, same_beam(case, k, kpool, what))
        if mode == "eot" and int(kpool[3].sum()) == 0:
            raise AssertionError(f"the EOT case put nothing into the pools ({what})")
        kpool = [p.clone() for p in pool]
        err = max(err, same_beam(case, beam_state_call(case, kpool), kpool, "state " + what))
        n += 2
    return dict(max_abs_err=err, launches_checked=n)


# ---- phase 2b: the word-timing kernels vs plain versions -------------------


KDTW, KMEDIAN = "dtw_trace_kernel", "median_filter_kernel"


def empty_grid_ms(grid_x, grid_y, threads, smem_bytes=0):
    """Device ms of one launch of the empty kernel on a (grid_x, grid_y)
    grid of `threads`-thread CTAs with `smem_bytes` of dynamic shared
    memory: the floor of a launch of that shape."""
    lib, stream = empty_lib(), torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.wtt_empty_grid(grid_x, grid_y, threads, smem_bytes, stream)
        if rc:
            raise RuntimeError(f"empty grid kernel launch failed: CUDA error {rc}")

    per_call_ms, per_call = device_ms(launch, kernel="empty_grid_kernel", attempts=6)
    return per_call_ms / per_call


def chain_floor_ms(steps):
    """Device ms of one thread running `steps` dependent steps of a DTW
    cell's arithmetic (smoke/empty_kernel.cu:chain_kernel)."""
    lib, stream = empty_lib(), torch.cuda.current_stream().cuda_stream
    out = torch.empty(1, dtype=torch.float64, device=DEV)

    def launch():
        rc = lib.wtt_chain(0.5, steps, out.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"chain kernel launch failed: CUDA error {rc}")

    per_call_ms, per_call = device_ms(launch, kernel="chain_kernel", attempts=6)
    return per_call_ms / per_call


def dtw_smem_bytes(N):
    """The DTW kernel's dynamic shared memory at N rows
    (csrc/dtw.cu:dtw_smem_bytes): rings, flags, x and trace tiles."""
    nw = -(-N // 32)
    return nw * 64 * 8 + 2 * nw * 4 + nw * 2 * 32 * 17 * 4 + nw * 2 * 16 * 36


def dtw_threads(N):
    """The DTW kernel's block: a compute warp per strip of 32 rows, and an
    I/O warp beside each while there are at most 15 strips."""
    nw = -(-N // 32)
    return 32 * (2 * nw if nw <= 15 else nw)


def dtw_case(N, M, tied, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(-3, 4, size=(N, M)) if tied else rng.randn(N, M)
    return torch.from_numpy(x.astype(np.float32)).to(DEV)


def same_dtw(x, k, what):
    p = dtw.dtw_trace_plain(x)
    torch.cuda.synchronize()
    if k.dtype != torch.int8 or not torch.equal(k, p):
        raise AssertionError(f"dtw_trace differs from plain ({what})")
    if not np.array_equal(dtw.backtrace(k.cpu().numpy()), dtw.backtrace(p.cpu().numpy())):
        raise AssertionError(f"dtw paths differ ({what})")


# (N, M): the main path's largest and smaller windows; N + 1 = 1024 (the
# limit); N + 1 and M + 1 off multiples of 32 (ragged strips and tiles);
# M < 32 (one tile); one cell
DTW_SHAPES = [
    (252, 1500), (40, 750), (234, 189), (10, 20), (1023, 1500), (1023, 40), (100, 20),
    (33, 31), (64, 1000), (31, 7), (1, 1), (1, 1500),
]  # fmt: skip


def check_dtw():
    """Trace tables and backtraced paths equal, bit for bit, on randn and
    on integer-valued (tied) costs at every shape; 1,000 back-to-back
    launches alternating two inputs, compared after the last; device ms per
    shape; at the main path's largest shape (N = 252 tokens, M = 1500) the
    plain and per-call times, the empty kernel at the same launch shape and
    the chain floor: N + M - 1 dependent steps on one thread. The plain
    version (1,751 host-driven steps at that shape, ~0.9 s a call) is timed
    on one call after one warm-up each way: its calls, and the profiler's
    records of ~10 kernels a step, are the check's cost."""
    per_shape = {}
    for seed, (N, M) in enumerate(DTW_SHAPES):
        for tied in (False, True):
            x = dtw_case(N, M, tied, seed)
            same_dtw(x, dtw.dtw_trace(x), f"{(N, M)}, tied={tied}")
        if N * M >= 10000:
            per_shape[f"{N}x{M}"] = kernel_ms(lambda: dtw.dtw_trace(x), dtw.dtw_trace, KDTW, 20)
    x, y = dtw_case(252, 1500, False, 101), dtw_case(252, 1500, True, 102)
    for _ in range(500):
        kx, ky = dtw.dtw_trace(x), dtw.dtw_trace(y)
    same_dtw(x, kx, "launch 999")
    same_dtw(y, ky, "launch 1000")
    N, M = DTW_SHAPES[0]
    x = dtw_case(N, M, False, 0)
    ms = kernel_ms(lambda: dtw.dtw_trace(x), dtw.dtw_trace, KDTW, 20)
    nbytes = 4 * N * M + (N + 1) * (M + 1)  # x read once, the int8 trace written once
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    chain_ms = chain_floor_ms(N + M - 1)
    return dict(
        max_abs_err=0.0, ms=ms, plain_ms=device_ms(lambda: dtw.dtw_trace_plain(x), reps=1, warmup=1)[0],
        bound_ms=max(bytes_ms, chain_ms), bound_by="operations" if chain_ms > bytes_ms else "bytes",
        bytes_bound_ms=bytes_ms, chain_floor_ms=chain_ms,
        empty_ms=empty_grid_ms(1, 1, dtw_threads(N), dtw_smem_bytes(N)),
        call_ms=call_ms(lambda: dtw.dtw_trace(x), 20),
        plain_call_ms=call_ms(lambda: dtw.dtw_trace_plain(x), 1, warmup=1), bytes=nbytes,
        steps=N + M - 1, device_ms_per_shape=per_shape, library_ms=None,
    )  # fmt: skip


def same_values(a, b):
    """Equal values, NaN where NaN (torch.equal counts NaN unequal)."""
    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan], b[~nan])


def special_rows(rows, T, seed):
    """Rows of NaN (15% of entries, 50% in every fourth row), +-inf (10%),
    0.0 and -0.0 (20%) and a coarse grid of numbers: windows of 7 then hold
    1, 3 and 4 NaNs (a numeric and a NaN median), infinities and both
    zeros, at column 0 and at n_valid too."""
    rng = np.random.RandomState(seed)
    x = np.round(rng.randn(rows, T) * 4) / 4
    u = rng.rand(rows, T)
    p_nan = np.where(np.arange(rows)[:, None] % 4 == 3, 0.5, 0.15)
    x = np.where(u < p_nan, np.nan, x)
    x = np.where((u >= p_nan) & (u < p_nan + 0.1), np.where(u < p_nan + 0.05, np.inf, -np.inf), x)
    zero = (u >= p_nan + 0.1) & (u < p_nan + 0.3)
    x = np.where(zero, np.where(u < p_nan + 0.2, 0.0, -0.0), x)
    counts = np.lib.stride_tricks.sliding_window_view(np.isnan(x), 7, axis=-1).sum(-1)
    if not all((counts == n).any() for n in (1, 3, 4)):
        raise AssertionError("the special rows lack windows of 1, 3 or 4 NaNs")
    return torch.from_numpy(x.astype(np.float32)).to(DEV)


def check_median():
    """Exactly equal on the valid columns (and the copied ones past them),
    at 40 heads x 224 rows x 1500 frames, width 7, reflecting at 1500 and
    at 551, on randn inputs, on inputs on a coarse grid (equal values) and
    on rows with planted NaN, +-inf and +-0 (NaN where the plain version
    has NaN); widths 3, 5 and 13 likewise on 300 rows; at T = 1499 and 1502
    (not multiples of 4: the scalar-load build) and on an offset view 4
    bytes past a 16-byte boundary (scalar-load build); then 1,000
    back-to-back launches alternating two inputs, compared after the last.
    Times at the main path's shape beside the empty kernel of the same
    launch shape and `unfold(...).median(-1)`."""
    R, T, W = 40 * 224, 1500, 7
    gen = torch.Generator(device=DEV).manual_seed(7)
    base = torch.randn((R, T), generator=gen, device=DEV)
    special = special_rows(R, T, 8)
    cases = [("randn", base), ("grid", torch.round(base * 4) / 4), ("special", special)]
    for name, x in cases:
        for w in (3, 5, 7, 13):
            xw = x if w == W else x[:300]
            for n_valid in (T, 551):
                k = median.median_filter(xw, w, n_valid=n_valid)
                if not same_values(k, median.median_filter_plain(xw, w, n_valid=n_valid)):
                    raise AssertionError(f"median_filter differs ({name}, width={w}, {n_valid})")
    for T2 in (1499, 1502):
        rand = torch.randn((300, T2), generator=gen, device=DEV)
        for name, x in (("randn", rand), ("special", special_rows(300, T2, T2))):
            for w in (3, 7, 13):
                for n_valid in (T2, 551, 4 if w < 7 else 7):
                    k = median.median_filter(x, w, n_valid=n_valid)
                    if not same_values(k, median.median_filter_plain(x, w, n_valid=n_valid)):
                        raise AssertionError(f"median_filter differs (T={T2}, {name}, {w}, {n_valid})")
    for name, x in (("randn", base[:300]), ("special", special[:300])):
        view = offset_view(x)
        if view.data_ptr() % 16 != 4:
            raise AssertionError("the offset view is 16-byte aligned")
        for w in (7, 13):
            for n_valid in (T, 551):
                k = median.median_filter(view, w, n_valid=n_valid)
                if not same_values(k, median.median_filter_plain(x, w, n_valid=n_valid)):
                    raise AssertionError(f"median_filter differs (offset view, {name}, {w}, {n_valid})")
    x, y = base, special
    for _ in range(500):
        kx, ky = median.median_filter(x, W, 551), median.median_filter(y, W, T)
    if not (same_values(kx, median.median_filter_plain(x, W, 551))
            and same_values(ky, median.median_filter_plain(y, W, T))):  # fmt: skip
        raise AssertionError("median_filter differs after 1,000 back-to-back launches")
    x = base
    ms = kernel_ms(lambda: median.median_filter(x, W, T), median.median_filter, KMEDIAN)
    # the one PyTorch call that computes the same values, on the input
    # reflected beforehand (outside the timed call)
    padded = torch.nn.functional.pad(x, (W // 2, W // 2), mode="reflect")
    lib = padded.unfold(-1, W, 1).median(-1).values
    if not torch.equal(lib, median.median_filter(x, W, T)):
        raise AssertionError("unfold(...).median(-1) does not compute the filter")
    nbytes = 2 * 4 * R * T  # x read once, the result written once
    return dict(
        max_abs_err=0.0, ms=ms, plain_ms=device_ms(lambda: median.median_filter_plain(x, W, T))[0],
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=device_ms(lambda: padded.unfold(-1, W, 1).median(-1))[0],
        empty_ms=empty_grid_ms(-(-T // 512), min(R, 4096), 128),  # median_filter.cu's grid
        call_ms=call_ms(lambda: median.median_filter(x, W, T)),
        plain_call_ms=call_ms(lambda: median.median_filter_plain(x, W, T)), bytes=nbytes,
    )  # fmt: skip


# ---- phase 3: float32 products of bf16 operands ----------------------------


def f32_products():
    """The logits (hidden @ tok_emb.T at turbo width) and a step's attention
    scores (beam 5, 20 heads, 1500 keys) from bf16 operands: within 1e-4 of
    the float64 product of the same bf16 values, where a bf16 rounding of
    values of magnitude ~1 is off by up to 4e-3."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    d, out = MODEL_DIMS["turbo"].n_text_state, {}
    shapes = {
        "logits": ((1, d), (d, V), 1.0, 0.03),
        "scores": ((5, 20, 1, 64), (5, 20, 64, 1500), 0.35, 0.35),
    }
    for name, (sa, sb, ka, kb) in shapes.items():
        a = (torch.randn(sa, generator=gen, device=DEV) * ka).bfloat16()
        b = (torch.randn(sb, generator=gen, device=DEV) * kb).bfloat16()
        if name == "logits":
            got = graphs.matmul_f32(a, b.t().contiguous().t())  # tok_emb.T's layout
        else:
            got = graphs.matmul_f32(a, b)
        want = a.double() @ b.double()
        err = (got.double() - want).abs().max().item()
        rounded = (got != got.bfloat16().float()).float().mean().item()
        if got.dtype != torch.float32 or not err < 1e-4 or not rounded > 0.99:
            raise AssertionError(f"{name}: dtype {got.dtype}, error {err}, unrounded {rounded}")
        out[name] = dict(max_abs_err=err, magnitude=want.abs().max().item())
    return out


# ---- phase 4: card vs CPU at tiny dims --------------------------------------


def tiny_params(dims, seed):
    """Seeded float32 weights, the (L, in, out) projections rescaled to
    0.5 / sqrt(in) so that activations stay O(1) and the logits spread
    widely: at the default 0.02 a 128-wide model's logits bunch within
    ~0.2 and the tokens would hang on near-ties."""
    params = init_random_params(dims, seed, torch.float32, "cpu")
    for part in ("encoder", "decoder"):
        for w in params[part]["blocks"].values():
            if w.dim() == 3:
                w.mul_(0.5 / np.sqrt(w.shape[1]) / 0.02)
    return params


def card_vs_cpu():
    dims = ModelDimensions(80, 1500, 128, 2, 2, 51866, 448, 128, 2, 2)
    params = tiny_params(dims, seed=11)
    gpu = Whisper(dims, params, device="cuda", compute_dtype=torch.float32)
    cpu = Whisper(dims, params, device="cpu", compute_dtype=torch.float32)
    mel = (np.random.RandomState(5).randn(80, 3000) * 0.6).astype(np.float32)
    out = {}
    # and with int8 weights (the engines' int8 decoder and cross-K/V)
    for weights in ("", "int8"):
        for name, kw in [("greedy", {}), ("beam5", dict(beam_size=5))]:
            name = f"{weights}_{name}" if weights else name
            gpu.decode_weights = cpu.decode_weights = weights
            opts = DecodingOptions(language="en", sample_len=40, **kw)
            g, c = decode(gpu, mel, opts), decode(cpu, mel, opts)
            if g.tokens != c.tokens:
                raise AssertionError(f"{name}: card tokens {g.tokens} != CPU tokens {c.tokens}")
            d = abs(g.avg_logprob - c.avg_logprob)
            if not d < 1e-3:
                raise AssertionError(f"{name}: avg_logprob differs by {d}")
            out[name] = dict(tokens=len(g.tokens), avg_logprob_diff=d)
    gpu.decode_weights = cpu.decode_weights = ""
    # word timestamps: the same words at the same times on both
    jfk = load_audio(os.path.join(ROOT, "tests", "data", "jfk.flac"))
    kw = dict(language="en", temperature=0.0, verbose=None, word_timestamps=True)
    gw, cw = words_of(gpu.transcribe(jfk, **kw)), words_of(cpu.transcribe(jfk, **kw))
    if not cw:
        raise AssertionError("the CPU run of jfk gave no words")
    out["words"] = dict(words=len(gw), max_time_diff_s=same_words(gw, cw, "jfk"))
    # the silence pass on jfk, 8 s of silence, jfk twice: the same windows
    # (seek, tokens and words as aligned, before any cull) and the same
    # final segments on both
    audio = np.concatenate([jfk, np.zeros(8 * 16000, np.float32), np.tile(jfk, 2)])
    kw = dict(kw, hallucination_silence_threshold=2.0)
    runs = []
    for model in (gpu, cpu):
        with watch_replays() as replays:
            result = model.transcribe(audio, **kw)
        runs.append((result["segments"], replays))
    (gsegs, greps), (csegs, creps) = runs
    if [r["aligned"] for r in greps] != [r["aligned"] for r in creps] or not any(
        r["aligned"] for r in creps
    ):
        raise AssertionError(f"silence pass: {len(greps)} vs {len(creps)} replays, or none aligned")
    d = 0.0
    for i, (g, c) in enumerate(zip(greps + [dict(segments=gsegs)], creps + [dict(segments=csegs)])):
        if [(s["seek"], s["tokens"]) for s in g["segments"]] != [
            (s["seek"], s["tokens"]) for s in c["segments"]
        ]:
            raise AssertionError(f"silence pass: segments differ at window {i}")
        for a, b in zip(g["segments"], c["segments"]):
            d = max(d, abs(a["start"] - b["start"]), abs(a["end"] - b["end"]))
        d = max(d, same_words(words_of(g), words_of(c), f"silence pass window {i}"))
    if not d < 1e-6:
        raise AssertionError(f"silence pass: segment times differ by {d} s")
    out["silence_pass"] = dict(
        windows_aligned=sum(r["aligned"] for r in creps), segments_kept=len(csegs),
        words_aligned=sum(len(words_of(r)) for r in creps), max_time_diff_s=d,
    )  # fmt: skip
    # transcribe_batch with conditioning: 33 s of jfk and 35 s of noise,
    # whose first windows decode to different tokens, so that round 2 has
    # two prompts; on the engine and on the host loop, on both devices
    noise = (np.random.RandomState(3).randn(35 * 16000) * 0.05).astype(np.float32)
    streams = [np.tile(jfk, 3), noise]
    runs = {}
    for fused in (True, False):
        for model in (gpu, cpu):
            model.use_fused_decode = fused
            try:
                with watch_loops() as loops, watch_rounds() as rounds:
                    results = transcribe_batch(model, streams, language="en", temperature=0.0)
            finally:
                model.use_fused_decode = True
            kind = "fused" if fused else "host"
            if [r["groups"] for r in rounds] != [1, 2] or any(lp["kind"] != kind for lp in loops):
                raise AssertionError(f"batch on {model.device}: rounds {rounds}, loops {loops}")
            runs[(kind, model.device.type)] = results, loops
    cres = runs[("fused", "cpu")][0]
    d = 0.0
    for key, (res, _) in runs.items():
        for i, (g, c) in enumerate(zip(res, cres)):
            if g["text"] != c["text"] or [s["tokens"] for s in g["segments"]] != [
                s["tokens"] for s in c["segments"]
            ]:
                raise AssertionError(f"batch {key}: stream {i} differs: {g['text']!r} vs {c['text']!r}")
            for a, b in zip(g["segments"], c["segments"]):
                d = max(d, abs(a["start"] - b["start"]), abs(a["end"] - b["end"]))
    if not d < 1e-6:
        raise AssertionError(f"batch: segment times differ by {d} s")
    out["batch"] = dict(
        loops={f"{k}:{dev}": [f"{lp['kind']}:{lp['rows']}" for lp in lps] for (k, dev), (_, lps) in runs.items()},
        segments=[len(r["segments"]) for r in cres], max_time_diff_s=d,
    )  # fmt: skip
    return out


def card_vs_cpu_en():
    """The English-only layout at tiny dims (V = 51864, 80 mels), float32,
    TF32 off, on the card (the captured loop) and on the CPU with the same
    seeded weights: the task's sample_begin is 1; greedy and beam-5
    decode() give equal tokens and avg_logprob within 1e-3; transcribe(jfk,
    language=None, word_timestamps=True) transcribes English with equal
    words, times within 1e-6 s; decode(language=None) raises on both."""
    dims = ModelDimensions(80, 1500, 128, 2, 2, 51864, 448, 128, 2, 2)
    params = tiny_params(dims, seed=13)
    gpu = Whisper(dims, params, device="cuda", compute_dtype=torch.float32)
    cpu = Whisper(dims, params, device="cpu", compute_dtype=torch.float32)
    if gpu.is_multilingual or DecodingTask(gpu, DecodingOptions(language="en")).sample_begin != 1:
        raise AssertionError("the English-only model is not laid out as the gpt2 encoding's")
    mel = (np.random.RandomState(6).randn(80, 3000) * 0.6).astype(np.float32)
    out = {}
    for name, kw in [("greedy", {}), ("beam5", dict(beam_size=5))]:
        opts = DecodingOptions(language="en", sample_len=40, **kw)
        g, c = decode(gpu, mel, opts), decode(cpu, mel, opts)
        if g.tokens != c.tokens or not g.tokens:
            raise AssertionError(f"en {name}: card tokens {g.tokens} != CPU tokens {c.tokens}")
        d = abs(g.avg_logprob - c.avg_logprob)
        if not d < 1e-3:
            raise AssertionError(f"en {name}: avg_logprob differs by {d}")
        run = gpu._fused_engine.history[-1]
        if not run.captured or run.replays == 0:
            raise AssertionError(f"en {name}: the card's decode did not replay its captured loop: {run}")
        out[name] = dict(tokens=len(g.tokens), avg_logprob_diff=d, replays=run.replays)
    for model in (gpu, cpu):
        try:
            decode(model, mel, DecodingOptions(temperature=0.0, sample_len=5))
        except ValueError as e:
            if "can't perform lang id" not in str(e):
                raise
        else:
            raise AssertionError(f"decode(language=None) of an English-only model ran on {model.device}")
    jfk = load_audio(JFK_PATH)
    kw = dict(language=None, temperature=0.0, verbose=None, word_timestamps=True)
    gr, cr = gpu.transcribe(jfk, **kw), cpu.transcribe(jfk, **kw)
    if gr["language"] != "en" or cr["language"] != "en":
        raise AssertionError(f"English-only transcribe: languages {gr['language']}, {cr['language']}")
    gw, cw = words_of(gr), words_of(cr)
    if not cw:
        raise AssertionError("the English-only CPU run of jfk gave no words")
    out["words"] = dict(words=len(gw), max_time_diff_s=same_words(gw, cw, "en jfk"))
    return out


CONFIG_RUNS = (1, 2, 3, 5)  # configuration 4 is turbo: the main path's beam5_t0 and words_greedy_t0
CONFIG_KERNEL = {1: "greedy_argmax_state", 2: "greedy_argmax_state", 3: "beam_update_state",
                 5: "beam_update_state"}  # fmt: skip


def configs_phase(card):
    """The repo's published configurations 1, 2, 3 and 5 at full width
    through config_matrix.run_config (transcribe() or transcribe_batch on a
    model with seeded random bf16 weights, freed before the next): each
    must be ok, re-capture nothing, and launch the update kernels as its
    engine's records say (engine_want; the counts set to 0 just before
    it), its loop-state kernel at least once; configuration 1 transcribes
    English, 2 detects a language of LANGUAGES, 5 returns four results
    each with segments. Logs each record (ms a token, wall s, captures,
    peak memory) with the card line; returns the launches summed."""
    from whisper_tpu_torch import config_matrix
    from whisper_tpu_torch.tokenizer import LANGUAGES

    total = {}
    t_phase = time.perf_counter()
    for n in CONFIG_RUNS:
        reset_launch_counts()
        torch.cuda.synchronize()
        record, runs = config_matrix.run_config(n, "cuda")
        counts = launch_counts()
        log(json.dumps({"phase": "configs", **record, "launches": counts, "card": card}))
        if not record["ok"]:
            raise AssertionError(f"configuration {n} failed: {record['error']}")
        want = engine_want(runs)
        if counts != want:
            raise AssertionError(f"configuration {n}: launches {counts} != its engine's records {want}")
        if not counts[CONFIG_KERNEL[n]]:
            raise AssertionError(f"configuration {n} never launched {CONFIG_KERNEL[n]}: {counts}")
        if record["recaptures"]:
            raise AssertionError(f"configuration {n} re-captured {record['recaptures']} graphs")
        if not all(r.captured for r in runs):
            raise AssertionError(f"configuration {n} ran a loop uncaptured on the card")
        if n == 1 and record["language"] != "en":
            raise AssertionError(f"configuration 1 transcribed {record['language']!r}")
        if n == 2 and record["language"] not in LANGUAGES:
            raise AssertionError(f"configuration 2 detected {record['language']!r}")
        if n == 5 and (record["n_streams"] != 4 or not all(record["segments_per_stream"])):
            raise AssertionError(f"configuration 5: {record['n_streams']} results, segments {record['segments_per_stream']}")
        add_counts(total, counts)
    log(json.dumps({"phase": "configs_seconds", "seconds": time.perf_counter() - t_phase}))
    return total


def turbo_config_record(stats, card):
    """Configuration 4 (turbo at beam 5 with word timestamps) as the main
    path ran it: the 60 s clip's beam5_t0 and words_greedy_t0 runs, which
    must re-capture nothing."""
    keys = ("wall_s", "windows_decoded", "decode_steps", "ms_per_token", "captures", "programs",
            "segments", "windows_aligned")  # fmt: skip
    record = {"phase": "configs", "config": 4, "name": "turbo beam5 word_timestamps", "ok": True,
              "model": "turbo", "from": list(stats), "card": card}  # fmt: skip
    for run, st in stats.items():
        record[run] = {k: st[k] for k in keys if k in st}
    log(json.dumps(record))
    if sorted(stats) != ["beam5_t0", "words_greedy_t0"] or any(
        st["programs"]["recaptures"] for st in stats.values()
    ):
        raise AssertionError(f"configuration 4's turbo runs: {record}")


def words_of(result):
    return [w for s in result["segments"] for w in s.get("words", [])]


def same_words(gw, cw, what) -> float:
    """Equal words, times within 1e-6 s; returns the largest time difference."""
    if [w["word"] for w in gw] != [w["word"] for w in cw]:
        raise AssertionError(f"{what}: words differ: card {gw} CPU {cw}")
    d = max(
        (max(abs(a["start"] - b["start"]), abs(a["end"] - b["end"])) for a, b in zip(gw, cw)),
        default=0.0,
    )
    if not d < 1e-6:
        raise AssertionError(f"{what}: word times differ by {d} s")
    return d


# ---- phase 5: the main path at turbo width ----------------------------------


@contextlib.contextmanager
def watch_replays(module="whisper_tpu_torch.transcribe"):
    """Within the block, log each word-timestamp replay of transcribe() (or
    of `module`'s caller, batch.py's for transcribe_batch; one
    add_word_timestamps call per window): its segments and words as aligned
    (copied before the silence pass may cull them), whether it had text
    tokens to align (then it launches median_filter and dtw_trace once), and
    its host-clock seconds. No synchronize is added: the replay ends in its
    own blocking read of the DTW trace. The function is restored on exit."""
    tmod = importlib.import_module(module)
    add_words = tmod.add_word_timestamps
    replays = []

    def watched(**kw):
        t0 = time.perf_counter()
        add_words(**kw)
        seconds = time.perf_counter() - t0
        eot = kw["tokenizer"].eot
        replays.append(dict(
            seconds=seconds,
            aligned=any(t < eot for s in kw["segments"] for t in s["tokens"]),
            segments=copy.deepcopy(kw["segments"]),
        ))  # fmt: skip

    tmod.add_word_timestamps = watched
    try:
        yield replays
    finally:
        tmod.add_word_timestamps = add_words


@contextlib.contextmanager
def watch_loops():
    """Within the block, log each decode loop a DecodingTask runs: "fused"
    (the engine) or "host" (the host loop), its rows (audios x group), its
    group, whether it is a beam search, its temperature, its steps (tokens
    per row) and its host-clock seconds, which end in the loop's own reads
    of the device, and the engine's record of the run (`run`, an EngineRun;
    None for the host loop). The methods are restored on exit."""
    fused, host = DecodingTask._main_loop_fused, DecodingTask._main_loop_host
    loops = []

    def latest(model):
        engine = getattr(model, "_fused_engine", None)
        return engine.history[-1] if engine is not None and engine.history else None

    def watched(run, kind):
        def call(self, tokens):
            before = latest(self.model)
            t0 = time.perf_counter()
            out = run(self, tokens)
            after = latest(self.model)
            loops.append(dict(
                kind=kind, rows=tokens.shape[0], group=self.n_group,
                beam=self.options.beam_size is not None, temperature=self.options.temperature,
                steps=out[0].shape[1] - tokens.shape[1], seconds=time.perf_counter() - t0,
                run=after if after is not before else None,  # the engine's record of it
            ))  # fmt: skip
            return out

        return call

    DecodingTask._main_loop_fused = watched(fused, "fused")
    DecodingTask._main_loop_host = watched(host, "host")
    try:
        yield loops
    finally:
        DecodingTask._main_loop_fused, DecodingTask._main_loop_host = fused, host


@contextlib.contextmanager
def watch_captures():
    """Within the block, count the engines' graph captures in this process
    and their seconds (FusedEngine._capture, the warm-up included).
    Restored on exit."""
    capture = FusedEngine._capture
    seen = dict(captures=0, seconds=0.0)

    def watched(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return capture(self, *args, **kw)
        finally:
            seen["captures"] += 1
            seen["seconds"] += time.perf_counter() - t0

    FusedEngine._capture = watched
    try:
        yield seen
    finally:
        FusedEngine._capture = capture


@contextlib.contextmanager
def watch_graph_replays():
    """Within the block, every CUDAGraph.replay: the host seconds of its
    call, and CUDA events recorded on the current stream just before and
    just after it (their interval is the graph's span on the card). Yields
    the list of (host s, start event, end event). Restored on exit."""
    replay = torch.cuda.CUDAGraph.replay
    seen = []

    def watched(self):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        replay(self)
        host = time.perf_counter() - t0
        end.record()
        seen.append((host, start, end))

    torch.cuda.CUDAGraph.replay = watched
    try:
        yield seen
    finally:
        torch.cuda.CUDAGraph.replay = replay


@contextlib.contextmanager
def watch_rounds():
    """Within the block, log each call of batch.py's _decode_window_batch
    (transcribe_batch's and the batcher's rounds: a round's first attempt,
    or one stream's fallback): its rows, its distinct prompts and its
    temperature. Restored on exit."""
    module = batch_module
    run = module._decode_window_batch
    rounds = []

    def watched(model, mels, prompts, lang, t, *args):
        rounds.append(dict(rows=len(prompts), groups=len({tuple(p) for p in prompts}), temperature=t))
        return run(model, mels, prompts, lang, t, *args)

    module._decode_window_batch = watched
    try:
        yield rounds
    finally:
        module._decode_window_batch = run


def reset_launch_counts():
    bk.reset_launch_counts()
    dtw.dtw_trace.launches = 0
    median.median_filter.launches = 0


def launch_counts():
    """Each kernel's launches since the last reset: the update kernels'
    scalar launches (step 0 of a captured loop or speculative run, every
    step of the host loop), their loop-state launches (a captured
    loop's replays and its uncaptured passes, counted on the card by the
    kernels themselves: a replay makes no Python call), the greedy
    kernel's per-row loop-state launches (the speculative round's draft and
    verify passes, counted on the card too) and its per-row-length ones
    (the speculative host loop) apart."""
    state = bk.state_launches()
    return {
        "greedy_argmax": bk.greedy_argmax.launches,
        "greedy_argmax_rows": bk.greedy_argmax.row_launches,
        "greedy_argmax_state": state["greedy_argmax_state"],
        "greedy_argmax_rows_state": state["greedy_argmax_rows_state"],
        "beam_update": bk.beam_update.launches,
        "beam_update_state": state["beam_update_state"], "dtw_trace": dtw.dtw_trace.launches,
        "median_filter": median.median_filter.launches,
    }  # fmt: skip


def traced_launches(name, span, run, counts=None):
    """The update kernel's launches in a profiled engine run (the trace's
    events of it, busy_between_updates: steps + 1) against what the run's
    record says it made (engine_want: step 0, then one a replay or
    uncaptured pass) and, given, the counts read after the run."""
    want = engine_want([run])
    made = sum(want.values())
    if span["steps"] + 1 != made or (counts is not None and counts != want):
        raise AssertionError(
            f"{name}: the trace holds {span['steps'] + 1} update launches, the counters "
            f"{counts}, the record {want} ({run})"
        )


def engine_want(runs, aligned=0, spec=()):
    """The launches that engine runs (`EngineRun` records of
    FusedEngine.history), speculative runs (`SpecRun` records of
    SpeculativeEngine.history) and `aligned` word-timing windows make: a
    captured loop's update launches once at step 0 (scalar) and once per
    replay and uncaptured pass (loop state: its capture warm-ups too); the
    eager loop once per step; a speculative run once at step 0 (scalar),
    then K + 1 draft launches and one verify launch per replay and
    uncaptured round pass (per-row at the loop state), or, on the
    host loop, one per-row launch per draft step and verify round. Each
    speculative record's own greedy count (the card's, for a program) must
    say the same."""
    want = dict.fromkeys(launch_counts(), 0)
    want["dtw_trace"] = want["median_filter"] = aligned
    for r in runs:
        kind = "beam_update" if r.beam_search else "greedy_argmax" if r.temperature == 0 else None
        if kind is None:
            continue
        if r.loop == "eager":
            want[kind] += r.steps
        else:
            want[kind] += 1
            want[kind + "_state"] += r.replays + r.bodies
    for r in spec:
        if r.loop == "eager":
            per_row, kind = r.draft_steps + r.rounds, "greedy_argmax_rows"
        else:
            per_row, kind = (r.k + 2) * (r.replays + r.bodies), "greedy_argmax_rows_state"
        if r.launches != 1 + per_row:
            raise AssertionError(f"a speculative run counted {r.launches} greedy launches, not 1 + {per_row}: {r}")
        want["greedy_argmax"] += 1
        want[kind] += per_row
    return want


def check_words(segs, audio_s):
    """Every word's times are finite and ordered, starts do not decrease
    within a segment, and each word lies in its window [t0, t0 + 30 s]; the
    clamp heuristics may move an edge word's start back by up to the 1.4 s
    cap and its end on by up to the 0.7 s typical span."""
    n = 0
    for s in segs:
        t0 = s["seek"] / 100
        starts = [w["start"] for w in s["words"]]
        if starts != sorted(starts):
            raise AssertionError(f"word starts decrease in segment {s['id']}")
        for w in s["words"]:
            if not (np.isfinite([w["start"], w["end"], w["probability"]]).all()
                    and t0 - 1.4 - 1e-6 <= w["start"] <= w["end"] <= t0 + 30.7 + 1e-6
                    and w["end"] <= audio_s + 30.7):  # fmt: skip
                raise AssertionError(f"word {w} out of its window at {t0} s")
            n += 1
    return n


def main_path(model, audio, draft=None, **kw):
    """transcribe() of `audio` (with `draft` installed, if given), the counts
    set to 0 just before it: the update kernels' launches equal what the
    engines' records say they made (engine_want: step 0 of each
    temperature-0 run and of each speculative run scalar, each replay and
    uncaptured pass at the loop state, the speculative runs' draft steps
    and verify rounds per-row); the word-timing kernels launch once per
    aligned window. Returns (stats, launches, the result)."""
    if model._fused_engine is not None:
        model._fused_engine.history.clear()
    model.set_draft_model(draft)
    reset_launch_counts()
    torch.cuda.synchronize()
    try:
        with watch_replays() as replays:
            t0 = time.perf_counter()
            result = model.transcribe(audio, language="en", verbose=None, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spec = list(model._spec_engine.history) if model._spec_engine is not None else []
    finally:
        model.set_draft_model(None)
    launches = launch_counts()
    runs = list(model._fused_engine.history) if model._fused_engine is not None else []
    aligned = sum(r["aligned"] for r in replays)
    replay_s = sum(r["seconds"] for r in replays)
    want = engine_want(runs, aligned, spec)
    if launches != want:
        raise AssertionError(f"launches {launches} != the engine's record and aligned windows {want}")
    if draft is not None and not spec:
        raise AssertionError("the run with a draft never reached the speculative engine")
    segs = result["segments"]
    values = [v for s in segs for v in (s["start"], s["end"], s["avg_logprob"])]
    if not np.isfinite(values).all() or (not segs and "hallucination_silence_threshold" not in kw):
        raise AssertionError("transcribe() returned no or non-finite segments")
    if segs and segs[-1]["end"] > len(audio) / 16000 + 30:
        raise AssertionError("segments end past the clip")
    # a speculative run counts its tokens decoded, as a plain run its steps
    steps = sum(r.steps for r in runs) + sum(r.steps for r in spec)
    decode_s = sum(r.seconds for r in runs) + sum(r.seconds for r in spec)
    stats = dict(
        loops=sorted({r.loop for r in runs}), captured=sorted({r.captured for r in runs}),
        replays=sum(r.replays for r in runs), bodies=sum(r.bodies for r in runs),
        captures=sum(r.captures for r in runs),
        capture_s=sum(r.capture_s for r in runs), done_reads=sum(r.done_reads for r in runs),
        programs=program_stats(runs),
        wall_s=wall,
        rtfx=len(audio) / 16000 / wall,
        windows_decoded=len(runs) + len(spec),
        decode_steps=steps,
        decode_s=decode_s,
        ms_per_token=decode_s / steps * 1e3,
        segments=len(segs),
        temperatures=sorted({r[1] for r in runs}),
    )
    if spec:
        rounds = sum(r.rounds for r in spec)
        # each round emits its accepted drafts and one token of the target's
        accepted = sum(max(r.steps - 1 - r.rounds, 0) for r in spec)
        stats.update(
            spec_windows=len(spec), draft_steps=sum(r.draft_steps for r in spec),
            verify_rounds=rounds, tokens_decoded=sum(r.steps for r in spec),
            acceptance=accepted / max(rounds * model.draft_k, 1),
            tokens_per_round=sum(r.steps for r in spec) / max(rounds, 1),
            spec_loops=sorted({r.loop for r in spec}), spec_captured=sorted({r.captured for r in spec}),
            spec_replays=sum(r.replays for r in spec),
            spec_bodies=sum(r.bodies for r in spec), spec_captures=sum(r.captures for r in spec),
            spec_capture_s=sum(r.capture_s for r in spec),
        )  # fmt: skip
    if kw.get("word_timestamps"):
        if aligned == 0:
            raise AssertionError("the word-timestamp run aligned no window")
        stats.update(
            windows_aligned=aligned, words=check_words(segs, len(audio) / 16000),
            replay_s=replay_s, replay_share=replay_s / wall,
        )  # fmt: skip
    return stats, launches, result


def replay_cross_kv(model):
    """The cross-K/V that each aligned window's replay computes from the
    window's audio features (1, 1500, d): device ms (profiler) and ms per
    call (CUDA events) at the model's width."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    xa = torch.randn((1, 1500, model.dims.n_audio_state), generator=gen, device=DEV)
    xa = xa.to(model.compute_dtype)
    return dict(
        device_ms=device_ms(lambda: model.cross_kv(xa))[0],
        call_ms=call_ms(lambda: model.cross_kv(xa)),
    )


# ---- phase 5b: multi-stream transcription at turbo width --------------------


def check_segments(results, what):
    """Every segment's times and log-probability finite, start <= end, and
    the windows' seeks not decreasing within a stream (with word timestamps
    a window's segment edges follow its words, whose clamps may move a
    start before the end of the segment before it, as in transcribe());
    returns the segments counted."""
    n = 0
    for i, r in enumerate(results):
        segs = r["segments"]
        values = [v for seg in segs for v in (seg["start"], seg["end"], seg["avg_logprob"])]
        seeks = [seg["seek"] for seg in segs]
        if not segs or not np.isfinite(values).all() or seeks != sorted(seeks) or any(
            seg["start"] > seg["end"] for seg in segs
        ):
            raise AssertionError(f"{what}: stream {i} has no, non-finite or unordered segments")
        n += len(segs)
    return n


def loop_stats(loops, kind):
    """ms per step (a token for every row) and per row token of the loops of
    `kind`, on the host clock."""
    mine = [lp for lp in loops if lp["kind"] == kind]
    steps = sum(lp["steps"] for lp in mine)
    seconds = sum(lp["seconds"] for lp in mine)
    row_tokens = sum(lp["steps"] * lp["rows"] for lp in mine)
    return dict(
        loops=len(mine), rows=[lp["rows"] for lp in mine], steps=steps, seconds=seconds,
        ms_per_step=seconds / steps * 1e3 if steps else None,
        ms_per_row_token=seconds / row_tokens * 1e3 if row_tokens else None,
    )  # fmt: skip


def program_stats(runs):
    """Of engine runs' records: the static-buffer keys they used (audios,
    group, pool size, last window), their captures, and the re-captures
    among them (graphs made again after the engine dropped their buffers,
    past engine.MAX_PROGRAMS)."""
    mine = [r for r in runs if r.loop == "program"]
    return dict(
        keys=len({r.program for r in mine}), captures=sum(r.captures for r in mine),
        recaptures=sum(r.recaptures for r in mine),
    )  # fmt: skip


def batch_run(name, fn, audio_s, replays_of="whisper_tpu_torch.batch"):
    """One multi-stream run with the counts set to 0 just before it and read
    just after: the update kernels launch as the engine's records of its
    runs say (engine_want), the word-timing kernels once per aligned window
    (the replays of `replays_of`). Every loop must be the engine's."""
    reset_launch_counts()
    torch.cuda.synchronize()
    with watch_loops() as loops, watch_rounds() as rounds, watch_replays(replays_of) as replays:
        t0 = time.perf_counter()
        results = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()
    aligned = sum(r["aligned"] for r in replays)
    if any(lp["kind"] == "fused" and lp["run"] is None for lp in loops):
        raise AssertionError(f"{name}: an engine loop left no record: {loops}")
    want = engine_want([lp["run"] for lp in loops if lp["run"] is not None], aligned)
    if launches != want:
        raise AssertionError(f"{name}: launches {launches} != the engine's record and aligned windows {want}")
    if any(lp["kind"] != "fused" for lp in loops):
        raise AssertionError(f"{name}: a loop left the engine: {loops}")
    stats = dict(
        wall_s=wall, audio_s=audio_s, rtfx=audio_s / wall, fused=loop_stats(loops, "fused"),
        programs=program_stats([lp["run"] for lp in loops if lp["run"] is not None]),
        loops=[f"{lp['kind']}:{lp['rows']}" for lp in loops],
        rounds=[f"{r['rows']}x{r['groups']}@{r['temperature']}" for r in rounds],
    )  # fmt: skip
    return results, stats, launches, loops, aligned


def same_tokens(a, b) -> bool:
    return [seg["tokens"] for seg in a["segments"]] == [seg["tokens"] for seg in b["segments"]]


def mel_rows_vs_full(streams, n_mels):
    """Each stream's row of the batched mel against its own whole-file mel
    (ops/stft.device_mel_full, as transcribe() computes it): the largest
    absolute difference over the frames both hold, and whether the two were
    padded to the same length."""
    from whisper_tpu_torch.frontend import batched_device_mel
    from whisper_tpu_torch.ops.stft import device_mel_full

    mels, _ = batched_device_mel(streams, n_mels, DEV)
    out = []
    for i, a in enumerate(streams):
        full, _ = device_mel_full(a, n_mels, DEV)
        F = min(full.shape[-1], mels.shape[-1])
        diff = (mels[i, :, :F] - full[:, :F]).abs().max().item()
        out.append(dict(max_abs_diff=diff, same_length=full.shape[-1] == mels.shape[-1]))
    return out


def f32_batch_vs_sequential(dims, streams, kw):
    """The same seeded turbo weights at float32 compute: transcribe_batch of
    the streams against transcribe() of each one, token for token."""
    model = Whisper(dims, None, device="cuda", compute_dtype=torch.float32, seed=0)
    batch = transcribe_batch(model, streams, **kw)
    singles = [model.transcribe(a, verbose=None, **kw) for a in streams]
    out = dict(
        streams_equal_to_sequential=[same_tokens(b, q) for b, q in zip(batch, singles)],
        identical_streams_equal=same_tokens(batch[0], batch[1]),
    )
    del model
    torch.cuda.empty_cache()
    return out


def loop_ms_per_step(model, windows, opts):
    """The engine's and the host loop's wall ms per step on the same
    windows, run engine, host, host, engine."""
    out = {"fused": [], "host": []}
    try:
        for kind in ("fused", "host", "host", "fused"):
            model.use_fused_decode = kind == "fused"
            with watch_loops() as loops:
                decode(model, windows, opts)
            (lp,) = loops
            if lp["kind"] != kind:
                raise AssertionError(f"asked for the {kind} loop, ran {lp['kind']}")
            out[kind].append(lp["seconds"] / lp["steps"] * 1e3)
    finally:
        model.use_fused_decode = True
    return out


def batch_phase(model, audio, card):
    """transcribe_batch of four streams at T = 0 with conditioning (the
    60 s clip, the same clip, its last 53 s, its first 23 s), beside
    transcribe() of the same streams one after another; transcribe_chunked
    of 120 s at beam 5 (four chunks in one fused call at A = 4); and
    transcribe_batch of two streams with word timestamps. Returns the
    launches of the three runs.

    Random weights give nearly every stream the same tokens whatever its
    audio, and each window decodes the full 224 tokens without a
    timestamp, so a stream's seek advances 30 s a round. The fourth stream
    ends in round 1, so that round 2 holds three streams: the finished one
    is dropped from the batch."""
    sr = 16000
    streams = [audio, audio.copy(), audio[7 * sr :], audio[: 23 * sr]]
    total_s = sum(len(a) for a in streams) / sr
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    kw = dict(language="en", temperature=0.0, condition_on_previous_text=True)
    results, stats, counts, loops, _ = batch_run(
        "batch4", lambda: transcribe_batch(model, streams, **kw), total_s
    )
    add(counts)
    if not loops or (loops[0]["kind"], loops[0]["rows"]) != ("fused", 4):
        raise AssertionError(f"batch4: the first round was not one fused call at B = 4: {loops}")
    if sum(lp["rows"] for lp in loops[1:]) != 3:
        raise AssertionError(f"batch4: round 2 did not hold the three unfinished streams: {loops}")
    if not same_tokens(results[0], results[1]):
        raise AssertionError("batch4: two identical streams gave different tokens (rows interact)")
    stats["segments"] = check_segments(results, "batch4")
    reset_launch_counts()
    t0 = time.perf_counter()
    singles = [model.transcribe(a, verbose=None, **kw) for a in streams]
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    stats.update(
        sequential_wall_s=seq_wall, sequential_rtfx=total_s / seq_wall,
        speedup=seq_wall / stats["wall_s"],
        streams_equal_to_sequential=[same_tokens(b, q) for b, q in zip(results, singles)],
    )  # fmt: skip
    log(json.dumps({"phase": "batch", "run": "batch4_conditioned", **stats, "launches": counts,
                    "card": card}))  # fmt: skip

    # witnesses for a batch stream that differs from its sequential run
    t0 = time.perf_counter()
    witness = dict(
        mel_rows_vs_full=mel_rows_vs_full(streams, model.dims.n_mels),
        f32=f32_batch_vs_sequential(model.dims, streams, kw),
    )
    from whisper_tpu_torch.frontend import batched_device_mel, batched_mel_windows

    mels, _ = batched_device_mel(streams, model.dims.n_mels, DEV)
    windows = batched_mel_windows(mels, [0] * 4, [N_FRAMES] * 4)
    opts = DecodingOptions(language="en", temperature=0.0)
    witness["loop_ms_per_step"] = {
        f"B{b}": loop_ms_per_step(model, windows[:b], opts) for b in (1, 4)
    }
    witness["seconds"] = time.perf_counter() - t0
    log(json.dumps({"phase": "batch", "run": "witness", **witness, "card": card}))

    long_audio = np.tile(audio, 2)[: 120 * sr]
    results, stats, counts, loops, _ = batch_run(
        "chunked",
        lambda: [transcribe_chunked(model, long_audio, language="en", temperature=0.0, beam_size=5)],
        120.0,
    )  # fmt: skip
    add(counts)
    if not loops or (loops[0]["kind"], loops[0]["rows"], loops[0]["group"]) != ("fused", 20, 5):
        raise AssertionError(f"chunked: the chunks were not one fused beam call at A = 4: {loops}")
    stats["segments"] = check_segments(results, "chunked")
    log(json.dumps({"phase": "batch", "run": "chunked_beam5", **stats, "launches": counts,
                    "card": card}))  # fmt: skip

    pair = [audio, audio[7 * sr :]]
    words_kw = dict(language="en", temperature=0.0, word_timestamps=True)
    results, stats, counts, loops, aligned = batch_run(
        "words", lambda: transcribe_batch(model, pair, **words_kw), sum(len(a) for a in pair) / sr
    )
    add(counts)
    if aligned == 0:
        raise AssertionError("words: transcribe_batch aligned no window")
    stats.update(
        segments=check_segments(results, "words"), windows_aligned=aligned,
        words=sum(check_words(r["segments"], len(a) / sr) for r, a in zip(results, pair)),
    )  # fmt: skip
    log(json.dumps({"phase": "batch", "run": "batch2_words", **stats, "launches": counts,
                    "card": card}))  # fmt: skip
    return launches


def cli_phase():
    """`python -m whisper_tpu_torch --device cuda --parallel True
    --profile_sync True` in a subprocess on two copies of jfk.flac, with a
    tiny float32 model written by save_model: all five outputs of each file
    present, and the per-graph report (profiling.py) in its stdout with
    the "encoder" and "fused_decode" spans."""
    d = os.path.join(ROOT, "smoke", "_build", "cli")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    dims = ModelDimensions(80, 1500, 128, 2, 2, 51866, 448, 128, 2, 2)
    npz = os.path.join(d, "tiny.npz")
    save_model(Whisper(dims, tiny_params(dims, seed=11), device="cuda", compute_dtype=torch.float32), npz)
    files = []
    for name in ("a.flac", "b.flac"):
        files.append(os.path.join(d, name))
        shutil.copy(os.path.join(ROOT, "tests", "data", "jfk.flac"), files[-1])
    out_dir = os.path.join(d, "out")
    cmd = [
        sys.executable, "-m", "whisper_tpu_torch", *files, "--model", npz, "--device", "cuda",
        "--parallel", "True", "--language", "en", "--verbose", "False",
        "--temperature_increment_on_fallback", "None", "--profile_sync", "True",
        "--output_dir", out_dir,
    ]  # fmt: skip
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CLI failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    want = [f"{stem}.{ext}" for stem in ("a", "b") for ext in ("txt", "vtt", "srt", "tsv", "json")]
    missing = [f for f in want if not os.path.isfile(os.path.join(out_dir, f))]
    if missing:
        raise AssertionError(f"the CLI wrote no {missing}")
    with open(os.path.join(out_dir, "a.json"), encoding="utf-8") as f:
        segments = len(json.load(f)["segments"])
    if segments == 0:
        raise AssertionError("the CLI's a.json holds no segment")
    if profiling.REPORT_HEADER not in proc.stdout:
        raise AssertionError(f"the CLI printed no timing report:\n{proc.stdout}")
    report = proc.stdout.split(profiling.REPORT_HEADER, 1)[1].strip().splitlines()[1:]
    spans = {row.split()[0]: row.split()[1:] for row in report if row.strip()}
    if not {"encoder", "fused_decode"} <= set(spans):
        raise AssertionError(f"the CLI's report lacks encoder or fused_decode: {report}")
    return dict(seconds=seconds, files=len(want), segments_a=segments, report=spans)


# ---- bf16_rows: one window alone and as row 0 of a batch of four -----------


def bf16_chain(model, windows, tokens, step_token):
    """encode, cross_kv, prefill, the prefill's last logits and one
    decode_step of `windows` (B, n_mels, 3000) at the model's dtype: each
    output as a float32 tensor."""
    B = windows.shape[0]
    xa = model.encode(windows)
    ck, cv = model.cross_kv(xa)
    toks = torch.tensor([tokens] * B, dtype=torch.int64, device=DEV)
    hidden, kv = model.prefill(toks, len(tokens), ck, cv)
    logits = model.hidden_to_logits(hidden[:, -1])
    cache = model.kv_to_cache_grouped(kv, 1)
    step_logits, cache = model.decode_step(
        torch.full((B,), step_token, dtype=torch.int64, device=DEV), len(tokens), cache, None, ck, cv
    )
    outs = dict(
        encode=xa, cross_k=ck.transpose(0, 1), cross_v=cv.transpose(0, 1), prefill_hidden=hidden,
        prefill_kv=kv.transpose(0, 2), prefill_logits=logits, step_logits=step_logits,
        step_cache=cache[:, :, :, : len(tokens) + 1].transpose(0, 2),
    )  # fmt: skip
    return {k: v.float() for k, v in outs.items()}  # batch first


def bf16_rows(model, audio):
    """Queue-3 item 1 of the roadmap: the same turbo bf16 window decoded at
    B = 1 and as row 0 of B = 4, once with three other audios beside it and
    once with three copies of itself. For each output of encode, cross_kv,
    prefill, the logits and one decode_step: the max abs difference of row
    0 between B = 1 and B = 4, and between the two B = 4 runs (equal there:
    the rows do not interact, and what differs is arithmetic that depends
    on B). Two probes of the encoder's first ops name the source: conv1 of
    the mel and the first q projection (a GEMM of M = 1500 B rows)."""
    from whisper_tpu_torch.frontend import batched_device_mel, batched_mel_windows
    from whisper_tpu_torch.tokenizer import get_tokenizer

    sr = 16000
    noise = (np.random.RandomState(9).randn(30 * sr) * 0.05).astype(np.float32)
    clips = [audio[: 30 * sr], audio[30 * sr : 60 * sr], audio[7 * sr : 37 * sr], noise]
    mels, _ = batched_device_mel(clips, model.dims.n_mels, DEV)
    others = batched_mel_windows(mels, [0] * 4, [N_FRAMES] * 4)
    copies = others[:1].expand(4, -1, -1).contiguous()
    tok = get_tokenizer(True, num_languages=model.num_languages, language="en", task="transcribe")
    tokens = list(tok.sot_sequence)
    runs = {name: bf16_chain(model, w, tokens, tok.timestamp_begin)
            for name, w in (("b1", others[:1]), ("b4_others", others), ("b4_copies", copies))}  # fmt: skip
    outputs, first_differs = {}, None
    for key in runs["b1"]:
        a, o, c = runs["b1"][key][0], runs["b4_others"][key][0], runs["b4_copies"][key][0]
        outputs[key] = dict(
            b1_vs_b4_max_abs_diff=(a - o).abs().max().item(), b1_equals_b4=bool(torch.equal(a, o)),
            b4_copies_vs_others_max_abs_diff=(c - o).abs().max().item(),
            rows_interact=not torch.equal(c, o),
            b4_copy_rows_equal=all(torch.equal(runs["b4_copies"][key][i], c) for i in range(1, 4)),
        )  # fmt: skip
        if first_differs is None and not torch.equal(a, o):
            first_differs = key
    enc = model.params["encoder"]
    x = others.to(model.compute_dtype)
    conv = torch.nn.functional.conv1d(x, enc["conv1_w"], enc["conv1_b"], padding=1)
    conv1 = torch.nn.functional.conv1d(x[:1], enc["conv1_w"], enc["conv1_b"], padding=1)
    h = runs["b4_others"]["encode"].to(model.compute_dtype)  # any (4, 1500, d) activations
    w = enc["blocks"]["attn_q_w"][0]
    gemm, gemm1 = h @ w, h[:1] @ w
    probes = dict(
        conv1_b1_equals_b4=bool(torch.equal(conv1[0], conv[0])),
        conv1_max_abs_diff=(conv1[0] - conv[0]).abs().float().max().item(),
        gemm_m1500_equals_m6000=bool(torch.equal(gemm1[0], gemm[0])),
        gemm_max_abs_diff=(gemm1[0] - gemm[0]).abs().float().max().item(),
    )  # fmt: skip
    rows_interact = any(v["rows_interact"] for v in outputs.values())
    return dict(
        first_output_that_differs=first_differs, rows_interact=rows_interact, outputs=outputs,
        probes=probes,
    )  # fmt: skip


# ---- 5d: streaming at turbo width --------------------------------------------


def segments_agree(a, b, words=False):
    """(segments with equal tokens, of len(a)); with `words`, also the
    largest word time difference over the segments whose words are equal
    (inf where the word strings differ)."""
    same = sum(x["tokens"] == y["tokens"] for x, y in zip(a, b)) if len(a) == len(b) else 0
    d = 0.0
    if words:
        for x, y in zip(a, b):
            wx, wy = x.get("words", []), y.get("words", [])
            if [w["word"] for w in wx] != [w["word"] for w in wy]:
                return same, float("inf")
            for p, q in zip(wx, wy):
                d = max(d, abs(p["start"] - q["start"]), abs(p["end"] - q["end"]))
    return same, d


def stream_once(model, audio, chunk_s, **kw):
    """Feed `audio` to a StreamingTranscriber in `chunk_s` chunks and flush.
    Returns (finals, partials, per-window records): each final window's
    decode seconds, the latency from the start of the feed() (or flush())
    that completed it to the return of its finals, and its mel window and
    seek (partial decodes are timed apart)."""
    from whisper_tpu_torch.streaming import StreamingTranscriber

    st = StreamingTranscriber(model, **kw)
    process, partial, window_mel = st._process, st.partial, st._window_mel
    windows, partial_s, clock = [], [], {}

    def timed_window_mel(avail, mel):
        win, size = window_mel(avail, mel)
        if not clock.get("in_partial"):
            mel_copy = win.clone() if torch.is_tensor(win) else win.copy()
            windows.append(dict(seek=st._seek, size=size, mel=mel_copy, t0=time.perf_counter()))
        return win, size

    def timed_process(final):
        n = len(windows)
        out = process(final)
        t_end = time.perf_counter()
        for w in windows[n:]:
            w["latency_s"] = t_end - clock["call"]
        done = windows[n:]
        for w, nxt in zip(done, done[1:] + [None]):
            w["seconds"] = (nxt["t0"] if nxt else t_end) - w["t0"]
        return out

    def timed_partial():
        clock["in_partial"] = True
        t0 = time.perf_counter()
        try:
            return partial()
        finally:
            clock["in_partial"] = False
            partial_s.append(time.perf_counter() - t0)

    st._window_mel, st._process, st.partial = timed_window_mel, timed_process, timed_partial
    finals, partials = [], []
    step = int(chunk_s * 16000)
    for i in range(0, len(audio), step):
        clock["call"] = time.perf_counter()
        for seg in st.feed(audio[i : i + step]):
            (partials if seg.get("partial") else finals).append(seg)
    clock["call"] = time.perf_counter()
    finals.extend(st.flush())
    return finals, partials, windows, partial_s


def streaming_phase(model, f32_model, audio, card):
    """5d: the 60 s clip fed in 1 s chunks with partials every 5 s, and in
    7 s chunks with word timestamps, greedy at T = 0: finals against
    transcribe() of the same audio and options (bf16: agreement reported;
    float32: equal, the gate), and each final window's mel against the
    whole-file mel's window. Returns the launches of the two bf16 runs."""
    from whisper_tpu_torch.ops.stft import device_mel_full, device_mel_window

    full, _ = device_mel_full(audio, model.dims.n_mels, DEV)
    launches = {}
    for name, chunk_s, kw in [
        ("partials_1s", 1.0, dict(language="en", temperature=0.0, partial_hop_s=5.0)),
        ("words_7s", 7.0, dict(language="en", temperature=0.0, word_timestamps=True)),
    ]:  # fmt: skip
        words = kw.get("word_timestamps", False)
        out = {}
        (finals, partials, windows, partial_s), stats, counts, _, aligned = batch_run(
            f"stream {name}", lambda: stream_once(model, audio, chunk_s, **kw), len(audio) / 16000,
            replays_of="whisper_tpu_torch.streaming",
        )  # fmt: skip
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if not finals or (words and aligned == 0):
            raise AssertionError(f"stream {name}: no finals, or no window aligned")
        check_segments([dict(segments=finals)], f"stream {name}")
        ref = model.transcribe(audio, verbose=None, **{k: v for k, v in kw.items() if k != "partial_hop_s"})
        same, d = segments_agree(finals, ref["segments"], words)
        out["bf16"] = dict(segments=len(finals), reference_segments=len(ref["segments"]),
                           segments_equal_to_transcribe=same, max_word_time_diff_s=d)  # fmt: skip
        if words:
            out["bf16"]["words"] = check_words(finals, len(audio) / 16000)
        f_finals, _, _, _ = stream_once(f32_model, audio, chunk_s, **kw)
        f_ref = f32_model.transcribe(audio, verbose=None, **{k: v for k, v in kw.items() if k != "partial_hop_s"})
        same, d = segments_agree(f_finals, f_ref["segments"], words)
        if same != len(f_ref["segments"]) or len(f_finals) != same or not d < 1e-6:
            raise AssertionError(f"stream {name} at float32: {same} of {len(f_ref['segments'])} "
                                 f"segments equal transcribe(), words within {d} s")  # fmt: skip
        out["f32"] = dict(segments=len(f_finals), segments_equal_to_transcribe=same, max_word_time_diff_s=d)
        mel_diff = [
            (torch.as_tensor(w["mel"], device=DEV) - device_mel_window(full, w["seek"], w["size"])).abs().max().item()
            for w in windows
        ]
        log(json.dumps({
            "phase": "streaming", "run": name, "chunk_s": chunk_s, "finals": len(finals),
            "partials": len(partials), "final_windows": len(windows),
            "seconds_per_final_window": [w["seconds"] for w in windows],
            "latency_from_feed_to_final_s": [w["latency_s"] for w in windows],
            "partial_decode_s": partial_s, "windows_aligned": aligned,
            "mel_window_vs_whole_file_max_abs_diff": mel_diff, **out, **stats, "launches": counts,
            "card": card,
        }))  # fmt: skip
    return launches


# ---- 5e: the continuous batcher at turbo width -------------------------------


def batcher_once(model, first, later, **kw):
    """ContinuousBatcher(slots=2): submit `first`, step once, submit
    `later`, drain. Returns (results in submission order, stats)."""
    from whisper_tpu_torch.continuous import ContinuousBatcher

    cb = ContinuousBatcher(model, slots=2, **kw)
    tickets = [cb.submit(a) for a in first]
    if later:
        cb.step()
        tickets += [cb.submit(a) for a in later]
    cb.drain()
    return [cb.pop(t) for t in tickets], dict(cb.stats)


def continuous_phase(model, f32_model, audio, jfk, card):
    """5e: the 60 s clip and its first 23 s, one round, then its last 53 s
    and jfk, greedy at T = 0 with conditioning; and a beam-5 run of two
    requests. Each ticket against sequential transcribe() (bf16: agreement
    reported; float32: equal, the gate). Returns the launches of the bf16
    batcher runs."""
    sr = 16000
    launches = {}
    for name, first, later, kw in [
        ("greedy_staggered", [audio, audio[: 23 * sr]], [audio[7 * sr :], jfk],
         dict(language="en", temperature=0.0)),
        ("beam5", [jfk, audio[: 23 * sr]], [], dict(language="en", temperature=0.0, beam_size=5)),
    ]:  # fmt: skip
        everything = first + later
        total_s = sum(len(a) for a in everything) / sr
        (results, cb_stats), stats, counts, loops, _ = batch_run(
            f"batcher {name}", lambda: batcher_once(model, first, later, **kw), total_s
        )
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        stats["segments"] = check_segments(results, f"batcher {name}")
        singles = [model.transcribe(a, verbose=None, **kw) for a in everything]
        f_results, _ = batcher_once(f32_model, first, later, **kw)
        f_singles = [f32_model.transcribe(a, verbose=None, **kw) for a in everything]
        f_equal = [same_tokens(r, q) and r["text"] == q["text"] for r, q in zip(f_results, f_singles)]
        if not all(f_equal):
            raise AssertionError(f"batcher {name} at float32: tickets equal to transcribe(): {f_equal}")
        log(json.dumps({
            "phase": "continuous", "run": name, "requests_s": [len(a) / sr for a in everything],
            "batcher_stats": cb_stats,
            "bf16_tickets_equal_to_transcribe": [same_tokens(r, q) for r, q in zip(results, singles)],
            "f32_tickets_equal_to_transcribe": f_equal, **stats, "launches": counts, "card": card,
        }))  # fmt: skip
    return launches


# ---- 5f: the servers at turbo width --------------------------------------------


def socket_request(path, payload, timeout=300.0):
    import socket

    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(timeout)
    try:
        c.connect(path)
        t0 = time.perf_counter()
        c.sendall((json.dumps(payload) + "\n").encode())
        line = c.makefile("rb").readline()
        return json.loads(line), time.perf_counter() - t0
    finally:
        c.close()


def socket_stream_pcm16(path, audio, chunk_s=1.0, timeout=300.0):
    import base64
    import socket

    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(timeout)
    try:
        c.connect(path)
        f = c.makefile("rb")
        t0 = time.perf_counter()
        c.sendall(b'{"stream": true, "language": "en"}\n')
        if not json.loads(f.readline()).get("ack"):
            raise AssertionError("the stream session was not acknowledged")
        step = int(chunk_s * 16000)
        for i in range(0, len(audio), step):
            raw = np.clip(audio[i : i + step] * 32768.0, -32768, 32767).astype("<i2").tobytes()
            c.sendall((json.dumps({"pcm16": base64.b64encode(raw).decode()}) + "\n").encode())
        c.sendall(b'{"end": true}\n')
        lines = []
        while True:
            msg = json.loads(f.readline())
            if msg.get("done") or "error" in msg:
                return lines, msg, time.perf_counter() - t0
            lines.append(msg)
    finally:
        c.close()


def concurrently(fn, n):
    out, errors = [None] * n, []

    def run(i):
        try:
            out[i] = fn()
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(o is None for o in out):
        raise AssertionError(f"a client failed: {errors}")
    return out


def multipart(data: bytes):
    boundary = "smoke" + os.urandom(8).hex()
    body = (
        f'--{boundary}\r\nContent-Disposition: form-data; name="file"; filename="jfk.flac"\r\n'
        "Content-Type: application/octet-stream\r\n\r\n"
    ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def http_upload(url, data, timeout=300.0):
    import urllib.request

    body, ctype = multipart(data)
    req = urllib.request.Request(
        f"{url}/v1/audio/transcriptions", data=body, headers={"Content-Type": ctype}, method="POST"
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read()), time.perf_counter() - t0


def http_stream_s16(url, audio, chunk_s=1.0, timeout=300.0):
    import http.client
    import urllib.parse

    u = urllib.parse.urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    step = int(chunk_s * 16000)
    chunks = (np.clip(audio[i : i + step] * 32768.0, -32768, 32767).astype("<i2").tobytes()
              for i in range(0, len(audio), step))  # fmt: skip
    try:
        t0 = time.perf_counter()
        conn.request(
            "POST", "/v1/audio/transcriptions/stream?encoding=s16&language=en", body=chunks,
            headers={"Transfer-Encoding": "chunked", "Content-Type": "audio/pcm"}, encode_chunked=True,
        )  # fmt: skip
        resp = conn.getresponse()
        msgs = [json.loads(line) for line in resp.read().splitlines() if line.strip()]
        return resp.status, msgs, time.perf_counter() - t0
    finally:
        conn.close()


def servers_phase(model, jfk, card):
    """5f: the unix-socket server (three concurrent jfk.flac clients, one
    bad request, one pcm16 live session) and the HTTP server (three
    concurrent uploads, /healthz, /metrics, one s16 live session), each
    with serve_forever on a thread, greedy at T = 0. Every reply equals
    transcribe() of its audio or the batcher's result for the same
    requests; every server thread ends after shutdown(). Returns the
    launches of the two servers' runs."""
    import tempfile
    import urllib.request

    from whisper_tpu_torch.continuous import ContinuousBatcher
    from whisper_tpu_torch.http_server import TranscriptionHTTPServer
    from whisper_tpu_torch.server import TranscriptionServer

    path = os.path.join(ROOT, "tests", "data", "jfk.flac")
    with open(path, "rb") as f:
        data = f.read()
    kw = dict(language="en", temperature=0.0)
    quantized = np.clip(jfk * 32768.0, -32768, 32767).astype(np.int16).astype(np.float32) / 32768.0
    # the references: transcribe(), and the batcher with 1 to 3 jfk rows in a round
    refs = {"transcribe": model.transcribe(path, verbose=None, **kw)["text"]}
    for n in (1, 2, 3):
        cb = ContinuousBatcher(model, slots=4, **kw)
        tickets = [cb.submit(path) for _ in range(n)]
        cb.drain()
        for i, t in enumerate(tickets):
            refs[f"batcher_B{n}_row{i}"] = cb.result(t)["text"]
    stream_ref = model.transcribe(quantized, verbose=None, **kw)["text"]

    def matches(text):
        return [k for k, v in refs.items() if v == text]

    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    with tempfile.TemporaryDirectory() as d:
        sock = os.path.join(d, "wtt.sock")
        srv = TranscriptionServer(model, sock, slots=4, **kw)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            deadline = time.monotonic() + 60
            while not os.path.exists(sock):
                if time.monotonic() > deadline:
                    raise AssertionError("the socket server never bound its socket")
                time.sleep(0.01)

            def drive():
                replies = concurrently(lambda: socket_request(sock, {"audio": path}), 3)
                bad, _ = socket_request(sock, {"audio": "/nonexistent/file.flac"})
                stream = socket_stream_pcm16(sock, quantized)
                return replies, bad, stream

            (replies, bad, (lines, done, stream_s)), stats, counts, _, _ = batch_run(
                "socket server", drive, 3 * len(jfk) / 16000 + len(quantized) / 16000
            )
            add(counts)
        finally:
            srv.shutdown()
            th.join(timeout=60)
        deadline = time.monotonic() + 60
        while any(t.is_alive() for t in srv._readers) and time.monotonic() < deadline:
            time.sleep(0.01)
        alive = [t for t in srv._readers if t.is_alive()]
        if th.is_alive() or alive:
            raise AssertionError(f"socket server threads outlived shutdown(): {th}, {alive}")
        if any("error" in r for r, _ in replies) or not all(matches(r["text"]) for r, _ in replies):
            raise AssertionError(f"socket replies differ from every reference: {replies}")
        if "error" not in bad:
            raise AssertionError(f"the bad request got no error: {bad}")
        if not done.get("done") or done["text"] != stream_ref:
            raise AssertionError(f"the pcm16 session's text differs from transcribe(): {done}")
        log(json.dumps({
            "phase": "servers", "server": "socket", "wall_s_per_request": [s for _, s in replies],
            "matched": [matches(r["text"]) for r, _ in replies], "bad_request": bad["error"][:80],
            "stream_s": stream_s, "stream_segments": len(lines), "threads_joined": True,
            **stats, "launches": counts, "card": card,
        }))  # fmt: skip

    srv = TranscriptionHTTPServer(model, "127.0.0.1", 0, slots=4, **kw)
    url = f"http://{srv.host}:{srv.port}"
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:

        def drive():
            replies = concurrently(lambda: http_upload(url, data), 3)
            with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
                health = json.loads(r.read())
            stream = http_stream_s16(url, jfk)
            with urllib.request.urlopen(f"{url}/metrics", timeout=60) as r:
                metrics = r.read().decode()
            return replies, health, stream, metrics

        (replies, health, (status, msgs, stream_s), metrics), stats, counts, _, _ = batch_run(
            "http server", drive, 4 * len(jfk) / 16000
        )
        add(counts)
    finally:
        srv.shutdown()
        th.join(timeout=60)
    if th.is_alive() or srv._httpd_thread.is_alive():
        raise AssertionError("HTTP server threads outlived shutdown()")
    if not all(matches(r["text"]) for r, _ in replies):
        raise AssertionError(f"HTTP replies differ from every reference: {replies}")
    if health.get("ok") is not True or status != 200 or not msgs[-1].get("done"):
        raise AssertionError(f"healthz {health}, stream status {status} last {msgs[-1:]}")
    if msgs[-1]["text"] != stream_ref:
        raise AssertionError(f"the s16 session's text differs from transcribe(): {msgs[-1]}")
    values = {ln.split()[0]: float(ln.split()[1]) for ln in metrics.splitlines() if ln and ln[0] != "#"}
    if values["wtpu_requests_completed_total"] != 3 or values["wtpu_decode_rounds_total"] < 1:
        raise AssertionError(f"metrics: {values}")
    log(json.dumps({
        "phase": "servers", "server": "http", "wall_s_per_request": [s for _, s in replies],
        "matched": [matches(r["text"]) for r, _ in replies], "stream_s": stream_s,
        "stream_segments": len(msgs) - 1, "metrics": values, "threads_joined": True, **stats,
        "launches": counts, "card": card,
    }))  # fmt: skip
    return launches


# ---- tiny dims: streaming and the batcher, card against CPU ----------------


def card_vs_cpu_serving():
    """At tiny dims in float32 on the card and on the CPU with the same
    seeded weights: StreamingTranscriber over 33 s of jfk in 7 s chunks
    with word timestamps, and ContinuousBatcher(slots=2) with conditioning
    over 33 s of jfk and 35 s of noise (round 2 holds two prompts): equal
    tokens, segment and word times within 1e-6 s."""
    dims = ModelDimensions(80, 1500, 128, 2, 2, 51866, 448, 128, 2, 2)
    params = tiny_params(dims, seed=11)
    gpu = Whisper(dims, params, device="cuda", compute_dtype=torch.float32)
    cpu = Whisper(dims, params, device="cpu", compute_dtype=torch.float32)
    jfk = load_audio(os.path.join(ROOT, "tests", "data", "jfk.flac"))
    long_audio = np.tile(jfk, 3)
    kw = dict(language="en", temperature=0.0, word_timestamps=True)
    (g, _, gw, _), (c, _, cw, _) = (stream_once(m, long_audio, 7.0, **kw) for m in (gpu, cpu))
    if [s["tokens"] for s in g] != [s["tokens"] for s in c] or not c:
        raise AssertionError("streaming: card and CPU finals differ")
    d = same_words(words_of(dict(segments=g)), words_of(dict(segments=c)), "streaming")
    for a, b in zip(g, c):
        d = max(d, abs(a["start"] - b["start"]), abs(a["end"] - b["end"]))
    if not d < 1e-6:
        raise AssertionError(f"streaming: times differ by {d} s")
    out = dict(streaming=dict(finals=len(c), windows=len(cw), words=len(words_of(dict(segments=c))),
                              max_time_diff_s=d))  # fmt: skip
    noise = (np.random.RandomState(3).randn(35 * 16000) * 0.05).astype(np.float32)
    runs = {}
    for model in (gpu, cpu):
        with watch_rounds() as rounds:
            results, _ = batcher_once(model, [long_audio, noise], [], language="en", temperature=0.0)
        runs[model.device.type] = results, [(r["rows"], r["groups"]) for r in rounds]
    (gres, grounds), (cres, crounds) = runs["cuda"], runs["cpu"]
    if grounds != crounds or (2, 2) not in crounds:
        raise AssertionError(f"batcher rounds: card {grounds}, CPU {crounds}: no round with two prompts")
    d = 0.0
    for i, (a, b) in enumerate(zip(gres, cres)):
        if not same_tokens(a, b) or a["text"] != b["text"]:
            raise AssertionError(f"batcher: ticket {i} differs on card and CPU")
        for x, y in zip(a["segments"], b["segments"]):
            d = max(d, abs(x["start"] - y["start"]), abs(x["end"] - y["end"]))
    if not d < 1e-6:
        raise AssertionError(f"batcher: segment times differ by {d} s")
    out["continuous"] = dict(rounds=crounds, segments=[len(r["segments"]) for r in cres], max_time_diff_s=d)
    return out


# ---- phase 6: where a decode window's time goes --------------------------


# ---- 5g: int8 weights and speculative decoding at turbo width ----------------


def spec_draft(dtype):
    """The draft of 5g: tiny's dimensions with turbo's vocabulary (as the
    JAX package's tools/spec_bench.py pins it) and turbo's 128 mels (so that
    transcribe() feeds both models one mel), seeded random weights."""
    turbo = MODEL_DIMS["turbo"]
    dims = dataclasses.replace(MODEL_DIMS["tiny"], n_vocab=turbo.n_vocab, n_mels=turbo.n_mels)
    return Whisper(dims, None, device=DEV, compute_dtype=dtype, seed=1)


def first_window(model, audio):
    """The clip's first 30 s mel window on the card, (n_mels, 3000)."""
    from whisper_tpu_torch.ops.stft import device_mel_full, device_mel_window

    mel, _ = device_mel_full(audio, model.dims.n_mels, DEV)
    return device_mel_window(mel, 0, 3000)


def engine_call(model, window, opts):
    """The arguments (initial tokens, cK, cV) and keywords of the engine run
    that decode(model, window, opts) makes, with the result of decode()."""
    from whisper_tpu_torch import engine as engine_module

    calls = []
    run = engine_module.FusedEngine.run

    def watched(self, *args, **kw):
        calls.append((args, kw))
        return run(self, *args, **kw)

    engine_module.FusedEngine.run = watched
    try:
        result = decode(model, window, opts)
    finally:
        engine_module.FusedEngine.run = run
    return calls[-1], result


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


SPEC_VARIANTS = ("captured", "body")
# the eager host loop runs in the float32 random-draft bracket only
SPEC_EAGER = SPEC_VARIANTS + ("eager",)
# tokens of the random-draft brackets' window, whose uncaptured body and
# eager loop take 23-43 ms a token; past 128 slots, so that spec_profile's
# 24-token run (the 128-slot key) captures its own graph just before its
# profile
SPEC_RANDOM_LEN = 128


def spec_engine(model, draft, k, variant):
    """A speculative engine running its loop as `variant`: "captured" (the
    round replayed from its graph), "body" (the same round run eagerly on
    the card) or "eager" (the host loop, a comparison variant, a host read
    of every row's n, draft position and done flag a round)."""
    spec = SpeculativeEngine(model, draft, k=k)
    spec.capture = variant == "captured"
    spec.eager_loop = variant == "eager"
    return spec


def spec_bracket(model, draft, window, only_token=None, k=4, reps=2, sample_len=None, variants=SPEC_VARIANTS):
    """The plain captured engine and the speculative engine (draft `draft`,
    K = k) on one greedy window at T = 0, its loop as each of `variants`
    (spec_engine): captured, uncaptured (the round body run eagerly) and,
    where asked, the eager host loop. The plain engine and the captured
    round run once untimed (their graphs), then `reps` timed runs each; the
    uncaptured body and the eager loop, dispatch-bound, one timed run each;
    `sample_len` cuts the window (decode()'s default: 224 tokens). With
    `only_token`, every other id is suppressed and timestamps are off: every draft is accepted (the upper bracket); else
    the window decodes as transcribe() would (timestamps on). The counts
    are set to 0 just before each timed run and must equal its record
    (engine_want). The captured round's outputs must equal the uncaptured
    body's. Then one more captured run with each replay between two CUDA
    events (watch_graph_replays): the graph's span on the card a replay
    and a token, the host ms of a replay's call, and the share of that
    run's wall outside the graphs. Returns (stats, the captured engine's
    arguments)."""
    opts = DecodingOptions(
        language="en", temperature=0.0, without_timestamps=only_token is not None, sample_len=sample_len
    )  # fmt: skip
    (args, kw), _ = engine_call(model, window, opts)
    if only_token is not None:
        kw = dict(kw, suppress_ids=[i for i in range(model.dims.n_vocab) if i != only_token],
                  blank_ids=[])  # fmt: skip
    _, dck, dcv = draft.encode_with_cross_kv(window[None])
    engines = {"plain": FusedEngine(model), **{v: spec_engine(model, draft, k, v) for v in variants}}

    def run(name):
        engine = engines[name]
        return engine.run(*args, **kw) if name == "plain" else engine.run(*args, dck, dcv, **kw)

    run("plain")
    run("captured")
    outs, walls, records, counts = {}, {}, {}, {}
    for rep in range(reps):
        for name in engines:
            if rep and name in ("body", "eager"):
                continue
            reset_launch_counts()
            outs[name], wall = timed(lambda: run(name))
            records[name] = engines[name].history[-1]
            counts[name] = launch_counts()
            want = engine_want([records[name]]) if name == "plain" else engine_want([], spec=[records[name]])
            if counts[name] != want:
                raise AssertionError(f"{name} run: launches {counts[name]} != its record's {want}")
            walls.setdefault(name, []).append(wall)
    ni = args[0].shape[-1]  # decoded tokens from ni

    def tokens(out):
        return out[0][0, ni : int(out[1])]

    cap = outs["captured"]
    if not all(np.array_equal(a, b) for a, b in zip(cap, outs["body"])):
        raise AssertionError("the captured round's outputs differ from the uncaptured body's")
    # one more captured run, each replay between two CUDA events
    with watch_graph_replays() as seen:
        _, watched_wall = timed(lambda: run("captured"))
    graph_ms = sum(a.elapsed_time(b) for _, a, b in seen)
    n_tok = engines["captured"].history[-1].steps
    replay_stats = dict(
        watched_wall_s=watched_wall, graph_ms_per_replay=graph_ms / len(seen),
        host_ms_per_replay_call=sum(h for h, _, _ in seen) / len(seen) * 1e3,
        graph_ms_per_token=graph_ms / n_tok, graph_idle_share=1 - graph_ms / (watched_wall * 1e3),
    )  # fmt: skip
    stats = dict(k=k, tokens=int(cap[1]) - ni)
    for name in engines:
        rec, wall = records[name], statistics.median(walls[name])
        steps = rec.steps
        row = dict(wall_s=wall, wall_s_runs=walls[name], ms_per_token=wall / steps * 1e3, tokens=steps,
                   launches=counts[name], tokens_equal_captured=bool(
                       int(outs[name][1]) == int(cap[1]) and np.array_equal(outs[name][0], cap[0])),
                   common_prefix_captured=common_prefix(tokens(outs[name]), tokens(cap)))  # fmt: skip
        if name != "plain":
            row.update(
                rounds=rec.rounds, draft_steps=rec.draft_steps, replays=rec.replays,
                bodies=rec.bodies, captures=rec.captures, capture_s=rec.capture_s,
                done_reads=rec.done_reads, program=rec.program,
                tokens_per_round=steps / max(rec.rounds, 1),
                acceptance=engines[name].last_stats["draft_acceptance"][0],
            )  # fmt: skip
        stats[name] = row
    stats["captured"].update(replay_stats)
    stats["speedup_captured"] = stats["plain"]["ms_per_token"] / stats["captured"]["ms_per_token"]
    return stats, (engines["captured"], args, dck, dcv, kw)


def common_prefix(a, b) -> int:
    n = min(len(a), len(b))
    diff = np.nonzero(np.asarray(a[:n]) != np.asarray(b[:n]))[0]
    return int(diff[0]) if len(diff) else n


def spec_profile(spec, args, dck, dcv, kw, sample_len):
    """One profiled run of the captured speculative engine (sample_len
    tokens; its graphs captured by an unprofiled run of the same key just
    before): between the first and the last greedy launch (step 0's scalar
    launch, the last replay's verify launch), per replayed round the
    device-busy ms (the union of the kernels' intervals), the span on the
    card's timeline, the idle share of that span and the kernels; the host
    ms of a replay's call ("spec_round") and of a done read ("spec_read");
    and the greedy launches in the trace against the run's record."""
    from torch.profiler import ProfilerActivity, profile

    kw = dict(kw, sample_len=sample_len)
    spec.run(*args, dck, dcv, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        spec.run(*args, dck, dcv, **kw)
        torch.cuda.synchronize()
    run = spec.history[-1]
    if run.captures or not run.replays:
        raise AssertionError(f"the profiled speculative run did not replay its graph: {run}")
    span = busy_between_updates(prof, "greedy_argmax_kernel")
    passes = run.replays + run.bodies
    if span["steps"] + 1 != run.launches:
        raise AssertionError(f"the trace holds {span['steps'] + 1} greedy launches, the record {run}")
    host = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in ("spec_round", "spec_read"):
            host.setdefault(e.name, []).append(e.time_range.elapsed_us())
    width = span["hi"] - span["lo"]
    return dict(
        sample_len=sample_len, tokens=run.steps, rounds=run.rounds, draft_steps=run.draft_steps,
        replays=run.replays, device_busy_ms_per_round=span["busy_us"] / passes / 1e3,
        span_ms_per_round=width / passes / 1e3, idle_share_of_span=1 - span["busy_us"] / width,
        kernels_per_replay=span["kernels"] / passes, greedy_launch_device_ms=span["update_us"] / 1e3,
        **{f"host_ms_{k[5:]}": statistics.mean(v) / 1e3 for k, v in host.items()},
    )  # fmt: skip


def decoder_weight_bytes(model):
    """The bytes of the decoder weights the loop reads per step in each mode:
    the eight block products and the embedding, bf16 against int8 with its
    scales."""
    eng = FusedEngine(model, weights="int8")
    dec, q = model.params["decoder"], eng._decoder_params()
    plain = [dec["blocks"][k] for k in DECODER_QUANT_KEYS] + [dec["tok_emb"]]
    int8 = [q["blocks"][k + s] for k in DECODER_QUANT_KEYS for s in ("", "@scale")]
    int8 += [q["tok_emb"], q["tok_emb@scale"]]
    size = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    return dict(bf16_bytes=size(plain), int8_bytes=size(int8),
                params=sum(t.numel() for t in plain))  # fmt: skip


def to_cpu(tree):
    return {k: to_cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


# the int8 reads on the card against the CPU, on inputs that are the same
# bits on both sides: only the order of the float32 sums differs. The
# cross-attention output goes through one more bf16 rounding (the cross_o
# product's operand), where a one-ulp float32 difference can round to the
# other bf16 neighbour and move an output by |w| * 2^-8 * |x|
INT8_OPS_TOL = 1e-4
INT8_CROSS_OUT_TOL = 1e-3


def int8_reads(dec, ckv, gen_seed, dev):
    """Each int8 read of the graphs at turbo width on `dev`, on seeded
    bf16-exact inputs: the eight block products of layer 0 (_dot), the
    token embedding, the logits head and layer 0's cross-attention (its
    layer norm's gain zero and bias bf16-exact, so that the query input is
    exact too): name -> float32 tensor on the CPU."""
    gen = torch.Generator().manual_seed(gen_seed)
    exact = lambda *shape: torch.randn(*shape, generator=gen).bfloat16().float().to(dev)  # noqa: E731
    blk = graphs._layer(dec, 0)
    out = {}
    with torch.inference_mode():
        for key in DECODER_QUANT_KEYS:
            out[key] = graphs._dot(exact(5, 1, blk[key].shape[0]), blk, key)
        ids = torch.arange(0, dec["tok_emb"].shape[0], 997, device=dev)
        out["tok_embedding"] = graphs.tok_embedding(dec, ids, torch.float32)
        out["hidden_to_logits"] = graphs.hidden_to_logits(dec, exact(5, dec["tok_emb"].shape[1]))
        d = blk["cross_ln_b"].shape[0]
        blk = dict(blk, cross_ln_g=torch.zeros(d, device=dev), cross_ln_b=exact(d))
        ck, cv = (graphs.ckv_layer(t, 0) for t in ckv)
        n_head = ck[0].shape[1]
        out["cross_attention"], out["cross_scores"] = graphs._cross_attention(
            exact(1, 5, d), blk, ck, cv, n_head, return_scores=True
        )  # fmt: skip
    return {k: v.float().cpu() for k, v in out.items()}


def int8_card_vs_cpu(f32_model, audio):
    """int8 at turbo width on the card against the CPU: the float32 model's
    decoder and the card's cross-K/V of the clip's first window, copied to
    the CPU and quantized on each side (int8 leaves equal, scales within
    one ulp); each int8 read of the graphs on the same inputs (int8_reads:
    within INT8_OPS_TOL, the cross-attention output within
    INT8_CROSS_OUT_TOL, the embedding rows exactly); and, reported, one
    prefill over the prompt (sot, en, transcribe) and one decode_step of a
    text token after it, with int8 weights and with the plain float32
    weights: the logits' largest difference between card and CPU and
    whether the argmax agrees (in int8 every product rounds its activation
    to bf16, so a summation-order difference that crosses one rounding
    midpoint carries on through the layers)."""
    from whisper_tpu_torch.tokenizer import get_tokenizer

    dims = f32_model.dims
    _, ck, cv = f32_model.encode_with_cross_kv(first_window(f32_model, audio)[None])
    dec = f32_model.params["decoder"]
    plain = {"card": (dec, ck, cv), "cpu": (to_cpu(dec), ck.cpu(), cv.cpu())}
    int8 = {side: (quantize_decoder(d), *quantize_cross_kv(k, v)) for side, (d, k, v) in plain.items()}
    (dg, kg, vg), (dc, kc, vc) = int8["card"], int8["cpu"]
    pairs = list(zip(leaves(dg), leaves(dc))) + [
        ((f"cross_{n}", a), (f"cross_{n}", b)) for n, x, y in (("k", kg, kc), ("v", vg, vc))
        for a, b in zip(x, y)
    ]  # fmt: skip
    scale_rel = 0.0
    for (name, a), (_, b) in pairs:
        a = a.cpu()
        if a.dtype == torch.int8:
            if not torch.equal(a, b):
                raise AssertionError(f"int8 {name}: the card's quantization differs from the CPU's")
        elif "@scale" in name or name.startswith("cross_"):
            rel = ((a - b).abs() / b.abs()).max().item()
            if not rel <= 2**-23:
                raise AssertionError(f"int8 {name}: scales differ by {rel} relative")
            scale_rel = max(scale_rel, rel)
    out = dict(scales_max_rel_diff=scale_rel, reads={})
    reads = [int8_reads(dq, (k, v), 5, dev) for (dq, k, v), dev in ((int8["card"], DEV),
                                                                    (int8["cpu"], "cpu"))]
    for name, a in reads[0].items():
        err = (a - reads[1][name]).abs().max().item()
        tol = 0.0 if name == "tok_embedding" else (
            INT8_CROSS_OUT_TOL if name == "cross_attention" else INT8_OPS_TOL)
        if not err <= tol:
            raise AssertionError(f"int8 {name} on the card differs from the CPU's by {err} > {tol}")
        out["reads"][name] = dict(max_abs_diff=err, abs_max=a.abs().max().item(), tol=tol)
    prompt = get_tokenizer(True, num_languages=f32_model.num_languages, language="en",
                           task="transcribe").sot_sequence  # fmt: skip
    n, L, d = len(prompt), dims.n_text_layer, dims.n_text_state
    for mode, sides in (("float32", plain), ("int8", int8)):
        logits = {}
        for side, (dt, k, v) in sides.items():
            dev = DEV if side == "card" else torch.device("cpu")
            toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
            with torch.inference_mode():
                hidden, kv = graphs.prefill(dt, toks, n, k, v, n_head=dims.n_text_head)
                first = graphs.hidden_to_logits(dt, hidden[:, n - 1])
                cache = torch.zeros((L, 2, 1, graphs.CACHE_SLOTS, d), dtype=kv.dtype, device=dev)
                cache[:, :, :, :n] = kv
                nxt = torch.tensor([1000], dtype=torch.int32, device=dev)
                step, _ = graphs.decode_step(dt, nxt, n, cache, None, k, v, n_head=dims.n_text_head)
            logits[side] = torch.cat([first, step]).cpu()
        out[f"pass_{mode}"] = dict(
            max_abs_diff=(logits["card"] - logits["cpu"]).abs().max().item(),
            logits_abs_max=logits["cpu"].abs().max().item(),
            argmax_equal=torch.equal(logits["card"].argmax(-1), logits["cpu"].argmax(-1)),
        )  # fmt: skip
    return out


def int8_spec_phase(model, draft, f32_model, audio, jfk, card):
    """5g. The decoder weight bytes of each weights mode (int8's loop
    profiles run beside phase 6's); the speculative engine (bf16 draft
    `draft`) on one window, captured and uncaptured (and the eager host
    loop in the float32 random-draft bracket), against the plain engine
    (spec_bracket), a random draft (the lower bracket) and a one-token
    vocabulary (every draft accepted, the upper bracket), in bf16 (the
    captured outputs equal the uncaptured body's) and at float32 (tokens
    equal, the gate), and one profiled captured run
    per draft (spec_profile); transcribe() of the clip and a
    ContinuousBatcher(slots=2) round with a draft at float32, equal to the
    plain ones (the gate)."""
    log(json.dumps({"phase": "int8_weights", **decoder_weight_bytes(model), "card": card}))
    t = time.perf_counter()
    log(json.dumps({"phase": "int8_card_vs_cpu", **int8_card_vs_cpu(f32_model, audio),
                    "seconds": time.perf_counter() - t}))  # fmt: skip
    t = time.perf_counter()
    f32_draft = spec_draft(torch.float32)
    window = first_window(model, audio)
    only = 1000  # a text id: every other id suppressed
    for name, kw, profiled in [
        ("random_draft", dict(sample_len=SPEC_RANDOM_LEN), 24), ("all_accepted", dict(only_token=only), 48),
    ]:  # fmt: skip
        stats, run = spec_bracket(model, draft, window, **kw)
        prof = spec_profile(*run, sample_len=profiled)
        cap = stats["captured"]
        log(json.dumps({"phase": "spec", "bracket": name, "dtype": "bf16", **stats, "card": card}))
        log(json.dumps({"phase": "spec_profile", "bracket": name, **prof, "card": card}))
        full = -(-(stats["tokens"] - 1) // (stats["k"] + 1))  # every round K + 1 tokens
        if name == "all_accepted" and cap["rounds"] != full:
            raise AssertionError(f"the one-token vocabulary took {cap['rounds']} rounds, not {full}")
        variants = SPEC_EAGER if name == "random_draft" else SPEC_VARIANTS
        f32_stats, _ = spec_bracket(f32_model, f32_draft, first_window(f32_model, audio), variants=variants, **kw)
        log(json.dumps({"phase": "spec", "bracket": name, "dtype": "float32", **f32_stats,
                        "card": card}))  # fmt: skip
        differ = [v for v in ("plain", *variants) if not f32_stats[v]["tokens_equal_captured"]]
        if differ:
            raise AssertionError(f"{name} at float32: the captured round's tokens differ from {differ}")
    log(json.dumps({"phase": "spec_brackets", "seconds": time.perf_counter() - t}))
    t = time.perf_counter()

    # the product paths at float32: transcribe() and one batcher round
    kw = dict(language="en", temperature=0.0, verbose=None)
    (plain, p_wall), (spec, s_wall) = [
        with_draft(f32_model, d, lambda: timed(lambda: f32_model.transcribe(audio, **kw)))
        for d in (None, f32_draft)
    ]  # fmt: skip
    if spec["text"] != plain["text"] or not same_tokens(spec, plain):
        raise AssertionError("transcribe() with a draft at float32 differs from plain")
    requests = [jfk, audio[: 23 * 16000]]
    (b_plain, _), (b_spec, _) = [
        with_draft(f32_model, d, lambda: batcher_once(f32_model, requests, [], language="en",
                                                      temperature=0.0))
        for d in (None, f32_draft)
    ]  # fmt: skip
    b_equal = [same_tokens(a, b) and a["text"] == b["text"] for a, b in zip(b_spec, b_plain)]
    if not all(b_equal):
        raise AssertionError(f"the batcher with a draft at float32 differs from plain: {b_equal}")
    log(json.dumps({
        "phase": "spec_paths", "dtype": "float32", "transcribe_equal": True,
        "transcribe_wall_s": [p_wall, s_wall], "batcher_tickets_equal": b_equal,
        "seconds": time.perf_counter() - t, "card": card,
    }))  # fmt: skip


def int8_profile(model, audio, beam_size, bf16_tokens):
    """decode_loop_profile of the window with int8 weights (the loop profile
    of the same window in bf16 runs just before it), its launches, and the
    common prefix of its tokens with bf16's."""
    model.decode_weights = "int8"
    reset_launch_counts()
    try:
        prof = decode_loop_profile(model, audio, beam_size)
    finally:
        model.decode_weights = ""
    tokens = prof.pop("tokens")
    return dict(
        weights="int8", **prof, launches=launch_counts(),
        tokens=[len(bf16_tokens), len(tokens)], common_prefix=common_prefix(bf16_tokens, tokens),
        parting=parting_read(model, audio, bf16_tokens, tokens),
    )  # fmt: skip


def parting_read(model, audio, bf16_tokens, int8_tokens):
    """Where the int8 tokens first part from the bf16 tokens of the same
    window: each mode's filtered log-probs at that position given the
    common prefix, from one prefill over it (greedy's filters and
    penalties): its pick, the gap between its top two, and the log-prob it
    gives each mode's token; beside them the largest and the typical
    (standard deviation) difference of the raw logits between the modes,
    and the spread of bf16's logits. None where neither parts."""
    p = common_prefix(bf16_tokens, int8_tokens)
    if p >= min(len(bf16_tokens), len(int8_tokens)):
        return None
    window = first_window(model, audio)
    (args, kw), _ = engine_call(model, window, DecodingOptions(language="en", temperature=0.0))
    initial, ck, cv = args
    initial = np.asarray(initial).reshape(-1)  # one audio
    ni = len(initial)
    n = ni + p
    toks = torch.zeros((1, graphs.CACHE_SLOTS), dtype=torch.int32, device=DEV)
    toks[0, :n] = torch.from_numpy(np.concatenate([initial, bf16_tokens[:p]]).astype(np.int32))
    filt = dict(use_timestamps=kw["use_timestamps"], eot=kw["eot"],
                timestamp_begin=kw["timestamp_begin"])  # fmt: skip
    max_ts = kw["max_initial_ts_index"]
    pens = FusedEngine(model)._penalties(
        kw["suppress_ids"], kw["blank_ids"], use_timestamps=kw["use_timestamps"],
        no_timestamps=kw["no_timestamps"], timestamp_begin=kw["timestamp_begin"],
        max_initial_ts_index=graphs.CACHE_SLOTS if max_ts is None else max_ts,
    )  # fmt: skip
    pair = (int(bf16_tokens[p]), int(int8_tokens[p]))
    out, logits = dict(position=p, tokens=list(pair)), {}
    for mode in ("bf16", "int8"):
        dec = FusedEngine(model, weights=mode)._decoder_params()
        kv = quantize_cross_kv(ck, cv) if mode == "int8" else (ck, cv)
        with torch.inference_mode():
            hidden, _ = graphs.prefill(dec, toks[:, :n], n, *kv, n_head=model.dims.n_text_head)
            lg = graphs.hidden_to_logits(dec, hidden[:, n - 1])
            lp = torch.log_softmax(bk.apply_filters(lg, toks, n, ni, *pens, **filt), dim=-1)[0]
        top = lp.topk(2)
        out[mode] = dict(
            pick=int(top.indices[0]), top2_gap=(top.values[0] - top.values[1]).item(),
            logprob_of_tokens=[lp[t].item() for t in pair],
        )  # fmt: skip
        logits[mode] = lg[0]
    diff = logits["int8"] - logits["bf16"]
    out.update(
        logit_diff_max=diff.abs().max().item(), logit_diff_std=diff.std().item(),
        bf16_logit_std=logits["bf16"].std().item(),
    )  # fmt: skip
    return out


def with_draft(model, draft, fn):
    """fn() with `draft` installed on `model` (None: none), then removed."""
    model.set_draft_model(draft)
    try:
        return fn()
    finally:
        model.set_draft_model(None)


PROFILE_STEPS = 48  # the profiled window's sample_len: reading a 224-step trace was most of the profiles' time


LOOP_VARIANTS = ("captured", "body", "eager")
LOOP_PROFILE_STEPS = 24  # the captured-loop phase's profiled steps (nine profiles)


def loop_engine(model, variant):
    """A fresh engine of the model running the loop as `variant`:
    "captured" (the body replayed from its graphs), "body" (the same body
    run eagerly on the card) or "eager" (the host loop, a comparison
    variant, a host read of `completed` each step)."""
    engine = FusedEngine(model)
    engine.capture = variant == "captured"
    engine.eager_loop = variant == "eager"
    return engine


def captured_loop_phase(model, audio, card):
    """One turbo window of the engine (the arguments decode() gives it on
    the clip's first window) at greedy T = 0, beam 5 and a T = 0.7 draw
    (seed 7), through each LOOP_VARIANTS engine. The captured loop's
    outputs must equal the uncaptured body's, token for token at every step
    (and its draws on the same seed); the launch counts of each first run
    must equal its record (engine_want). Per variant: the first run's wall
    and record (captures, capture s, replays, uncaptured passes, done
    reads), peak memory, wall ms per step over two later runs; from a
    profiled run of LOOP_PROFILE_STEPS steps (its graphs captured beforehand),
    device-busy ms per step, idle share against the wall, kernels per step
    and the update kernel's device ms."""
    from torch.profiler import ProfilerActivity, profile

    window = first_window(model, audio)
    out = {}
    for name, opts in [
        ("greedy", dict(temperature=0.0)), ("beam5", dict(beam_size=5, temperature=0.0)),
        ("sampled", dict(temperature=0.7)),
    ]:  # fmt: skip
        (args, kw), _ = engine_call(model, window, DecodingOptions(language="en", **opts))
        kw = dict(kw, rng_seed=7)
        short = dict(kw, sample_len=LOOP_PROFILE_STEPS)
        # a kernel once a step: the update, or the draw's argmax (ArgMaxOps)
        update = {"greedy": "greedy_argmax_kernel", "beam5": "beam_update_kernel"}.get(name, "argmax")
        results, outs = {}, {}
        for variant in LOOP_VARIANTS:
            engine = loop_engine(model, variant)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            first, first_s = timed(lambda: engine.run(*args, **kw))
            record = engine.history[-1]
            counts = launch_counts()
            if counts != engine_want([record]):
                raise AssertionError(f"{name} {variant}: launches {counts} != its record {record}")
            peak = torch.cuda.max_memory_allocated()
            walls = []
            for _ in range(2):
                again, _ = timed(lambda: engine.run(*args, **kw))
                if not all(np.array_equal(a, b) for a, b in zip(first, again)):
                    raise AssertionError(f"{name} {variant}: two runs of one window differ")
                walls.append(engine.history[-1].seconds / engine.history[-1].steps * 1e3)
            engine.run(*args, **short)  # its graphs, if any, before the profile
            reset_launch_counts()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                engine.run(*args, **short)
                torch.cuda.synchronize()
            span = busy_between_updates(prof, update)
            n = span["steps"]
            if name != "sampled":
                traced_launches(name, span, engine.history[-1], launch_counts())
            wall = statistics.median(walls)
            busy = span["busy_us"] / n / 1e3
            results[variant] = dict(
                first_run_s=first_s, steps=record.steps, replays=record.replays,
                bodies=record.bodies, captures=record.captures, capture_s=record.capture_s,
                done_reads=record.done_reads, peak_bytes=peak, launches=counts,
                wall_ms_per_step=wall, wall_ms_per_step_runs=walls,
                device_busy_ms_per_step=busy, device_idle_share=1 - busy / wall,
                kernels_per_step=span["kernels"] / n, update_device_ms=span["update_us"] / 1e3,
            )  # fmt: skip
            outs[variant] = first
            del engine
        cap, body = outs["captured"], outs["body"]
        n = int(cap[1])
        if int(body[1]) != n or not np.array_equal(cap[0][:, :n], body[0][:, :n]):
            raise AssertionError(f"{name}: the captured loop's tokens differ from the uncaptured body's")
        same_all = all(np.array_equal(a, b) for a, b in zip(cap, body))
        eager = outs["eager"]
        out[name] = dict(
            **results, tokens=n - len(args[0][0]), captured_equals_body=same_all,
            eager_common_prefix=common_prefix(cap[0][0, :n].tolist(), eager[0][0, : int(eager[1])].tolist()),
        )  # fmt: skip
        log(json.dumps({"phase": "captured_loop", "mode": name, **out[name], "card": card}))
    return out




DONE_LAGS = (0, 1, 2, 4, 8, 16)  # the done read's lags the done-lag phase compares
EARLY_KEEP = (4, 8, 6, 12, 16, 5, 10)  # text ids an early-end set keeps


def early_end_set(model, args, kw, lo=16, tries=42):
    """A suppression set under which the greedy window ends early on random
    weights: all but EOT and K text ids drawn from a seeded generator, K
    cycling through EARLY_KEEP (a random model tends to repeat one id, so
    only a few draws end at all); the first set under which every row is
    done after lo steps or more and before sample_len. Returns
    (suppress_ids, steps)."""
    rng = np.random.RandomState(11)
    eot = kw["eot"]
    engine = FusedEngine(model)
    seen = []
    for t in range(tries):
        keep = set(rng.choice(eot, EARLY_KEEP[t % len(EARLY_KEEP)], replace=False).tolist())
        sup = [i for i in range(model.dims.n_vocab) if i not in keep | {eot}]
        engine.run(*args, **dict(kw, suppress_ids=sup))
        steps = engine.history[-1].steps
        seen.append(steps)
        if lo <= steps < kw["sample_len"]:
            return sup, steps
    raise AssertionError(f"no suppression set ended the window after {lo} steps or more: {seen}")


def done_lag_phase(model, audio, card):
    """The done read's lag (engine.DONE_LAG: passes left queued on the card
    while the host waits on an earlier pass's event) on the turbo clip's
    first window at greedy T = 0: a window that every row ends early
    (early_end_set) and the whole 224-step window, each at every lag of
    DONE_LAGS, ascending then descending, two runs a turn (no timestamp
    rules, so that the early set leaves text ids to pick). Per lag: the
    early window's wall, replays after every row was done, done reads; the
    whole window's wall ms a step. Every run's outputs must equal the first
    lag's: replays after every row is done change nothing."""
    from whisper_tpu_torch import engine as engine_module

    window = first_window(model, audio)
    # no timestamp rules: their begin penalty would leave no text id at step 0
    opts = DecodingOptions(language="en", temperature=0.0, without_timestamps=True)
    (args, kw), _ = engine_call(model, window, opts)
    sup, early_steps = early_end_set(model, args, kw)
    early = dict(kw, suppress_ids=sup)
    engine = FusedEngine(model)
    engine.run(*args, **early)
    engine.run(*args, **kw)  # both windows' graphs before the timed runs
    chosen = engine_module.DONE_LAG
    res = {k: dict(early_ms=[], after_done=[], done_reads=[], whole_ms_per_step=[]) for k in DONE_LAGS}
    want = {}
    try:
        for k in DONE_LAGS + DONE_LAGS[::-1]:
            engine_module.DONE_LAG = k
            for _ in range(2):
                for name, opts in (("early", early), ("whole", kw)):
                    out, _ = timed(lambda: engine.run(*args, **opts))
                    run = engine.history[-1]
                    ref = want.setdefault(name, out)
                    if not all(np.array_equal(a, b) for a, b in zip(out, ref)):
                        raise AssertionError(f"done lag {k}: the {name} window's outputs changed")
                    r = res[k]
                    if name == "early":
                        r["early_ms"].append(run.seconds * 1e3)
                        r["after_done"].append(run.replays + run.bodies - (run.steps - 1))
                        r["done_reads"].append(run.done_reads)
                    else:
                        r["whole_ms_per_step"].append(run.seconds / run.steps * 1e3)
    finally:
        engine_module.DONE_LAG = chosen
    out = dict(
        early_steps=early_steps, whole_steps=engine.history[-1].steps, chosen=chosen,
        lags={k: dict(early_ms_median=statistics.median(r["early_ms"]),
                      whole_ms_per_step_median=statistics.median(r["whole_ms_per_step"]), **r)
              for k, r in res.items()},
    )  # fmt: skip
    log(json.dumps({"phase": "done_lag", **out, "card": card}))
    return out


def decode_loop_profile(model, audio, beam_size=None):
    """One window of decode() at the model's width, greedy or beam search:
    the engine's wall ms per step (host clock, three unprofiled runs of the
    whole window) and its tokens; from a profiled run of its first
    PROFILE_STEPS steps, between the first and the last update launch, the
    device-busy ms per step (the union of the kernels' intervals), the
    kernels per step, the update kernel's device ms per step, and the
    host's ms per step blocked in device-to-host reads
    (`aten::_local_scalar_dense`: the run's final read; the captured loop
    reads its done flag from pinned memory, `done_reads` of its record).
    The short window runs once unprofiled first, so that its graphs are
    captured before the profile."""
    from torch.profiler import ProfilerActivity, profile

    window = first_window(model, audio)
    opts = DecodingOptions(language="en", temperature=0.0, beam_size=beam_size)
    update = "beam_update_kernel" if beam_size else "greedy_argmax_kernel"
    walls = []
    for _ in range(3):
        result = decode(model, window, opts)
        # the engine of the model's weights mode (decode() may build it)
        run = model._fused_engine.history[-1]
        steps = run.steps
        walls.append(run.seconds / steps * 1e3)
    short = dataclasses.replace(opts, sample_len=PROFILE_STEPS)
    decode(model, window, short)  # the short window's graphs, before the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode(model, window, short)
        torch.cuda.synchronize()
    reads = [
        e.time_range for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CPU and e.name == "aten::_local_scalar_dense"
    ]  # fmt: skip
    span = busy_between_updates(prof, update)
    lo, hi, n = span["lo"], span["hi"], span["steps"]  # steps between the first and the last update
    reads = [r for r in reads if lo <= r.start < hi]
    traced_launches(f"decode {update}", span, model._fused_engine.history[-1])
    wall = statistics.median(walls)
    busy_ms = span["busy_us"] / n / 1e3
    return dict(
        mode=f"beam{beam_size}" if beam_size else "greedy",
        steps=steps,
        wall_ms_per_step=wall,
        wall_ms_per_step_runs=walls,
        profiled_ms_per_step=(hi - lo) / n / 1e3,
        device_busy_ms_per_step=busy_ms,
        device_idle_share=1 - busy_ms / wall,
        kernels_per_step=span["kernels"] / n,
        update_ms_per_step=span["update_us"] / 1e3,
        host_reads_per_step=len(reads) / n,
        host_read_ms_per_step=sum(r.elapsed_us() for r in reads) / n / 1e3,
        replays=run.replays, done_reads=run.done_reads,
        tokens=result.tokens,
    )


# ---- train: fine-tuning, checkpoints and draft distillation ----------------

TRAIN_DIR = os.path.join(ROOT, "smoke", "_build", "train")
JFK_PATH = os.path.join(ROOT, "tests", "data", "jfk.flac")
TRAIN_TEXTS = [
    "and so my fellow americans ask not what your country can do for you",
    "ask not what you can do for your country",
]
# the 1-layer, 64-wide student of the tiny card-vs-CPU distillation
TINY_STUDENT = ModelDimensions(80, 1500, 64, 1, 1, 51866, 448, 64, 1, 1)


def train_records():
    return [{"audio": JFK_PATH, "text": t} for t in TRAIN_TEXTS]


def train_dir(name):
    path = os.path.join(TRAIN_DIR, name)
    shutil.rmtree(path, ignore_errors=True)
    return path


class StepClock:
    """The log function of run_finetune / run_distill: keeps each line and
    the host clock at which it came. A step's line follows the host read of
    its loss, so the gaps between step lines are the steps' wall times."""

    def __init__(self):
        self.lines, self.times = [], []

    def __call__(self, line):
        self.lines.append(line)
        self.times.append(time.perf_counter())

    def steps(self):
        return [(ln, t) for ln, t in zip(self.lines, self.times) if "  loss " in ln]

    def step_ms(self):
        t = [t for _, t in self.steps()]
        return [(b - a) * 1e3 for a, b in zip(t, t[1:])]

    def field(self, name):
        """The values of `name` in the step lines ("ce", "kl")."""
        return [float(ln.split(f"  {name} ")[1].split()[0]) for ln, _ in self.steps()]


def falling(history, what):
    if not (np.isfinite(history).all() and history[-1] < history[0]):
        raise AssertionError(f"{what}: losses {history} not finite and falling")


def finetune_phase(model, jfk):
    """run_finetune of the turbo model: 4 steps at batch 2, max_tokens 128,
    lr 1e-3, on two jfk records with different texts. The losses finite and
    falling; wall ms a step after the first, peak memory, the checkpoint's
    bytes, save seconds (from the last step's line to the return, the
    device-to-host copy included), load seconds; then load_model of the
    directory decodes the clip's first window at T = 0 on the card, the
    greedy kernel launched once a step. Returns (stats, launches of that
    decode)."""
    from whisper_tpu_torch import load_model
    from whisper_tpu_torch.checkpoint import load_checkpoint
    from whisper_tpu_torch.finetune import run_finetune

    out_dir, clock = train_dir("finetune"), StepClock()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history = run_finetune(
        model, train_records(), steps=4, batch_size=2, out_dir=out_dir, learning_rate=1e-3,
        max_tokens=128, log=clock,
    )  # fmt: skip
    end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    falling(history, "turbo fine-tune")
    ckpt = os.path.join(out_dir, "state_4.pt")
    t = time.perf_counter()
    load_checkpoint(out_dir)
    load_s = time.perf_counter() - t
    t = time.perf_counter()
    tuned = load_model(out_dir, device=DEV, compute_dtype=model.compute_dtype)
    torch.cuda.synchronize()
    load_model_s = time.perf_counter() - t
    window = first_window(tuned, jfk)
    reset_launch_counts()
    result = decode(tuned, window, DecodingOptions(language="en", temperature=0.0))
    torch.cuda.synchronize()
    counts = launch_counts()
    run = tuned._fused_engine.history[-1]
    if counts != engine_want([run]) or not run.steps:
        raise AssertionError(f"the tuned model's decode: launches {counts}, its record {run}")
    if not result.tokens or not np.isfinite(result.avg_logprob):
        raise AssertionError("the tuned model decoded no token")
    del tuned
    torch.cuda.empty_cache()
    return dict(
        losses=history, first_step_s=clock.times[0] - t0, step_ms=clock.step_ms(),
        max_memory_allocated=peak, checkpoint_bytes=os.path.getsize(ckpt),
        save_s=end - clock.times[-1], load_checkpoint_s=load_s, load_model_s=load_model_s,
        decoded_tokens=len(result.tokens),
    ), counts  # fmt: skip


def backward_ms(model, reps=2):
    """One turbo train step's forward and backward at batch 2, the stacked
    weights split per layer by one unbind (graphs._layers, kept) and by
    indexing each layer (select, whose backward writes a zero tensor of
    the whole stack per layer), in turns unbind, select, select, unbind:
    host ms (synchronized) of the forward and of the backward."""
    from whisper_tpu_torch.finetune import batches, model_tokenizer
    from whisper_tpu_torch.parallel.train import device_batch, init_train_state, loss_fn

    tok = model_tokenizer(model, "en")
    batch = next(batches(train_records(), tok, n_mels=model.dims.n_mels, batch_size=2, max_tokens=128))
    batch = device_batch(batch, DEV)
    params = init_train_state(model.params, 1e-3, 0.01).params
    unbind = graphs._layers

    def select(tree):
        return [graphs._layer(tree, l) for l in range(tree["blocks"]["attn_q_w"].shape[0])]

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_fn(params, batch, n_audio_head=model.dims.n_audio_head,
                       n_text_head=model.dims.n_text_head)  # fmt: skip
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for _, v in flatten_tree(params):
            v.grad = None
        return (t1 - t0) * 1e3, (t2 - t1) * 1e3

    out = {"unbind": [], "select": []}
    try:
        step()  # warm-up
        for _ in range(reps):
            for name, fn in (("unbind", unbind), ("select", select), ("select", select), ("unbind", unbind)):
                graphs._layers = fn
                out[name].append(step())
    finally:
        graphs._layers = unbind
    del params
    torch.cuda.empty_cache()
    return {
        f"{name}_{part}_ms": [r[i] for r in runs]
        for name, runs in out.items() for i, part in enumerate(("forward", "backward"))
    }  # fmt: skip


SPEC_EVAL = dict(ks=(4, 8), clips=2, steps=8, batch=2, trials=1)  # the tool's 16 clips, 400 steps at 8, 5 trials cut


def eval_phase(model):
    """spec_distill_eval.run at a cut size (SPEC_EVAL) on the turbo target
    with a tiny-sized draft, the counts set to 0 before it: the clips
    labeled by the captured engine (greedy at the loop state, row 1b),
    run_distill over them and one unlabeled jfk record, which pseudo_label
    transcribes with the target at T = 0; the plain captured engine and the
    speculative round (per-row at the loop state, row 1c) with the
    distilled and a random draft on a training clip and a held-out one.
    Held: the losses finite and falling; each clip's label equal to a
    second captured run's tokens; acceptance in [0, 1] and at least one
    round a row on every line; the launches equal to the engines' records
    (engine_want), rows 1b and 1c among them. Reported: the acceptances,
    speedup_vs_fused, bf16 token agreement (near-ties may flip in bf16),
    ms a distill step, each stage's seconds. Returns (stats, launches)."""
    from whisper_tpu_torch import distill as distill_module
    from whisper_tpu_torch import spec_distill_eval as sde
    from whisper_tpu_torch import speculative

    workdir, labeled, spec_engines = train_dir("spec_eval"), {}, []
    pseudo_label, spec_engine = distill_module.pseudo_label, speculative.SpeculativeEngine

    def timed_label(*args, **kw):
        out, labeled["s"] = timed(lambda: pseudo_label(*args, **kw))
        return out

    class Recorded(spec_engine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            spec_engines.append(self)

    distill_module.pseudo_label, speculative.SpeculativeEngine = timed_label, Recorded
    engine = model_engine(model)
    engine.history.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    lines = []
    try:
        t0 = time.perf_counter()
        out = sde.run(model, "tiny", workdir=workdir, extra_records=[{"audio": JFK_PATH}], log=lambda *_: None,
                      emit=lines.append, **SPEC_EVAL)  # fmt: skip
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        distill_module.pseudo_label, speculative.SpeculativeEngine = pseudo_label, spec_engine
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    runs, spec = list(engine.history), [r for e in spec_engines for r in e.history]
    if counts != engine_want(runs, spec=spec):
        raise AssertionError(f"the eval's launches {counts} != its records' {engine_want(runs, spec=spec)}")
    if not (counts["greedy_argmax_state"] and counts["greedy_argmax_rows_state"]) or not all(r.captured for r in runs + spec):
        raise AssertionError(f"the eval did not run its captured loops through rows 1b and 1c: {counts}")
    d = out["distill"]
    falling(d["history"], "the eval's turbo -> tiny distillation")
    for i, rec in enumerate(out["manifest"]):
        again = sde.teacher_path_tokens(model, sde.synth_speech(sde.TRAIN_SEED + i))
        if again != rec["tokens"] or len(again) != sde.SAMPLE_LEN:
            raise AssertionError(f"clip {i}: its label and a second captured run part at {common_prefix(again, rec['tokens'])}")
    for line in lines:
        if line["K"] is not None and not (0.0 <= line["acceptance"] <= 1.0 and min(line["rounds"]) >= 1):
            raise AssertionError(f"an eval line out of range: {line}")
    torch.cuda.empty_cache()
    return dict(
        seconds=seconds, labels_s=out["labels_s"], eval_s=out["eval_s"], pseudo_label_s=labeled["s"],
        distill_s=d["seconds"], first_step_s=d["first_step_s"], step_ms=d["step_ms"], step_ms_p50=d["step_ms_p50"],
        losses=d["history"], max_memory_allocated=peak, lines=lines, captures=sum(r.captures for r in runs + spec),
        cut=f"{SPEC_EVAL} against the tool's 16 clips, 400 steps at batch 8, 5 trials",
    ), counts  # fmt: skip


def eval_tools_phase(model, card):
    """The evaluation tools on the turbo model, the counts set to 0 before
    it: eval_wer's --ref-dir / --audio-dir form on jfk.flac, whose reference
    is the model's own T = 0 transcript (overall WER 0.0000), then once more
    with --weights int8 (its WER reported); validate_real --offline with its
    report under smoke/_build/ (exit 0, every weight section skipped with a
    reason, the report read back). Returns the launches of the transcribes."""
    from whisper_tpu_torch import eval_wer, validate_real

    t = time.perf_counter()
    root = train_dir("eval_tools")
    refs, audio = os.path.join(root, "refs"), os.path.join(root, "audio")
    os.makedirs(refs)
    os.makedirs(audio)
    shutil.copy(JFK_PATH, os.path.join(audio, "jfk.flac"))
    reset_launch_counts()
    own = model.transcribe(JFK_PATH, language="en", temperature=0.0, verbose=None)["text"]
    with open(os.path.join(refs, "jfk.txt"), "w") as f:
        f.write(own)
    args = ["--ref-dir", refs, "--audio-dir", audio, "--temperature", "0", "--device", "cuda"]
    printed = {}
    for weights in ("", "int8"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = eval_wer.main(args + ["--weights", weights], model=model)
        overall = [ln for ln in buf.getvalue().splitlines() if ln.startswith("overall WER:")]
        if rc != 0 or len(overall) != 1:
            raise AssertionError(f"eval_wer {weights or 'bf16'}: exit {rc}, printed {buf.getvalue()!r}")
        printed[weights or "bf16"] = overall[0]
    torch.cuda.synchronize()
    counts = launch_counts()
    if not printed["bf16"].startswith("overall WER: 0.0000 "):
        raise AssertionError(f"eval_wer against the model's own transcript: {printed['bf16']}")
    report_path = os.path.join(root, "validate_real.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = validate_real.main(["--offline", "--device", "cuda", "--out", report_path])
    with open(report_path) as f:
        report = json.load(f)
    sections = ("e2e_tests", "wer", "longform", "int8_wer_delta", "speculative_acceptance")
    skipped = {s: report[s].get("reason") for s in sections if report[s]["status"] == "skipped"}
    if rc != 0 or len(skipped) != len(sections) or not all(skipped.values()) or report["network"] is not False:
        raise AssertionError(f"validate_real --offline: exit {rc}, report {report}")
    log(json.dumps({"phase": "eval_tools", "seconds": time.perf_counter() - t, "own_transcript_chars": len(own),
                    "eval_wer": printed, "validate_real": {"exit": rc, "skipped": skipped,
                    "checkpoints": report["checkpoints"]}, "launches": counts, "card": card}))  # fmt: skip
    return counts


BENCH_TOOLS_KERNEL = {  # each tool's loop kernel on this phase's runs
    "continuous_bench": "greedy_argmax_state", "throughput_bench": "beam_update_state",
    "streaming_latency": "greedy_argmax_state", "soak_server": "greedy_argmax_state",
    "spec_bench": "greedy_argmax_rows_state", "spec_bench_float32": "greedy_argmax_rows_state",
    "graph_bench": "beam_update_state",
    "trace_ops": "beam_update_state", "serve_bench": "beam_update_state",
}  # fmt: skip


def spec_parting(model, fused, spec):
    """Where spec_bench's accept0 tokens part from the plain engine's, per
    window (`fused`, `spec`: each window's decoded ids): the common prefix
    and, given it, the target's filtered log-probs at the parting position
    from one prefill over it (the bracket's filters and penalties, a third
    shape of the same products): its top-two ids and gap, and each
    engine's token's rank and log-prob. None for a window whose tokens are
    equal."""
    from whisper_tpu_torch import spec_bench
    from whisper_tpu_torch.frontend import encode_clip
    from whisper_tpu_torch.tokenizer import get_tokenizer

    tok = get_tokenizer(model.is_multilingual, num_languages=model.num_languages, language="en",
                        task="transcribe")  # fmt: skip
    kw = spec_bench.bracket_kwargs(tok, model.dims.n_vocab, spec_bench.SAMPLE_LEN)["accept0"]
    ck, cv, _ = encode_clip(model, spec_bench.clip_audio(len(fused)))
    pens = FusedEngine(model)._penalties(
        kw["suppress_ids"], kw["blank_ids"], use_timestamps=kw["use_timestamps"],
        no_timestamps=kw["no_timestamps"], timestamp_begin=kw["timestamp_begin"],
        max_initial_ts_index=kw["max_initial_ts_index"],
    )  # fmt: skip
    filt = dict(use_timestamps=kw["use_timestamps"], eot=kw["eot"], timestamp_begin=kw["timestamp_begin"])
    initial = list(tok.sot_sequence)
    dec = model.params["decoder"]
    out = []
    for a, (f, sp) in enumerate(zip(fused, spec)):
        p = common_prefix(f, sp)
        if p >= min(len(f), len(sp)):
            out.append(None)
            continue
        n = len(initial) + p
        toks = torch.zeros((1, graphs.CACHE_SLOTS), dtype=torch.int32, device=DEV)
        toks[0, :n] = torch.tensor(initial + list(f[:p]), dtype=torch.int32)
        with torch.inference_mode():
            hidden, _ = graphs.prefill(dec, toks[:, :n], n, ck[:, a : a + 1], cv[:, a : a + 1],
                                       n_head=model.dims.n_text_head)  # fmt: skip
            lg = graphs.hidden_to_logits(dec, hidden[:, n - 1])
            lp = torch.log_softmax(bk.apply_filters(lg, toks, n, len(initial), *pens, **filt), dim=-1)[0]
        top = lp.topk(2)
        pair = (int(f[p]), int(sp[p]))
        out.append(dict(
            common_prefix=p, tokens=list(pair), top2=top.indices.tolist(),
            top2_gap=(top.values[0] - top.values[1]).item(),
            ranks=[int((lp > lp[t]).sum()) + 1 for t in pair], logprob_of_tokens=[lp[t].item() for t in pair],
        ))  # fmt: skip
    return out


def bench_tools_phase(model, card):
    """The load and latency tools (whisper_tpu_torch/<tool>.py) through
    their run() cores on the turbo model, each at a cut size, the counts set
    to 0 before each and read after it: each tool's seconds and launches,
    and its loop kernel launched (BENCH_TOOLS_KERNEL; graph_bench's
    alignment replay launches the median filter too). Held: the soak's
    errors 0 and its drained server empty; spec_bench's accept1 at K = 4
    accepting every draft (acceptance 1.0); trace_ops' trace holding device
    ops; serve_bench's world of one over NCCL capturing its body, its tokens
    the single engine's; spec_bench again on float32 models (turbo and its
    draft), whose speculative tokens must equal the plain engine's in both
    brackets; in bf16, where accept0's tokens part from the plain engine's,
    both tokens within the top three of a prefill's filtered log-probs
    there (spec_parting: a near-tie, not a row's logits mixed up). Logged:
    the batcher's captures, re-captures and program keys; the bf16
    parting. Returns the launches of all the tools."""
    from whisper_tpu_torch import (
        continuous_bench, graph_bench, serve_bench, soak_server, spec_bench, streaming_latency,
        throughput_bench, trace_ops,
    )  # fmt: skip

    t_phase = time.perf_counter()
    tools, total = {}, {}

    def run(name, fn):
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = launch_counts()
        if not counts[BENCH_TOOLS_KERNEL[name]]:
            raise AssertionError(f"{name} never launched {BENCH_TOOLS_KERNEL[name]}: {counts}")
        tools[name] = {"seconds": seconds, "launches": {k: v for k, v in counts.items() if v}}
        add_counts(total, counts)
        return out

    cont = run("continuous_bench", lambda: continuous_bench.run_serving_bench(model, 4, 4))
    tools["continuous_bench"].update(
        makespan_s=[cont["makespan_s"], cont["warm_pass"]["makespan_s"]],
        latency_p95_s=[cont["latency_p95_s"], cont["warm_pass"]["latency_p95_s"]],
        aggregate_rtfx=[cont["aggregate_rtfx"], cont["warm_pass"]["aggregate_rtfx"]],
        captures=cont["captures_total"], recaptures=cont["recaptures_total"],
        program_keys=cont["program_keys_total"],
    )  # fmt: skip
    tp = run("throughput_bench", lambda: throughput_bench.run(model, streams=2, seconds=30, trials=1))
    tools["throughput_bench"].update(value=tp["value"], p50_batch_latency_s=tp["p50_batch_latency_s"],
                                     recaptures=tp["recaptures"])  # fmt: skip
    sl = run("streaming_latency", lambda: streaming_latency.run(model, 6))
    tools["streaming_latency"].update(first_partial_s=sl["first_partial_s"], partials=sl["partials"],
                                      partial_feed_p50_s=sl["partial_feed_p50_s"])  # fmt: skip
    soak = run("soak_server", lambda: soak_server.run(soak_server.synthetic_model(DEV), 24, 2, 4))
    if soak["errors"] or soak["ok"] != 24 or not soak["state_empty_after_drain"]:
        raise AssertionError(f"the soak: {soak}")
    tools["soak_server"].update({k: soak[k] for k in (
        "ok", "errors", "state_empty_after_drain", "rss_start_mb", "rss_end_mb", "rss_growth_tail_mb_per_100req",
        "device_mem_start_mb", "device_mem_end_mb", "device_mem_growth_tail_mb_per_100req")})  # fmt: skip
    spec = run("spec_bench", lambda: spec_bench.run(model, spec_bench.draft_model(model, "tiny", DEV), ks=(4,),
                                                    trials=1))  # fmt: skip
    upper = next(r for r in spec["records"] if r["bracket"] == "accept1" and r["K"] == 4)
    if upper["measured_acceptance"] != 1.0 or not upper["all_accepted"]:
        raise AssertionError(f"spec_bench's accept1 at K = 4: {upper}")
    spec_keys = ("engine", "bracket", "K", "p50_decode_s", "vs_fused", "measured_acceptance", "tokens_equal_fused",
                 "captured")  # fmt: skip
    tools["spec_bench"]["records"] = [{k: r[k] for k in spec_keys} for r in spec["records"]]
    parting = spec_parting(model, spec["tokens"][("fused_greedy", "accept0", None)],
                           spec["tokens"][("speculative", "accept0", 4)])  # fmt: skip
    tools["spec_bench"]["accept0_parting"] = parting
    if any(w and max(w["ranks"]) > 3 for w in parting):
        raise AssertionError(f"spec_bench's bf16 accept0 parts from plain on no near-tie: {parting}")
    f32 = Whisper(model.dims, None, name=model.name, device=DEV, compute_dtype=torch.float32, seed=0)
    spec32 = run("spec_bench_float32", lambda: spec_bench.run(f32, spec_bench.draft_model(f32, "tiny", DEV),
                                                              ks=(4,), trials=1))  # fmt: skip
    del f32
    tools["spec_bench_float32"]["records"] = [{k: r[k] for k in spec_keys} for r in spec32["records"]]
    if not all(r["tokens_equal_fused"] for r in spec32["records"]):
        raise AssertionError(f"spec_bench at float32: speculative tokens differ from plain: {spec32['records']}")
    gb = run("graph_bench", lambda: graph_bench.run(model, trials=3))
    if not tools["graph_bench"]["launches"].get("median_filter"):
        raise AssertionError(f"graph_bench's alignment replay never launched the median filter: {tools}")
    tools["graph_bench"].update(
        steady_ms={k: v["steady_ms"] for k, v in gb["timings"].items()},
        pct_of_roofline={k: v["pct_of_roofline"] for k, v in gb["roofline"].items()},
    )  # fmt: skip
    to = run("trace_ops", lambda: trace_ops.run(model, 2, "decode"))
    if not to["device_ops"]:
        raise AssertionError("trace_ops: the profiler captured no device op")
    tools["trace_ops"].update(total_ms_per_iter=to["total_ms_per_iter"], by_category=to["by_category_ms_per_iter"])
    opts = dict(model="turbo", compute_dtype="bfloat16", device_type="cuda", dp=1, tp=1, streams=2, beam=5,
                steps=96, trials=1, skip_single=False)  # fmt: skip
    sb = run("serve_bench", lambda: serve_bench.launch(opts, model=model))
    if not (sb["sharded_captured"] and sb["tokens_equal_single"] and sb["backend"] == "nccl"):
        raise AssertionError(f"serve_bench at a world of one: {dict(sb, tokens=None)}")
    tools["serve_bench"].update(sharded_ms_per_step=sb["sharded_ms_per_step"],
                                sharding_overhead_x=sb["sharding_overhead_x"])  # fmt: skip
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "bench_tools", "seconds": time.perf_counter() - t_phase, "tools": tools,
                    "launches": total, "card": card}))  # fmt: skip
    return total


def matmul_grads(dims):
    """graphs.matmul_f32 on bf16 operands needing gradients (the autograd
    Function) at the training path's shapes at `dims`' width: the logits
    head (B·T, d) x (d, V), encoder self-attention scores, cross-attention
    scores, and cross-attention scores whose K is shared over the batch
    (broadcast): the forward equal bit for bit to the product without
    autograd, each gradient within one bf16 ulp of the widened form's."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    d, H, V_ = dims.n_text_state, dims.n_text_head, dims.n_vocab
    shapes = {
        "logits": ((254, d), (d, V_)),
        "encoder_scores": ((2, H, 1500, 64), (2, H, 64, 1500)),
        "cross_scores": ((2, H, 127, 64), (2, H, 64, 1500)),
        "broadcast_scores": ((2, H, 127, 64), (1, H, 64, 1500)),
    }
    out = {}
    for name, (sa, sb) in shapes.items():
        a = (torch.randn(sa, generator=gen, device=DEV) * 0.5).bfloat16().requires_grad_(True)
        b = (torch.randn(sb, generator=gen, device=DEV) * 0.5).bfloat16().requires_grad_(True)
        y = graphs.matmul_f32(a, b)
        if y.grad_fn is None or type(y.grad_fn).__name__ != "_MatmulF32Backward":
            raise AssertionError(f"{name}: matmul_f32 did not go through the Function ({y.grad_fn})")
        with torch.no_grad():
            same = torch.equal(y, graphs.matmul_f32(a, b))
        g = torch.randn(y.shape, generator=gen, device=DEV)
        got = torch.autograd.grad(y, (a, b), g)
        want = torch.autograd.grad(a.float() @ b.float(), (a, b), g)
        ulps = []
        for x, w in zip(got, want):
            ulp = torch.finfo(torch.bfloat16).eps * w.float().abs().clamp(min=2**-126)
            ulps.append(((x.float() - w.float()).abs() / ulp).max().item())
        if not same or max(ulps) > 1 or any(x.dtype != torch.bfloat16 for x in got):
            raise AssertionError(f"{name}: forward equal {same}, gradients {ulps} bf16 ulps")
        out[name] = dict(forward_equal=same, grad_ulps=ulps)
    return out


def train_card_vs_cpu():
    """At tiny dims in float32 (TF32 off), one model on the card and on the
    CPU: the gradients of one loss_fn call (rtol 1e-4, atol 1e-6), the loss
    histories of run_finetune and of run_distill (rtol 1e-4), and the card's
    distilled draft attached: speculative tokens equal plain greedy's (the
    float32 gate)."""
    from whisper_tpu_torch import load_model
    from whisper_tpu_torch.distill import run_distill
    from whisper_tpu_torch.finetune import batches, model_tokenizer, run_finetune
    from whisper_tpu_torch.parallel.train import device_batch, init_train_state, loss_fn

    dims = ModelDimensions(80, 1500, 128, 2, 2, 51866, 448, 128, 2, 2)
    params = tiny_params(dims, seed=11)
    models = {
        "card": Whisper(dims, params, device=DEV, compute_dtype=torch.float32),
        "cpu": Whisper(dims, params, device="cpu", compute_dtype=torch.float32),
    }
    tok = model_tokenizer(models["cpu"], "en")
    batch = next(batches(train_records(), tok, n_mels=80, batch_size=2, max_tokens=48))
    grads, losses, ft, dl = {}, {}, {}, {}
    kw = dict(steps=4, batch_size=2, learning_rate=1e-3, max_tokens=48, log=lambda *_: None)
    for dev, m in models.items():
        p = init_train_state(m.params, 1e-3, 0.01).params
        loss = loss_fn(p, device_batch(batch, m.device), n_audio_head=2, n_text_head=2)
        loss.backward()
        losses[dev] = loss.item()
        grads[dev] = {k: v.grad.cpu() for k, v in flatten_tree(p)}
        ft[dev] = run_finetune(m, train_records(), out_dir=train_dir(f"tiny_ft_{dev}"), **kw)
        dl[dev] = run_distill(m, TINY_STUDENT, train_records(), out_dir=train_dir(f"tiny_draft_{dev}"), **kw)
    worst = 0.0
    for k, g in grads["card"].items():
        want = grads["cpu"][k]
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
        worst = max(worst, (g - want).abs().max().item())
    np.testing.assert_allclose(losses["card"], losses["cpu"], rtol=1e-5)
    np.testing.assert_allclose(ft["card"], ft["cpu"], rtol=1e-4)
    np.testing.assert_allclose(dl["card"], dl["cpu"], rtol=1e-4)
    falling(ft["card"], "tiny fine-tune")
    falling(dl["card"], "tiny distillation")

    gpu = models["card"]
    draft = load_model(os.path.join(TRAIN_DIR, "tiny_draft_card"), device=DEV, compute_dtype=torch.float32)
    window = first_window(gpu, load_audio(JFK_PATH))
    opts = DecodingOptions(language="en", temperature=0.0)
    plain = decode(gpu, window, opts)
    gpu.set_draft_model(draft, k=4)
    try:
        reset_launch_counts()
        spec = decode(gpu, window, opts)
        counts = launch_counts()
    finally:
        gpu.set_draft_model(None)
    if spec.tokens != plain.tokens or not counts["greedy_argmax_rows_state"]:
        raise AssertionError(f"float32: the distilled draft's tokens differ ({counts})")
    return dict(
        grad_max_abs_err=worst, loss=losses, finetune_losses=ft, distill_losses=dl,
        spec_tokens_equal_f32=True, spec_tokens=len(spec.tokens),
    )  # fmt: skip


def train_profile(model):
    """One profiled turbo train step at batch 2 (after an unprofiled one):
    its wall ms, device-busy ms (the union of the kernels' intervals), idle
    share, kernel count, and the five kernels of most device time (summed
    by name), the user annotations (AdamW's range) left out."""
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.finetune import batches, model_tokenizer
    from whisper_tpu_torch.parallel.train import make_train_step

    tok = model_tokenizer(model, "en")
    batch = next(batches(train_records(), tok, n_mels=model.dims.n_mels, batch_size=2, max_tokens=128))
    init_state, train_step = make_train_step(model.dims, learning_rate=1e-3)
    state = init_state(model.params)
    state, loss = train_step(state, batch)
    float(loss)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = train_step(state, batch)
        float(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        # the optimizer's range also shows on the card's timeline: not a kernel
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    )
    busy, end, by_name = 0.0, spans[0][0], {}
    for start, stop, name in spans:
        by_name[name] = by_name.get(name, 0.0) + stop - start
        start = max(start, end)
        if stop > start:
            busy, end = busy + stop - start, stop
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    del state
    torch.cuda.empty_cache()
    return dict(
        wall_ms=wall * 1e3, device_busy_ms=busy / 1e3, device_idle_share=1 - busy / 1e3 / (wall * 1e3),
        kernels=len(spans), top5=[dict(name=n[:120], ms=us / 1e3) for n, us in top],
    )  # fmt: skip


def train_phase(model, jfk, card):
    """The training slice: the Function's gradients, card against CPU at
    tiny dims, the turbo fine-tune with the backward's unbind / select
    timing, the distilled-draft eval phase. Returns the launches of its
    decodes (the counts set to 0 before each and read after it)."""
    t = time.perf_counter()
    log(json.dumps({"phase": "train_matmul_grads", **matmul_grads(model.dims)}))
    log(json.dumps({"phase": "train_card_vs_cpu", **train_card_vs_cpu()}))
    ft, ft_counts = finetune_phase(model, jfk)
    log(json.dumps({"phase": "train_finetune", **ft, "launches": ft_counts, "card": card}))
    log(json.dumps({"phase": "train_backward", **backward_ms(model), "card": card}))
    dl, dl_counts = eval_phase(model)
    log(json.dumps({"phase": "train_spec_eval", **dl, "launches": dl_counts, "card": card}))
    counts = {k: ft_counts[k] + dl_counts[k] for k in ft_counts}
    if not counts["greedy_argmax"] or not counts["greedy_argmax_rows_state"]:
        raise AssertionError(f"the train phase launched a greedy kernel no time: {counts}")
    log(json.dumps({"phase": "train", "seconds": time.perf_counter() - t, "launches": counts}))
    return counts



MESH_ENCODER_LAYERS = 8  # (b)'s turbo-width model: the encoder cut from 32 layers
# (b)'s and (c)'s engine windows: 128 tokens after the 3-token prompt cross
# the 128-slot phase edge (the uncaptured body over gloo pays its tp
# all-reduces a pass, ~30 ms a token at tp = 2 on an NVIDIA H100 80GB HBM3 at 700 W)
MESH_SAMPLE_LEN = 128


def two_windows(model, audio):
    """The clip's first two 30 s mel windows on the card, (2, n_mels, 3000)."""
    from whisper_tpu_torch.ops.stft import device_mel_full, device_mel_window

    mel, _ = device_mel_full(audio, model.dims.n_mels, DEV)
    return torch.stack([device_mel_window(mel, seek, 3000) for seek in (0, 3000)])


def segment_tokens(result):
    return [s["tokens"] for s in result["segments"]]


def engine_ms(engine):
    """Wall ms per step of the engine's latest run (its history)."""
    run = engine.history[-1]
    return run.seconds / run.steps * 1e3


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def allreduce_ms(group, shape, reps=100):
    """Host ms of one dist.all_reduce of a float32 tensor of `shape` on the
    card over `group`, synchronized after each (the median of `reps`, after
    one untimed)."""
    x = torch.ones(shape, device=DEV)
    times = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.distributed.all_reduce(x, group=group)
        torch.cuda.synchronize()
        if i >= 1:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def nccl_capture_probe(rows=2, width=1280):
    """(a'): one dist.all_reduce and one dist.all_gather_into_tensor on the
    world group, called directly (comm.py does nothing on a group of one),
    captured in a torch.cuda.CUDAGraph on a side stream after an uncaptured
    warm-up (the communicator is made at its first collective, which must
    not happen inside a capture), then replayed on new inputs and held
    against the same collectives uncaptured on those inputs (exact)."""
    dist = torch.distributed
    n = dist.get_world_size()
    x = torch.zeros((rows, width), device=DEV)
    reduced, gathered = torch.zeros_like(x), torch.zeros((n * rows, width), device=DEV)

    def body():
        reduced.copy_(x)
        dist.all_reduce(reduced)
        dist.all_gather_into_tensor(gathered, x)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        body()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        body()
    gen = torch.Generator(device=DEV).manual_seed(3)
    same = True
    for _ in range(3):
        x.copy_(torch.randn(x.shape, device=DEV, generator=gen))
        graph.replay()
        want_reduced, want_gathered = x.clone(), torch.empty_like(gathered)
        dist.all_reduce(want_reduced)
        dist.all_gather_into_tensor(want_gathered, x)
        torch.cuda.synchronize()
        same = same and torch.equal(reduced, want_reduced) and torch.equal(gathered, want_gathered)
    if not same:
        raise AssertionError("(a') the captured NCCL collectives differ from the uncaptured ones")
    return {"world": n, "backend": dist.get_backend(), "replays": 3, "equal": same}


def check_mesh_captured(what, stats):
    """Every engine run of a main_path() run on the mesh ran the loop
    program captured: its bodies captured and replayed."""
    p = "spec_" if "spec_loops" in stats else ""
    if stats[p + "loops"] != ["program"] or stats[p + "captured"] != [True] or not (
        stats[p + "replays"] > 0 and stats[p + "captures"] > 0
    ):
        raise AssertionError(f"{what}: not the captured loop program: {stats}")


def loop_program(run, captured):
    """Whether an EngineRun or SpecRun ran the loop program as `captured`
    says: its body captured and replayed, else only uncaptured passes."""
    if run.loop != "program" or run.captured != captured:
        return False
    if captured:
        return run.replays > 0 and run.captures > 0
    return run.captures == run.replays == 0 < run.bodies


def mesh_world1(audio):
    """(a), in the one rank of a world of one over NCCL: the turbo model
    (bf16, seed 0) transcribes the clip greedy, at beam 5 (T = 0) and
    greedy with the 5g draft (bf16), in turns plain, then under
    set_mesh(make_mesh()), through main_path (the launches held to the
    records): the mesh's engines capture their loop bodies (dp = tp = 1
    run no collective, so the arithmetic is the plain model's) and their
    tokens must equal the plain model's. Then (a') the capture probe; one
    fine-tune step through make_train_step with and without the mesh: equal
    losses; and the host ms of one NCCL all-reduce of a decode step's
    activation at world 1. Returns the mesh runs' launches, each run's ms
    per token and each part's seconds."""
    from whisper_tpu_torch.finetune import batches, model_tokenizer
    from whisper_tpu_torch.parallel import make_mesh
    from whisper_tpu_torch.parallel.train import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    build.load_library()
    model = Whisper(MODEL_DIMS["turbo"], None, device=DEV, compute_dtype=torch.bfloat16, seed=0)
    model.transcribe(audio[: 16000 * 5], language="en", temperature=0.0, verbose=None)  # warm-up
    draft = spec_draft(torch.bfloat16)
    runs = {
        "greedy": dict(temperature=0.0), "beam5": dict(beam_size=5, temperature=0.0),
        "greedy_draft": dict(temperature=0.0, draft=draft),
    }  # fmt: skip
    out, counts, seconds = {"backend": torch.distributed.get_backend()}, {}, {}
    mesh = make_mesh()
    tokens = {}
    for name, kw in runs.items():
        t = time.perf_counter()
        for which in ("plain", "mesh"):
            model.set_mesh(mesh if which == "mesh" else None)
            stats, launches, result = main_path(model, audio, **kw)
            tokens[name, which] = segment_tokens(result)
            if which == "mesh":
                add_counts(counts, launches)
                out["engine"] = type(model._fused_engine).__name__
                check_mesh_captured(f"(a) {name}", stats)
            out[f"{name}_{which}_ms_per_token"] = stats["ms_per_token"]
            out[f"{name}_{which}_captures"] = stats.get("spec_captures", stats["captures"])
        if tokens[name, "mesh"] != tokens[name, "plain"]:
            raise AssertionError(f"(a) {name}: the mesh run's tokens differ from the plain model's")
        seconds[name] = time.perf_counter() - t
    model.set_mesh(None)
    # bf16: the verify pass's products have other shapes than the step's
    out["greedy_draft_equals_greedy"] = tokens["greedy_draft", "mesh"] == tokens["greedy", "plain"]
    t = time.perf_counter()
    out["nccl_capture_probe"] = nccl_capture_probe()
    out["nccl_allreduce_ms_1x1280"] = allreduce_ms(None, (1, 1, 1280))
    seconds["nccl_probe"] = time.perf_counter() - t
    t = time.perf_counter()
    batch = next(batches(train_records(), model_tokenizer(model, "en"), n_mels=128, batch_size=2, max_tokens=128))
    losses = []
    for m in (None, mesh):
        init_state, step = make_train_step(model.dims, m, learning_rate=1e-3)
        state, loss = step(init_state(model.params), batch)
        losses.append(float(loss))
        del state
        torch.cuda.empty_cache()
    if losses[0] != losses[1] or not np.isfinite(losses[0]):
        raise AssertionError(f"(a) the mesh's fine-tune step loss {losses[1]} != {losses[0]}")
    seconds["finetune"] = time.perf_counter() - t
    out.update(finetune_step_loss=losses[0], launches=counts, seconds=seconds)
    return out


def mesh_engine_parts(model, meshes, mel, captured, beams, counts, out, part, spec_draft_dtype=None):
    """DataParallelEngine on each mesh of `meshes` on the two windows `mel`,
    greedy and (in `beams`) beam 5 at T = 0, MESH_SAMPLE_LEN tokens (the
    128-slot phase edge crossed), against the plain engine on
    the same engine arguments: equal tokens, step count and beam pools; the
    loop-body program, captured or not as `captured` says, the launches
    held to the records (engine_want). With `spec_draft_dtype`, the
    speculative engine at dp = 2 with the 5g draft: plain greedy's tokens.
    Fills out["passes"] (each engine run's body passes, which every rank
    must share) and the ms per token."""
    from whisper_tpu_torch.parallel import DataParallelEngine, DataParallelSpeculativeEngine

    passes = out.setdefault("passes", {})
    for beam in beams:
        what = "beam5" if beam else "greedy"
        opts = DecodingOptions(language="en", temperature=0.0, beam_size=beam, sample_len=MESH_SAMPLE_LEN)
        (args, kw), _ = engine_call(model, mel, opts)
        plain_engine = FusedEngine(model)
        want = plain_engine.run(*args, **kw)
        out[f"{what}_plain_ms_per_token"] = engine_ms(plain_engine)
        for name, mesh in meshes.items():
            engine = DataParallelEngine(model, mesh)
            reset_launch_counts()
            got = engine.run(*args, **kw)
            torch.cuda.synchronize()
            launched = launch_counts()
            add_counts(counts, launched)
            run = engine.history[-1]
            n = want[1]
            same = got[1] == n and np.array_equal(got[0][:, :n], want[0][:, :n])
            if beam:
                same = same and np.array_equal(got[4], want[4]) and np.array_equal(got[7], want[7])
            if not same:
                raise AssertionError(f"{name} {what}: the engine's tokens differ from the plain engine's")
            if not loop_program(run, captured) or launched != engine_want([run]):
                raise AssertionError(f"{name} {what}: {run}, launches {launched} != {engine_want([run])}")
            passes[f"{what}_{name}"] = run.replays + run.bodies
            out[f"{what}_{name}_ms_per_token"] = engine_ms(engine)
            part(f"{what}_{name}")
        if not beam and spec_draft_dtype is not None:
            draft = spec_draft(spec_draft_dtype)
            dck, dcv = draft.cross_kv(draft.encode(mel))
            spec = DataParallelSpeculativeEngine(model, draft, meshes["dp2"], k=4)
            reset_launch_counts()
            got = spec.run(*args, dck, dcv, **kw)
            torch.cuda.synchronize()
            launched = launch_counts()
            add_counts(counts, launched)
            run = spec.history[-1]
            n = want[1]
            if got[1] != n or not np.array_equal(got[0][:, :n], want[0][:, :n]):
                raise AssertionError("dp2 speculative: tokens differ from plain greedy's")
            # the round at dp = 2 uses no group (tp = sp = 1): it captures
            if not loop_program(run, True) or launched != engine_want([], spec=[run]):
                raise AssertionError(f"dp2 speculative: {run}, launches {launched}")
            stats = spec.last_stats
            out["spec_dp2_tokens_per_round"] = sum(stats["emitted"]) / max(sum(stats["rounds"]), 1)
            # each dp group runs its own rounds: the ranks' passes may differ
            out["spec_dp2_captured"], out["spec_dp2_passes"] = run.captured, run.replays + run.bodies
            part("spec_dp2")


def world2_setup(axes):
    """What (b) and (c) share, in each rank of a world of two: the
    turbo-width model with its encoder cut to MESH_ENCODER_LAYERS layers,
    float32 with TF32 off (seed 0), a mesh of two ranks on each of `axes`
    ("dp2", "tp2", ...), the result's dicts (out, counts, seconds) and the
    part clock: part(name) records the seconds since the previous part."""
    from whisper_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load_library()
    dims = dataclasses.replace(MODEL_DIMS["turbo"], n_audio_layer=MESH_ENCODER_LAYERS)
    model = Whisper(dims, None, device=DEV, compute_dtype=torch.float32, seed=0)
    meshes = {k: make_mesh(**{k[:2]: 2}) for k in axes}
    out, counts, seconds = {"backend": torch.distributed.get_backend()}, {}, {}
    clock = [time.perf_counter()]

    def part(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

    return model, meshes, out, counts, seconds, part


def mesh_world2(audio, jfk):
    """(b), in each rank of a world of two sharing the card over gloo: the
    turbo-width model with its encoder cut to MESH_ENCODER_LAYERS layers,
    float32 with TF32 off (seed 0). DataParallelEngine at dp = 2 and at tp
    = 2 on two windows, greedy and beam 5, against the plain engine on the
    same engine arguments (mesh_engine_parts): equal tokens, step count and
    beam pools, the loop body run uncaptured (gloo: no capture, no replay);
    the speculative engine at dp = 2 with the 5g draft (float32): plain
    greedy's tokens; sp_encode at sp = 2 and pp_encode at pp = 2 against
    encode (max abs error, within 1e-3); 2 fine-tune steps at tp = 2
    against single-device ones (rtol 1e-4) and the gathered tree's largest
    difference from the single-device one; transcribe(jfk,
    word_timestamps=True) at tp = 2 against the plain model: equal words
    and times; the host ms of one gloo all-reduce over the tp group of a
    decode step's activation and of a training one. Every rank runs every
    part, so each plain run shares the card with the other rank's. The
    speculative engine runs at dp = 2: at tp = 2 its ~1,000 draft passes
    would each pay the gloo all-reduces (the CPU tests hold it at tp = 2).
    Returns the mesh runs' launches, their passes (which the ranks must
    share), ms per token and each part's seconds."""
    from whisper_tpu_torch.finetune import batches, model_tokenizer
    from whisper_tpu_torch.parallel import pp_encode, shard_params, sp_encode
    from whisper_tpu_torch.parallel.sharding import gather_params
    from whisper_tpu_torch.parallel.train import make_train_step

    model, meshes, out, counts, seconds, part = world2_setup(("dp2", "tp2", "sp2", "pp2"))
    mel = two_windows(model, audio)
    engines = {k: meshes[k] for k in ("dp2", "tp2")}
    mesh_engine_parts(model, engines, mel, False, (None, 5), counts, out, part, spec_draft_dtype=torch.float32)

    xa = model.encode(mel)
    for name, build_fn in (("sp2", sp_encode), ("pp2", pp_encode)):
        got = build_fn(model, meshes[name])(shard_params(model.params["encoder"], meshes[name]), mel)
        err = float((got - xa).abs().max())
        out[f"{name}_encode_max_abs_err"] = err
        if not err <= 1e-3:
            raise AssertionError(f"(b) {name}_encode differs from encode by {err}")
    part("encoders")

    tok = model_tokenizer(model, "en")
    data = batches(train_records(), tok, n_mels=128, batch_size=2, max_tokens=128)
    steps = [next(data) for _ in range(2)]
    histories, trees = [], []
    for m in (None, meshes["tp2"]):
        init_state, step = make_train_step(model.dims, m, learning_rate=1e-3)
        state = init_state(model.params)
        histories.append([float(step(state, b)[1]) for b in steps])
        tree = state.params if m is None else gather_params(state.params, m)
        trees.append({k: v.detach() for k, v in flatten_tree(tree)})
        del state
        torch.cuda.empty_cache()
    if not np.allclose(histories[1], histories[0], rtol=1e-4, atol=0):
        raise AssertionError(f"(b) tp2 fine-tune losses {histories[1]} vs single-device {histories[0]}")
    out["finetune_losses"] = histories
    out["finetune_params_max_abs_diff"] = max(float((trees[1][k] - v).abs().max()) for k, v in trees[0].items())
    del trees
    part("finetune")

    words = dict(language="en", temperature=0.0, word_timestamps=True, verbose=None)
    want = words_of(model.transcribe(jfk, **words))
    model.set_mesh(meshes["tp2"])
    try:
        reset_launch_counts()
        got = words_of(model.transcribe(jfk, **words))
        torch.cuda.synchronize()
        add_counts(counts, launch_counts())
    finally:
        model.set_mesh(None)

    part("words")
    tp = meshes["tp2"].get_group("tp")
    out["gloo_allreduce_ms_1x1280"] = allreduce_ms(tp, (1, 1, 1280))
    out["gloo_allreduce_ms_2x1500x1280"] = allreduce_ms(tp, (2, 1500, 1280), reps=5)

    def timed_words(ws):
        return [(w["word"], w["start"], w["end"]) for w in ws]

    if not got or timed_words(got) != timed_words(want):
        raise AssertionError("(b) tp2 word timestamps differ from the plain model's")
    out.update(
        words=len(got), launches=counts, seconds=seconds,
        word_probability_max_abs_diff=max(abs(a["probability"] - b["probability"]) for a, b in zip(got, want)),
    )  # fmt: skip
    return out


def mesh_world2_nccl(audio):
    """(c), in each rank of a world of two over NCCL, one card a rank (only
    where the machine has two cards or more): the model of (b) (turbo
    width, encoder cut, float32, TF32 off); DataParallelEngine at dp = 2
    and tp = 2, greedy on two windows, its loop body captured with the
    collectives inside (the tp all-reduces, the done count's all-reduce
    over dp) and replayed: tokens and step count equal to the plain
    engine's (mesh_engine_parts)."""
    model, meshes, out, counts, seconds, part = world2_setup(("dp2", "tp2"))
    mesh_engine_parts(model, meshes, two_windows(model, audio), True, (None,), counts, out, part)
    out.update(launches=counts, seconds=seconds)
    return out


def same_passes(ranks, what):
    """Every rank ran the same loop passes in every part (rank lockstep:
    each pass issues the same collectives)."""
    passes = [r["passes"] for r in ranks]
    if any(p != passes[0] for p in passes[1:]):
        raise AssertionError(f"{what}: the ranks ran different passes: {passes}")


def parallel_phase(audio, jfk, card):
    """The mesh on the card (parallel/): (a) a world of one over NCCL, its
    engines' loop bodies captured, and (a') the NCCL capture probe; (b) two
    ranks sharing the card over gloo, the bodies run uncaptured; (c) a
    world of two over NCCL, one card a rank, where the machine has two
    cards (else a line saying it did not run). Each is spawned from here
    after the kernels are built (mesh_world1, mesh_world2,
    mesh_world2_nccl); a failed rank fails the phase. Returns the launches
    of the mesh runs, summed over the ranks."""
    from whisper_tpu_torch.parallel.launch import spawn

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counts = {}
    t = time.perf_counter()
    (a,) = spawn(mesh_world1, 1, audio, device_type="cuda", timeout=600)
    add_counts(counts, a["launches"])
    a["seconds_world1"] = time.perf_counter() - t
    log(json.dumps({"phase": "parallel_world1_nccl", **a, "card": card}))
    t = time.perf_counter()
    b = spawn(mesh_world2, 2, audio, jfk, device_type="cuda", backend="gloo", timeout=600)
    same_passes(b, "(b)")
    for rank, r in enumerate(b):
        add_counts(counts, r["launches"])
        log(json.dumps({"phase": "parallel_world2_gloo", "rank": rank, **r, "card": card}))
    log(json.dumps({"phase": "parallel_world2_gloo", "seconds_world2": time.perf_counter() - t}))
    t = time.perf_counter()
    if torch.cuda.device_count() >= 2:
        c = spawn(mesh_world2_nccl, 2, audio, device_type="cuda", timeout=600)
        same_passes(c, "(c)")
        for rank, r in enumerate(c):
            add_counts(counts, r["launches"])
            log(json.dumps({"phase": "parallel_world2_nccl", "rank": rank, **r, "card": card}))
        log(json.dumps({"phase": "parallel_world2_nccl", "seconds_world2_nccl": time.perf_counter() - t}))
    else:
        log(json.dumps({
            "phase": "parallel_world2_nccl", "ran": False, "cards": torch.cuda.device_count(),
            "why": "NCCL takes one rank a card and this machine has one: captured collectives "
                   "between ranks are not checked here ((a') captures them at world 1)",
        }))  # fmt: skip
    log(json.dumps({"phase": "parallel", "launches": counts}))
    # the mesh's engines run the loop programs: a scalar launch at step 0,
    # then loop-state launches; no per-row launch without the loop state
    # (the host loop's, which no engine runs on its main path)
    missing = [k for k, n in counts.items() if n == 0 and k != "greedy_argmax_rows"]
    if missing or counts["greedy_argmax_rows"]:
        raise AssertionError(f"the mesh runs launched {missing} no time, or a host loop's launch: {counts}")
    return counts


# ---- export_runtime: torch.export, AOTInductor and the native runner -------

EXPORT_DIR = os.path.join(ROOT, "smoke", "_build", "export")
EXPORT_TINY_DIMS = ModelDimensions(80, 1500, 128, 2, 2, 51866, 448, 128, 2, 2)
# the English-only layout (the gpt2 encoding: V = 51864, sample_begin 1) of the int8 pipeline
EXPORT_TINY_EN_DIMS = ModelDimensions(80, 1500, 128, 2, 2, 51864, 448, 128, 2, 2)
STEP_BEAM_SRC = (2, 0, 1, 4, 3)  # the reorder the turbo beam step is checked with


def write_wav(path, audio):
    """16 kHz mono 16-bit PCM, for the runner's audio decoder."""
    import wave

    pcm = np.clip(np.round(np.asarray(audio) * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return path


def runner_lines(stderr):
    return [json.loads(line[6:]) for line in stderr.splitlines() if line.startswith("[wtt] {")]


def done_lag(pdir):
    """The done flag's lag in passes that the pipeline's loop.txt gives the
    runner (export.loop_manifest)."""
    with open(os.path.join(pdir, "loop.txt")) as f:
        (lag,) = [int(line.split()[1]) for line in f if line.startswith("done_lag ")]
    return lag


def check_attempt(a, lag):
    """A runner attempt's counts: at T = 0 one scalar launch (step 0) and
    one loop-state launch, counted on the card by the kernel, per replay
    and per uncaptured pass (capture warm-ups included); none when
    sampling. A captured run's uncaptured passes are its warm-ups, one a
    capture; a pass a token after step 0, and at most `lag` (the done
    lag) after the finish; a done read a pass but the first `lag`."""
    scalar = a["greedy_launches"] + a["beam_launches"]
    state = a["greedy_state_launches"] + a["beam_state_launches"]
    passes = a["replays"] + a["bodies"]
    t0 = a["temperature"] == 0
    loop_passes = passes - a["captures"]
    ok = (scalar == (1 if t0 else 0) and state == (passes if t0 else 0)
          and (a["bodies"] == a["captures"] if a["loop"] == "captured" else a["replays"] == a["captures"] == 0)
          and a["steps"] - 1 <= loop_passes <= a["steps"] - 1 + lag
          and a["done_reads"] == max(loop_passes - lag, 0))  # fmt: skip
    if not ok:
        raise AssertionError(f"the runner's launches, passes or reads do not match its steps: {a}")


def run_runner(binary, pdir, audio_path, *flags, timeout=600):
    """One single-shot run of wtt_transcribe: its transcript, its attempt
    lines (one per decode of a window, the accepted one marked, each held
    by check_attempt), the file's summary line, and its wall seconds
    (process start, graph loads and weight uploads included)."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [binary, pdir, audio_path, *flags], capture_output=True, text=True, errors="replace",
        timeout=timeout,
    )  # fmt: skip
    if res.returncode != 0:
        raise AssertionError(f"wtt_transcribe {flags} exited {res.returncode}: {res.stderr[-3000:]}")
    lines = runner_lines(res.stderr)
    (summary,) = [line for line in lines if "file" in line]
    attempts = [line for line in lines if "window" in line]
    lag = done_lag(pdir)
    for a in attempts:
        check_attempt(a, lag)
    other = [line for line in res.stderr.splitlines() if not line.startswith("[wtt]")]
    return dict(text=res.stdout, attempts=attempts, summary=summary, seconds=time.perf_counter() - t0,
                loads=[line for line in res.stderr.splitlines() if "loaded in" in line],
                other_stderr=[len(other), sorted(set(line[:160] for line in other))[:4]])  # fmt: skip


def accepted_tokens(run):
    """The tokens the runner kept: each window's accepted, not skipped
    attempt (what --serve replies with)."""
    return [t for a in run["attempts"] if a["accepted"] and not a["skipped"] for t in a["token_ids"]]


def pipeline_manifest(pdir):
    with open(os.path.join(pdir, "pipeline.txt")) as f:
        return dict(line.rstrip("\n").split(" ", 1) for line in f)


def ranked_tokens(out, P, eot, G):
    """The runner's choice from FusedEngine.run's outputs (wtt_transcribe.cpp
    decode_window): greedy's row up to EOT; at beam (G > 0) the finished
    pool topped up with live beams by sum_logprob, ranked by score / length."""
    toks, n, slp = out[0], int(out[1]), out[2]
    if not G:
        seq = [int(t) for t in toks[0, P:n]]
        return seq[: seq.index(eot)] if eot in seq else seq
    ftok, fscore, flen = out[4][0], out[5][0], out[6][0]
    cands = [([int(t) for t in ftok[i, P : flen[i] - 1]], float(fscore[i]))
             for i in range(min(int(out[7][0]), G))]  # fmt: skip
    for b in sorted(range(G), key=lambda b: -float(slp[b])):
        if len(cands) >= G:
            break
        cands.append(([int(t) for t in toks[b, P:n]], float(slp[b])))
    return max(cands, key=lambda c: c[1] / max(len(c[0]), 1))[0]


def engine_window(model, pdir, mel, beam, temperature=0.0, seed=0, weights="", engine=None):
    """FusedEngine.run on a (n_mels, 3000) window as the runner decodes it
    (the pipeline's masks, manifest and seed), on `engine` or a new one:
    (the tokens the runner would pick, the run's EngineRun)."""
    from whisper_tpu_torch.tokenizer import get_tokenizer

    m = pipeline_manifest(pdir)
    tok = get_tokenizer(model.is_multilingual, num_languages=model.num_languages,
                        language="en", task="transcribe")  # fmt: skip
    initial = [int(t) for t in m["initial_tokens"].split()]
    smask = np.fromfile(os.path.join(pdir, "suppress_mask.bin"), dtype=bool)
    bmask = np.fromfile(os.path.join(pdir, "blank_mask.bin"), dtype=bool)
    G = int(m["beam_size"]) if beam else 1
    xa = model.encode(np.asarray(mel)[None])
    ck, cv = model.cross_kv(xa)
    engine = engine or FusedEngine(model, weights=weights)
    out = engine.run(
        initial, ck, cv, sot_index=0, suppress_ids=np.nonzero(smask)[0].tolist(),
        blank_ids=np.nonzero(bmask)[0].tolist(), max_initial_ts_index=int(m["max_initial_ts_index"]),
        sample_len=int(m["sample_len"]), n_group=G, beam_search=beam,
        max_candidates=G if beam else 0, use_timestamps=True, temperature=temperature,
        eot=tok.eot, timestamp_begin=tok.timestamp_begin, no_timestamps=tok.no_timestamps,
        no_speech=tok.no_speech, rng_seed=seed,
    )  # fmt: skip
    return ranked_tokens(out, len(initial), tok.eot, G if beam else 0), engine.history[-1]


def run_record(run):
    """An EngineRun's ms per token (the run's host wall over its steps,
    prefill and captures included) and its loop counts."""
    return dict(ms_per_token=run.seconds * 1e3 / run.steps, steps=run.steps, replays=run.replays,
                bodies=run.bodies, captures=run.captures, capture_s=run.capture_s,
                done_reads=run.done_reads)  # fmt: skip


def parting_gap(model, pdir, mel, eager, runner):
    """Where the runner's tokens first part from the eager engine's: the
    eager filtered log-probs there given the common prefix (one prefill over
    it, greedy's filters and penalties): its pick and its top-two gap."""
    p = common_prefix(eager, runner)
    if p >= min(len(eager), len(runner)):
        return None
    m = pipeline_manifest(pdir)
    initial = [int(t) for t in m["initial_tokens"].split()]
    P, n = len(initial), len(initial) + p
    pens = [torch.from_numpy(np.fromfile(os.path.join(pdir, f), np.float32)).to(DEV)
            for f in ("suppress_pen.bin", "begin_pen.bin")]  # fmt: skip
    toks = torch.zeros((1, graphs.CACHE_SLOTS), dtype=torch.int32, device=DEV)
    toks[0, :n] = torch.tensor(initial + list(eager[:p]), dtype=torch.int32)
    dec = model.params["decoder"]
    with torch.inference_mode():
        ck, cv = model.cross_kv(model.encode(np.asarray(mel)[None]))
        hidden, _ = graphs.prefill(dec, toks[:, :n], n, ck, cv, n_head=model.dims.n_text_head)
        lg = graphs.hidden_to_logits(dec, hidden[:, n - 1])
        filt = dict(use_timestamps=True, eot=int(m["eot"]), timestamp_begin=int(m["timestamp_begin"]))
        lp = torch.log_softmax(bk.apply_filters(lg, toks, n, P, *pens, **filt), dim=-1)[0]
    top = lp.topk(2)
    return dict(position=p, tokens=[int(eager[p]), int(runner[p])], eager_pick=int(top.indices[0]),
                top2_gap=(top.values[0] - top.values[1]).item(),
                logprob_of_tokens=[lp[int(eager[p])].item(), lp[int(runner[p])].item()])  # fmt: skip


def rel_err(got, want) -> float:
    """max |got - want| / max |want| over want's finite entries; infinite
    where the two differ in their non-finite entries (a filtered -inf)."""
    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(got[~fin], want[~fin]):
        return float("inf")
    return ((got - want)[fin].abs().max() / want[fin].abs().max().clamp_min(1e-30)).item()


def profile_kernels(fn, reps=20):
    """Device ms per call (the union of kernel intervals), kernels per call
    and the five longest kernels by name, from one profile of `reps` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(device_ms=busy / reps / 1e3, kernels=len(spans) / reps,
                top=[[name[:80], us / reps / 1e3] for name, us in top])  # fmt: skip


def turbo_graph_checks(model, pdir, mel):
    """Each turbo graph through its AOTInductor package (AotiRunner, the
    package cache the export filled) against the same function run eagerly
    on the same inputs: max |diff| / max |ref| per output; the prefill's
    argmax (step 0's) equal; whether the step wrote the cache in place; the
    step packages' device ms and kernels per call at each cache window;
    and the encoder loaded a second time from the package cache."""
    from whisper_tpu_torch.export import param_leaves, pipeline_graphs
    from whisper_tpu_torch.runtime.aoti import AotiRunner

    fns = pipeline_graphs(model)
    m = pipeline_manifest(pdir)
    runner = AotiRunner(pdir, cache_dir=os.path.join(EXPORT_DIR, "cache"))
    out = {"load": {}}
    for name in fns:
        compile_s, load_s, cached = runner.load_graph(name)
        if not cached:
            raise AssertionError(f"{name}: the export's package was not in the cache")
        out["load"][name] = load_s
    t0 = time.perf_counter()
    second = AotiRunner(pdir, cache_dir=os.path.join(EXPORT_DIR, "cache"))
    out["encoder_cached_load"] = dict(zip(("compile_s", "load_s", "cached"), second.load_graph("encoder")),
                                      wall_s=time.perf_counter() - t0)  # fmt: skip
    del second

    def check(name, inputs):
        fn, args, n_params = fns[name]
        weights = param_leaves(args[0]) if n_params else []
        eager_in = [t.clone() for t in inputs]
        with torch.no_grad():
            want = fn(*([args[0]] if n_params else []), *eager_in)
        want = list(want) if isinstance(want, (tuple, list)) else [want]
        got = runner.execute(name, [*weights, *inputs])
        out[name] = [rel_err(g, w) for g, w in zip(got, want)]
        return got, want, eager_in

    P = len(m["initial_tokens"].split())
    mel_t = torch.as_tensor(np.asarray(mel)[None], device=DEV)
    (xa,), (xa_ref,), _ = check("encoder", [mel_t])
    (ck, cv), (ck_ref, cv_ref), _ = check("cross_kv", [xa_ref.contiguous()])
    tokens = torch.tensor([[int(t) for t in m["initial_tokens"].split()]], dtype=torch.int32, device=DEV)
    (logits, _, _), (logits_ref, _, kv_ref), _ = check("prefill", [tokens, ck_ref, cv_ref])
    out["step0_argmax"] = [int(logits.argmax()), int(logits_ref.argmax())]
    if out["step0_argmax"][0] != out["step0_argmax"][1]:
        raise AssertionError(f"the prefill package's step-0 argmax differs: {out['step0_argmax']}")
    pos = torch.tensor(P, dtype=torch.int32, device=DEV)
    for name in (n for n in fns if n.startswith("step_")):  # every cache window's package
        G = len(STEP_BEAM_SRC) if name.startswith("step_beam") else 1
        cache = model.kv_to_cache_grouped(kv_ref, G).contiguous()
        last = logits_ref.argmax(-1).to(torch.int32).repeat(G)
        src = [torch.tensor(STEP_BEAM_SRC, dtype=torch.int32, device=DEV)] if G > 1 else []
        inputs = [last, pos, cache, *src, ck_ref, cv_ref]
        _, _, eager_in = check(name, inputs)
        out[name + "_cache"] = rel_err(cache, eager_in[2])
        out[name + "_wrote_in_place"] = bool(cache[:, :, :, P].abs().max() > 0)
        weights = param_leaves(fns[name][1][0])
        out[name + "_profile"] = profile_kernels(lambda: runner.execute(name, [*weights, *inputs]))
    toks = torch.zeros((1, graphs.CACHE_SLOTS), dtype=torch.int32, device=DEV)
    toks[:, :P] = tokens
    pens = fns["filters"][1][3:]
    check("filters", [logits_ref.contiguous(), toks, torch.tensor([P], dtype=torch.int32, device=DEV), *pens])
    return out


RUNNER_LAUNCHES = {  # kernel name: the runner's file-line key
    "greedy_argmax": "greedy_launches", "beam_update": "beam_launches",
    "greedy_argmax_state": "greedy_state_launches", "beam_update_state": "beam_state_launches",
}  # fmt: skip


class RunnerCalls:
    """Runs of the native runner, summing the update launches it reports
    (the scalar ones counted at the call, the loop-state ones by the
    kernels on the card)."""

    def __init__(self, binary):
        self.binary = binary
        self.launches = dict.fromkeys(RUNNER_LAUNCHES, 0)

    def count(self, summary):
        for name, key in RUNNER_LAUNCHES.items():
            self.launches[name] += summary[key]

    def __call__(self, pdir, audio_path, *flags):
        r = run_runner(self.binary, pdir, audio_path, *flags)
        self.count(r["summary"])
        return r


def tiny_export_model(dims=EXPORT_TINY_DIMS, seed=11):
    """A tiny float32 model of the export phase (seeded weights): the
    multilingual one, or at EXPORT_TINY_EN_DIMS the English-only one. Both
    take seed 11: their encoders' weights are then equal, so the two
    pipelines' encoder archives are one compile; the English-only greedy
    decode of jfk runs through every phase too."""
    return Whisper(dims, tiny_params(dims, seed=seed), device="cuda", compute_dtype=torch.float32)


def tiny_en_export_model():
    return tiny_export_model(EXPORT_TINY_EN_DIMS)


def export_tiny_pipelines(dirs, cache):
    """Run in a spawned process: export the tiny float32 pipeline and the
    tiny English-only int8 one (V = 51864, sample_begin 1, the gpt2 rank
    file) and compile the packages the tiny checks and the tool's export
    load.
    Returns (export s, compile wall s, [(export
    path, compile s, cached)])."""
    from whisper_tpu_torch.export import export_pipeline
    from whisper_tpu_torch.runtime.aoti import compile_graphs

    os.nice(10)  # the card's phases go first on the cores
    t = time.perf_counter()
    export_pipeline(dirs["tiny_f32"], tiny_export_model(), compile=False)
    export_pipeline(dirs["tiny_en_int8"], tiny_en_export_model(), weights="int8", compile=False)
    export_s = time.perf_counter() - t
    # the int8 runner decodes greedy only: no beam step; the float32
    # packages are all compiled, the tool's export finds them cached
    jobs = [os.path.join(dirs[d], f"{g}.export.pt2") for d in ("tiny_f32", "tiny_en_int8")
            for g in json.load(open(os.path.join(dirs[d], "timings.json")))
            if not (d == "tiny_en_int8" and g.startswith("step_beam"))]  # fmt: skip
    t = time.perf_counter()
    results = compile_graphs(jobs, cache, workers=3)
    return export_s, time.perf_counter() - t, [(j, *r) for j, r in zip(jobs, results)]


def export_turbo_pipeline(pdir, cache):
    """Run in a spawned process: the turbo pipeline exported and
    AOT-compiled (export_pipeline compiles on a card) from a model built as
    the main path's (MODEL_DIMS["turbo"], seeded bf16 weights, seed 0), so
    with its weights. Returns (export and compile s, weights_fingerprint)."""
    from whisper_tpu_torch.export import export_pipeline

    os.nice(10)  # the card's phases go first on the cores
    model = Whisper(MODEL_DIMS["turbo"], None, device="cuda", compute_dtype=torch.bfloat16, seed=0)
    t = time.perf_counter()
    export_pipeline(pdir, model, cache_dir=cache)
    return time.perf_counter() - t, weights_fingerprint(model)


def weights_fingerprint(model):
    """Each weight's sum in float64: equal weights give equal sums."""
    return [float(v.double().sum()) for _, v in flatten_tree(model.params)]


def build_runner():
    from whisper_tpu_torch.runtime import build as runner_build

    t = time.perf_counter()
    return RunnerCalls(runner_build.build_runner()), time.perf_counter() - t


def start_exports():
    """Start the export phase's host work once the card-vs-CPU comparisons
    are done, so that it runs beside the card's phases, not on the export
    phase's path: the tiny pipelines (export_tiny_pipelines) and the turbo
    pipeline (export_turbo_pipeline; its encoder's compile alone takes
    ~240–250 s) in a spawned process each, and the runner's g++ build on a
    thread. Returns the futures, the pools (which the export phase shuts
    down), the pipelines' directories and the start time."""
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    os.makedirs(EXPORT_DIR)
    cache = os.path.join(EXPORT_DIR, "cache")
    dirs = {name: os.path.join(EXPORT_DIR, name) for name in ("tiny_f32", "tiny_en_int8", "turbo")}
    ctx = multiprocessing.get_context("spawn")
    tiny, turbo = (concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) for _ in range(2))
    thread = concurrent.futures.ThreadPoolExecutor(1)
    return dict(
        tiny=tiny.submit(export_tiny_pipelines, dirs, cache),
        turbo=turbo.submit(export_turbo_pipeline, dirs["turbo"], cache),
        runner=thread.submit(build_runner), pools=(tiny, turbo, thread), dirs=dirs,
        started=time.perf_counter(),
    )  # fmt: skip


def export_and_check_tiny(model, t_phase, stack, exports):
    """Wait for the work start_exports began (`exports`: the runner, the
    tiny pipelines, the turbo pipeline, whose weights must be `model`'s),
    start the export tool in a subprocess (it reads the tiny packages'
    compile cache and goes on beside the checks; export_tool_check reads
    it after them), and run the tiny checks. The tool's process and the
    pools are stopped when `stack` (an ExitStack) closes. Returns
    (RunnerCalls, {pipeline: directory}, the tool's process
    (export_tool_start), the tiny float32 greedy tokens)."""
    for pool in exports["pools"]:
        stack.callback(pool.shutdown)
    dirs = exports["dirs"]
    t = time.perf_counter()
    runner, build_s = exports["runner"].result()
    tiny_export_s, tiny_compile_s, results = exports["tiny"].result()
    turbo_s, fingerprint = exports["turbo"].result()
    wait_s = time.perf_counter() - t
    if fingerprint != weights_fingerprint(model):
        raise AssertionError("the turbo pipeline's weights are not the main path's")
    tool = export_tool_start()
    stack.callback(stop_process, tool[0])
    timings = {d: json.load(open(os.path.join(dirs[d], "timings.json"))) for d in dirs}
    for job, seconds, cached in results:
        d, name = os.path.basename(os.path.dirname(job)), os.path.basename(job).removesuffix(".export.pt2")
        timings[d][name].update(compile_s=seconds, cached=cached)
    log(json.dumps({"phase": "export_runtime", "part": "build_and_compile", "runner_build_s": build_s,
                    "tiny_export_s": tiny_export_s, "tiny_compile_wall_s": tiny_compile_s,
                    "turbo_export_and_compile_s": turbo_s, "started_before_phase_s": t_phase - exports["started"],
                    "wait_s": wait_s, "graphs": timings,
                    "since_phase_start_s": time.perf_counter() - t_phase}))  # fmt: skip
    f32_greedy = tiny_runner_checks(runner, tiny_export_model(), tiny_en_export_model(), dirs, t_phase)
    return runner, dirs, tool, f32_greedy


def tiny_runner_checks(runner, tiny, tiny_en, dirs, t_phase):
    """Tiny float32 and English-only int8 on jfk: the captured runner's
    tokens equal the engine's on the same mel bytes (greedy, beam 5, the
    English-only int8 greedy at sample_begin 1 with the gpt2 rank file, and
    the ladder's accepted draw at its temperature and seed), the T = 0
    decodes running through all three phases (a capture each: past slots
    128 and 256); the English-only transcript against the port tokenizer's
    text of the same tokens (reported); a pipeline without one of its
    packages makes the runner exit non-zero. Returns the float32 greedy
    tokens."""
    from whisper_tpu_torch.runtime.native import decode_audio, log_mel_native
    from whisper_tpu_torch.tokenizer import get_tokenizer

    jfk_mel = log_mel_native(decode_audio(JFK_PATH, 16000), 80, padding=480000)[:, :3000]
    out = {}
    one = ["--tokens", "--max-windows", "1"]
    en_run = runner(dirs["tiny_en_int8"], JFK_PATH, *one, "--no-fallback")
    checks = [
        ("f32_greedy", runner(dirs["tiny_f32"], JFK_PATH, *one, "--no-fallback")["attempts"][0], False, ""),
        ("en_int8_greedy", en_run["attempts"][0], False, "int8"),
    ]  # fmt: skip
    # with --beam the ladder's T = 0 attempt is beam 5, the later ones draws;
    # every tiny T = 0 result fails the gates on jfk (avg logprob near -10),
    # so the accepted attempt is a draw
    ladder_run = runner(dirs["tiny_f32"], JFK_PATH, *one, "--beam")
    ladder = ladder_run["attempts"]
    checks.append(("f32_beam5", ladder[0], True, ""))
    if not ladder[-1]["temperature"] > 0:
        raise AssertionError(f"the tiny ladder accepted T = 0; no draw to check: {ladder[-1]}")
    checks.append(("f32_sampled", ladder[-1], False, ""))
    for label, a, beam, weights in checks:
        pdir = dirs["tiny_en_int8" if weights else "tiny_f32"]
        model = tiny_en if weights else tiny
        want, _ = engine_window(model, pdir, jfk_mel, beam, a["temperature"], a["seed"], weights)
        if a["token_ids"] != want:
            raise AssertionError(f"tiny {label}: runner {a['token_ids'][:20]}... != engine {want[:20]}...")
        if a["temperature"] == 0 and a["captures"] != 3:
            raise AssertionError(f"tiny {label}: {a['steps']} steps, {a['captures']} captures; want every phase")
        out[label] = dict(tokens=len(want), steps=a["steps"], temperature=a["temperature"],
                          seed=a["seed"], ms_per_token=a["ms_per_token"], loop=a["loop"],
                          replays=a["replays"], captures=a["captures"])  # fmt: skip
    out["ladder_other_stderr"] = ladder_run["other_stderr"]
    m = pipeline_manifest(dirs["tiny_en_int8"])
    if (m["n_vocab"], m["sample_begin"], m["tiktoken"]) != ("51864", "1", "gpt2.tiktoken"):
        raise AssertionError(f"the English-only pipeline's manifest: {m}")
    en_tok = get_tokenizer(False)
    en_text = en_tok.decode([t for t in en_run["attempts"][0]["token_ids"] if t < en_tok.eot])
    out["en_int8_text"] = dict(chars=len(en_run["text"].strip()),
                               equal_to_tokenizer=en_run["text"].strip() == en_text.strip())  # fmt: skip

    broken = os.path.join(EXPORT_DIR, "tiny_missing")
    shutil.copytree(dirs["tiny_f32"], broken)
    os.remove(os.path.join(broken, "step_greedy_w128.aoti.pt2"))
    res = subprocess.run([runner.binary, broken, JFK_PATH], capture_output=True, text=True, timeout=300)
    if res.returncode == 0 or "missing" not in res.stderr:
        raise AssertionError(f"a missing package: exit {res.returncode}, {res.stderr[-500:]}")
    out["missing_package"] = res.stderr.strip().splitlines()[-1][:200]
    log(json.dumps({"phase": "export_runtime", "part": "tiny", **out,
                    "since_phase_start_s": time.perf_counter() - t_phase}))  # fmt: skip
    return checks[0][1]["token_ids"]


def serve_check(runner, pdir, audio_path, want):
    """--serve: two requests, whose replies' tokens must be `want` and the
    second of which captures nothing (the graphs stay for the process),
    then shutdown; the server's wall seconds to come up and to answer each.
    Its stderr goes to a file, which nothing has to drain."""
    sock = os.path.join(EXPORT_DIR, "wtt.sock")
    err_path = os.path.join(EXPORT_DIR, "serve.stderr")
    t0 = time.perf_counter()
    with open(err_path, "w") as err_file:
        serving = subprocess.Popen([runner.binary, pdir, "--serve", sock],
                                   stdout=subprocess.DEVNULL, stderr=err_file)  # fmt: skip
    try:
        while "serving on" not in open(err_path).read():
            if serving.poll() is not None or time.perf_counter() - t0 > 300:
                raise AssertionError(f"the serving runner did not come up: {open(err_path).read()[-2000:]}")
            time.sleep(0.1)
        up_s = time.perf_counter() - t0
        replies, answer_s = [], []
        for _ in range(2):
            t1 = time.perf_counter()
            replies.append(runner_request(sock, f"{audio_path}\n"))
            answer_s.append(time.perf_counter() - t1)
        bye = runner_request(sock, "shutdown\n")
        rc = serving.wait(timeout=120)
    finally:
        if serving.poll() is None:
            serving.kill()
            serving.wait()
    for reply in replies:
        if reply.get("tokens") != want:
            raise AssertionError(f"serve reply {str(reply)[:300]} != the single-shot run's tokens")
    if bye != {"ok": True} or rc != 0:
        raise AssertionError(f"serve shutdown: {bye}, exit {rc}")
    lines, lag = runner_lines(open(err_path).read()), done_lag(pdir)
    for a in lines:
        if "window" in a:
            check_attempt(a, lag)
    files = [line for line in lines if "file" in line]
    for line in files:
        runner.count(line)
    captures = [f["captures"] for f in files]
    if len(files) != 2 or captures[0] == 0 or captures[1] != 0:
        raise AssertionError(f"--serve's captures a request: {captures}, want some then none")
    return dict(up_s=up_s, answer_s=answer_s, reply_tokens=len(want), captures=captures,
                capture_s=[f["capture_s"] for f in files], replays=[f["replays"] for f in files])  # fmt: skip


RUNNER_KEYS = ("steps", "ms_per_token", "read_ms_per_token", "replays", "bodies", "captures",
               "capture_s", "done_reads", "greedy_launches", "beam_launches",
               "greedy_state_launches", "beam_state_launches")  # fmt: skip


def runner_attempt(a):
    """A runner attempt's counts and times, and its ms per token with its
    captures' seconds left out (the loop's steady cost)."""
    loop_ms = (a["decode_ms"] - a["capture_s"] * 1e3) / max(a["steps"], 1)
    return dict({k: a[k] for k in RUNNER_KEYS}, loop_ms_per_token=loop_ms)


def turbo_runner_checks(runner, model, jfk, pdir, card, t_phase):
    """Turbo bf16: each graph's package against its eager run; the 60 s
    clip greedy and beam 5 at T = 0 through the captured runner, and its
    first window through --no-capture, whose tokens must equal the
    captured run's; the first window against the captured engine (the common prefix;
    where they part, the eager top-two gap there), the engine's first run
    (which captures) and second beside the runner's; jfk through the
    ladder, single-shot and through --serve, whose replies must equal the
    single-shot run's tokens."""
    from whisper_tpu_torch.runtime.native import decode_audio, log_mel_native

    clip = write_wav(os.path.join(EXPORT_DIR, "clip60.wav"), np.tile(jfk, 6)[: 60 * 16000])
    mel = log_mel_native(decode_audio(clip, 16000), model.dims.n_mels, padding=480000)[:, :3000]
    log(json.dumps({"phase": "export_runtime", "part": "turbo_graphs",
                    **turbo_graph_checks(model, pdir, mel), "card": card}))  # fmt: skip
    out = {}
    engine = FusedEngine(model)
    for label, beam in (("greedy", False), ("beam5", True)):
        flags = ("--tokens", "--no-fallback", *(["--beam"] if beam else []))
        run = runner(pdir, clip, *flags)
        uncaptured = runner(pdir, clip, *flags, "--max-windows", "1", "--no-capture")["attempts"]
        first = run["attempts"][0]
        for captured, body in zip(run["attempts"], uncaptured):
            if body["token_ids"] != captured["token_ids"]:
                raise AssertionError(f"turbo {label} window {body['window']}: --no-capture "
                                     f"{body['token_ids'][:20]}... != captured {captured['token_ids'][:20]}...")  # fmt: skip
        eager, engine_first = engine_window(model, pdir, mel, beam, engine=engine)
        _, engine_second = engine_window(model, pdir, mel, beam, engine=engine)
        out[label + "_window1"] = dict(
            tokens=len(first["token_ids"]), eager_tokens=len(eager),
            common_prefix=common_prefix(first["token_ids"], eager),
            parting=parting_gap(model, pdir, mel, eager, first["token_ids"]),
            captured=[runner_attempt(a) for a in run["attempts"][:2]],
            no_capture=[runner_attempt(a) for a in uncaptured],
            engine=[run_record(engine_first), run_record(engine_second)],
        )  # fmt: skip
        out[label + "_clip60"] = dict(
            windows=run["summary"]["windows"], seconds=run["summary"]["seconds"],
            process_s=run["seconds"], rtfx=60.0 / run["summary"]["seconds"],
            attempts=[[a["window"], a["steps"], a["ms_per_token"], a["captures"], a["capture_s"]]
                      for a in run["attempts"]],
            **{k: run["summary"][k] for k in RUNNER_KEYS[3:] if k in run["summary"]},
            loads=run["loads"], other_stderr=run["other_stderr"],
        )  # fmt: skip
    # the ladder at turbo width on jfk (random weights fail every gate, so
    # six attempts), single-shot and through --serve
    ladder = runner(pdir, JFK_PATH, "--tokens")
    out["jfk_ladder"] = dict(attempts=[[a["temperature"], a["seed"], a["steps"], a["ms_per_token"], a["captures"]]
                                       for a in ladder["attempts"]], process_s=ladder["seconds"])  # fmt: skip
    out["serve"] = serve_check(runner, pdir, JFK_PATH, accepted_tokens(ladder))
    log(json.dumps({"phase": "export_runtime", "part": "turbo_runner", **out, "card": card,
                    "since_phase_start_s": time.perf_counter() - t_phase}))  # fmt: skip


def stop_process(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def export_tool_start():
    """Start `python -m whisper_tpu_torch.export_pipeline` on the tiny
    float32 model saved by save_model, into the phase's compile cache,
    --no-build, at nice 10 beside the turbo compile and checks (as the tiny
    compiles run). Its graphs were just compiled there, so each should load from the
    cache: a cold compile means the cache key moved (reported). Returns
    (process, start time, log path)."""
    npz = os.path.join(EXPORT_DIR, "tiny_f32.npz")
    save_model(tiny_export_model(), npz)
    cmd = [
        "nice", "-n", "10", sys.executable, "-m", "whisper_tpu_torch.export_pipeline",
        "--checkpoint", npz, "--out", os.path.join(EXPORT_DIR, "tool"), "--compute-dtype", "float32",
        "--cache-dir", os.path.join(EXPORT_DIR, "cache"), "--no-build",
    ]  # fmt: skip
    log_path = os.path.join(EXPORT_DIR, "tool.log")
    with open(log_path, "w") as out:  # a file: nothing has to drain a pipe
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, cwd=ROOT,
                                env=dict(os.environ, PYTHONPATH=ROOT))  # fmt: skip
    return proc, time.perf_counter(), log_path


def export_tool_check(runner, t_phase, started, want):
    """The tool's pipeline (export_tool_start) gives the runner built above
    the same tokens, `want`, as the phase's tiny float32 pipeline (greedy,
    one window of jfk, tiny_runner_checks); its timings.json with each
    graph's cached flag is logged."""
    proc, t0, log_path = started
    try:
        rc = proc.wait(timeout=900)
    finally:
        stop_process(proc)
    tool_s = time.perf_counter() - t0
    with open(log_path) as f:
        tool_log = f.read()
    if rc != 0:
        raise AssertionError(f"the export tool failed ({rc}):\n{tool_log[-4000:]}")
    tool_dir = os.path.join(EXPORT_DIR, "tool")
    got = runner(tool_dir, JFK_PATH, "--tokens", "--max-windows", "1", "--no-fallback")["attempts"][0]["token_ids"]
    if got != want:
        raise AssertionError(f"the tool's pipeline: {got[:20]}... != the phase's tiny f32 {want[:20]}...")
    with open(os.path.join(tool_dir, "timings.json")) as f:
        timings = json.load(f)
    log(json.dumps({"phase": "export_runtime", "part": "tool", "seconds": tool_s, "tokens": len(got),
                    "timings": timings, "cold": [g for g, t in timings.items() if not t.get("cached")],
                    "printed": [ln for ln in tool_log.splitlines() if "exported pipeline" in ln],
                    "since_phase_start_s": time.perf_counter() - t_phase}))  # fmt: skip


def export_runtime_phase(model, jfk, card, exports):
    """Export, AOT-compile and run the native runner (tiny float32 and
    English-only int8, turbo bf16; the exports, compiles and the runner's
    build that start_exports began) and the one-command export tool.
    Returns the runner's update launches."""
    t_phase = time.perf_counter()
    with contextlib.ExitStack() as stack:
        runner, dirs, tool, f32_greedy = export_and_check_tiny(model, t_phase, stack, exports)
        turbo_runner_checks(runner, model, jfk, dirs["turbo"], card, t_phase)
        export_tool_check(runner, t_phase, tool, f32_greedy)
    if not all(runner.launches.values()):
        raise AssertionError(f"the runner launched an update kernel no time: {runner.launches}")
    log(json.dumps({"phase": "export_runtime", "seconds": time.perf_counter() - t_phase,
                    "runner_launches": runner.launches}))  # fmt: skip
    return runner.launches


def runner_request(path, line, timeout=300.0):
    """One request to a serving runner: a raw line, one JSON line back."""
    import socket

    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(timeout)
    try:
        c.connect(path)
        c.sendall(line.encode())
        return json.loads(c.makefile("rb").readline())
    finally:
        c.close()


def main():
    with watch_captures() as captures:
        line, gpu_name = run_phases()
    # the captures of this process (the CLI's subprocess and the spawned
    # ranks capture in their own)
    log(json.dumps({"phase": "captures", **captures}))
    print(json.dumps(line))
    print(card_line())
    device = {"platform": "gpu", "kind": gpu_name, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


def run_phases():
    """Every phase in turn; returns (the kernels line, the card's name)."""
    start = time.perf_counter()

    def clock(after):
        # the smoke's elapsed seconds after each part, against its time limit
        log(json.dumps({"phase": "clock", "after": after, "seconds": time.perf_counter() - start}))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu_name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {gpu_name} host {host_cpu()}")
    card = card_line()

    t = time.perf_counter()
    start_empty_build()
    build.load_library()
    empty_lib()
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t}))
    log("\n".join(line for line in build.build_log.splitlines() if "Used" in line))

    kernels = {}
    for name, check in [
        ("greedy_argmax", check_greedy), ("greedy_argmax_rows", check_greedy_rows),
        ("greedy_argmax_state", check_greedy_state), ("greedy_argmax_rows_state", check_greedy_rows_state),
        ("beam_update", check_beam), ("beam_update_state", check_beam_state), ("dtw_trace", check_dtw),
        ("median_filter", check_median),
    ]:  # fmt: skip
        t = time.perf_counter()
        kernels[name] = dict(check(), seconds=time.perf_counter() - t)
    clock("kernels")
    log(json.dumps({"phase": "odd_vocab", "max_abs_err": check_odd_vocab()}))
    log(json.dumps({"phase": "layout_vocab", **check_layout_vocab()}))
    log(json.dumps({"phase": "f32_products", **f32_products()}))
    for name, r in kernels.items():
        log(json.dumps({"phase": "kernel", "name": name, **r, "card": card}))
    log(json.dumps({"phase": "yardstick",
                    "note": "library_ms of the update kernels is torch.topk on the same rows, "
                            "which computes none of the filters; no single PyTorch call "
                            "computes the DTW trace"}))  # fmt: skip

    clock("f32_products")
    log(json.dumps({"phase": "card_vs_cpu", **card_vs_cpu()}))
    clock("card_vs_cpu")
    log(json.dumps({"phase": "card_vs_cpu_en", **card_vs_cpu_en()}))
    clock("card_vs_cpu_en")
    exports = start_exports()
    config_launches = configs_phase(card)
    clock("configs")

    dims = MODEL_DIMS["turbo"]
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = Whisper(dims, None, device="cuda", compute_dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    log(json.dumps({"phase": "init_turbo", "seconds": time.perf_counter() - t}))
    jfk = load_audio(os.path.join(ROOT, "tests", "data", "jfk.flac"))
    audio = np.tile(jfk, 6)[: 60 * 16000]
    model.transcribe(audio[: 16000 * 5], language="en", temperature=0.0, verbose=None)  # warm-up
    captured_loop_phase(model, audio, card)
    clock("captured_loop")
    done_lag_phase(model, audio, card)
    clock("done_lag")
    draft = spec_draft(torch.bfloat16)

    launches = dict(config_launches)
    turbo_config = {}
    np.random.seed(0)  # the sampling seeds of the temperature ladder
    words = dict(word_timestamps=True, temperature=0.0)
    silence = dict(words, hallucination_silence_threshold=2.0)
    for name, clip, kw in [
        ("greedy_ladder", audio, {}),
        ("beam5_t0", audio, dict(beam_size=5, temperature=0.0)),
        ("words_greedy_t0", audio, words),
        ("words_silence_skip", audio[: 20 * 16000], silence),
        ("greedy_t0", audio, dict(temperature=0.0)),
        ("greedy_t0_draft", audio, dict(temperature=0.0, draft=draft)),
    ]:  # fmt: skip
        stats, counts, _ = main_path(model, clip, **kw)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        log(json.dumps({"phase": "main_path", "run": name, **stats, "launches": counts,
                        "card": card}))  # fmt: skip
        if name in ("beam5_t0", "words_greedy_t0"):
            turbo_config[name] = stats
    turbo_config_record(turbo_config, card)
    clock("main_path")
    for k, v in batch_phase(model, audio, card).items():
        launches[k] = launches.get(k, 0) + v
    clock("batch")
    log(json.dumps({"phase": "cli", **cli_phase()}))
    clock("cli")
    t = time.perf_counter()
    layers = layers_measure(model, audio)
    log(json.dumps({"phase": "layers", **layers, "seconds": time.perf_counter() - t, "card": card}))
    clock("layers")

    log(json.dumps({"phase": "bf16_rows", **bf16_rows(model, audio), "card": card}))
    serving = {}

    def add_serving(counts):
        for k, v in counts.items():
            serving[k] = serving.get(k, 0) + v
            launches[k] = launches.get(k, 0) + v

    t = time.perf_counter()
    f32_model = Whisper(dims, None, device="cuda", compute_dtype=torch.float32, seed=0)
    add_serving(streaming_phase(model, f32_model, audio, card))
    batcher_counts = continuous_phase(model, f32_model, audio, jfk, card)
    add_serving(batcher_counts)
    del f32_model
    torch.cuda.empty_cache()
    add_serving(servers_phase(model, jfk, card))
    log(json.dumps({"phase": "serving", "seconds": time.perf_counter() - t, "launches": serving}))
    clock("serving")
    speculative = ("greedy_argmax_rows", "greedy_argmax_rows_state")  # no draft in serving
    if batcher_counts["beam_update"] == 0 or any(
        n == 0 for k, n in serving.items() if k not in speculative
    ):
        raise AssertionError(f"streaming and serving launched a kernel no time: {serving}, 5e {batcher_counts}")
    # the per-row launch without the loop state is the host loop's, which
    # no engine runs on its main path (5g's float32 eager bracket compares with it)
    for name, n in launches.items():
        if n == 0 and name != "greedy_argmax_rows":
            raise AssertionError(f"the main path never launched {name}")
    t = time.perf_counter()
    f32_model = Whisper(dims, None, device="cuda", compute_dtype=torch.float32, seed=0)
    int8_spec_phase(model, draft, f32_model, audio, jfk, card)
    del f32_model
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "int8_spec", "seconds": time.perf_counter() - t}))
    clock("int8_spec")
    log(json.dumps({"phase": "card_vs_cpu_serving", **card_vs_cpu_serving()}))
    clock("card_vs_cpu_serving")
    log(json.dumps({"phase": "memory", "max_memory_allocated": torch.cuda.max_memory_allocated()}))
    for k, v in train_phase(model, jfk, card).items():
        launches[k] = launches.get(k, 0) + v
    clock("train")
    add_counts(launches, eval_tools_phase(model, card))
    clock("eval_tools")
    add_counts(launches, bench_tools_phase(model, card))
    clock("bench_tools")
    add_counts(launches, parallel_phase(audio, jfk, card))
    clock("parallel")
    log(json.dumps({"phase": "replay_cross_kv", **replay_cross_kv(model), "card": card}))
    for beam_size in (None, 5):
        profile = decode_loop_profile(model, audio, beam_size)
        tokens = profile.pop("tokens")
        log(json.dumps({"phase": "loop_profile", **profile, "card": card}))
        log(json.dumps({"phase": "int8_vs_bf16", **int8_profile(model, audio, beam_size, tokens),
                        "card": card}))  # fmt: skip
    clock("loop_profiles")
    log(json.dumps({"phase": "train_profile", **train_profile(model), "card": card}))
    clock("train_profile")
    add_counts(launches, export_runtime_phase(model, jfk, card, exports))
    clock("export_runtime")
    for name in kernels:
        if not launches.get(name) and name != "greedy_argmax_rows":
            raise AssertionError(f"the smoke's runs never launched {name}: {launches}")

    source = {
        "greedy_argmax": ("greedy_argmax.cu", "whisper_tpu/ops/beam_kernel.py:627"),
        "greedy_argmax_rows": ("greedy_argmax.cu", "whisper_tpu/ops/beam_kernel.py:627"),
        "greedy_argmax_state": ("greedy_argmax.cu", "whisper_tpu/ops/beam_kernel.py:627"),
        "greedy_argmax_rows_state": ("greedy_argmax.cu", "whisper_tpu/ops/beam_kernel.py:627"),
        "beam_update": ("beam_update.cu", "whisper_tpu/ops/beam_kernel.py:449"),
        "beam_update_state": ("beam_update.cu", "whisper_tpu/ops/beam_kernel.py:449"),
        "dtw_trace": ("dtw.cu", "whisper_tpu/ops/pallas_kernels.py:138"),
        "median_filter": ("median_filter.cu", "whisper_tpu/ops/pallas_kernels.py:210"),
    }  # fmt: skip
    line = {
        "kernels": [
            {
                "name": name, "route": "cuda", "source": "whisper_tpu_torch/csrc/" + source[name][0],
                "replaces": source[name][1], "launches": launches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r.get("bound_by", "bytes"),
                "library_ms": r.get("library_ms"),
                **{k: r[k] for k in ("cluster", "call_ms", "empty_ms", "chain_floor_ms", "rows_ms",
                                     "scalar_ms", "state_ms") if k in r},
            }  # fmt: skip
            for name, r in kernels.items()
        ]
    }
    return line, gpu_name


if __name__ == "__main__":
    main()
