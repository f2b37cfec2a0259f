"""Sharded-serving bench (the counterpart of tools/serve_bench.py):
`DataParallelEngine` over a (dp, tp) mesh of torch.distributed ranks,
beside the single-device `FusedEngine` on the same mel.

Every rank (SPMD) builds the model from the same seed, encodes the same
random mel (A streams, A = --streams or 2 dp) with `dp_encode` and
`dp_cross_kv` over the mesh, and runs the sharded engine at beam --beam
for --steps tokens (EOT suppressed, timestamp rules on): one warm run (its
graphs), then --trials timed runs, median. Unless --skip-single, the
plain model's encoder, cross-K/V and `FusedEngine` run the same batch on
the rank's device for the collective-overhead comparison. The record adds
to the JAX tool's keys the world and backend, whether the sharded loop
replayed captured graphs, and whether its tokens equal the single engine's.

Where the ranks come from:
  * --virtual N: N ranks on the CPU over gloo, spawned here
    (parallel.launch.spawn; the JAX tool's forced host platform);
  * under torchrun: its ranks (NCCL on the cards);
  * otherwise one rank in this process over NCCL on one card (gloo with
    --device cpu), where the loop body is captured.
--tp must divide the world (the JAX default of 2 does not divide one
rank: pass --tp 1 on one card); a mismatch raises before any rank starts.

  python -m whisper_tpu_torch.serve_bench --virtual 2 --tp 2 --device cpu
  python -m whisper_tpu_torch.serve_bench --model turbo --tp 1          # one card
  torchrun --nproc-per-node 4 -m whisper_tpu_torch.serve_bench --dp 2 --tp 2
"""

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .tool_common import beam_kwargs, build_model, device_name

COMPUTE_DTYPE = "bfloat16"  # the models' compute dtype, as the JAX tool's (launch() takes another in opts)


def mel_batch(n_audio: int, n_mels: int) -> np.ndarray:
    """The JAX tool's random mel batch."""
    rng = np.random.RandomState(0)
    return (rng.randn(n_audio, n_mels, 3000) * 0.5).astype(np.float32)


def split_world(world: int, dp: Optional[int], tp: int) -> int:
    """dp for a world of `world` ranks at tp, checked: tp must divide the
    world, and dp * tp must be the world."""
    if tp < 1 or world % tp:
        raise ValueError(
            f"tp={tp} does not divide the world of {world} rank(s); pass a --tp that divides it "
            "(--tp 1 on one card, or more ranks through --virtual or torchrun)"
        )
    if dp is None:
        return world // tp
    if dp * tp != world:
        raise ValueError(f"dp={dp} x tp={tp} != the world of {world} rank(s)")
    return dp


def run(model, mesh, streams: Optional[int] = None, beam: int = 5, steps: int = 96, trials: int = 3,
        skip_single: bool = False) -> dict:  # fmt: skip
    """One rank's part (every rank of the mesh calls it alike). Returns the
    record, with the engines' decoded tokens under "tokens" (not printed)."""
    from .engine import FusedEngine
    from .parallel.mesh import mesh_shape
    from .parallel.serve import DataParallelEngine, dp_cross_kv, dp_encode
    from .parallel.sharding import shard_params
    from .tokenizer import get_tokenizer

    shape = mesh_shape(mesh)
    dp, tp = shape["dp"], shape.get("tp", 1)
    dims = model.dims
    if dims.n_text_head % tp:
        raise ValueError(f"{dims.n_text_head} heads are not divisible by tp={tp}")
    A = streams or 2 * dp
    tok = get_tokenizer(model.is_multilingual, num_languages=model.num_languages, language="en",
                        task="transcribe")  # fmt: skip
    mel = mel_batch(A, dims.n_mels)
    enc, dec = (shard_params(model.params[k], mesh) for k in ("encoder", "decoder"))
    xa = dp_encode(model, mesh)(enc, mel)
    ck, cv = dp_cross_kv(model, mesh)(dec, xa)
    init = np.tile(np.array([list(tok.sot_sequence)], np.int32), (A, 1))
    kw = beam_kwargs(tok, beam, steps)

    def timed(engine, c, v):
        engine.run(init, c, v, **kw)  # warm-up: the loop's graphs
        ts, out = [], None
        for _ in range(trials):
            t0 = time.perf_counter()
            out = engine.run(init, c, v, **kw)  # numpy outputs: the run has ended on the card
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)), out

    sharded = DataParallelEngine(model, mesh)
    t_sharded, out = timed(sharded, ck, cv)
    result = {
        "metric": f"serve_{model.name}_dp{dp}_tp{tp}_{A}streams_bs{beam}",
        "platform": model.device.type,
        "world": dist.get_world_size(),
        "backend": dist.get_backend(),
        "streams": A,
        "steps": steps,
        "sharded_decode_s": t_sharded,
        "sharded_ms_per_step": 1e3 * t_sharded / steps,
        "aggregate_x_realtime": A * 30.0 / t_sharded,
        "sharded_captured": sharded.history[-1].captured,
        "device": device_name(model.device),
        "tokens": {"sharded": out[0][:, : int(out[1])]},
    }
    if not skip_single:
        xa1 = model.encode(mel)
        ck1, cv1 = model.cross_kv(xa1)
        t_single, single = timed(FusedEngine(model), ck1, cv1)
        result["single_device_decode_s"] = t_single
        result["sharding_overhead_x"] = t_sharded / t_single
        result["tokens"]["single"] = single[0][:, : int(single[1])]
        result["tokens_equal_single"] = bool(int(single[1]) == int(out[1]) and np.array_equal(single[0], out[0]))
    return result


def rank_main(opts: dict) -> dict:
    """A spawned rank (parallel.launch.spawn has made its process group):
    the model and the mesh, then run()."""
    from .parallel.mesh import make_mesh

    device_type = opts["device_type"]
    model = build_model(opts["model"], device_type, getattr(torch, opts["compute_dtype"]))
    mesh = make_mesh(dp=opts["dp"], tp=opts["tp"], device_type=device_type)
    return run(model, mesh, opts["streams"], opts["beam"], opts["steps"], opts["trials"], opts["skip_single"])


def launch(opts: dict, virtual: int = 0, model=None) -> dict:
    """Rank 0's record (every rank's under torchrun) over the world `opts`
    and `virtual` name. `model`: an already loaded model for a world run in
    this process (one rank, or torchrun's)."""
    from .parallel.launch import spawn
    from .parallel.mesh import init_from_env, make_mesh

    if virtual:
        opts = dict(opts, device_type="cpu", dp=split_world(virtual, opts["dp"], opts["tp"]))
        return spawn(rank_main, virtual, opts, device_type="cpu")[0]
    device_type = opts["device_type"]
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        init_from_env(device_type)
    if dist.is_initialized():
        dp = split_world(dist.get_world_size(), opts["dp"], opts["tp"])
        model = model or build_model(opts["model"], device_type, getattr(torch, opts["compute_dtype"]))
        return run(model, make_mesh(dp, opts["tp"], device_type=device_type), opts["streams"], opts["beam"],
                   opts["steps"], opts["trials"], opts["skip_single"])  # fmt: skip
    dp = split_world(1, opts["dp"], opts["tp"])
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this machine; pass --device cpu")
    model = model or build_model(opts["model"], device_type, getattr(torch, opts["compute_dtype"]))
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo", store=store, rank=0, world_size=1)
        try:
            return run(model, make_mesh(dp, opts["tp"], device_type=device_type), opts["streams"],
                       opts["beam"], opts["steps"], opts["trials"], opts["skip_single"])  # fmt: skip
        finally:
            dist.destroy_process_group()


def main(argv: Optional[List[str]] = None, model=None) -> int:
    """The command. `model`: an already loaded model in place of --model's
    (a run in this process; --virtual ranks build their own)."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="tiny", help="registry name of the dims (seeded random weights), or a checkpoint")
    ap.add_argument("--dp", type=int, default=None)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--virtual", type=int, default=0, help="N gloo ranks on the CPU")
    ap.add_argument("--streams", type=int, default=None, help="audio streams per batch (default: 2*dp)")
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--steps", type=int, default=96)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--skip-single", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda or cpu (the ranks' device type)")
    args = ap.parse_args(argv)
    device_type = torch.device(args.device).type
    opts = dict(
        model=args.model, compute_dtype=COMPUTE_DTYPE, device_type=device_type, dp=args.dp, tp=args.tp,
        streams=args.streams, beam=args.beam, steps=args.steps, trials=args.trials,
        skip_single=args.skip_single,
    )  # fmt: skip
    out = launch(opts, args.virtual, model)
    if not dist.is_initialized() or dist.get_rank() == 0:
        out.pop("tokens")
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
