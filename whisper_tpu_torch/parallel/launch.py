"""Start a world of ranks on this machine with torch.multiprocessing, the
way the tests and the smoke run the mesh without torchrun.

    results = spawn(fn, 4, *args)

runs fn(*args) in 4 processes of the spawn context, each with the default
process group initialised over a FileStore in a temporary directory. The
ranks run on CUDA with NCCL unless the caller asks otherwise: rank r
selects card r % device_count, so several ranks may share one card when
`backend="gloo"` is given; `device_type="cpu"` runs them on the CPU over
gloo (the tests). Without a card the CUDA default raises; nothing falls
back to the CPU. Returns the ranks' return values in rank order; a rank that raises
or dies makes spawn raise, with every rank's traceback, after stopping the
others. `fn` and `args` are pickled: `fn` must be importable by name.
"""

import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world, store_path, device_type, backend, fn, args, results):
    try:
        torch.set_num_threads(1)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend or ("nccl" if device_type == "cuda" else "gloo"),
            store=store, rank=rank, world_size=world,
        )  # fmt: skip
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, *args, device_type: str = "cuda", backend=None, timeout: float = 900.0):
    """fn(*args) on `world` ranks; their results in rank order."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this machine; pass device_type='cpu'")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(r, world, store, device_type, backend, fn, args, results),
                daemon=True,
            )
            for r in range(world)
        ]
        for p in procs:
            p.start()
        got, errors = {}, {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) + len(errors) < world:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    lost = [r for r in dead if r not in got and r not in errors]
                    if lost or time.monotonic() > deadline:
                        why = f"exit codes {[procs[r].exitcode for r in lost]}" if lost else "timeout"
                        raise RuntimeError(f"ranks {lost or 'all'} ended without a result ({why})")
                    if errors:
                        # a failed rank leaves the others waiting in a collective
                        break
                    continue
                (got if ok else errors)[rank] = out
        finally:
            for p in procs:
                p.join(timeout=5 if len(got) == world else 0.1)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    if errors:
        raise RuntimeError(
            "".join(f"rank {r} failed:\n{tb}\n" for r, tb in sorted(errors.items()))
        )
    return [got[r] for r in range(world)]
