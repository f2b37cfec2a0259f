"""The readings a cell's limits are set from, in one process: the program's
comparison numbers on many seeds (sound runs: the lower reading), and the
control's on a few (the upper reading): the float32 reference's fp8 twin
in the program's place, decoding the same sampled windows itself
(check.py, control=True).

Each seed builds the cell as a run does (weights from the seed, the warm
call), runs a short window of the cell's own traffic and compares. One line
of JSON a reading on standard output.

    python3 portbench/limits.py --workload <cell> --seconds 5 \
        --seeds 101 102 ... --fp8-seeds 101 102 103
"""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, harness  # noqa: E402


def reading(cell: str, seed: int, seconds: float, *, fp8: bool = False, device="cuda") -> dict:
    t0 = time.perf_counter()
    ctx = harness.setup(cell, seed, seconds, device)
    rec = harness.measure(ctx, False)
    harness.free_program(ctx)
    out = check.compare(ctx, rec["window"]["served"], np.random.default_rng([seed, 1]), control=fp8)
    out.update(cell=cell, seed=seed, seconds=time.perf_counter() - t0, windows=rec["window"]["windows"])
    del ctx
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fp8-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    fp8 = set(args.fp8_seeds)
    for seed in list(dict.fromkeys(args.seeds + args.fp8_seeds)):
        print(json.dumps(reading(args.workload, seed, args.seconds, fp8=seed in fp8)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
