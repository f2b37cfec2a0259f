"""Dynamic time warping for word-timestamp alignment: the trace table of a
cost matrix, and the host backtrace over it.

`dtw_trace` (csrc/dtw.cu) replaces
whisper_tpu/ops/pallas_kernels.py:dtw_trace_pallas. It launches its CUDA
kernel for CUDA tensors (or raises) and runs `dtw_trace_plain` for CPU
tensors; there is no other route. Both accumulate the cost in float64, as
the JAX package's default word-timing path does (`dtw_np` over the matrix
widened to float64, whisper_tpu/ops/dtw.py:76-78): near-ties in a sum of
~1,700 steps decide the path, so only the same precision gives the same
path. The decision rule is the reference's: diagonal if strictly least,
else up if strictly least, else left.
"""

import numpy as np
import torch

from ..kernels import build

MAX_ROWS = 1023  # text tokens per matrix: one lane per row, one block of <= 32 warps


def backtrace(trace: np.ndarray) -> np.ndarray:
    """trace: (N+1, M+1) int in {0 diag, 1 up, 2 left}. Returns (2, K) path
    indices over the (N, M) cost matrix (copied from
    whisper_tpu/ops/dtw.py:23-46)."""
    i = trace.shape[0] - 1
    j = trace.shape[1] - 1
    trace = trace.copy()
    trace[0, :] = 2
    trace[:, 0] = 1

    result = []
    while i > 0 or j > 0:
        result.append((i - 1, j - 1))
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        elif t == 2:
            j -= 1
        else:
            raise ValueError("Unexpected trace[i, j]")
    result = np.array(result)
    return result[::-1, :].T


def dtw_trace_plain(x: torch.Tensor) -> torch.Tensor:
    """x: (N, M) cost matrix -> (N+1, M+1) int8 trace table (0 diag, 1 up,
    2 left; -1 on the borders), one anti-diagonal at a time with the cost in
    float64: the torch form of whisper_tpu/ops/dtw.py:_dtw_table_np."""
    N, M = x.shape
    x = x.to(torch.float64)
    cost = torch.full((N + 1, M + 1), float("inf"), dtype=torch.float64, device=x.device)
    trace = torch.full((N + 1, M + 1), -1, dtype=torch.int8, device=x.device)
    cost[0, 0] = 0.0
    # cells on anti-diagonal d satisfy i + j == d, i in [max(1, d-M), min(N, d-1)]
    for d in range(2, N + M + 1):
        i = torch.arange(max(1, d - M), min(N, d - 1) + 1, device=x.device)
        j = d - i
        c0 = cost[i - 1, j - 1]  # diag
        c1 = cost[i - 1, j]  # up
        c2 = cost[i, j - 1]  # left
        take0 = (c0 < c1) & (c0 < c2)
        take1 = (c1 < c0) & (c1 < c2) & ~take0
        c = torch.where(take0, c0, torch.where(take1, c1, c2))
        cost[i, j] = x[i - 1, j - 1] + c
        trace[i, j] = torch.where(take0, 0, torch.where(take1, 1, 2)).to(torch.int8)
    return trace


def dtw_trace(x: torch.Tensor) -> torch.Tensor:
    """The (N+1, M+1) int8 trace table of an (N, M) float32 cost matrix;
    see `dtw_trace_plain`. On a CUDA tensor the kernel runs; N <= 1023."""
    if x.device.type == "cpu":
        return dtw_trace_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"dtw_trace runs on CUDA or CPU tensors, not {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            f"dtw_trace takes a contiguous 2-D float32 matrix, got {x.dtype} {tuple(x.shape)}"
        )
    N, M = x.shape
    if not (1 <= N <= MAX_ROWS and M >= 1):
        raise ValueError(f"dtw_trace takes 1 <= N <= {MAX_ROWS} rows and M >= 1, got {(N, M)}")
    lib = build.load_library()
    trace = torch.empty((N + 1, M + 1), dtype=torch.int8, device=x.device)
    rc = lib.wtt_dtw_trace(
        x.data_ptr(), trace.data_ptr(), N, M, torch.cuda.current_stream(x.device).cuda_stream
    )
    dtw_trace.launches += 1
    if rc != 0:
        raise RuntimeError(f"dtw_trace kernel launch failed: CUDA error {rc}")
    return trace


dtw_trace.launches = 0


def dtw(x: torch.Tensor) -> np.ndarray:
    """x: (N, M) cost matrix -> (2, K) alignment path (text index, time
    index): the trace on x's device, the backtrace on the host."""
    return backtrace(dtw_trace(x).cpu().numpy())
