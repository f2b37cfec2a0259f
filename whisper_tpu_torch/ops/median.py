"""Median filter of odd width over the last axis, with reflect padding at a
boundary column `n_valid` (the array's edge by default).

`median_filter` (csrc/median_filter.cu) replaces
whisper_tpu/ops/pallas_kernels.py:median_filter_pallas. It launches its CUDA
kernel for CUDA tensors (or raises) and runs `median_filter_plain` for CPU
tensors; there is no other route. The word-timing cost matrix reflects at
the window's valid frame count, not at the array's edge
(whisper_tpu/models/graphs.py:436-444), so the boundary is an argument.
Columns at or past `n_valid` are copied from the input: the caller slices
them off. NaN orders above every number, as in torch.sort and jnp.sort (the
JAX package's word-timing path, whisper_tpu/models/graphs.py:444): a window
with more than width // 2 NaNs has a NaN median.
"""

from typing import Optional

import torch

from ..kernels import build

# the widths the kernel is compiled for (it keeps the window in registers)
KERNEL_WIDTHS = (3, 5, 7, 13)


def _check_args(T: int, width: int, n_valid: Optional[int]) -> int:
    if width <= 0 or width % 2 == 0:
        raise ValueError(f"`filter_width` should be odd and positive, got {width}")
    n_valid = T if n_valid is None else int(n_valid)
    if not width // 2 < n_valid <= T:
        raise ValueError(f"need width // 2 < n_valid <= T, got {width}, {n_valid}, {T}")
    return n_valid


def _reflect_index(n_cols: int, width: int, n_valid: int, device) -> torch.Tensor:
    """(n_cols, width) source columns of each output column's window,
    reflected at column n_valid as np.pad(mode="reflect") reflects at the
    edge of x[..., :n_valid]; columns >= n_valid read themselves."""
    pad = width // 2
    cols = torch.arange(n_cols, device=device)
    idx = cols[:, None] + torch.arange(-pad, pad + 1, device=device)[None, :]
    idx = torch.where(idx < 0, -idx, idx)
    idx = torch.where(idx >= n_valid, 2 * n_valid - 2 - idx, idx)
    return torch.where(cols[:, None] < n_valid, idx, cols[:, None])


def median_filter_plain(x: torch.Tensor, width: int, n_valid: Optional[int] = None):
    """x: (..., T) -> same shape: the median of each reflect-padded window
    (the torch counterpart of whisper_tpu/ops/median.py:median_filter_np,
    which it equals at n_valid == T). Identity when T <= width // 2."""
    T = x.shape[-1]
    if T <= width // 2:
        return x
    n_valid = _check_args(T, width, n_valid)
    windows = x[..., _reflect_index(T, width, n_valid, x.device)]  # (..., T, width)
    return torch.sort(windows, dim=-1).values[..., width // 2]


def median_filter(x: torch.Tensor, width: int, n_valid: Optional[int] = None):
    """See `median_filter_plain`. On a CUDA tensor the kernel runs on the
    float32 rows of x (any leading dims), for a width in KERNEL_WIDTHS."""
    if x.device.type == "cpu":
        return median_filter_plain(x, width, n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"median_filter runs on CUDA or CPU tensors, not {x.device}")
    T = x.shape[-1]
    if T <= width // 2:
        return x
    n_valid = _check_args(T, width, n_valid)
    if width not in KERNEL_WIDTHS:
        raise ValueError(f"median_filter's kernel takes a width in {KERNEL_WIDTHS}, got {width}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"median_filter takes contiguous float32 rows, got {x.dtype}")
    rows = x.numel() // T
    lib = build.load_library()
    out = torch.empty_like(x)
    rc = lib.wtt_median_filter(
        x.data_ptr(), out.data_ptr(), rows, T, width, n_valid,
        torch.cuda.current_stream(x.device).cuda_stream,
    )  # fmt: skip
    median_filter.launches += 1
    if rc != 0:
        raise RuntimeError(f"median_filter kernel launch failed: CUDA error {rc}")
    return out


median_filter.launches = 0
