"""From host waveforms to decoder-ready features on the model's device.

The counterpart of whisper_tpu/frontend.py:
  * `pack_audio` — a waveform padded for upload, as int16 when exact;
  * `batched_device_mel` / `batched_mel_windows` — N streams' mel as one
    (N, n_mels, F) tensor (one upload, one batched STFT), and each round's
    windows sliced from it at every stream's seek (batch.py);
  * `encode_clip` — a whole clip's 30 s windows through the mel, the
    encoder and the cross-K/V, the windows on the audio axis;
  * `encode_clip_spec` — the same for a target and its draft, the
    speculative engine's inputs.
transcribe()'s whole-file mel and its windows are ops/stft.py's
`device_mel_full` / `device_mel_window`.
"""

from typing import List, Tuple

import numpy as np
import torch

from .audio import HOP_LENGTH, N_FRAMES, N_SAMPLES
from .ops.stft import log_mel_spectrogram_torch, pack_audio

__all__ = [
    "batched_device_mel", "batched_mel_windows", "encode_clip", "encode_clip_spec", "pack_audio",
]  # fmt: skip


def batched_device_mel(audios: List[np.ndarray], n_mels: int, device) -> Tuple[torch.Tensor, List[int]]:
    """N host waveforms -> one (N, n_mels, F) mel on `device` and each
    stream's content frames. Every stream is padded to one 30 s bucket past
    the longest plus 30 s (digital silence cannot move a stream's global
    max, so its real frames are those of the host log_mel_spectrogram(audio,
    padding=N_SAMPLES)). One stream that is not exactly int16 makes the
    whole batch float32, the others read as i / 32768."""
    lengths = [np.asarray(a).shape[-1] for a in audios]
    total = max(lengths) + N_SAMPLES
    bucket = -(-total // N_SAMPLES) * N_SAMPLES
    packed = [pack_audio(a, bucket) for a in audios]
    if any(p.dtype == np.float32 for p in packed):
        stacked = np.stack(
            [p.astype(np.float32) / (32768.0 if p.dtype == np.int16 else 1.0) for p in packed]
        )
    else:
        stacked = np.stack(packed)
    mel = log_mel_spectrogram_torch(torch.from_numpy(stacked).to(device), n_mels)
    return mel, [n // HOP_LENGTH for n in lengths]


def batched_mel_windows(mels: torch.Tensor, seeks: List[int], segment_sizes: List[int]) -> torch.Tensor:
    """One (n_mels, N_FRAMES) window per stream at its seek, frames >=
    its segment size zeroed: (N, n_mels, N_FRAMES). A seek is clamped so
    that the window fits, as a dynamic slice clamps it."""
    B, n_mels, F = mels.shape
    dev = mels.device
    starts = np.clip(np.asarray(seeks, np.int64), 0, F - N_FRAMES)
    frames = torch.arange(N_FRAMES, device=dev)
    index = torch.from_numpy(starts).to(dev)[:, None] + frames  # (N, N_FRAMES)
    windows = torch.gather(mels, 2, index[:, None, :].expand(B, n_mels, N_FRAMES))
    sizes = torch.from_numpy(np.asarray(segment_sizes, np.int64)).to(dev)
    return torch.where(frames[None, None, :] < sizes[:, None, None], windows, 0.0)


@torch.inference_mode()
def encode_clip(model, audio: np.ndarray):
    """A host waveform -> (cK, cV, n_windows): the clip's mel on the model's
    device, its contiguous 30 s windows stacked on the audio axis, the
    encoder and the cross-K/V, (L, n_windows, H, dh, 1500) each. Untimed:
    no profiling span, as the JAX frontend records none."""
    audio = np.asarray(audio, dtype=np.float32)
    n_windows = max(1, -(-audio.shape[-1] // N_SAMPLES))
    packed = pack_audio(audio, (n_windows + 1) * N_SAMPLES)
    n_mels = model.dims.n_mels
    mel = log_mel_spectrogram_torch(torch.from_numpy(packed).to(model.device), n_mels)
    windows = mel[:, : n_windows * N_FRAMES].reshape(n_mels, n_windows, N_FRAMES).transpose(0, 1)
    ck, cv = model.cross_kv_untimed(model.encode_untimed(windows))
    return ck, cv, n_windows


def encode_clip_spec(model, draft, audio: np.ndarray):
    """A host waveform -> (cK, cV, draft cK, draft cV, n_windows): each
    model's cross-K/V of the clip's 30 s windows (encode_clip), from its own
    mel, so the draft may have another n_mels than the target."""
    ck, cv, n_windows = encode_clip(model, audio)
    dck, dcv, _ = encode_clip(draft, audio)
    return ck, cv, dck, dcv, n_windows
