"""Log-mel spectrogram: host (numpy) and device (torch) implementations.

The host path is copied from whisper_tpu/ops/stft.py (framework-free). The
device path is the counterpart of `log_mel_spectrogram_jax`: reflect pad,
the 400-point Hann real-DFT basis applied to 160-sample hops, the final
frame dropped, log10 with a 1e-10 floor, clamp at the global max minus 8,
then (x + 4) / 4. int16 input is read as i / 32768.

The DFT is a framing view times the (400, 402) basis as one matmul rather
than a convolution: a float32 matmul on the card runs in full float32 unless
`torch.backends.cuda.matmul.allow_tf32` is set, whereas cuDNN convolutions
default to TF32 — the JAX version pins Precision.HIGHEST for the same reason.
"""

import numpy as np
import torch

from .mel import mel_filterbank

HOP_LENGTH = 160
N_FFT = 400
_CHUNK_SAMPLES = 30 * 16000


def _hann_window(n: int) -> np.ndarray:
    # periodic Hann, as used by torch.hann_window(N)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float64)


def log_mel_raw_np(audio: np.ndarray, n_mels: int = 80, padding: int = 0) -> np.ndarray:
    """Unnormalized log10 mel: (n_mels, n_samples//160) float64."""
    audio = np.asarray(audio, dtype=np.float32)
    if padding > 0:
        audio = np.concatenate([audio, np.zeros(padding, dtype=np.float32)])

    half = N_FFT // 2
    padded = np.pad(audio.astype(np.float64), (half, half), mode="reflect")
    n_frames = 1 + (padded.shape[0] - N_FFT) // HOP_LENGTH
    frames = np.lib.stride_tricks.as_strided(
        padded,
        shape=(n_frames, N_FFT),
        strides=(padded.strides[0] * HOP_LENGTH, padded.strides[0]),
        writeable=False,
    )
    spec = np.fft.rfft(frames * _hann_window(N_FFT), axis=-1)
    magnitudes = np.abs(spec[:-1]) ** 2  # drop the final frame like torch path

    mel = mel_filterbank(n_mels).astype(np.float64) @ magnitudes.T
    return np.log10(np.maximum(mel, 1e-10))


def normalize_log_mel(log_spec: np.ndarray, log_max: float) -> np.ndarray:
    """Clamp to (max - 8), then (x + 4) / 4."""
    log_spec = np.maximum(log_spec, log_max - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def log_mel_spectrogram_np(audio: np.ndarray, n_mels: int = 80, padding: int = 0) -> np.ndarray:
    """audio: float32 (n_samples,) at 16 kHz -> (n_mels, n_samples//160) float32."""
    log_spec = log_mel_raw_np(audio, n_mels=n_mels, padding=padding)
    return normalize_log_mel(log_spec, float(log_spec.max()))


def _dft_basis(device) -> torch.Tensor:
    """(N_FFT, 2F) windowed real-DFT basis: cos columns then sin columns."""
    window = _hann_window(N_FFT)
    F = N_FFT // 2 + 1
    k = np.arange(N_FFT)[:, None] * np.arange(F)[None, :]
    ang = -2.0 * np.pi * k / N_FFT
    basis = np.concatenate(
        [np.cos(ang) * window[:, None], np.sin(ang) * window[:, None]], axis=1
    ).astype(np.float32)
    return torch.from_numpy(basis).to(device)


def log_mel_raw_torch(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Unnormalized log10 mel on the audio's device: audio (n,) or (batch,
    n) float32 or int16, n % 160 == 0 -> (..., n_mels, n // 160) float32,
    before the floor at the global max minus 8."""
    if audio.dtype == torch.int16:
        audio = audio.to(torch.float32) / 32768.0
    single = audio.ndim == 1
    if single:
        audio = audio[None]
    n = audio.shape[1]
    if n % HOP_LENGTH:
        raise ValueError("audio length must be a multiple of the hop")

    half = N_FFT // 2
    left = audio[:, 1 : half + 1].flip(-1)
    right = audio[:, -half - 1 : -1].flip(-1)
    padded = torch.cat([left, audio, right], dim=1)

    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :-1]  # (b, n//160, 400)
    spec = frames @ _dft_basis(audio.device)  # (b, n//160, 2F)
    F = N_FFT // 2 + 1
    magnitudes = spec[..., :F] ** 2 + spec[..., F:] ** 2  # (b, T, 201)

    filters = torch.from_numpy(mel_filterbank(n_mels)).to(audio.device)
    mel = filters @ magnitudes.transpose(1, 2)  # (b, n_mels, T)

    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    return log_spec[0] if single else log_spec


def normalize_log_mel_torch(log_spec: torch.Tensor, log_max) -> torch.Tensor:
    """Clamp to (max - 8), then (x + 4) / 4: `log_max` a float, or a tensor
    that broadcasts against `log_spec`."""
    return (torch.clamp(log_spec, min=log_max - 8.0) + 4.0) / 4.0


def log_mel_spectrogram_torch(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio: (n,) or (batch, n) float32 or int16 tensor, n % 160 == 0 ->
    (..., n_mels, n // 160) float32 on the audio's device, floored at each
    row's global max minus 8."""
    log_spec = log_mel_raw_torch(audio, n_mels)
    return normalize_log_mel_torch(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True))


def pack_audio(audio, total_samples: int) -> np.ndarray:
    """A float32 waveform zero-padded to `total_samples`: as int16 when every
    sample is exactly representable (i / 32768, as 16-bit PCM decodes), half
    the bytes to upload and the same mel; as float32 otherwise (copied from
    whisper_tpu/frontend.py)."""
    audio = np.asarray(audio, dtype=np.float32)
    n = audio.shape[-1]
    scaled = audio * 32768.0
    if np.all(np.abs(scaled) <= 32767) and np.array_equal(scaled, np.round(scaled)):
        packed = np.zeros(total_samples, dtype=np.int16)
        packed[:n] = scaled.astype(np.int16)
    else:
        packed = np.zeros(total_samples, dtype=np.float32)
        packed[:n] = audio
    return packed


def device_mel_raw(audio, n_mels: int, device):
    """audio: float32 (n,) host waveform -> (raw log-mel (n_mels, F) on
    `device`, content_frames). The waveform is zero-padded by 30 s and up
    to a 30 s multiple (extra zeros cannot change the global max);
    content_frames is derived from the true length. Audio representable as
    int16 is uploaded as int16 (pack_audio)."""
    n = np.asarray(audio).shape[-1]
    bucket = -(-(n + _CHUNK_SAMPLES) // _CHUNK_SAMPLES) * _CHUNK_SAMPLES
    padded = pack_audio(audio, bucket)
    return log_mel_raw_torch(torch.from_numpy(padded).to(device), n_mels), n // HOP_LENGTH


def device_mel_full(audio, n_mels: int, device):
    """audio: float32 (n,) host waveform -> (device mel (n_mels, F),
    content_frames): device_mel_raw floored at its global max minus 8."""
    raw, content_frames = device_mel_raw(audio, n_mels, device)
    return normalize_log_mel_torch(raw, raw.amax()), content_frames


def device_mel_window(mel: torch.Tensor, seek: int, segment_size: int) -> torch.Tensor:
    """The (n_mels, 3000) window at frame `seek`, with frames >=
    segment_size zeroed. Like a dynamic slice, the start is clamped so that
    the window fits."""
    n_frames = _CHUNK_SAMPLES // HOP_LENGTH
    start = max(0, min(int(seek), mel.shape[-1] - n_frames))
    win = mel[:, start : start + n_frames].clone()
    win[:, max(0, int(segment_size)) :] = 0.0
    return win
