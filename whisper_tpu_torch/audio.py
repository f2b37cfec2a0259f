"""Audio frontend: decode, pad/trim, log-mel features.

Constants and semantics follow whisper_tpu/audio.py: 16 kHz, 400-point FFT,
160-sample hop, 30 s (3000-frame) windows. Decoding goes through the native
decoder (runtime/native.py: WAV and FLAC) and falls back to an ffmpeg
subprocess for other containers, as the JAX package's load_audio does.
"""

from subprocess import CalledProcessError, run
from typing import Union

import numpy as np

from .ops.stft import log_mel_spectrogram_np
from .runtime.native import decode_audio, native_available
from .utils import exact_div

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000 samples per 30-second chunk
N_FRAMES = exact_div(N_SAMPLES, HOP_LENGTH)  # 3000 mel frames per chunk

N_SAMPLES_PER_TOKEN = HOP_LENGTH * 2  # initial convs have stride 2
FRAMES_PER_SECOND = exact_div(SAMPLE_RATE, HOP_LENGTH)  # 10 ms per frame
TOKENS_PER_SECOND = exact_div(SAMPLE_RATE, N_SAMPLES_PER_TOKEN)  # 20 ms per token


# copied from whisper_tpu/audio.py:34-48
def _load_audio_ffmpeg(file: str, sr: int) -> np.ndarray:
    cmd = [
        "ffmpeg", "-nostdin", "-threads", "0", "-i", file,
        "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le", "-ar", str(sr), "-",
    ]  # fmt: skip
    try:
        out = run(cmd, capture_output=True, check=True).stdout
    except CalledProcessError as e:
        raise RuntimeError(f"Failed to load audio: {e.stderr.decode()}") from e
    except FileNotFoundError as e:
        raise RuntimeError(
            "Cannot decode audio: native decoder failed and ffmpeg is not installed"
        ) from e
    return np.frombuffer(out, np.int16).flatten().astype(np.float32) / 32768.0


def load_audio(file: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Read an audio file as a mono float32 waveform at `sr` Hz: the native
    decoder first; where it fails, ffmpeg; where both fail, the native
    decoder's error (ffmpeg's when the native library is unavailable)."""
    native_error = None
    if native_available():
        try:
            return decode_audio(file, sr)
        except RuntimeError as e:
            native_error = e
    try:
        return _load_audio_ffmpeg(file, sr)
    except RuntimeError:
        if native_error is not None:
            raise native_error
        raise


def pad_or_trim(array, length: int = N_SAMPLES, *, axis: int = -1):
    """Pad with zeros or trim the array along `axis` to exactly `length`."""
    array = np.asarray(array)
    if array.shape[axis] > length:
        array = array.take(indices=range(length), axis=axis)
    if array.shape[axis] < length:
        pad_widths = [(0, 0)] * array.ndim
        pad_widths[axis] = (0, length - array.shape[axis])
        array = np.pad(array, pad_widths)
    return array


def log_mel_spectrogram(
    audio: Union[str, np.ndarray], n_mels: int = 80, padding: int = 0
) -> np.ndarray:
    """Host (numpy) log-mel of an audio file or 16 kHz waveform, optionally
    right-padded with `padding` zero samples: (n_mels, n_frames) float32."""
    if isinstance(audio, str):
        audio = load_audio(audio)
    audio = np.asarray(audio, dtype=np.float32)
    return log_mel_spectrogram_np(audio, n_mels=n_mels, padding=padding)
