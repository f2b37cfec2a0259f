"""ctypes binding for the native audio library (runtime/audioio.cpp): the
audio decoder, the log-mel spectrogram and the float32 <-> bf16 buffer
conversions (the counterpart of whisper_tpu/runtime/native.py).

The library is built with g++ from the repository's runtime/audioio.cpp into
the port's own build directory (whisper_tpu_torch/_build/) at first use. A
failure raises; there is no ffmpeg fallback and no numpy stand-in when the
library cannot be built or loaded.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "runtime", "audioio.cpp")

_lock = threading.Lock()
_lib = None


def _build(path: str):
    if not os.path.isfile(SOURCE):
        raise RuntimeError(f"audio decoder source not found: {SOURCE}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-o", tmp, SOURCE],
        capture_output=True,
        text=True,
        timeout=300,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"building the audio decoder failed:\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builders never see a partial file


def load_library() -> ctypes.CDLL:
    """The audioio library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = os.path.join(BUILD_DIR, "audioio.so")
            if not os.path.isfile(path) or os.path.getmtime(path) < os.path.getmtime(SOURCE):
                _build(path)
            lib = ctypes.CDLL(path)
            lib.audioio_decode.restype = ctypes.c_int
            lib.audioio_decode.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.audioio_free.restype = None
            lib.audioio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            lib.audioio_last_error.restype = ctypes.c_char_p
            lib.audioio_last_error.argtypes = []
            lib.audioio_log_mel.restype = ctypes.c_int
            lib.audioio_log_mel.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.c_int,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
            ]
            for name, src, dst in (
                ("audioio_f32_to_bf16", ctypes.c_float, ctypes.c_uint16),
                ("audioio_bf16_to_f32", ctypes.c_uint16, ctypes.c_float),
            ):
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = [ctypes.POINTER(src), ctypes.POINTER(dst), ctypes.c_int64]
            _lib = lib
        return _lib


def decode_audio(path: str, sample_rate: int) -> np.ndarray:
    """Decode an audio file (WAV/FLAC) to mono float32 at `sample_rate`.
    Raises RuntimeError with the decoder's message on failure."""
    lib = load_library()
    out_ptr = ctypes.POINTER(ctypes.c_float)()
    out_n = ctypes.c_int64(0)
    rc = lib.audioio_decode(
        path.encode("utf-8"), sample_rate, ctypes.byref(out_ptr), ctypes.byref(out_n)
    )
    if rc != 0:
        msg = lib.audioio_last_error().decode("utf-8", errors="replace")
        raise RuntimeError(f"failed to decode audio {path!r}: {msg}")
    try:
        return np.array(np.ctypeslib.as_array(out_ptr, shape=(out_n.value,)), np.float32)
    finally:
        lib.audioio_free(out_ptr)


def native_available() -> bool:
    """Whether the native library builds and loads here (False where there
    is no g++ or no runtime/audioio.cpp)."""
    try:
        load_library()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def log_mel_native(audio: np.ndarray, n_mels: int = 80, padding: int = 0) -> np.ndarray:
    """The log-mel spectrogram of runtime/audioio.cpp (audioio_log_mel), the
    mel the native runner computes: (n_mels, frames) float32 of the float32
    samples with `padding` zeros appended. Raises RuntimeError on failure."""
    lib = load_library()
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    frames = ctypes.c_int64(0)
    rc = lib.audioio_log_mel(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), audio.size, n_mels, padding,
        ctypes.byref(out), ctypes.byref(frames),
    )  # fmt: skip
    if rc != 0:
        msg = lib.audioio_last_error().decode("utf-8", errors="replace")
        raise RuntimeError(f"native log-mel failed: {msg}")
    try:
        return np.array(np.ctypeslib.as_array(out, shape=(n_mels, frames.value)), np.float32)
    finally:
        lib.audioio_free(out)


def f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even float32 -> bf16 in native code: a uint16 array
    of the same shape holding the bf16 bit patterns."""
    lib = load_library()
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.shape, dtype=np.uint16)
    lib.audioio_f32_to_bf16(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        x.size,
    )
    return out


def bf16_to_f32(x: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint16) -> float32, exactly, in native code."""
    lib = load_library()
    x = np.ascontiguousarray(x, dtype=np.uint16)
    out = np.empty(x.shape, dtype=np.float32)
    lib.audioio_bf16_to_f32(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        x.size,
    )
    return out
