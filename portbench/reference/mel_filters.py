"""The Slaney-normalised mel filterbank of librosa.filters.mel(sr=16000,
n_fft=400, n_mels=n_mels), the one openai/whisper ships as mel_filters.npz,
worked out from its formula in float64. A frozen copy kept with the
benchmark, so that the reference shares no code with the program."""

import numpy as np

SAMPLE_RATE = 16000
N_FFT = 400
_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney's scale: linear below 1 kHz, logarithmic above."""
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log = freq >= _MIN_LOG_HZ
    return np.where(log, _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP, mels)


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    freqs = _F_SP * mels
    log = mels >= _MIN_LOG_MEL
    return np.where(log, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)), freqs)


def mel_filters(n_mels: int) -> np.ndarray:
    """(n_mels, N_FFT // 2 + 1) float32."""
    fft_freqs = np.fft.rfftfreq(n=N_FFT, d=1.0 / SAMPLE_RATE)
    edges = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(SAMPLE_RATE / 2.0), n_mels + 2))
    widths = np.diff(edges)
    ramps = edges[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / widths[:-1, None]
    upper = ramps[2:] / widths[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (edges[2 : n_mels + 2] - edges[:n_mels]))[:, None]
    return weights.astype(np.float32)
