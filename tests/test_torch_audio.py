"""Port audio frontend vs the JAX package: decode (native and the ffmpeg
fallback), host mel, device mel and window slicing.

Tolerance for the mel is 2e-5 (log-mel units) wherever the order of the
float32 DFT sums cannot move an element that far, and a bound derived from
that arithmetic where it can (`_dft_order_bound`): the float32 DFT of the
port (a matmul) and of the JAX package (a convolution) sum in different
orders, and the host path computes in float64.

The derivation. For frame t, with y_n = x_n w_n the windowed frame (N = 400
samples) and S_t = sum_n |y_n|, each float32 implementation computes Re X_k
and Im X_k as N-term float32 dot products in its own order. By the rule of
thumb for an N-term float32 sum (Wilkinson; Higham & Mary, SIAM J. Sci.
Comput. 41(5), 2019) each part carries an error of at most
eps_t = sqrt(N) u S_t, u = 2**-24 (on jfk.flac the largest seen is 7 u S_t).
To first order the power |X_k|^2 then moves by 2 (|Re X_k| + |Im X_k|) eps_t,
the mel bin P_m = sum_k f_mk |X_k|^2 by the f_mk-weighted sum of that, and the
output (log10 P_m + 4) / 4 by dP_m / (4 ln(10) P_m). Below the floor at the
global max minus 8 the output is clamped, so P_m is read as at least the
floor's power. The terms after the DFT are non-negative sums whose relative
error (~201 u) moves the output by ~1e-6, inside 2e-5. A comparison of two
float32 implementations allows the bound twice, one against the float64 host
once. On jfk.flac the elements whose bound passes 2e-5 are the low-power
bins of loud frames (bin 0, frame 575: power 1.2e-6 in a frame of rms 0.32),
where the DFT sums cancel.

How much of the comparison that widens, on jfk.flac at 80 mels (88,000
elements): the bound passes 2e-5 at 49,407 elements between two float32
mels (35,595 against the float64 host), 10 x 2e-5 at 10,635 and 100 x 2e-5
at 1,325; the largest allowance is 7.5e-3 (bin 71, frame 95). The bound is
a worst case: the differences seen pass 2e-5 at one element (bin 0, frame
575: 3.95e-5 port against JAX, 2.59e-5 port against the host) and reach at
most 7.5% of their allowance."""

import shutil

import numpy as np
import pytest
import torch

from conftest import JFK
from whisper_tpu.audio import N_FRAMES, N_SAMPLES
from whisper_tpu.audio import load_audio as jax_load_audio
from whisper_tpu.ops import stft as jax_stft
from whisper_tpu.ops.mel import mel_filterbank
from whisper_tpu_torch import audio as port_audio
from whisper_tpu_torch.ops import stft as port_stft

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

TOL = 2e-5


def _dft_order_bound(audio, n_mels):
    """(n_mels, len(audio) // 160) bound on how far one float32 DFT's order
    of summation can move each normalized log-mel element (module docstring),
    computed in float64 from the float32 waveform."""
    n_fft, hop = jax_stft.N_FFT, jax_stft.HOP_LENGTH
    padded = np.pad(np.asarray(audio, np.float64), n_fft // 2, mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(padded, n_fft)[::hop]
    y = frames[: len(audio) // hop] * jax_stft._hann_window(n_fft)
    spec = np.fft.rfft(y, axis=-1)
    eps = np.sqrt(n_fft) * 2.0**-24 * np.abs(y).sum(-1)  # (T,)
    filters = mel_filterbank(n_mels).astype(np.float64)
    power = filters @ (np.abs(spec) ** 2).T
    d_power = filters @ (2.0 * (np.abs(spec.real) + np.abs(spec.imag)) * eps[:, None]).T
    floor = power.max() * 1e-8
    return d_power / np.maximum(power, floor) / (4.0 * np.log(10.0))


def _assert_mel_close(mine, theirs, bound, n_float32):
    """|mine - theirs| within TOL, or within `n_float32` times the DFT-order
    bound where that is larger (2 for two float32 mels, 1 against float64)."""
    tol = np.maximum(TOL, n_float32 * bound)
    assert mine.shape == theirs.shape == tol.shape
    excess = np.abs(mine - theirs) - tol
    assert excess.max() <= 0.0, np.unravel_index(excess.argmax(), excess.shape)


def _s16_waveform(n=160 * 600, seed=3):
    i16 = (np.random.RandomState(seed).randn(n) * 8000).astype(np.int16)
    return i16, i16.astype(np.float32) / 32768.0


def test_load_audio_matches_jax(jfk_audio):
    audio = port_audio.load_audio(JFK)
    assert audio.dtype == np.float32
    assert np.array_equal(audio, jax_load_audio(JFK))


def test_load_audio_errors(tmp_path):
    with pytest.raises(RuntimeError, match="cannot open file"):
        port_audio.load_audio(str(tmp_path / "missing.flac"))
    bad = tmp_path / "garbage.bin"
    bad.write_bytes(b"\x01\x02" * 100)
    with pytest.raises(RuntimeError, match="unrecognized container"):
        port_audio.load_audio(str(bad))


# A stand-in for ffmpeg on PATH: it appends its arguments to ffmpeg.log
# beside itself and writes the input file's bytes to stdout as the s16le
# stream, or fails with exit code 1 when built with fail=True.
_FFMPEG = """#!/bin/sh
echo "$@" >> "${{0%/*}}/ffmpeg.log"
{body}
"""
_FFMPEG_OK = """while [ $# -gt 0 ]; do
  if [ "$1" = "-i" ]; then src="$2"; fi
  shift
done
{cat} "$src"
"""
_FFMPEG_FAIL = 'echo "stand-in decoder error" >&2\nexit 1'


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch, jfk_audio):
    """Install the stand-in ffmpeg as the only program on PATH; returns
    (install(fail=False), calls()). Both native libraries are loaded before
    PATH changes, so neither needs g++ afterwards."""
    port_audio.native_available()
    cat = shutil.which("cat")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    monkeypatch.setenv("PATH", str(bin_dir))

    def install(fail=False):
        exe = bin_dir / "ffmpeg"
        body = _FFMPEG_FAIL if fail else _FFMPEG_OK.format(cat=cat)
        exe.write_text(_FFMPEG.format(body=body))
        exe.chmod(0o755)

    def calls():
        log = bin_dir / "ffmpeg.log"
        return log.read_text().splitlines() if log.exists() else []

    return install, calls


def _not_audio(tmp_path, name="clip.mp3", n=2000):
    path = tmp_path / name
    path.write_bytes(np.random.RandomState(7).randint(0, 256, n).astype(np.uint8).tobytes())
    return str(path)


def test_ffmpeg_fallback_matches_jax(tmp_path, fake_ffmpeg):
    install, calls = fake_ffmpeg
    install()
    path = _not_audio(tmp_path)
    audio = port_audio.load_audio(path)
    assert audio.dtype == np.float32 and audio.shape == (1000,)
    assert np.array_equal(audio, jax_load_audio(path))
    assert len(calls()) == 2 and all(f"-i {path} " in c and "-ar 16000" in c for c in calls())


def _raised(fn, path):
    with pytest.raises(RuntimeError) as info:
        fn(path)
    return type(info.value), str(info.value)


@pytest.mark.parametrize("ffmpeg", ["missing", "exit1"])
def test_ffmpeg_failure_reraises_native_error(tmp_path, fake_ffmpeg, ffmpeg):
    install, calls = fake_ffmpeg
    if ffmpeg == "exit1":
        install(fail=True)
    path = _not_audio(tmp_path)
    port = _raised(port_audio.load_audio, path)
    assert port == _raised(jax_load_audio, path)
    assert port[1].startswith(f"failed to decode audio {path!r}")
    assert len(calls()) == (2 if ffmpeg == "exit1" else 0)


def test_wav_and_flac_never_start_ffmpeg(tmp_path, fake_ffmpeg, jfk_audio):
    import wave

    install, calls = fake_ffmpeg
    install()
    i16, expected = _s16_waveform()
    path = tmp_path / "tone.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(i16.tobytes())
    assert np.array_equal(port_audio.load_audio(str(path)), expected)
    assert np.array_equal(port_audio.load_audio(JFK), jfk_audio)
    assert calls() == []


def test_torch_mel_matches_jax_and_numpy_on_jfk(jfk_audio):
    n = (len(jfk_audio) // 160) * 160
    audio = jfk_audio[:n]
    mine = port_stft.log_mel_spectrogram_torch(torch.from_numpy(audio), 80).numpy()
    jx = np.asarray(jax_stft.log_mel_spectrogram_jax(audio, 80))
    host = jax_stft.log_mel_spectrogram_np(audio, 80)
    bound = _dft_order_bound(audio, 80)
    _assert_mel_close(mine, jx, bound, 2)
    _assert_mel_close(mine, host, bound, 1)
    _assert_mel_close(jx, host, bound, 1)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_torch_mel_int16_matches_jax(n_mels):
    import jax.numpy as jnp

    i16, audio = _s16_waveform()
    from_i16 = port_stft.log_mel_spectrogram_torch(torch.from_numpy(i16), n_mels).numpy()
    from_f32 = port_stft.log_mel_spectrogram_torch(torch.from_numpy(audio), n_mels).numpy()
    assert np.array_equal(from_i16, from_f32)
    jx = np.asarray(jax_stft.log_mel_spectrogram_jax(jnp.asarray(i16), n_mels))
    assert np.abs(from_i16 - jx).max() < TOL
    assert np.abs(from_i16 - jax_stft.log_mel_spectrogram_np(audio, n_mels)).max() < TOL


def test_host_mel_is_the_jax_host_mel(jfk_audio):
    mine = port_audio.log_mel_spectrogram(jfk_audio, 80, padding=N_SAMPLES)
    theirs = jax_stft.log_mel_spectrogram_np(jfk_audio, 80, padding=N_SAMPLES)
    assert np.array_equal(mine, theirs)


def test_device_mel_full_and_window_match_jax(jfk_audio):
    mel, frames = port_stft.device_mel_full(jfk_audio, 80, "cpu")
    jmel, jframes = jax_stft.device_mel_full(jfk_audio, 80)
    assert frames == jframes
    assert tuple(mel.shape) == tuple(np.shape(jmel))
    bucket = np.zeros(mel.shape[-1] * jax_stft.HOP_LENGTH, np.float32)
    bucket[: len(jfk_audio)] = jfk_audio
    bound = _dft_order_bound(bucket, 80)
    _assert_mel_close(mel.numpy(), np.asarray(jmel), bound, 2)

    for seek, size in [(0, N_FRAMES), (frames - 100, 100), (350, 2000)]:
        win = port_stft.device_mel_window(mel, seek, size).numpy()
        jwin = np.asarray(jax_stft.device_mel_window(jmel, seek, size))
        win_bound = port_stft.device_mel_window(torch.from_numpy(bound), seek, size)
        assert win.shape == (80, N_FRAMES)
        _assert_mel_close(win, jwin, win_bound.numpy(), 2)
        assert np.all(win[:, size:] == 0.0)


def test_pad_or_trim():
    x = np.ones(1000, dtype=np.float32)
    assert port_audio.pad_or_trim(x, 480000).shape == (480000,)
    assert port_audio.pad_or_trim(np.ones(500000), 480000).shape == (480000,)
    assert port_audio.pad_or_trim(np.ones((80, 100)), 3000).shape == (80, 3000)
