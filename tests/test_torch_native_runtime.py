"""The port's native runtime pieces on the CPU: the audio library's log-mel
and bf16 conversions (whisper_tpu_torch/runtime/native.py) against the JAX
package's bindings of the same runtime/audioio.cpp, bit for bit; no fallback
when the library is missing; the compile cache's directory as an argument
(runtime_config.py); and the native runner's build (runtime/build.py): its
command line, and its source compiled against the installed torch headers
(no card is needed to compile, only to link and run). The runner itself
runs in a `cuda`-marked test, which skips without a card."""

import json
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from whisper_tpu_torch import runtime_config
from whisper_tpu_torch.kernels import build as kernels_build
from whisper_tpu_torch.runtime import build, native


@pytest.fixture(scope="module")
def jfk(jfk_flac_path):
    return native.decode_audio(jfk_flac_path, 16000)


@pytest.mark.parametrize("n_mels, padding", [(80, 0), (128, 480000)])
def test_log_mel_native_equals_jax(jfk, n_mels, padding):
    from whisper_tpu.runtime.native import log_mel_native as jax_log_mel_native

    got = native.log_mel_native(jfk, n_mels, padding=padding)
    want = jax_log_mel_native(jfk, n_mels, padding=padding)
    assert got.dtype == np.float32 and got.shape == want.shape == (n_mels, (jfk.size + padding) // 160)
    assert np.array_equal(got, want)


def test_bf16_conversions_equal_jax():
    from whisper_tpu.runtime.native import bf16_to_f32 as jax_bf16_to_f32
    from whisper_tpu.runtime.native import f32_to_bf16 as jax_f32_to_bf16

    rng = np.random.RandomState(0)
    x = (rng.randn(4, 257) * 10.0 ** rng.randint(-30, 30, size=(4, 257))).astype(np.float32)
    x[0, :6] = [np.inf, -np.inf, 0.0, -0.0, 1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8]  # ties to even
    bits = native.f32_to_bf16(x)
    assert bits.dtype == np.uint16 and bits.shape == x.shape
    assert np.array_equal(bits, jax_f32_to_bf16(x))
    assert np.array_equal(bits, torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16))
    back = native.bf16_to_f32(bits)
    assert np.array_equal(back, jax_bf16_to_f32(bits))
    assert np.array_equal(back, torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16).float().numpy())


def test_missing_library_raises(tmp_path, monkeypatch):
    """Without runtime/audioio.cpp the port raises where the JAX package's
    f32_to_bf16 / bf16_to_f32 fall back to numpy."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "missing" / "audioio.cpp"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    assert native.native_available() is False
    x = np.zeros(8, np.float32)
    for call in (
        lambda: native.log_mel_native(x, 80),
        lambda: native.f32_to_bf16(x),
        lambda: native.bf16_to_f32(x.view(np.uint16)),
        lambda: native.decode_audio("a.wav", 16000),
    ):
        with pytest.raises(RuntimeError, match="source not found"):
            call()


def test_compile_cache_directory_is_an_argument(tmp_path, monkeypatch):
    for var in ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    default = runtime_config.configure_compile_cache()
    assert default == str(tmp_path / "home" / ".cache" / "whisper_tpu_torch" / "inductor")
    chosen = runtime_config.configure_compile_cache(str(tmp_path / "cache"))
    assert chosen == str(tmp_path / "cache") and os.path.isdir(chosen)
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == chosen
    assert os.environ["TRITON_CACHE_DIR"] == os.path.join(chosen, "triton")
    from torch._inductor.runtime.cache_dir_utils import cache_dir

    assert cache_dir() == chosen


def test_runner_command_line(tmp_path):
    """g++ with torch's ABI flag and headers, the runner, runtime/audioio.cpp
    and the kernels' library (named by the kernels' source hash), libtorch
    and zlib, rpaths to torch/lib and the kernels. Nothing is built."""
    lib = kernels_build.library_path()
    before = set(os.listdir(kernels_build.BUILD_DIR)) if os.path.isdir(kernels_build.BUILD_DIR) else set()
    cmd = build.runner_command(str(tmp_path / "runner"), lib)
    assert cmd[0].endswith("g++")
    assert f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}" in cmd
    assert build.RUNNER_SOURCE in cmd and native.SOURCE in cmd and lib in cmd
    assert native.SOURCE.endswith(os.path.join("runtime", "audioio.cpp"))
    assert re.fullmatch(r"wtt_kernels_[0-9a-f]{16}\.so", os.path.basename(lib))
    torch_lib = os.path.join(os.path.dirname(torch.__file__), "lib")
    assert f"-Wl,-rpath,{torch_lib}" in cmd and f"-L{torch_lib}" in cmd
    for flag in ("-ltorch", "-ltorch_cuda", "-lc10_cuda", "-lz"):
        assert flag in cmd
    assert os.path.basename(build.runner_path()).startswith("wtt_transcribe_")
    after = set(os.listdir(kernels_build.BUILD_DIR)) if os.path.isdir(kernels_build.BUILD_DIR) else set()
    assert after == before


def test_runner_source_compiles(tmp_path):
    """The runner's source compiles with the build's flags against the
    installed torch's headers (-fsyntax-only: linking needs libtorch_cuda,
    which a CPU build of torch lacks)."""
    cmd = build.runner_command(str(tmp_path / "runner"), kernels_build.library_path())
    flags = [a for a in cmd[1:] if a.startswith(("-std=", "-D", "-I", "-W")) and not a.startswith("-Wl,")]
    out = subprocess.run(
        [cmd[0], "-fsyntax-only", *flags, build.RUNNER_SOURCE],
        capture_output=True, text=True, timeout=300,
    )  # fmt: skip
    assert out.returncode == 0, out.stderr[-4000:]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the native runner runs only on a card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_runner_matches_engine_on_card(cuda_device, tmp_path, jfk_flac_path):
    """Tiny float32 model (TF32 off): the runner's greedy tokens on one
    window at T = 0 equal the port's engine on the same mel bytes."""
    import whisper_tpu_torch
    from whisper_tpu_torch.engine import FusedEngine
    from whisper_tpu_torch.export import export_pipeline
    from whisper_tpu_torch.models.dims import ModelDimensions

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dims = ModelDimensions(80, 1500, 128, 2, 2, 51865, 448, 128, 2, 2)
    model = whisper_tpu_torch.Whisper(dims, None, device="cuda", compute_dtype=torch.float32, seed=3)
    pdir = str(tmp_path / "pipeline")
    export_pipeline(pdir, model, cache_dir=str(tmp_path / "cache"))
    runner = build.build_runner()
    res = subprocess.run(
        [runner, pdir, jfk_flac_path, "--tokens", "--max-windows", "1", "--no-fallback"],
        capture_output=True, text=True, errors="replace", timeout=900,
    )  # fmt: skip
    assert res.returncode == 0, res.stderr[-4000:]
    window = [json.loads(l[6:]) for l in res.stderr.splitlines() if l.startswith("[wtt] {\"window\"")][0]
    manifest = dict(l.rstrip("\n").split(" ", 1) for l in open(os.path.join(pdir, "pipeline.txt")))
    initial = [int(t) for t in manifest["initial_tokens"].split()]
    audio = native.decode_audio(jfk_flac_path, 16000)
    mel = native.log_mel_native(audio, dims.n_mels, padding=480000)[:, :3000]
    ck, cv = model.cross_kv(model.encode(mel[None]))
    ts, eot = int(manifest["timestamp_begin"]), int(manifest["eot"])
    smask = np.fromfile(os.path.join(pdir, "suppress_mask.bin"), dtype=bool)
    bmask = np.fromfile(os.path.join(pdir, "blank_mask.bin"), dtype=bool)
    out = FusedEngine(model).run(
        initial, ck, cv, sot_index=0, suppress_ids=np.nonzero(smask)[0].tolist(),
        blank_ids=np.nonzero(bmask)[0].tolist(), max_initial_ts_index=50,
        sample_len=int(manifest["sample_len"]), n_group=1, beam_search=False, max_candidates=0,
        use_timestamps=True, temperature=0.0, eot=eot, timestamp_begin=ts,
        no_timestamps=ts - 1, no_speech=ts - 2,
    )  # fmt: skip
    engine = [int(t) for t in out[0][0, len(initial) : int(out[1])] if t != eot]
    assert window["token_ids"] == engine
    assert window["greedy_launches"] == window["steps"]
