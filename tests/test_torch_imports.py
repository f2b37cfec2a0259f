"""The port imports neither JAX nor the JAX package, builds nothing on
import, and its entry points run on the card unless told otherwise."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

import whisper_tpu_torch

PKG = os.path.dirname(whisper_tpu_torch.__file__)
ROOT = os.path.dirname(PKG)


def _sources():
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, not sources
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".cpp")):
                yield os.path.join(dirpath, f)


def test_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['regex'] = None\n"
        "import whisper_tpu_torch, whisper_tpu_torch.engine, whisper_tpu_torch.ops.beam_kernel\n"
        "import whisper_tpu_torch.timing, whisper_tpu_torch.ops.dtw, whisper_tpu_torch.ops.median\n"
        "import whisper_tpu_torch.batch, whisper_tpu_torch.frontend, whisper_tpu_torch.cli\n"
        "import whisper_tpu_torch.models.registry, whisper_tpu_torch.utils.writers\n"
        "import whisper_tpu_torch.normalizers\n"
        "import whisper_tpu_torch.streaming, whisper_tpu_torch.continuous\n"
        "import whisper_tpu_torch.server, whisper_tpu_torch.http_server, whisper_tpu_torch.version\n"
        "import whisper_tpu_torch.quant, whisper_tpu_torch.speculative\n"
        "import whisper_tpu_torch.checkpoint, whisper_tpu_torch.finetune, whisper_tpu_torch.distill\n"
        "import whisper_tpu_torch.parallel.train, whisper_tpu_torch.comm\n"
        "import whisper_tpu_torch.parallel.mesh, whisper_tpu_torch.parallel.sharding\n"
        "import whisper_tpu_torch.parallel.serve, whisper_tpu_torch.parallel.launch\n"
        "import whisper_tpu_torch.parallel.sequence, whisper_tpu_torch.parallel.pipeline\n"
        "from whisper_tpu_torch.parallel import DataParallelEngine, make_mesh, pp_encode, sp_encode\n"
        "import os\n"
        "from whisper_tpu_torch.kernels.build import BUILD_DIR\n"
        "built = set(os.listdir(BUILD_DIR)) if os.path.isdir(BUILD_DIR) else set()\n"
        "import whisper_tpu_torch.export, whisper_tpu_torch.runtime.aoti\n"
        "import whisper_tpu_torch.runtime.native, whisper_tpu_torch.runtime.build\n"
        "import whisper_tpu_torch.runtime_config\n"
        "import whisper_tpu_torch.profiling, whisper_tpu_torch.export_pipeline\n"
        "import whisper_tpu_torch.config_matrix\n"
        "import whisper_tpu_torch.spec_distill_eval, whisper_tpu_torch.eval_wer\n"
        "import whisper_tpu_torch.validate_real\n"
        "assert (set(os.listdir(BUILD_DIR)) if os.path.isdir(BUILD_DIR) else set()) == built\n"
        "assert whisper_tpu_torch.runtime.native._lib is None  # the audio library is not loaded\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and (m == 'whisper_tpu' or m.startswith(('whisper_tpu.', 'jax')))]\n"
        "assert not bad, bad\n"
        "from whisper_tpu_torch.kernels import build\n"
        "assert build._lib is None  # nothing is built on import\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sources_name_no_jax_and_no_jax_package_module():
    for path in _sources():
        text = open(path, encoding="utf-8").read()
        assert not re.search(r"\bimport jax\b|\bfrom jax\b", text), path
        assert not re.search(r"whisper_tpu\.[A-Za-z_]", text), path
        assert "WHISPER_TPU_PROFILE" not in text, path  # profiling takes set_sync
        if path.endswith(".py"):
            for node in ast.walk(ast.parse(text)):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                for name in names:
                    top = name.split(".")[0]
                    assert top not in ("jax", "jaxlib", "whisper_tpu", "tiktoken", "tqdm", "regex"), (
                        path, name,
                    )  # fmt: skip


def test_entry_points_default_to_cuda(synth_checkpoint, tiny_dims):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        whisper_tpu_torch.load_model(synth_checkpoint)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        whisper_tpu_torch.Whisper(tiny_dims)
    model = whisper_tpu_torch.load_model(
        None, device="cpu", dims=tiny_dims, compute_dtype=torch.float32
    )
    assert model.device.type == "cpu"


def test_batch_and_cli_default_to_cuda(tmp_path, monkeypatch, synth_checkpoint, jfk_flac_path):
    """load_model's device defaults to cuda, and so does the CLI's
    --device, which is then an error on a machine without a card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid here")
    import inspect

    from whisper_tpu_torch import cli

    assert inspect.signature(whisper_tpu_torch.load_model).parameters["device"].default == "cuda"
    monkeypatch.setattr(
        sys, "argv", ["whisper-tpu-torch", jfk_flac_path, "--model", synth_checkpoint,
                      "--output_dir", str(tmp_path)],
    )  # fmt: skip
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.cli()


def test_package_data_lists_the_new_modules():
    """pyproject.toml installs the normalizers with their english.json, and
    the console script."""
    text = open(os.path.join(ROOT, "pyproject.toml"), encoding="utf-8").read()
    assert '"whisper_tpu_torch.normalizers"' in text
    assert '"normalizers/*.json"' in text
    assert 'whisper-tpu-torch = "whisper_tpu_torch.cli:cli"' in text
    assert 'whisper-tpu-torch-serve = "whisper_tpu_torch.server:main"' in text
    assert 'whisper-tpu-torch-http = "whisper_tpu_torch.http_server:main"' in text
    assert 'whisper-tpu-torch-finetune = "whisper_tpu_torch.finetune:main"' in text
    assert 'whisper-tpu-torch-distill = "whisper_tpu_torch.distill:main"' in text
    assert '"whisper_tpu_torch.parallel"' in text
    assert os.path.isfile(os.path.join(PKG, "normalizers", "english.json"))


def test_public_api_and_version():
    """The JAX package's streaming and serving exports, and its version."""
    import whisper_tpu

    for name in ("ContinuousBatcher", "StreamingTranscriber", "__version__"):
        assert name in whisper_tpu_torch.__all__ and name in whisper_tpu.__all__
    assert whisper_tpu_torch.__version__ == whisper_tpu.__version__


@pytest.mark.parametrize("module", ["server", "http_server"])
def test_servers_default_to_cuda(tmp_path, synth_checkpoint, module):
    """The servers' main() loads the model on the card unless --device
    says otherwise: on a machine without one that is an error, before
    anything listens."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid here")
    import importlib

    main = importlib.import_module(f"whisper_tpu_torch.{module}").main
    args = [str(tmp_path / "s.sock")] if module == "server" else ["--port", "0"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([*args, "--model", synth_checkpoint])
    assert not os.path.exists(tmp_path / "s.sock")


@pytest.mark.parametrize("module", ["finetune", "distill"])
def test_training_mains_default_to_cuda(tmp_path, synth_checkpoint, module):
    """finetune and distill load their model on the card unless --device
    says otherwise: without one that is an error, before any checkpoint
    is written."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid here")
    import importlib

    main = importlib.import_module(f"whisper_tpu_torch.{module}").main
    manifest = tmp_path / "m.jsonl"
    manifest.write_text('{"audio": "a.flac", "text": "x"}\n')
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([str(manifest), "--model", synth_checkpoint, "--out", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("module", ["spec_distill_eval", "eval_wer"])
def test_eval_tool_mains_default_to_cuda(tmp_path, synth_checkpoint, jfk_flac_path, module):
    """The evaluation tools load their model on the card unless --device
    says otherwise: without one that is an error, before the distillation
    eval writes anything."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid here")
    import importlib

    main = importlib.import_module(f"whisper_tpu_torch.{module}").main
    if module == "spec_distill_eval":
        args = ["--target", synth_checkpoint, "--workdir", str(tmp_path / "work")]
    else:
        (tmp_path / "refs").mkdir()
        (tmp_path / "refs" / "jfk.txt").write_text("and so my fellow americans")
        args = ["--ref-dir", str(tmp_path / "refs"), "--audio-dir", os.path.dirname(jfk_flac_path),
                "--model", synth_checkpoint]  # fmt: skip
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)
    assert not os.path.exists(tmp_path / "work")


def test_validate_real_defaults_to_cuda():
    """The drill's model loads (the long-form and acceptance sections, the
    eval_wer runs) take the card unless --device says otherwise."""
    import inspect

    from whisper_tpu_torch import validate_real

    for fn in (validate_real.run_wer, validate_real.run_wer_int8_delta, validate_real.run_spec_acceptance,
               validate_real.run_longform):  # fmt: skip
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    assert "--device" in validate_real.eval_wer_command("ls", "tiny.en", 1, "cuda")


def test_make_mesh_defaults_to_cuda_and_nccl():
    """make_mesh runs on CUDA with NCCL unless told otherwise: without a
    card that is an error, and nothing falls back to gloo or to the CPU
    (no process group is initialised)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid here")
    import inspect

    import torch.distributed as dist

    from whisper_tpu_torch.parallel import make_mesh

    params = inspect.signature(make_mesh).parameters
    assert params["device_type"].default == "cuda" and params["backend"].default is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    assert not dist.is_initialized()


def test_spawn_defaults_to_cuda():
    """parallel.launch.spawn starts its ranks on CUDA unless told
    otherwise: without a card it raises before starting a process, and
    nothing falls back to gloo on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid here")
    import inspect
    import multiprocessing

    from whisper_tpu_torch.parallel.launch import spawn

    params = inspect.signature(spawn).parameters
    assert params["device_type"].default == "cuda" and params["backend"].default is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spawn(os.getpid, 2)
    assert not multiprocessing.active_children()
