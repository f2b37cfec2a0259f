"""Process-level compile cache of the exported graphs (the counterpart of
whisper_tpu/runtime_config.py, which turns on JAX's persistent compilation
cache).

AOTInductor compiles each exported graph (export.py, runtime/aoti.py) with
Inductor, whose on-disk caches (generated code, compiled kernels, and
Triton's cubins beneath them) let a later compile of the same graph in
another process skip most of the work. Their directory is an argument,
never an environment switch of the port's own.
"""

import os

DEFAULT_CACHE_DIR = os.path.join("~", ".cache", "whisper_tpu_torch", "inductor")


def configure_compile_cache(cache_dir=None) -> str:
    """Point Inductor's and Triton's on-disk caches at `cache_dir` (default
    ~/.cache/whisper_tpu_torch/inductor) for this process and the processes
    it starts. Returns the directory."""
    path = os.path.abspath(os.path.expanduser(cache_dir or DEFAULT_CACHE_DIR))
    os.makedirs(path, exist_ok=True)
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = path
    os.environ["TRITON_CACHE_DIR"] = os.path.join(path, "triton")
    from torch._inductor.utils import clear_caches

    clear_caches()  # drop directories Inductor looked up before the switch
    return path
