"""Build the native runner (csrc/wtt_transcribe.cpp) at first use (the
counterpart of runtime/Makefile's wtpu_transcribe target).

g++ compiles the runner and its CUDA-graph unit (csrc/wtt_graph.cpp, the
one source that includes the CUDA toolkit's headers) with
runtime/audioio.cpp against libtorch (the headers and libraries inside the
torch package: ATen, c10's CUDA streams and AOTInductor's package loader),
with torch's own C++ ABI flag and an rpath to torch/lib, and links the
kernels' library that kernels/build.py builds (the update kernels' C ABI),
cudart where a unit needs it, and zlib. The binary lands in the gitignored
whisper_tpu_torch/_build/ under a name keyed by the hash of its sources and
of the kernels' library name (itself keyed by the kernels' sources), so an
edited runner or kernel rebuilds it.
"""

import hashlib
import os
import shutil
import subprocess

import torch

from ..kernels import build as kernels_build
from . import native

RUNNER_SOURCE = os.path.join(kernels_build.CSRC, "wtt_transcribe.cpp")
GRAPH_SOURCE = os.path.join(kernels_build.CSRC, "wtt_graph.cpp")
CXX_FLAGS = ("-std=c++17", "-O2", "-Wno-deprecated-declarations")
TORCH_LIBS = ("-ltorch", "-ltorch_cpu", "-ltorch_cuda", "-lc10", "-lc10_cuda")


def runner_path() -> str:
    """Where the runner for these sources is built."""
    h = hashlib.sha256()
    for path in (RUNNER_SOURCE, GRAPH_SOURCE, native.SOURCE):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(os.path.basename(kernels_build.library_path()).encode())
    h.update(" ".join(CXX_FLAGS + TORCH_LIBS).encode() + torch.__version__.encode())
    return os.path.join(kernels_build.BUILD_DIR, f"wtt_transcribe_{h.hexdigest()[:16]}")


def gxx() -> str:
    """The g++ on PATH, which builds the runner and AOTInductor's packages."""
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the native runner and the packages are built with g++")
    return path


def cuda_home() -> str:
    """The CUDA toolkit's root (the headers wtt_graph.cpp includes, cudart)."""
    from torch.utils import cpp_extension

    return cpp_extension.CUDA_HOME or "/usr/local/cuda"


def runner_command(out_path: str, kernel_library: str) -> list:
    """The compiler's command line that builds the runner into `out_path`."""
    from torch.utils import cpp_extension

    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    cuda = cuda_home()
    lib_dirs = cpp_extension.library_paths() + [os.path.join(cuda, "lib64")]
    return [
        gxx(), *CXX_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
        *(f"-I{p}" for p in cpp_extension.include_paths()), f"-I{os.path.join(cuda, 'include')}",
        "-o", out_path, RUNNER_SOURCE, GRAPH_SOURCE, native.SOURCE, kernel_library,
        *(f"-L{p}" for p in lib_dirs), *TORCH_LIBS, "-lz", "-lpthread",
        "-Wl,--as-needed", "-lcudart", "-Wl,--no-as-needed",
        *(f"-Wl,-rpath,{p}" for p in lib_dirs + [os.path.dirname(kernel_library)]),
    ]  # fmt: skip


def build_runner() -> str:
    """Build the runner if this version is not built yet (the kernels'
    library first, with nvcc). Returns the binary's path; a failed build
    raises."""
    path = runner_path()
    if os.path.isfile(path):
        return path
    kernel_library = kernels_build.build_library()
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        runner_command(tmp, kernel_library), capture_output=True, text=True, timeout=900
    )
    if proc.returncode != 0:
        raise RuntimeError(f"building the native runner failed:\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent caller never runs a partial binary
    return path
