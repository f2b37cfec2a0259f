"""Build and load the hand-written CUDA kernels (whisper_tpu_torch/csrc/).

nvcc compiles the sources for sm_90a into one shared library with a plain C
interface, loaded with ctypes. The library lands in the gitignored
whisper_tpu_torch/_build/ under a name keyed by the sources' hash, so an
edited source is rebuilt. Nothing is built on import: the first CUDA launch
(or an explicit `build_library()`) builds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("greedy_argmax.cu", "beam_update.cu", "dtw.cu", "median_filter.cu")
HEADERS = ("update_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)  # fmt: skip

_lock = threading.Lock()
_lib = None
build_log = ""  # the compiler's output (register and shared-memory use)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "wtt_greedy_argmax": [_P] * 6 + [_I] * 8 + [_P],
    "wtt_greedy_argmax_rows": [_P] * 7 + [_I] * 7 + [_P],
    "wtt_greedy_argmax_state": [_P] * 8 + [_I] * 6 + [_P],
    "wtt_greedy_argmax_rows_state": [_P] * 9 + [_I] * 6 + [_P],
    "wtt_beam_update": [_P] * 12 + [_I] * 11 + [_P],
    "wtt_beam_update_state": [_P] * 14 + [_I] * 8 + [_P],
    "wtt_greedy_argmax_chunks": [_I],
    "wtt_beam_update_chunks": [_I] * 2,
    "wtt_dtw_trace": [_P] * 2 + [_I] * 2 + [_P],
    "wtt_median_filter": [_P] * 2 + [_I] * 4 + [_P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS + (" ".join(NVCC_FLAGS),):
        path = os.path.join(CSRC, name)
        h.update(open(path, "rb").read() if os.path.isfile(path) else name.encode())
    return os.path.join(BUILD_DIR, f"wtt_kernels_{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile the kernels if this version of the sources is not built yet:
    one nvcc per source, all started together, then one link. Returns the
    library's path."""
    global build_log
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [os.path.join(BUILD_DIR, f"{s}.{tag}.o") for s in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )  # fmt: skip
        for src, obj in zip(SOURCES, objs)
    ]
    logs = [p.communicate(timeout=900)[0] for p in procs]
    build_log = "".join(logs)
    failed = [src for src, p in zip(SOURCES, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = f"{path}.{tag}"
    link = subprocess.run(
        [nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True, timeout=300
    )
    for obj in objs:
        os.remove(obj)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builders never load a partial file
    return path


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
