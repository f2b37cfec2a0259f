"""AOTInductor packages of the exported graphs, compiled and run from Python
(the counterpart of whisper_tpu/runtime/pjrt.py's PjrtRunner).

`compile_package` AOT-compiles a `<name>.export.pt2` (export.py) for the
device its program was traced on into a package kept in a cache directory,
keyed by the archive's sha256, the torch version and the device's compute
capability: an edited export or another card never loads a stale package
whose inputs differ from the spec (the rule of pjrt.py's executable cache).
`compile_graphs` runs several compiles at once in spawned worker processes.
`AotiRunner` loads a pipeline directory's graphs through that cache and runs
them on CUDA tensors, checking each call against the graph's spec; a CUDA
tensor is the port's device-resident buffer, so there is no buffer class.
"""

import concurrent.futures
import hashlib
import json
import multiprocessing
import os
import shutil
import time

import torch

from ..runtime_config import configure_compile_cache
from .build import gxx


def _package_key(export_path: str, device_index: int) -> str:
    h = hashlib.sha256()
    with open(export_path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    major, minor = torch.cuda.get_device_capability(device_index)
    h.update(f"torch {torch.__version__} sm_{major}{minor}".encode())
    return h.hexdigest()[:24]


def compile_package(export_path: str, cache_dir=None, device_index: int = 0):
    """The AOTInductor package of an exported graph: compiled into
    `<cache>/aoti/` unless a package of the same key is there. Returns
    (package path, compile seconds, whether it came from the cache)."""
    cache = configure_compile_cache(cache_dir)
    name = os.path.basename(export_path).removesuffix(".export.pt2")
    os.makedirs(os.path.join(cache, "aoti"), exist_ok=True)
    path = os.path.join(cache, "aoti", f"{name}.{_package_key(export_path, device_index)}.aoti.pt2")
    if os.path.isfile(path):
        return path, 0.0, True
    t0 = time.perf_counter()
    ep = torch.export.load(export_path)
    tmp = f"{path}.{os.getpid()}.tmp.pt2"
    # cpp.cxx: Inductor would take $CXX before g++; the packages are built
    # with the runner's g++ (runtime/build.py), whose link step has OpenMP,
    # which Inductor's wrapper always links. Triton compiles one kernel per
    # candidate configuration that compile-time autotuning benchmarks:
    # pointwise kernels get one configuration (a third of the turbo step
    # graph's compile time, PERF.md §6), and deterministic mode, where this
    # torch has it, keeps one per reduction and benchmarks nothing
    configs = {"cpp.cxx": (None, gxx()), "triton.autotune_pointwise": False}
    if hasattr(torch._inductor.config, "deterministic"):
        configs["deterministic"] = True
    with torch.cuda.device(device_index):
        torch._inductor.aoti_compile_and_package(ep, package_path=tmp, inductor_configs=configs)
    os.replace(tmp, path)  # atomic: a concurrent loader never sees a partial package
    return path, time.perf_counter() - t0, False


def _compile_into_dir(export_path: str, cache_dir):
    """Worker job: compile (or find) the package and put it beside the
    export as `<name>.aoti.pt2`, the file the native runner loads."""
    import torch._inductor.config

    # one graph a worker, all started together: Inductor's own pool of
    # compile processes in each would only oversubscribe the cores
    torch._inductor.config.compile_threads = 1
    try:
        path, seconds, cached = compile_package(export_path, cache_dir)
    except Exception as e:  # Inductor's errors may not pickle back to the parent
        raise RuntimeError(f"compiling {export_path} failed: {type(e).__name__}: {e}") from None
    shutil.copyfile(path, export_path.removesuffix(".export.pt2") + ".aoti.pt2")
    return seconds, cached


def compile_graphs(export_paths, cache_dir=None, workers=None):
    """Compile exported graphs into `<name>.aoti.pt2` beside each, in
    spawned worker processes (compile time is host work: Inductor's
    lowering, Triton and the C++ wrapper). Archives of the same package key
    (one graph exported twice, byte for byte) compile once.
    `workers` caps the processes (default: half the CPUs); a worker takes
    the next graph when it is done with one, in the order given: a warm
    worker compiles a graph in a fraction of the time a process takes for
    its first (PERF.md §6). `export_paths` may be any iterable: each graph
    is submitted as the iterable yields it, so a caller can trace the next
    one while the first compile. Returns [(seconds, cached)] in the order
    given; a failed compile raises."""
    if not torch.cuda.is_available():
        raise RuntimeError("AOTInductor packages are compiled for a CUDA card; none is available")
    dev = torch.cuda.current_device()
    paths, keys, firsts = [], [], {}
    ctx = multiprocessing.get_context("spawn")
    workers = workers or max(1, (os.cpu_count() or 2) // 2)
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        for path in export_paths:
            key = _package_key(path, dev)
            if key not in firsts:
                firsts[key] = (path, pool.submit(_compile_into_dir, path, cache_dir))
            paths.append(path)
            keys.append(key)
        done = {key: future.result() for key, (_, future) in firsts.items()}
    out = []
    for path, key in zip(paths, keys):
        first = firsts[key][0]
        if first != path:
            shutil.copyfile(first.removesuffix(".export.pt2") + ".aoti.pt2",
                            path.removesuffix(".export.pt2") + ".aoti.pt2")  # fmt: skip
            out.append((0.0, True))
        else:
            out.append(done[key])
    return out


class AotiRunner:
    """The graphs of an export directory, compiled for the current CUDA
    device through the package cache and run from Python."""

    def __init__(self, export_dir: str, cache_dir=None):
        if not torch.cuda.is_available():
            raise RuntimeError("AotiRunner runs AOTInductor packages on a CUDA card; none is available")
        self.export_dir = export_dir
        self.cache_dir = cache_dir
        self.specs = {}
        self._graphs = {}

    def load_graph(self, name: str):
        """Compile `<name>.export.pt2` or reuse its cached package, and load
        it. Returns (compile seconds, load seconds, whether cached)."""
        with open(os.path.join(self.export_dir, f"{name}.spec.json")) as f:
            self.specs[name] = json.load(f)
        dev = torch.cuda.current_device()
        export_path = os.path.join(self.export_dir, f"{name}.export.pt2")
        path, compile_s, cached = compile_package(export_path, self.cache_dir, dev)
        t0 = time.perf_counter()
        self._graphs[name] = torch._inductor.aoti_load_package(path, device_index=dev)
        return compile_s, time.perf_counter() - t0, cached

    def execute(self, name: str, inputs):
        """Run a loaded graph on its flat inputs (weights first), each
        checked against the spec's count, shape and dtype. Returns the
        output tensors; inputs the graph writes (a step's cache) are
        updated in place."""
        spec = self.specs[name]
        if len(inputs) != len(spec["inputs"]):
            raise ValueError(f"{name}: {len(inputs)} inputs, the spec has {len(spec['inputs'])}")
        for i, (t, s) in enumerate(zip(inputs, spec["inputs"])):
            if list(t.shape) != s["shape"] or str(t.dtype).removeprefix("torch.") != s["dtype"]:
                raise ValueError(
                    f"{name} input {i}: {tuple(t.shape)} {t.dtype}, spec {s['shape']} {s['dtype']}"
                )
            if not t.is_cuda or not t.is_contiguous():
                raise ValueError(f"{name} input {i} must be a contiguous CUDA tensor")
        outputs = self._graphs[name].loader.run(list(inputs))
        if len(outputs) != len(spec["outputs"]):
            raise RuntimeError(f"{name}: {len(outputs)} outputs, the spec has {len(spec['outputs'])}")
        return outputs
