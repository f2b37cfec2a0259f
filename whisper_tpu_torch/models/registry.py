"""Checkpoint registry: download URLs, SHA256 digests, alignment heads.

Copied from whisper_tpu/models/registry.py (framework-free): the published
openai/whisper checkpoints, their digests and their alignment-head masks.
`download_checkpoint` reuses a cached file whose SHA256 matches and
downloads otherwise; a failed download raises RuntimeError naming the
cache directory, so that a machine without the file or a network stops
with a message instead of waiting.
"""

import hashlib
import os
import urllib.request
import warnings
from typing import List, Optional

DOWNLOAD_TIMEOUT_S = 60  # per blocking socket operation of a download

_BASE = "https://openaipublic.azureedge.net/main/whisper/models"

_CHECKPOINTS = {
    "tiny.en": "d3dd57d32accea0b295c96e26691aa14d8822fac7d9d27d5dc00b4ca2826dd03",
    "tiny": "65147644a518d12f04e32d6f3b26facc3f8dd46e5390956a9424a650c0ce22b9",
    "base.en": "25a8566e1d0c1e2231d1c762132cd20e0f96a85d16145c3a00adf5d1ac670ead",
    "base": "ed3a0b6b1c0edf879ad9b11b1af5a0e6ab5db9205f891f668f8b0e6c6326e34e",
    "small.en": "f953ad0fd29cacd07d5a9eda5624af0f6bcf2258be67c92b79389873d91e0872",
    "small": "9ecf779972d90ba49c06d968637d720dd632c55bbf19d441fb42bf17a411e794",
    "medium.en": "d7440d1dc186f76616474e0ff0b3b6b879abc9d1a4926b7adfa41db2d497ab4f",
    "medium": "345ae4da62f9b3d59415adc60127b97c714f32e89e936602e85993674d08dcb1",
    "large-v1": "e4b87e7e0bf463eb8e6956e646f1e277e901512310def2c24bf0e11bd3c28e9a",
    "large-v2": "81f7c96c852ee8fc832187b0132e569d6c3065a3252ed18e56effd0b6a73e524",
    "large-v3": "e5b1a55b89c1367dacf97e3e19bfd829a01529dbfdeefa8caeb59b3f1b81dadb",
    "large": "e5b1a55b89c1367dacf97e3e19bfd829a01529dbfdeefa8caeb59b3f1b81dadb",
    "large-v3-turbo": "aff26ae408abcba5fbf8813c21e62b0941638c5f6eebfb145be0c9839262a19a",
    "turbo": "aff26ae408abcba5fbf8813c21e62b0941638c5f6eebfb145be0c9839262a19a",
}

# the aliases download their full names' files
_FILE_NAMES = {"large": "large-v3", "turbo": "large-v3-turbo"}
_MODELS = {
    name: f"{_BASE}/{sha}/{_FILE_NAMES.get(name, name)}.pt" for name, sha in _CHECKPOINTS.items()
}

# base85+gzip packed (n_text_layer, n_text_head) bool masks marking the
# cross-attention heads used for word-level timing alignment (published with
# each openai/whisper checkpoint).
ALIGNMENT_HEADS = {
    "tiny.en": b"ABzY8J1N>@0{>%R00Bk>$p{7v037`oCl~+#00",
    "tiny": b"ABzY8bu8Lr0{>%RKn9Fp%m@SkK7Kt=7ytkO",
    "base.en": b"ABzY8;40c<0{>%RzzG;p*o+Vo09|#PsxSZm00",
    "base": b"ABzY8KQ!870{>%RzyTQH3`Q^yNP!>##QT-<FaQ7m",
    "small.en": b"ABzY8>?_)10{>%RpeA61k&I|OI3I$65C{;;pbCHh0B{qLQ;+}v00",
    "small": b"ABzY8DmU6=0{>%Rpa?J`kvJ6qF(V^F86#Xh7JUGMK}P<N0000",
    "medium.en": b"ABzY8usPae0{>%R7<zz_OvQ{)4kMa0BMw6u5rT}kRKX;$NfYBv00*Hl@qhsU00",
    "medium": b"ABzY8B0Jh+0{>%R7}kK1fFL7w6%<-Pf*t^=N)Qr&0RR9",
    "large-v1": b"ABzY8r9j$a0{>%R7#4sLmoOs{s)o3~84-RPdcFk!JR<kSfC2yj",
    "large-v2": b"ABzY8zd+h!0{>%R7=D0pU<_bnWW*tkYAhobTNnu$jnkEkXqp)j;w1Tzk)UH3X%SZd&fFZ2fC2yj",
    "large-v3": b"ABzY8gWO1E0{>%R7(9S+Kn!D~%ngiGaR?*L!iJG9p-nab0JQ=-{D1-g00",
    "large": b"ABzY8gWO1E0{>%R7(9S+Kn!D~%ngiGaR?*L!iJG9p-nab0JQ=-{D1-g00",
    "large-v3-turbo": b"ABzY8j^C+e0{>%RARaKHP%t(lGR*)0g!tONPyhe`",
    "turbo": b"ABzY8j^C+e0{>%RARaKHP%t(lGR*)0g!tONPyhe`",
}


def available_models() -> List[str]:
    return list(_MODELS.keys())


def default_download_root() -> str:
    default = os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(os.getenv("XDG_CACHE_HOME", default), "whisper")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def download_checkpoint(name: str, root: Optional[str] = None) -> str:
    """The local path of an official checkpoint: the cached file when its
    SHA256 matches, else a fresh download, verified."""
    if name not in _MODELS:
        raise RuntimeError(f"Model {name} not found; available models = {available_models()}")
    url = _MODELS[name]
    expected_sha256 = _CHECKPOINTS[name]
    root = root or default_download_root()
    os.makedirs(root, exist_ok=True)
    target = os.path.join(root, os.path.basename(url))

    if os.path.exists(target) and not os.path.isfile(target):
        raise RuntimeError(f"{target} exists and is not a regular file")

    if os.path.isfile(target):
        if _sha256(target) == expected_sha256:
            return target
        warnings.warn(f"{target} exists but SHA256 mismatches; re-downloading")

    try:
        with urllib.request.urlopen(url, timeout=DOWNLOAD_TIMEOUT_S) as source, open(
            target, "wb"
        ) as output:
            while True:
                chunk = source.read(1 << 20)
                if not chunk:
                    break
                output.write(chunk)
    except OSError as e:  # URLError, timeouts and refused connections
        raise RuntimeError(
            f"checkpoint {name!r} is not in {root} and could not be downloaded from "
            f"{url} ({e}); put {os.path.basename(url)} there, or pass a local .pt or "
            ".npz file"
        ) from e

    if _sha256(target) != expected_sha256:
        raise RuntimeError("Downloaded checkpoint failed SHA256 verification; please retry.")
    return target
