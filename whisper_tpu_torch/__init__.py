"""whisper_tpu_torch: the PyTorch/CUDA port of whisper_tpu.

Public API: `load_model`, `save_model`, `available_models`, `transcribe`,
`transcribe_batch`, `transcribe_chunked`, `StreamingTranscriber`,
`ContinuousBatcher`, `decode`, `DecodingOptions`, `DecodingResult`,
`detect_language`, `log_mel_spectrogram`, `pad_or_trim`, `load_audio`,
`__version__`. The servers are `whisper_tpu_torch.server` (unix socket)
and `whisper_tpu_torch.http_server` (HTTP). Models run on the CUDA card
unless the caller passes another device (the tests pass device="cpu").
"""

import os
from typing import Optional

import numpy as np
import torch

from .audio import load_audio, log_mel_spectrogram, pad_or_trim
from .batch import transcribe_batch, transcribe_chunked
from .continuous import ContinuousBatcher
from .decoding import DecodingOptions, DecodingResult, decode, detect_language
from .models.dims import MODEL_DIMS, ModelDimensions
from .models.params import load_params_npz, params_from_torch_state_dict
from .models.registry import ALIGNMENT_HEADS, available_models, download_checkpoint
from .models.whisper import Whisper, resolve_device
from .quant import check_weights_mode
from .streaming import StreamingTranscriber
from .transcribe import transcribe
from .version import __version__

__all__ = [
    "ContinuousBatcher",
    "DecodingOptions",
    "DecodingResult",
    "MODEL_DIMS",
    "ModelDimensions",
    "Whisper",
    "available_models",
    "decode",
    "detect_language",
    "load_audio",
    "load_model",
    "log_mel_spectrogram",
    "pad_or_trim",
    "save_model",
    "StreamingTranscriber",
    "transcribe",
    "transcribe_batch",
    "transcribe_chunked",
    "__version__",
]


def _load_torch_checkpoint(path: str):
    with open(path, "rb") as fp:
        checkpoint = torch.load(fp, map_location="cpu", weights_only=True)
    dims = ModelDimensions(**checkpoint["dims"])
    return dims, params_from_torch_state_dict(checkpoint["model_state_dict"], dims)


def load_model(
    name: Optional[str],
    download_root: Optional[str] = None,
    compute_dtype=torch.bfloat16,
    device="cuda",
    dims: Optional[ModelDimensions] = None,
    seed: int = 0,
    weights: str = "",
) -> Whisper:
    """Load a model by registry name (the cached official checkpoint under
    `download_root`, downloaded and SHA256-verified when missing, with its
    published alignment heads), from a local openai/whisper `.pt` checkpoint
    or a `.npz` written by `save_model` or the JAX package, or — with
    `name=None` and `dims` — build one with random weights drawn from
    `seed` on the device. `weights="int8"` makes its decode loops run on
    weight-only int8 (quant.py; the model keeps its own weights)."""
    device = resolve_device(device)
    weights = check_weights_mode(weights)
    alignment_heads = params = None
    if name is None:
        if dims is None:
            raise ValueError("random weights (name=None) need `dims`")
        name = "custom"
    elif name in available_models():
        dims, params = _load_torch_checkpoint(download_checkpoint(name, download_root))
        alignment_heads = ALIGNMENT_HEADS[name]
    elif os.path.isfile(name):
        if name.endswith(".npz"):
            tree = load_params_npz(name)
            dims = ModelDimensions(**{k: int(v) for k, v in tree.pop("dims").items()})
            params = tree["params"] if "params" in tree else tree
        else:
            dims, params = _load_torch_checkpoint(name)
    else:
        raise RuntimeError(f"Model {name} not found; available models = {available_models()}")
    model = Whisper(dims, params, name=name, compute_dtype=compute_dtype, device=device, seed=seed)
    model.decode_weights = weights
    if alignment_heads is not None:
        model.set_alignment_heads(alignment_heads)
    return model


def save_model(model: Whisper, path: str):
    """Write a model as `.npz`: "params/<path>" float32 arrays and
    "dims/<field>" int64 scalars (whisper_tpu/__init__.py's layout)."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = v.detach().to("cpu", torch.float32).numpy()

    walk(model.params, "params/")
    for k, v in model.dims.__dict__.items():
        flat[f"dims/{k}"] = np.int64(v)
    np.savez(path, **flat)
