"""Checkpoint directories of a parameter tree (the counterpart of
whisper_tpu/checkpoint.py), in a torch-native layout:

  dims.json      the model dimensions and "step", the last step written
                 (the JAX package's file, field for field)
  state_{step}.pt  a torch.save of the flat {"<a>/<b>/<leaf>": tensor} tree,
                 on the CPU in the dtype it was trained in

`load_model` reads such a directory (keyed on dims.json). The JAX package
writes its directories with orbax, which the port cannot read: that needs
orbax and tensorstore, which a CUDA machine need not have. A JAX checkpoint
reaches the port as a `.npz` (the JAX package's `save_model`).
"""

import json
import os
from typing import Dict, Optional

import torch

from .models.dims import ModelDimensions
from .models.params import flatten_tree, unflatten_tree


def _replace(path: str, write):
    """Write through `write(tmp_path)`, then rename over `path`: a reader
    never sees a half-written file."""
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, params: Dict, dims: ModelDimensions, step: int = 0):
    """Write `params` as state_{step}.pt in the directory `path`, then
    dims.json naming `step`."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    flat = {k: v.detach().to("cpu") for k, v in flatten_tree(params)}
    _replace(os.path.join(path, f"state_{step}.pt"), lambda tmp: torch.save(flat, tmp))

    def write_dims(tmp):
        with open(tmp, "w") as f:
            json.dump({**dims.__dict__, "step": step}, f)

    _replace(os.path.join(path, "dims.json"), write_dims)


def load_checkpoint(path: str, step: Optional[int] = None):
    """A checkpoint directory -> (params, dims, step): the tree of CPU
    tensors at `step` (default: dims.json's), read with weights_only."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "dims.json")) as f:
        meta = json.load(f)
    saved_step = meta.pop("step", 0)
    dims = ModelDimensions(**meta)
    step = saved_step if step is None else step
    flat = torch.load(os.path.join(path, f"state_{step}.pt"), map_location="cpu", weights_only=True)
    return unflatten_tree(flat.items()), dims, step
