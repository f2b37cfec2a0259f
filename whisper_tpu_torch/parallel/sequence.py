"""Sequence-parallel encoder: the 1500-frame audio context split over an
`sp` mesh axis (the counterpart of whisper_tpu/parallel/sequence.py).

Each sp rank owns T / sp frames end to end through the layer stack.
LayerNorm, the MLP and the projections are per position and need no
communication; attention needs every key and value, which each layer
fetches with one all-gather over sp of K and one of V (B, T/sp, d/tp each;
graphs.encoder_block). The conv stem runs replicated on every rank (about
1% of the encoder's operations, cheaper than a halo exchange for the
overlapping stride-2 convolutions), and ln_post runs on the shard.

Composition: `dp` splits the batch (each dp group runs its own sp ring),
`tp` splits heads and MLP hidden inside each rank, with the row-parallel
products all-reduced over tp. The result is all-gathered over sp and dp,
so every rank returns the whole (B, T, d).
"""

import torch

from ..models import graphs
from ..comm import all_gather, local_slice
from .mesh import axis_group, mesh_shape
from .serve import _batch_split


def sp_encode(model, mesh):
    """A sequence-parallel encoder: fn(enc, mel) with `enc` this rank's
    tp shard of the encoder (sharding.shard_params) and mel (B, n_mels,
    frames) whole on every rank -> (B, frames // 2, d), numerically
    graphs.encode's. `mesh` must carry an sp axis of size > 1 that divides
    frames // 2 (checked at the call); tp must divide n_audio_head."""
    shape = mesh_shape(mesh)
    sp, tp = shape.get("sp", 1), shape.get("tp", 1)
    if sp < 2:
        raise ValueError("sp_encode needs a mesh with an sp axis of size > 1")
    if model.dims.n_audio_head % tp:
        raise ValueError(f"n_audio_head {model.dims.n_audio_head} not divisible by tp={tp}")
    n_head = model.dims.n_audio_head // tp
    sp_g, tp_g = axis_group(mesh, "sp"), axis_group(mesh, "tp")

    @torch.inference_mode()
    def fn(enc, mel):
        mel = torch.as_tensor(mel, device=model.device)
        dp = _batch_split(mesh, mel.shape[0])
        x = graphs.encoder_stem(enc, local_slice(mel, dp, 0))
        if x.shape[1] % sp:
            raise ValueError(f"{x.shape[1]} frames not divisible by sp={sp}")
        x = local_slice(x, sp_g, 1)
        for blk in graphs._layers(enc):
            x = graphs.encoder_block(x, blk, n_head, tp_g, sp_g)
        x = graphs.encoder_ln_post(enc, x)
        return all_gather(all_gather(x, sp_g, 1), dp, 0)

    return fn
