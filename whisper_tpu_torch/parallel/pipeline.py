"""Pipeline-parallel encoder (GPipe) over a mesh's `pp` axis (the
counterpart of whisper_tpu/parallel/pipeline.py).

Stage s runs layers [s * L / pp, (s + 1) * L / pp) of the encoder; the
batch is cut into microbatches, and at tick t stage s runs microbatch
t - s. This is eager, so the bubble ticks compute nothing: a stage off its
schedule only takes part in the tick's hand-off (comm.stage_handoff, an
all-gather over pp that runs on every backend). Stage 0 alone computes the
conv stem; the last stage applies ln_post, and its result is broadcast to
every stage at the end.

Composition: `dp` splits the batch (each dp group runs its own pipeline;
the result is all-gathered over dp), `tp` splits heads and MLP hidden
inside each stage, with the row-parallel products all-reduced over tp.

When to use it: throughput serving of deep encoders (large-v3: 32 layers)
at batch sizes that amortise the (pp - 1) / (M + pp - 1) bubble, or when a
stage's share of the weights matters. The single-card latency path stays
unpipelined.
"""

import torch

from ..models import graphs
from ..comm import all_gather, broadcast_from, group_rank, local_slice, stage_handoff
from .mesh import axis_group, mesh_shape
from .serve import _batch_split


def pp_encode(model, mesh, microbatches: int = 0):
    """A pipeline-parallel encoder: fn(enc, mel) with `enc` this rank's tp
    shard of the encoder (sharding.shard_params; a stage reads its slice of
    the layer stack) and mel (B, n_mels, frames) whole on every rank ->
    (B, frames // 2, d), numerically graphs.encode's.

    `mesh` must have a pp axis with n_audio_layer % pp == 0; dp and tp
    compose (B / dp divisible by the microbatches, n_audio_head % tp == 0).
    `microbatches` is per dp group and defaults to pp."""
    dims = model.dims
    shape = mesh_shape(mesh)
    pp, tp = shape.get("pp", 1), shape.get("tp", 1)
    if pp < 2:
        raise ValueError("pp_encode needs a mesh with a pp axis of size > 1")
    if dims.n_audio_layer % pp:
        raise ValueError(f"{dims.n_audio_layer} encoder layers not divisible by pp={pp}")
    if dims.n_audio_head % tp:
        raise ValueError(f"n_audio_head {dims.n_audio_head} not divisible by tp={tp}")
    n_micro = microbatches or pp
    n_head = dims.n_audio_head // tp
    per_stage = dims.n_audio_layer // pp
    pp_g, tp_g = axis_group(mesh, "pp"), axis_group(mesh, "tp")

    @torch.inference_mode()
    def fn(enc, mel):
        mel = torch.as_tensor(mel, device=model.device)
        dp = _batch_split(mesh, mel.shape[0])
        mel = local_slice(mel, dp, 0)
        Bl = mel.shape[0]
        if Bl % n_micro:
            raise ValueError(f"local batch {Bl} not divisible by microbatches={n_micro}")
        s = group_rank(pp_g)
        layers = graphs._layers(enc)[s * per_stage : (s + 1) * per_stage]
        mb = Bl // n_micro
        T, d = mel.shape[-1] // 2, enc["pos_emb"].shape[1]
        idle = torch.zeros((mb, T, d), dtype=enc["blocks"]["attn_q_w"].dtype, device=mel.device)
        x_mb = graphs.encoder_stem(enc, mel).chunk(n_micro) if s == 0 else None
        outs = []
        recv = idle
        ticks = n_micro + pp - 1
        for t in range(ticks):
            m = t - s  # the microbatch this stage runs at tick t
            out = idle
            if 0 <= m < n_micro:
                out = x_mb[m] if s == 0 else recv
                for blk in layers:
                    out = graphs.encoder_block(out, blk, n_head, tp_g)
                if s == pp - 1:
                    outs.append(graphs.encoder_ln_post(enc, out))
            if t < ticks - 1:
                recv = stage_handoff(out, pp_g)
        y = torch.cat(outs) if s == pp - 1 else idle.new_zeros((Bl, T, d))
        return all_gather(broadcast_from(y, pp_g, pp - 1), dp, 0)

    return fn
