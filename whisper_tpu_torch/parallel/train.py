"""The fine-tuning step, on one device or over a (dp, tp) mesh (the
counterpart of whisper_tpu/parallel/train.py): teacher-forced cross-entropy
of the whole encoder-decoder, autograd for the backward,
torch.optim.AdamW for optax.adamw.

AdamW(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay) is optax.adamw at its
defaults: the decay is decoupled and applies to every leaf (optax is given
no mask, so the position embeddings and the float32 LayerNorm leaves decay
too), and eps_root is 0. The moments take each leaf's dtype, so a bf16
tree trains with bf16 optimizer state, as the JAX package trains its
model's compute-dtype parameters.

On a mesh (what GSPMD derives from the JAX package's annotations, written
out):
  * tp: each rank trains its shard of the tree (sharding.py); the graphs
    all-reduce the row-parallel products forward and the column-parallel
    inputs' gradients backward (comm.py), so every replicated leaf gets
    its whole gradient on every tp rank;
  * dp: each rank takes B / dp rows of the batch. The loss is the masked
    NLL summed over the GLOBAL batch over the GLOBAL count of unmasked
    tokens: the count is all-reduced over dp, each rank's backward is that
    of its rows' sum over the global count, and the gradients are summed
    over dp. The reported loss is the sum of the ranks' terms, the same on
    every rank.
AdamW stays elementwise on the local shards.
"""

from typing import Dict, NamedTuple

import torch

from ..models import graphs
from ..models.dims import ModelDimensions
from ..models.params import flatten_tree, map_tree
from ..comm import all_reduce, group_size, local_slice
from .mesh import axis_group, mesh_shape
from .sharding import shard_params


class TrainState(NamedTuple):
    params: Dict  # leaf tensors, updated in place by the optimizer
    opt_state: torch.optim.AdamW
    step: int


def device_batch(batch: Dict, device, dp=None) -> Dict:
    """A batch of numpy arrays or tensors as tensors on `device`; with a dp
    group, this rank's rows."""
    return {k: local_slice(torch.as_tensor(v, device=device), dp, 0) for k, v in batch.items()}


def masked_mean(values, mask, dp=None):
    """sum(values * mask) / sum(mask) over the global batch: the count is
    all-reduced over dp (each rank returns its rows' share of the mean)."""
    count = all_reduce(mask.sum().detach().clone(), dp)
    return (values * mask).sum() / count.clamp(min=1.0)


def loss_fn(params, batch, *, n_audio_head, n_text_head, pad_id: int = -100, tp=None, dp=None):
    """batch: mel (B, n_mels, 3000) f32, tokens (B, T) int; the next-token
    cross-entropy over the positions whose target is not pad_id. With
    process groups: `params` is this rank's tp shard and `batch` its dp
    rows, and the result is its rows' share of the global mean."""
    mel, tokens = batch["mel"], batch["tokens"].long()
    targets = tokens[:, 1:]
    inputs = tokens[:, :-1].clamp(min=0)

    xa = graphs.encode(params["encoder"], mel, n_head=n_audio_head, tp=tp)
    ck, cv = graphs.cross_kv(params["decoder"], xa, n_head=n_text_head, tp=tp)
    logits = graphs.decoder_forward(params["decoder"], inputs, ck, cv, n_head=n_text_head, tp=tp)

    mask = (targets != pad_id).float()
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = -logprobs.gather(-1, targets.clamp(min=0)[..., None])[..., 0]
    return masked_mean(nll, mask, dp)


def init_train_state(params: Dict, learning_rate: float, weight_decay: float) -> TrainState:
    """Trainable leaf copies of `params`, in their dtypes and on their
    device (the caller's tensors are never trained), and their AdamW."""
    params = map_tree(params, lambda _, v: torch.as_tensor(v).detach().clone().requires_grad_(True))
    opt = torch.optim.AdamW(
        [v for _, v in flatten_tree(params)], lr=learning_rate, betas=(0.9, 0.999),
        eps=1e-8, weight_decay=weight_decay,
    )  # fmt: skip
    return TrainState(params, opt, 0)


def optimizer_step(state: TrainState, loss, dp=None) -> TrainState:
    """The backward of `loss` into the state's parameters, the gradients
    summed over dp, and one AdamW step; the gradients are dropped after it."""
    loss.backward()
    if group_size(dp) > 1:
        for _, p in flatten_tree(state.params):
            all_reduce(p.grad, dp)
    state.opt_state.step()
    state.opt_state.zero_grad(set_to_none=True)
    return state._replace(step=state.step + 1)


def mesh_groups(mesh, *dims: ModelDimensions):
    """(dp, tp) process groups of a mesh; (None, None) for no mesh. Raises
    when tp does not divide the heads of one of `dims`."""
    tp = mesh_shape(mesh).get("tp", 1)
    for d in dims:
        if d.n_audio_head % tp or d.n_text_head % tp:
            raise ValueError(
                f"tp={tp} must divide the heads ({d.n_audio_head} audio, {d.n_text_head} text)"
            )
    return axis_group(mesh, "dp"), axis_group(mesh, "tp")


def make_train_step(
    dims: ModelDimensions, mesh=None, learning_rate: float = 1e-5, weight_decay: float = 0.01
):
    """Returns (init_state, train_step). init_state(params) -> TrainState
    of this rank's shard; train_step(state, batch) -> (state, loss), the
    batch (whole on every rank) moved to the parameters' device and split
    over dp, the loss a detached scalar tensor there, the same on every
    rank."""
    dp, tp = mesh_groups(mesh, dims)

    def init_state(params) -> TrainState:
        return init_train_state(
            params if mesh is None else shard_params(params, mesh), learning_rate, weight_decay
        )

    def train_step(state: TrainState, batch):
        batch = device_batch(batch, state.params["decoder"]["tok_emb"].device, dp)
        loss = loss_fn(
            state.params, batch, n_audio_head=dims.n_audio_head, n_text_head=dims.n_text_head,
            tp=tp, dp=dp,
        )  # fmt: skip
        return optimizer_step(state, loss, dp), all_reduce(loss.detach().clone(), dp)

    return init_state, train_step
