"""The fine-tuning step on one device (whisper_tpu/parallel/train.py
without its mesh): teacher-forced cross-entropy of the whole
encoder-decoder, autograd for the backward, torch.optim.AdamW for
optax.adamw.

AdamW(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay) is optax.adamw at its
defaults: the decay is decoupled and applies to every leaf (optax is given
no mask, so the position embeddings and the float32 LayerNorm leaves decay
too), and eps_root is 0. The moments take each leaf's dtype, so a bf16
tree trains with bf16 optimizer state, as the JAX package trains its
model's compute-dtype parameters.
"""

from typing import Dict, NamedTuple

import torch

from ..models import graphs
from ..models.dims import ModelDimensions
from ..models.params import flatten_tree, map_tree


class TrainState(NamedTuple):
    params: Dict  # leaf tensors, updated in place by the optimizer
    opt_state: torch.optim.AdamW
    step: int


def device_batch(batch: Dict, device) -> Dict:
    """A batch of numpy arrays or tensors as tensors on `device`."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_fn(params, batch, *, n_audio_head, n_text_head, pad_id: int = -100):
    """batch: mel (B, n_mels, 3000) f32, tokens (B, T) int; the next-token
    cross-entropy over the positions whose target is not pad_id."""
    mel, tokens = batch["mel"], batch["tokens"].long()
    targets = tokens[:, 1:]
    inputs = tokens[:, :-1].clamp(min=0)

    xa = graphs.encode(params["encoder"], mel, n_head=n_audio_head)
    ck, cv = graphs.cross_kv(params["decoder"], xa, n_head=n_text_head)
    logits = graphs.decoder_forward(params["decoder"], inputs, ck, cv, n_head=n_text_head)

    mask = (targets != pad_id).float()
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = -logprobs.gather(-1, targets.clamp(min=0)[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def init_train_state(params: Dict, learning_rate: float, weight_decay: float) -> TrainState:
    """Trainable leaf copies of `params`, in their dtypes and on their
    device (the caller's tensors are never trained), and their AdamW."""
    params = map_tree(params, lambda _, v: torch.as_tensor(v).detach().clone().requires_grad_(True))
    opt = torch.optim.AdamW(
        [v for _, v in flatten_tree(params)], lr=learning_rate, betas=(0.9, 0.999),
        eps=1e-8, weight_decay=weight_decay,
    )  # fmt: skip
    return TrainState(params, opt, 0)


def optimizer_step(state: TrainState, loss) -> TrainState:
    """The backward of `loss` into the state's parameters and one AdamW
    step; the gradients are dropped after it."""
    loss.backward()
    state.opt_state.step()
    state.opt_state.zero_grad(set_to_none=True)
    return state._replace(step=state.step + 1)


def make_train_step(dims: ModelDimensions, learning_rate: float = 1e-5, weight_decay: float = 0.01):
    """Returns (init_state, train_step). init_state(params) -> TrainState;
    train_step(state, batch) -> (state, loss), the batch's arrays moved to
    the parameters' device, the loss a detached scalar tensor there."""

    def init_state(params) -> TrainState:
        return init_train_state(params, learning_rate, weight_decay)

    def train_step(state: TrainState, batch):
        batch = device_batch(batch, state.params["decoder"]["tok_emb"].device)
        loss = loss_fn(
            state.params, batch, n_audio_head=dims.n_audio_head, n_text_head=dims.n_text_head
        )
        return optimizer_step(state, loss), loss.detach()

    return init_state, train_step
