"""Draft distillation: train a small Whisper student against a frozen target
so that speculative decoding has an in-domain draft (the counterpart of
whisper_tpu/distill.py on one device).

The student has a preset's size with the target's vocabulary and mel
count, so the result plugs into
`model.set_draft_model(load_model(out_dir))`. Records without text are
pseudo-labeled by the target itself (greedy, temperature 0), so unlabeled
audio is enough.

Loss, pad-masked, next-token:
    (1 - alpha) * CE(student, labels) + alpha * tau^2 * KL(teacher/tau || student/tau)

The student starts from `init_random_params_host(draft dims, seed)`, the
JAX package's numpy initialisation, and trains in float32; the teacher's
forward runs under no_grad on a float32 copy of the target's tree.

Usage:

    python -m whisper_tpu_torch.distill manifest.jsonl --model turbo \\
        --draft tiny --steps 2000 --batch 8 --out ./draft_ckpt [--device cuda]
    # then:
    model = whisper_tpu_torch.load_model("turbo")
    model.set_draft_model(whisper_tpu_torch.load_model("./draft_ckpt"))
"""

import dataclasses
import os
from typing import Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from .finetune import PAD_ID, batches, load_manifest, model_tokenizer
from .models.dims import MODEL_DIMS, ModelDimensions


def draft_dims(target_dims: ModelDimensions, preset: str = "tiny") -> ModelDimensions:
    """Dimensions for a draft student: the preset's size with the TARGET's
    vocab and mel count, so tokenizer and frontend are shared (the
    set_draft_model contract, models/whisper.py)."""
    base = MODEL_DIMS[preset] if isinstance(preset, str) else preset
    return dataclasses.replace(base, n_vocab=target_dims.n_vocab, n_mels=target_dims.n_mels)


def pseudo_label(
    model, records: List[dict], language: Optional[str] = "en", **decode_options
) -> List[dict]:
    """Fill missing "text" fields by transcribing with the target model at
    temperature 0 — distillation's labels ARE the teacher's behavior, so
    unlabeled audio is valid input."""
    out = []
    for rec in records:
        if rec.get("text") or rec.get("tokens") is not None:
            out.append(rec)
            continue
        r = model.transcribe(
            rec["audio"], language=language, temperature=0.0, verbose=None, **decode_options
        )
        out.append({**rec, "text": r["text"].strip()})
    return out


class DistillState(NamedTuple):
    params: Dict  # the student's leaf tensors, updated in place
    opt_state: torch.optim.AdamW
    step: int


def distill_loss(
    student_params,
    teacher_params,
    batch,
    *,
    heads_s,  # (n_audio_head, n_text_head) of the student
    heads_t,  # (n_audio_head, n_text_head) of the teacher
    alpha: float,
    tau: float,
    pad_id: int = PAD_ID,
):
    """Pad-masked next-token CE + temperature-tau KL to the frozen teacher.
    Both models read the same mel (draft_dims pins n_mels equal); the
    teacher's forward runs under no_grad. Returns (loss, {"ce", "kl"}), the
    parts detached."""
    from .models import graphs

    mel, tokens = batch["mel"], batch["tokens"].long()
    targets = tokens[:, 1:]
    inputs = tokens[:, :-1].clamp(min=0)

    def forward(params, n_audio_head, n_text_head):
        xa = graphs.encode(params["encoder"], mel, n_head=n_audio_head)
        ck, cv = graphs.cross_kv(params["decoder"], xa, n_head=n_text_head)
        return graphs.decoder_forward(params["decoder"], inputs, ck, cv, n_head=n_text_head)

    z_s = forward(student_params, *heads_s)
    with torch.no_grad():
        z_t = forward(teacher_params, *heads_t)

    mask = (targets != pad_id).float()
    denom = mask.sum().clamp(min=1.0)

    logp_s = torch.log_softmax(z_s, dim=-1)
    nll = -logp_s.gather(-1, targets.clamp(min=0)[..., None])[..., 0]
    ce = (nll * mask).sum() / denom

    logp_st = torch.log_softmax(z_s / tau, dim=-1)
    logp_tt = torch.log_softmax(z_t / tau, dim=-1)
    kl_tok = (logp_tt.exp() * (logp_tt - logp_st)).sum(dim=-1)
    kl = (kl_tok * mask).sum() / denom

    loss = (1.0 - alpha) * ce + alpha * (tau * tau) * kl
    return loss, {"ce": ce.detach(), "kl": kl.detach()}


def make_distill_step(
    dims_t: ModelDimensions,
    dims_s: ModelDimensions,
    learning_rate: float = 1e-4,
    weight_decay: float = 0.01,
    alpha: float = 0.5,
    tau: float = 2.0,
):
    """Returns (init_state, step). init_state(student_params) ->
    DistillState; step(state, teacher_params, batch) -> (state, (loss,
    aux)), the batch moved to the student's device, the teacher's tree read
    only."""
    from .parallel.train import device_batch, init_train_state, optimizer_step

    heads_s = (dims_s.n_audio_head, dims_s.n_text_head)
    heads_t = (dims_t.n_audio_head, dims_t.n_text_head)

    def init_state(student_params) -> DistillState:
        return DistillState(*init_train_state(student_params, learning_rate, weight_decay))

    def step(state: DistillState, teacher_params, batch):
        batch = device_batch(batch, state.params["decoder"]["tok_emb"].device)
        loss, aux = distill_loss(
            state.params, teacher_params, batch, heads_s=heads_s, heads_t=heads_t,
            alpha=alpha, tau=tau,
        )  # fmt: skip
        return optimizer_step(state, loss), (loss.detach(), aux)

    return init_state, step


def run_distill(
    model,
    draft: Union[str, ModelDimensions],
    manifest: List[dict],
    *,
    steps: int,
    batch_size: int,
    out_dir: str,
    learning_rate: float = 1e-4,
    weight_decay: float = 0.01,
    alpha: float = 0.5,
    tau: float = 2.0,
    max_tokens: int = 128,
    checkpoint_every: int = 0,
    language: Optional[str] = "en",
    log=print,
    seed: int = 0,
) -> List[float]:
    """Distill `model` into a fresh `draft`-sized student over `manifest` on
    the model's device; writes a checkpoint directory that load_model()
    reads and set_draft_model() accepts. Returns the per-step total-loss
    history."""
    from .checkpoint import save_checkpoint
    from .models.params import init_random_params_host, map_tree

    if steps < 1:
        # a zero-step run would still write a random-weights "draft"
        # checkpoint to out_dir — refuse rather than leave a garbage artifact
        raise ValueError(f"steps must be >= 1, got {steps}")
    dims_s = draft_dims(model.dims, draft)
    tokenizer = model_tokenizer(model, language)

    unlabeled = [r for r in manifest if not r.get("text") and r.get("tokens") is None]
    if unlabeled:
        log(f"pseudo-labeling {len(unlabeled)} unlabeled records with the target model")
        manifest = pseudo_label(model, manifest, language=language)

    init_state, step = make_distill_step(
        model.dims, dims_s,
        learning_rate=learning_rate, weight_decay=weight_decay, alpha=alpha, tau=tau,
    )  # fmt: skip
    student = init_random_params_host(dims_s, seed=seed)
    state = init_state(map_tree(student, lambda _, v: v.to(model.device)))
    teacher = map_tree(model.params, lambda _, v: v.float())

    it = batches(
        manifest,
        tokenizer,
        n_mels=dims_s.n_mels,
        batch_size=batch_size,
        max_tokens=max_tokens,
        seed=seed,
    )

    history: List[float] = []
    for i in range(1, steps + 1):
        state, (loss, aux) = step(state, teacher, next(it))
        loss = float(loss)
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite distill loss at step {i}: {loss}")
        history.append(loss)
        log(
            f"step {i}/{steps}  loss {loss:.4f}  "
            f"ce {float(aux['ce']):.4f}  kl {float(aux['kl']):.4f}"
        )
        if checkpoint_every and i % checkpoint_every == 0 and i < steps:
            save_checkpoint(out_dir, state.params, dims_s, i)
    save_checkpoint(out_dir, state.params, dims_s, steps)
    return history


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="distill a Whisper model into a speculative-decoding draft"
    )
    parser.add_argument(
        "manifest", help="JSON-lines {audio[, text]}; missing text is pseudo-labeled by the "
        "target model"
    )  # fmt: skip
    parser.add_argument("--model", default="turbo", help="target (teacher) model")
    parser.add_argument("--draft", default="tiny", help="student size preset")
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--out", default="./draft_ckpt")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--alpha", type=float, default=0.5)
    parser.add_argument("--tau", type=float, default=2.0)
    parser.add_argument("--max_tokens", type=int, default=128)
    parser.add_argument("--checkpoint_every", type=int, default=0)
    parser.add_argument("--language", default="en")
    parser.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = parser.parse_args(argv)

    from . import load_model

    model = load_model(args.model, device=args.device)
    history = run_distill(
        model,
        args.draft,
        load_manifest(args.manifest, require_text=False),
        steps=args.steps,
        batch_size=args.batch,
        out_dir=args.out,
        learning_rate=args.lr,
        weight_decay=args.weight_decay,
        alpha=args.alpha,
        tau=args.tau,
        max_tokens=args.max_tokens,
        checkpoint_every=args.checkpoint_every,
        language=args.language,
    )
    print(
        f"final loss {history[-1]:.4f}; draft checkpoint at "
        f"{os.path.abspath(args.out)} — attach with "
        "model.set_draft_model(whisper_tpu_torch.load_model(out_dir))"
    )


if __name__ == "__main__":
    main()
