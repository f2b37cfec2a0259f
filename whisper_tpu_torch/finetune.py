"""Fine-tuning: a manifest of (audio, text) pairs -> an updated checkpoint
(the counterpart of whisper_tpu/finetune.py).

The data pipeline makes log-mel windows and teacher-forced token rows at
fixed shapes; the loop takes one AdamW step a batch (parallel/train.py),
logs the loss, optionally a held-out loss, and writes checkpoints
(checkpoint.py) that `load_model(out_dir)` reads. Pass a (dp, tp) mesh
(parallel/mesh.py) and the same loop trains SPMD on every rank: the batch
split over dp, the tree over tp; rank 0 writes the gathered tree.

Usage:

    python -m whisper_tpu_torch.finetune manifest.jsonl --model tiny \\
        --steps 500 --batch 8 --out ./ft_ckpt [--device cuda]
    torchrun --nproc_per_node 4 -m whisper_tpu_torch.finetune manifest.jsonl \\
        --model tiny --batch 8 --dp 2 --tp 2

Manifest: JSON lines of {"audio": "/path.flac", "text": "reference text"}.
"""

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .audio import N_FRAMES, log_mel_spectrogram, pad_or_trim
from .comm import all_reduce
from .tokenizer import get_tokenizer

# PAD_ID, load_manifest, make_example and batches: copied from
# whisper_tpu/finetune.py (framework-free), with the port's audio and tokenizer.

PAD_ID = -100  # masked out of the loss (parallel/train.py loss_fn)


def load_manifest(path: str, require_text: bool = True) -> List[dict]:
    """JSON-lines manifest -> list of {"audio", "text"} records.

    `require_text=False` admits audio-only records (distill.py pseudo-labels
    them with the target model; fine-tuning proper always needs labels)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            labeled = "text" in rec or "tokens" in rec
            if "audio" not in rec or (require_text and not labeled):
                raise ValueError(f"manifest line needs audio+text (or tokens): {rec}")
            records.append(rec)
    if not records:
        raise ValueError(f"empty manifest: {path}")
    return records


def make_example(
    record: dict, tokenizer, n_mels: int, max_tokens: int
) -> Tuple[np.ndarray, np.ndarray]:
    """One (mel (n_mels, 3000), tokens (max_tokens,)) training example.

    Tokens are the decoding-time sequence the model must reproduce:
    sot_sequence + text + eot, padded with PAD_ID to the fixed length.

    Optional record fields: "tokens" (a list of token ids) replaces the
    re-encoded text body — BPE does not round-trip decode(encode(.)) on
    arbitrary generated text, so distillation on a teacher's exact decode
    path labels with ids, not text. "mel_padding" (samples of zero pad
    before the mel, e.g. N_SAMPLES) makes the training window normalize
    exactly like an inference window sliced from a padded whole-clip mel.
    """
    audio = record["audio"]
    mel = log_mel_spectrogram(audio, n_mels, padding=record.get("mel_padding", 0))
    mel = pad_or_trim(np.asarray(mel), N_FRAMES, axis=-1).astype(np.float32)

    if record.get("tokens") is not None:
        body = [int(t) for t in record["tokens"]]
    else:
        # disallowed_special=(): training text is DATA — a transcript that
        # happens to contain the literal string "<|it|>" (pseudo-labels
        # can) must encode as plain text, never as the special token
        body = tokenizer.encode(" " + record["text"].strip(), disallowed_special=())
    ids = list(tokenizer.sot_sequence_including_notimestamps) + body + [tokenizer.eot]
    if len(ids) > max_tokens:
        ids = ids[: max_tokens - 1] + [tokenizer.eot]
    tokens = np.full((max_tokens,), PAD_ID, np.int32)
    tokens[: len(ids)] = ids
    return mel, tokens


def batches(
    records: List[dict],
    tokenizer,
    *,
    n_mels: int,
    batch_size: int,
    max_tokens: int,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite shuffled batch iterator at fixed shapes."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(records))
    cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    while True:
        rng.shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[start : start + batch_size]
            mels, toks = [], []
            for i in idx:
                if i not in cache:
                    cache[i] = make_example(records[i], tokenizer, n_mels, max_tokens)
                m, t = cache[i]
                mels.append(m)
                toks.append(t)
            yield {"mel": np.stack(mels), "tokens": np.stack(toks)}
        if len(records) < batch_size:
            raise ValueError(f"manifest has {len(records)} examples < batch {batch_size}")


def model_tokenizer(model, language: Optional[str]):
    """The transcribe-task tokenizer of `model`'s vocabulary."""
    return get_tokenizer(
        model.is_multilingual,
        num_languages=model.num_languages,
        language=language,
        task="transcribe",
    )


def run_finetune(
    model,
    manifest: List[dict],
    *,
    steps: int,
    batch_size: int,
    out_dir: str,
    mesh=None,
    learning_rate: float = 1e-5,
    weight_decay: float = 0.01,
    max_tokens: int = 128,
    checkpoint_every: int = 0,
    language: Optional[str] = "en",
    eval_manifest: Optional[List[dict]] = None,
    eval_every: int = 0,
    log=print,
    seed: int = 0,
) -> List[float]:
    """Train `steps` steps on the model's device; returns the per-step loss
    history and writes the final (and optionally periodic) checkpoints to
    `out_dir`. The trained tree is a copy of `model.params` in the model's
    dtypes: the model itself is left as it was. With `eval_manifest` (and
    `eval_every`), logs the teacher-forced loss of one fixed held-out
    batch. With a mesh, every rank calls this with the same arguments and
    gets the same history; the batch must split over dp."""
    from .parallel.train import device_batch, loss_fn, make_train_step, mesh_groups

    tokenizer = model_tokenizer(model, language)
    init_state, train_step = make_train_step(
        model.dims, mesh, learning_rate=learning_rate, weight_decay=weight_decay
    )
    dp, tp = mesh_groups(mesh, model.dims)
    state = init_state(model.params)
    it = batches(
        manifest,
        tokenizer,
        n_mels=model.dims.n_mels,
        batch_size=batch_size,
        max_tokens=max_tokens,
        seed=seed,
    )
    eval_batch = None
    if eval_manifest and eval_every:
        n_eval = min(len(eval_manifest), batch_size)
        eval_batch = device_batch(
            next(
                batches(
                    eval_manifest[:n_eval] * max(1, -(-batch_size // n_eval)),
                    tokenizer,
                    n_mels=model.dims.n_mels,
                    batch_size=batch_size,
                    max_tokens=max_tokens,
                    seed=seed + 1,
                )
            ),
            model.device,
            dp,
        )

    history: List[float] = []
    for step in range(1, steps + 1):
        state, loss = train_step(state, next(it))
        loss = float(loss)
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at step {step}: {loss}")
        history.append(loss)
        log(f"step {step}/{steps}  loss {loss:.4f}")
        if eval_batch is not None and step % eval_every == 0:
            with torch.no_grad():
                ev = loss_fn(
                    state.params, eval_batch, n_audio_head=model.dims.n_audio_head,
                    n_text_head=model.dims.n_text_head, tp=tp, dp=dp,
                )  # fmt: skip
            log(f"step {step}/{steps}  eval_loss {float(all_reduce(ev, dp)):.4f}")
        if checkpoint_every and step % checkpoint_every == 0 and step < steps:
            save_sharded_checkpoint(out_dir, state.params, model.dims, step, mesh)
    save_sharded_checkpoint(out_dir, state.params, model.dims, steps, mesh)
    return history


def save_sharded_checkpoint(out_dir: str, params, dims, step: int, mesh=None):
    """checkpoint.save_checkpoint of a trained tree: on a mesh, every rank
    gathers the whole tree over tp and rank 0 writes it."""
    import torch.distributed as dist

    from .checkpoint import save_checkpoint

    if mesh is not None:
        from .parallel.sharding import gather_params

        params = gather_params(params, mesh)
    if mesh is None or dist.get_rank() == 0:
        save_checkpoint(out_dir, params, dims, step)


def init_mesh(dp: Optional[int], tp: int, device: str):
    """The CLIs' mesh from --dp/--tp: None when neither is given; else the
    mesh over the world, the default group initialised from torchrun's
    environment if it is not yet (which selects the rank's card before the
    model is loaded)."""
    if dp is None and tp == 1:
        return None
    from .parallel.mesh import make_mesh

    return make_mesh(dp=dp, tp=tp, device_type=torch.device(device).type)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="fine-tune a Whisper model")
    parser.add_argument("manifest", help="JSON-lines file of {audio, text}")
    parser.add_argument("--model", default="tiny")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--out", default="./ft_ckpt")
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--max_tokens", type=int, default=128)
    parser.add_argument("--checkpoint_every", type=int, default=0)
    parser.add_argument("--eval_manifest", default=None)
    parser.add_argument("--eval_every", type=int, default=0)
    parser.add_argument("--language", default="en")
    parser.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    parser.add_argument("--dp", type=int, default=None, help="data-parallel ranks (torchrun)")
    parser.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks (torchrun)")
    args = parser.parse_args(argv)

    from . import load_model

    mesh = init_mesh(args.dp, args.tp, args.device)
    model = load_model(args.model, device=args.device)
    history = run_finetune(
        model,
        load_manifest(args.manifest),
        steps=args.steps,
        batch_size=args.batch,
        out_dir=args.out,
        mesh=mesh,
        learning_rate=args.lr,
        weight_decay=args.weight_decay,
        max_tokens=args.max_tokens,
        checkpoint_every=args.checkpoint_every,
        language=args.language,
        eval_manifest=(load_manifest(args.eval_manifest) if args.eval_manifest else None),
        eval_every=args.eval_every,
    )
    print(f"final loss {history[-1]:.4f}; checkpoint at {os.path.abspath(args.out)}")


if __name__ == "__main__":
    main()
