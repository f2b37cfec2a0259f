"""Data-parallel (+ tensor- and sequence-parallel) batched inference over a
device mesh (the counterpart of whisper_tpu/parallel/serve.py).

SPMD: every rank runs the same call with the same inputs and returns the
same full outputs. Inside a call:

  * `dp` splits the audio batch: each dp rank decodes its A / dp audios
    (A * G / dp rows under beam search); an A that dp does not divide runs
    whole on every dp rank (unsharded over dp, still over tp);
  * `tp` splits the decoder's heads and MLP hidden (sharding.py): each
    rank holds its shard of the weights and of the cross-K/V (L, A/dp,
    H/tp, dh, 1500); the row-parallel products are all-reduced in graphs.py;
  * `sp` splits the cross-K/V's 1500-frame axis when it divides it: the
    cross-attention softmax is assembled over the group (graphs.py).

The logits are replicated over tp and sp (the token embedding is), so
every rank of a dp group launches the same update kernel on the same
logits and takes the same tokens. Both engines run the single-device
engines' loop programs (engine.py, speculative.py) on the rank's shard,
with the collectives inside the body, as the JAX package's mesh engines
run one jitted program with GSPMD's collectives in it:

  * the loop body's done flag is the whole batch's: the not-done count is
    all-reduced over dp on the device inside the body (FusedEngine._live),
    so every rank runs the single-device engine's number of steps, a rank
    whose rows are done keeps stepping (writing nothing) until every row is
    done, and a finished row evolves as it would there;
  * sampling at T > 0 all-gathers each step's probabilities over dp inside
    the body and draws for the whole batch with the shared generator (the
    graph registers it), then keeps the rank's rows: the single-device
    engine's draws (FusedEngine._draw);
  * the speculative engine's dp groups run their rounds independently (a
    row's tokens do not depend on the other rows), each group on its own
    rows' flag; the outputs are gathered and padded to the longest row of
    the batch at the end.

The outputs are all-gathered over dp after the loop.

Capture: a run captures its body as a CUDA graph when every group the body
uses is NCCL or has one rank (comm.capturable, decided before the run and
recorded as `captured` in the run's EngineRun / SpecRun); over gloo the
body runs uncaptured on the card. Every rank must issue the same
collectives in the same order: the host stops on the step count and on the
batch's flag, which are the same on every rank, so every rank runs the
same passes, captures and program evictions. A rank that stopped early
would leave the others waiting in their next collective.

The encoder and the cross-K/V (dp_encode, dp_cross_kv) are computed
sharded and all-gathered, so the decoding task, the word-timing replay and
the engines read whole tensors; the engines take their shard of them.

Usage (every rank):

    mesh = make_mesh(dp=2, tp=2)
    eng = DataParallelEngine(model, mesh)
    out = eng.run(initial_tokens, ck, cv, n_group=5, beam_search=True, ...)
"""

import numpy as np
import torch

from ..engine import FusedEngine, model_engine
from ..models import graphs
from ..speculative import SpeculativeEngine
from ..comm import all_gather, group_rank, group_size, local_slice
from .mesh import axis_group, mesh_shape
from .sharding import shard_params


def _frame_group(mesh, n_frames: int):
    """The sp group when it divides the cross-K/V frame axis, else None."""
    sp = mesh_shape(mesh).get("sp", 1)
    return axis_group(mesh, "sp") if sp > 1 and n_frames % sp == 0 else None


def _head_group(mesh, n_head: int):
    """The tp group when it divides the model's heads, else None: a draft
    whose heads tp does not divide keeps them replicated."""
    tp = mesh_shape(mesh).get("tp", 1)
    return axis_group(mesh, "tp") if n_head % tp == 0 else None


def _batch_split(mesh, n_audio: int):
    """The dp group when it divides the batch, else None (every dp rank
    takes the whole batch)."""
    dp = axis_group(mesh, "dp")
    return dp if group_size(dp) > 1 and n_audio % group_size(dp) == 0 else None


def _local_ckv(t, device, dp, tp, sp):
    """This rank's (L, A/dp, H/tp, dh, T/sp) block of a whole cross-K/V."""
    t = torch.as_tensor(t, device=device)
    return local_slice(local_slice(local_slice(t, dp, 1), tp, 2), sp, 4)


def _gather_rows(a, dp, device):
    """A numpy array of this rank's rows -> the whole batch's, over dp."""
    return all_gather(torch.as_tensor(a, device=device), dp, 0).cpu().numpy()


class DataParallelEngine(FusedEngine):
    """FusedEngine over a mesh: the audio batch over `dp`, the heads over
    `tp`, the cross-K/V frames over `sp`. Takes the whole ck/cv (L, A, H,
    dh, T) on every rank and returns the single-device engine's nine
    outputs on every rank."""

    def __init__(self, model, mesh, weights: str = ""):
        super().__init__(model, weights=weights)
        self.mesh = mesh
        self._tp = _head_group(mesh, model.dims.n_text_head)

    def _decoder_params(self):
        """The engine's decoder tree (int8 quantized whole, then split)
        sharded over tp; the whole tree when the heads stay replicated."""
        if self._dec_params is None:
            dec = super()._decoder_params()
            self._dec_params = dec if self._tp is None else shard_params(dec, self.mesh)
        return self._dec_params

    def run(self, initial_tokens, ck, cv, **kw):
        initial = np.asarray(initial_tokens, dtype=np.int32)
        if initial.ndim == 1:
            initial = initial[None, :]
        dev = self.model.device
        self._dp = dp = _batch_split(self.mesh, initial.shape[0])
        self._sp = _frame_group(self.mesh, ck.shape[-1])
        ck, cv = (_local_ckv(t, dev, dp, self._tp, self._sp) for t in (ck, cv))
        if dp is not None:
            initial = np.array_split(initial, group_size(dp))[group_rank(dp)]
        tokens, n, sum_lp, no_speech, *pools = super().run(initial, ck, cv, **kw)
        if dp is None:
            return (tokens, n, sum_lp, no_speech, *pools)
        rows = [_gather_rows(a, dp, dev) for a in (tokens, sum_lp, no_speech, *pools)]
        return (rows[0], n, *rows[1:])


def dp_encode(model, mesh):
    """The encoder over (dp, tp): fn(enc, mel) with `enc` this rank's
    encoder shard (shard_params) and mel (A, n_mels, 3000) whole on every
    rank -> xa (A, 1500, d) whole on every rank (all-gathered over dp)."""
    tp = axis_group(mesh, "tp")
    n_head = model.dims.n_audio_head

    @torch.inference_mode()
    def fn(enc, mel):
        mel = torch.as_tensor(mel, device=model.device)
        dp = _batch_split(mesh, mel.shape[0])
        xa = graphs.encode(enc, local_slice(mel, dp, 0), n_head=n_head, tp=tp)
        return all_gather(xa, dp, 0)

    return fn


def dp_cross_kv(model, mesh):
    """The cross-K/V over (dp, tp): fn(dec, xa) with `dec` this rank's
    decoder shard and xa (A, 1500, d) whole -> (ck, cv), each (L, A, H, dh,
    1500) whole on every rank (all-gathered over tp and dp)."""
    tp = axis_group(mesh, "tp")
    n_head = model.dims.n_text_head

    @torch.inference_mode()
    def fn(dec, xa):
        dp = _batch_split(mesh, xa.shape[0])
        ck, cv = graphs.cross_kv(dec, local_slice(xa, dp, 0), n_head=n_head, tp=tp)
        return tuple(all_gather(all_gather(t, tp, 2), dp, 1) for t in (ck, cv))

    return fn


class DataParallelSpeculativeEngine(SpeculativeEngine):
    """SpeculativeEngine over a mesh: both models' decoders sharded over
    `tp` (a draft whose heads tp does not divide keeps them replicated),
    the audio batch over `dp`, both cross-K/V frame axes over `sp`. Takes
    the whole cross-K/V of both models and returns the single-device
    engine's outputs on every rank."""

    def __init__(self, model, draft_model, mesh, k: int = 4, weights: str = ""):
        self.mesh = mesh
        super().__init__(model, draft_model, k=k, weights=weights)

    def _model_engine(self, model, weights):
        """The model's cached engine when it runs on this mesh (set_mesh),
        else a DataParallelEngine of this engine's own."""
        if getattr(model, "mesh", None) is self.mesh:
            return model_engine(model, weights)
        return DataParallelEngine(model, self.mesh, weights=weights)

    def run(self, initial_tokens, ck, cv, draft_ck, draft_cv, **kw):
        initial = np.asarray(initial_tokens, dtype=np.int32)
        if initial.ndim == 1:
            initial = initial[None, :]
        n_initial = initial.shape[1]
        dev = self.model.device
        dp = _batch_split(self.mesh, initial.shape[0])
        self._sp = _frame_group(self.mesh, ck.shape[-1])
        ck, cv = (_local_ckv(t, dev, dp, self._target._tp, self._sp) for t in (ck, cv))
        dck, dcv = (_local_ckv(t, dev, dp, self._draft._tp, self._sp) for t in (draft_ck, draft_cv))
        if dp is None:
            return super().run(initial, ck, cv, dck, dcv, **kw)
        initial = np.array_split(initial, group_size(dp))[group_rank(dp)]
        tokens, _, sum_lp, no_speech, *pools = super().run(initial, ck, cv, dck, dcv, **kw)
        stats = self.last_stats
        per_row = np.stack([stats["rounds"], stats["emitted"]], axis=1).astype(np.int32)
        rows = [_gather_rows(a, dp, dev) for a in (tokens, sum_lp, no_speech, per_row, *pools)]
        tokens, sum_lp, no_speech, per_row, *pools = rows
        # each dp group padded its rows with EOT to its own longest row:
        # pad to the whole batch's, as one engine over the batch would
        n_row = n_initial + per_row[:, 1]
        n_tokens = int(n_row.max())
        col = np.arange(tokens.shape[1])[None, :]
        pad = np.where(col < n_tokens, kw["eot"], 0).astype(tokens.dtype)
        tokens = np.where(col >= n_row[:, None], pad, tokens)
        K = self.k
        accepted = np.maximum(per_row[:, 1] - 1 - per_row[:, 0], 0)
        self.last_stats = {
            "rounds": per_row[:, 0].tolist(),
            "emitted": per_row[:, 1].tolist(),
            "draft_acceptance": (accepted / np.maximum(per_row[:, 0] * K, 1)).tolist(),
            "k": K,
        }
        return (tokens, n_tokens, sum_lp, no_speech, *pools)
