"""The user-facing Whisper model: dimensions, parameters on one device, and
the graph entry points (the counterpart of whisper_tpu/models/whisper.py)."""

import base64
import gzip
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import graphs
from .dims import ModelDimensions
from .params import cast_params, flatten_tree, init_random_params


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. A missing card is an error, never a silent move to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to run on the CPU"
        )
    return device


class Whisper(nn.Module):
    def __init__(
        self,
        dims: ModelDimensions,
        params: Optional[Dict] = None,
        name: str = "custom",
        compute_dtype=torch.bfloat16,
        device="cuda",
        seed: int = 0,
    ):
        super().__init__()
        self.dims = dims
        self.name = name
        self.device = resolve_device(device)
        if isinstance(compute_dtype, str):
            compute_dtype = getattr(torch, compute_dtype)
        self.compute_dtype = compute_dtype
        if params is None:
            params = init_random_params(dims, seed=seed, dtype=compute_dtype, device=self.device)
        self.params = cast_params(params, compute_dtype, self.device)
        for path, t in flatten_tree(self.params):
            self.register_buffer(path.replace("/", "__"), t, persistent=True)
        # word timing aligns on these cross-attention heads; the default is
        # every head of the upper half of the decoder's layers
        half = dims.n_text_layer // 2
        self.alignment_heads: List[Tuple[int, int]] = [
            (l, h) for l in range(half, dims.n_text_layer) for h in range(dims.n_text_head)
        ]
        # decode() runs the engine; False sends it to the host loop
        # (decoding.DecodingTask._main_loop_host)
        self.use_fused_decode = True
        # the engines' weights mode: "" (the model's own dtype) or "int8"
        # (quant.py); load_model(..., weights=) sets it
        self.decode_weights = ""
        # speculative greedy decoding (set_draft_model)
        self.draft_k = 4
        self.set_draft_model(None)
        self.set_mesh(None)

    # ---- graph entry points -------------------------------------------------

    def _mesh_pick(self, plain, sharded, batch: int):
        """The sharded function when a mesh is set and the batch splits over
        dp; the plain single-device one otherwise (transcribe()'s
        per-window n_audio=1 calls under a dp > 1 mesh)."""
        if self.mesh is None:
            return plain
        dp = dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape)).get("dp", 1)
        return sharded if batch % dp == 0 else plain

    @torch.inference_mode()
    def encode(self, mel) -> torch.Tensor:
        """mel: (B, n_mels, 3000) -> audio features (B, 1500, d)."""
        mel = torch.as_tensor(mel, device=self.device)
        fn = self._mesh_pick(self._encode_plain, self._encode_sharded, mel.shape[0])
        return fn(mel)

    @torch.inference_mode()
    def cross_kv(self, xa):
        fn = self._mesh_pick(self._cross_kv_plain, self._cross_kv_sharded, xa.shape[0])
        return fn(xa)

    def _encode_plain(self, mel):
        return graphs.encode(self.params["encoder"], mel, n_head=self.dims.n_audio_head)

    def _cross_kv_plain(self, xa):
        return graphs.cross_kv(self.params["decoder"], xa, n_head=self.dims.n_text_head)

    @torch.inference_mode()
    def encode_with_cross_kv(self, mel):
        """mel (B, n_mels, 3000) -> (xa, cK, cV)."""
        xa = self.encode(mel)
        ck, cv = self.cross_kv(xa)
        return xa, ck, cv

    @torch.inference_mode()
    def prefill(self, tokens, n_valid, ck, cv):
        """tokens: (B, n), n <= PREFILL_LEN -> (hidden (B, n, d), kv (L, 2, B, n, d))."""
        tokens = torch.as_tensor(tokens, dtype=torch.int64, device=self.device)
        if tokens.shape[1] > graphs.PREFILL_LEN:
            raise ValueError(
                f"initial token length {tokens.shape[1]} exceeds prefill window "
                f"{graphs.PREFILL_LEN}"
            )
        return graphs.prefill(
            self.params["decoder"], tokens, n_valid, ck, cv, n_head=self.dims.n_text_head
        )

    @torch.inference_mode()
    def decode_step(self, tokens, pos, cache, src, ck, cv):
        tokens = torch.as_tensor(tokens, device=self.device)
        if src is not None:
            src = torch.as_tensor(src, device=self.device)
        return graphs.decode_step(
            self.params["decoder"], tokens, pos, cache, src, ck, cv,
            n_head=self.dims.n_text_head,
        )  # fmt: skip

    @torch.inference_mode()
    def alignment_replay(
        self, tokens, n_valid, ck, cv, row_ids, n_frames: int, eot: int,
        qk_scale: float = 1.0, medfilt_width: int = 7,
    ):  # fmt: skip
        """The word-timestamp replay of one token sequence (1, n): prefill
        with the alignment heads' scores, token probabilities and the DTW
        cost matrix (graphs.alignment_outputs). Returns tensors on the
        model's device: text_probs (n,), matrix (n, 1500)."""
        tokens = torch.as_tensor(tokens, dtype=torch.int64, device=self.device)
        if tokens.shape[1] > graphs.PREFILL_LEN:
            raise ValueError(
                f"replay length {tokens.shape[1]} exceeds prefill window {graphs.PREFILL_LEN}"
            )
        return graphs.alignment_outputs(
            self.params["decoder"], tokens, n_valid, ck, cv,
            torch.as_tensor(row_ids, device=self.device), n_frames // 2, qk_scale,
            n_head=self.dims.n_text_head, alignment_heads=tuple(self.alignment_heads),
            eot=eot, medfilt_width=medfilt_width,
        )  # fmt: skip

    @torch.inference_mode()
    def hidden_to_logits(self, hidden):
        return graphs.hidden_to_logits(self.params["decoder"], hidden)

    def new_cache(self, batch: int, width: Optional[int] = None) -> torch.Tensor:
        """An empty (L, 2, batch, 448, width) self-attention K/V cache; the
        width defaults to d (a tensor-parallel rank's is d / tp)."""
        shape = (
            self.dims.n_text_layer, 2, batch, graphs.CACHE_SLOTS, width or self.dims.n_text_state
        )  # fmt: skip
        return torch.zeros(shape, dtype=self.compute_dtype, device=self.device)

    @torch.inference_mode()
    def kv_to_cache_grouped(self, kv, n_group: int) -> torch.Tensor:
        """The prefill's kv (L, 2, n_audio, P, d) -> a cache (L, 2,
        n_audio * n_group, 448, d) holding each audio's K/V in slots 0..P-1
        of its n_group rows (audio-major), as engine.FusedEngine lays it."""
        cache = self.new_cache(kv.shape[2] * n_group, kv.shape[-1])
        cache[:, :, :, : kv.shape[3]] = kv.repeat_interleave(n_group, dim=2)
        return cache

    # ---- metadata ------------------------------------------------------------

    @property
    def is_multilingual(self) -> bool:
        return self.dims.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        return self.dims.n_vocab - 51765 - int(self.is_multilingual)

    def set_alignment_heads(self, dump: bytes):
        """Install a published alignment-head mask: base85 + gzip packed
        bools of shape (n_text_layer, n_text_head)."""
        array = np.frombuffer(gzip.decompress(base64.b85decode(dump)), dtype=bool)
        mask = array.reshape(self.dims.n_text_layer, self.dims.n_text_head)
        self.alignment_heads = [(int(l), int(h)) for l, h in np.argwhere(mask)]

    def set_draft_model(self, draft: Optional["Whisper"], k: int = 4):
        """Attach a draft model for speculative greedy decoding, or clear it
        with None.

        With a draft, decode() / transcribe() / transcribe_batch / the
        batcher run their greedy temperature-0 attempts on the speculative
        engine (speculative.py): the draft proposes `k` tokens a round and
        this model checks them in one decoder pass; the tokens are those of
        plain greedy. The t > 0 ladder and beam search run the plain engine.
        Both models read one mel, so the draft must share n_mels as well as
        the vocabulary (frontend.encode_clip_spec and SpeculativeEngine
        serve drafts of another n_mels directly)."""
        if draft is not None and draft.dims.n_vocab != self.dims.n_vocab:
            raise ValueError(
                "draft must share the tokenizer/vocab "
                f"({draft.dims.n_vocab} vs {self.dims.n_vocab})"
            )
        if draft is not None and draft.dims.n_mels != self.dims.n_mels:
            raise ValueError(
                "transcribe()-level speculation feeds both models one mel; "
                f"draft n_mels {draft.dims.n_mels} != {self.dims.n_mels} "
                "(use SpeculativeEngine + encode_clip_spec directly)"
            )
        # a plain attribute: the draft is not a submodule of this model
        object.__setattr__(self, "draft_model", draft)
        self._spec_engine = None  # the decoding task builds it for this draft
        if draft is not None:
            self.draft_k = int(k)

    def set_mesh(self, mesh):
        """Run this model's whole decode surface - decode() / transcribe() /
        transcribe_batch / ContinuousBatcher / the servers - on `mesh`
        (parallel/mesh.py), SPMD: every rank calls the same entry points
        with the same inputs and gets the same results. The encoder and the
        cross-K/V run over (dp, tp) and are all-gathered; the engines
        (parallel/serve.py) split the audio batch over dp, the heads over
        tp and the cross-K/V frames over sp. Batches dp does not divide
        (transcribe()'s per-window n_audio=1) encode unsharded and decode
        unsharded over dp, so keep serving batch sizes at a multiple of dp.
        Pass None to restore the single-device model."""
        self.mesh = mesh
        self._fused_engine = None  # the decoding task builds it for this mesh
        self._spec_engine = None
        self._encode_sharded = self._cross_kv_sharded = None
        if mesh is None:
            return
        from ..parallel.serve import dp_cross_kv, dp_encode
        from ..parallel.sharding import shard_params

        enc = shard_params(self.params["encoder"], mesh)
        dec = shard_params(self.params["decoder"], mesh)
        encode_fn, cross_kv_fn = dp_encode(self, mesh), dp_cross_kv(self, mesh)
        self._encode_sharded = lambda mel: encode_fn(enc, mel)
        self._cross_kv_sharded = lambda xa: cross_kv_fn(dec, xa)

    # ---- high-level API ------------------------------------------------------

    def decode(self, mel, options=None, **kwargs):
        from ..decoding import decode as decode_fn

        return decode_fn(self, mel, options, **kwargs)

    def detect_language(self, mel_or_features, tokenizer=None):
        from ..decoding import detect_language as detect_fn

        return detect_fn(self, mel_or_features, tokenizer)

    def transcribe(self, audio, **kwargs):
        from ..transcribe import transcribe as transcribe_fn

        return transcribe_fn(self, audio, **kwargs)

