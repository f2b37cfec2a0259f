"""Weight-only int8 for the text decoder (the counterpart of
whisper_tpu/quant.py).

Each weight product of the decode loop stores its weight as int8 with one
float32 scale per output channel (a '<name>@scale' sibling in the same
tree); the token embedding, which is also the logits head, gets one scale
per vocabulary row; the cross-attention K/V of a window get one scale per
(dh,) column. `graphs._dot`, `graphs.tok_embedding`, `graphs.hidden_to_logits`
and `graphs._cross_attention` read the quantized forms. Biases, layer
norms, positional embeddings and the cross-K/V projections stay in the
compute dtype.

int8 is an opt-in serving mode (`FusedEngine(model, weights="int8")`,
`load_model(..., weights="int8")`): its tokens follow the quantized
weights and are not held equal to the bf16 engine's.

The quantized tree lives on the engine that uses it, never on the model:
the model's own parameters serve the encoder, the word-timing replay and
the plain engine.
"""

from typing import Dict, Tuple

import torch

# the decoder's weight products, (..., K, N) contracted over K: one scale
# per output channel N
DECODER_QUANT_KEYS: Tuple[str, ...] = (
    "attn_q_w",
    "attn_k_w",
    "attn_v_w",
    "attn_o_w",
    "cross_q_w",
    "cross_o_w",
    "mlp_fc1_w",
    "mlp_fc2_w",
)

WEIGHT_MODES = ("bf16", "int8")  # the CLI's and the servers' names


def check_weights_mode(mode: str) -> str:
    """The canonical form of a weights mode: "" for the model's own dtype
    (given as "" or "bf16"), "int8"; ValueError for any other."""
    if mode not in ("",) + WEIGHT_MODES:
        raise ValueError(f"unknown weights mode {mode!r} (expected 'bf16' or 'int8')")
    return "" if mode == "bf16" else mode


def _quantize(w, axis):
    """Symmetric int8 along `axis`: scale = amax / 127 + 1e-12, round half
    to even, clip to +-127. Returns (int8 tensor, float32 scale with `axis`
    reduced away)."""
    wf = w.float()
    # the divisor a tensor: CUDA multiplies by the reciprocal of a Python
    # number, which can leave a scale one ulp off the quotient and move an
    # int8 value across a rounding midpoint
    s = wf.abs().amax(dim=axis, keepdim=True) / torch.full((), 127.0, device=w.device) + 1e-12
    wi8 = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return wi8, s.squeeze(axis)


def _quantize_k_major(w):
    """(..., K, N) weight -> (int8 weight, (..., N) float32 scale)."""
    return _quantize(w, -2)


def _quantize_rows(w):
    """(V, d) embedding -> (int8, (V,) float32 scale): the logits head
    contracts over d, so the scales are per vocabulary row."""
    return _quantize(w, -1)


@torch.inference_mode()
def quantize_cross_kv(ck, cv):
    """Per-column int8 of a window's cross-attention K/V, (L, B, H, dh, T)
    each: one scale per (dh,) column, so the K scale factors out of the
    score product (scores * s_k) and the V scale folds into the softmax
    weights (w * s_v). Returns ((ck_i8, ck_scale), (cv_i8, cv_scale)) with
    scales (L, B, H, T) float32."""
    return _quantize(ck, 3), _quantize(cv, 3)


@torch.inference_mode()
def quantize_decoder(dec: Dict, quantize_embedding: bool = True) -> Dict:
    """A new decoder tree whose loop weights are int8 with '@scale'
    siblings, on the tree's device; `dec` is left as it is."""
    out = dict(dec)
    blocks = dict(dec["blocks"])
    for key in DECODER_QUANT_KEYS:
        blocks[key], blocks[key + "@scale"] = _quantize_k_major(blocks[key])
    out["blocks"] = blocks
    if quantize_embedding:
        out["tok_emb"], out["tok_emb@scale"] = _quantize_rows(dec["tok_emb"])
    return out
