"""Whisper compute graphs as plain functions on tensors.

The counterpart of whisper_tpu/models/graphs.py with the same public
layouts, so that the tests compare like with like:

  encode      mel (B, n_mels, 3000)            -> xa (B, 1500, d)
  cross_kv    xa                               -> cK/cV (L, B, H, dh, 1500)
  prefill     tokens (B, P) + cross K/V        -> hidden (B, P, d), kv (L, 2, B, P, d)
  prefill_with_alignment                       -> ... + align scores (n_heads_sel, P, 1500)
  alignment_outputs  the word-timing replay    -> text_probs (P,), cost matrix (P, 1500)
  decode_step token (B,) + KV cache (L, 2, B, 448, d) -> logits (B, V) f32, cache

LayerNorm epsilons are 1e-7 in the audio encoder and 1e-5 in the text
decoder; GELU is exact. Attention scores and the logits are float32
products of the compute-dtype operands (`matmul_f32`, the counterpart of
XLA's preferred_element_type=float32) and the softmax runs in float32. The
forms that exist only for TPU layouts (one-hot slot writes, the row-map lazy
beam reorder, bucketed cache phases, query chunking) are not copied:
decode_step writes the new slot in place and reorders beams by an index
gather over the occupied slots.
"""

import torch
import torch.nn.functional as F

from ..ops.median import median_filter

CACHE_SLOTS = 448  # n_text_ctx; fixed self-attention cache length
PREFILL_LEN = 256  # longest first pass (224 prompt + 3 sot + margin)


def layer_norm(x, g, b, eps):
    out = F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(), eps)
    return out.to(x.dtype)


def _heads(x, n_head):
    """(B, T, d) -> (B, H, T, dh)."""
    B, T, d = x.shape
    return x.view(B, T, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x):
    """(B, H, T, dh) -> (B, T, d)."""
    B, H, T, dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * dh)


def matmul_f32(a, b):
    """a @ b as a float32 result, the products summed in float32 and never
    rounded to the operands' dtype. On the card cuBLAS reads bf16 operands
    and writes f32 (out_dtype); elsewhere the operands are widened first,
    which gives the same products."""
    if not a.is_cuda or a.dtype == torch.float32:
        return a.float() @ b.float()
    if a.dim() == b.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    (m, k), n = a.shape[-2:], b.shape[-1]
    a3 = a.expand(*batch, m, k).reshape(-1, m, k)
    b3 = b.expand(*batch, k, n).reshape(-1, k, n)
    return torch.bmm(a3, b3, out_dtype=torch.float32).view(*batch, m, n)


def _softmax_f32(scores, dtype):
    return torch.softmax(scores.float(), dim=-1).to(dtype)


def _self_attention(q, k, v, mask, n_head):
    """q, k, v: (B, T, d); mask: additive, broadcastable to (B, H, Tq, Tk)."""
    dh = q.shape[-1] // n_head
    qh = _heads(q * (dh**-0.5), n_head)
    scores = matmul_f32(qh, _heads(k, n_head).transpose(-1, -2))
    if mask is not None:
        scores = scores + mask
    w = _softmax_f32(scores, q.dtype)
    return _merge_heads(w @ _heads(v, n_head))


def _layer(tree, l):
    return {k: v[l] for k, v in tree["blocks"].items()}


def encode(enc, mel, *, n_head):
    """mel: (B, n_mels, 3000) -> (B, 1500, d) audio features."""
    blocks = enc["blocks"]
    dtype = blocks["attn_q_w"].dtype
    x = mel.to(dtype)
    x = F.gelu(F.conv1d(x, enc["conv1_w"], enc["conv1_b"], padding=1))
    x = F.gelu(F.conv1d(x, enc["conv2_w"], enc["conv2_b"], stride=2, padding=1))
    x = x.transpose(1, 2) + enc["pos_emb"]  # (B, 1500, d)

    for l in range(blocks["attn_q_w"].shape[0]):
        blk = _layer(enc, l)
        h = layer_norm(x, blk["attn_ln_g"], blk["attn_ln_b"], 1e-7)
        q = h @ blk["attn_q_w"] + blk["attn_q_b"]
        k = h @ blk["attn_k_w"]
        v = h @ blk["attn_v_w"] + blk["attn_v_b"]
        x = x + _self_attention(q, k, v, None, n_head) @ blk["attn_o_w"] + blk["attn_o_b"]
        h = layer_norm(x, blk["mlp_ln_g"], blk["mlp_ln_b"], 1e-7)
        h = F.gelu(h @ blk["mlp_fc1_w"] + blk["mlp_fc1_b"])
        x = x + h @ blk["mlp_fc2_w"] + blk["mlp_fc2_b"]
    return layer_norm(x, enc["ln_post_g"], enc["ln_post_b"], 1e-7)


def cross_kv(dec, xa, *, n_head):
    """xa: (B, 1500, d) -> (cK, cV) each (L, B, H, dh, 1500)."""
    blocks = dec["blocks"]
    xa = xa.to(blocks["cross_k_w"].dtype)
    B, T, d = xa.shape
    dh = d // n_head

    def split(y):  # (B, T, d) -> (B, H, dh, T)
        return y.view(B, T, n_head, dh).permute(0, 2, 3, 1)

    L = blocks["cross_k_w"].shape[0]
    ck = torch.stack([split(xa @ blocks["cross_k_w"][l]) for l in range(L)])
    cv = torch.stack(
        [split(xa @ blocks["cross_v_w"][l] + blocks["cross_v_b"][l]) for l in range(L)]
    )
    return ck, cv


def _cross_attention(x, blk, ck_l, cv_l, n_head, return_scores=False):
    """x: (B, T, d); ck_l/cv_l: (Bc, H, dh, Tk) with B % Bc == 0 — each
    audio's K/V serves the B // Bc query rows of its group. With
    return_scores, also the float32 scores before the softmax, (Bc, H,
    g*T, Tk)."""
    B, T, d = x.shape
    dh = d // n_head
    Bc = ck_l.shape[0]
    g = B // Bc
    h = layer_norm(x, blk["cross_ln_g"], blk["cross_ln_b"], 1e-5)
    q = (h @ blk["cross_q_w"] + blk["cross_q_b"]) * (dh**-0.5)
    # (Bc, H, g*T, dh): the group's query rows share one K/V
    qh = q.view(Bc, g * T, n_head, dh).transpose(1, 2)
    scores = matmul_f32(qh, ck_l)  # (Bc, H, g*T, Tk)
    w = _softmax_f32(scores, x.dtype)
    out = w @ cv_l.transpose(-1, -2)  # (Bc, H, g*T, dh)
    out = out.transpose(1, 2).reshape(B, T, d)
    attn = out @ blk["cross_o_w"] + blk["cross_o_b"]
    return (attn, scores) if return_scores else attn


def _mlp(x, blk):
    h = layer_norm(x, blk["mlp_ln_g"], blk["mlp_ln_b"], 1e-5)
    h = F.gelu(h @ blk["mlp_fc1_w"] + blk["mlp_fc1_b"])
    return h @ blk["mlp_fc2_w"] + blk["mlp_fc2_b"]


def _prefill(dec, tokens, n_valid, ck, cv, n_head, alignment_heads):
    """The prefill's layers; also collects the float32 cross-attention
    scores (B, P, Tk) of each (layer, head) in alignment_heads."""
    blocks = dec["blocks"]
    B, P = tokens.shape
    dev = tokens.device

    x = dec["tok_emb"][tokens.long()] + dec["pos_emb"][:P]
    pos = torch.arange(P, device=dev)
    allowed = (pos[None, :] <= pos[:, None]) & (pos[None, :] < int(n_valid))
    mask = torch.zeros((P, P), device=dev).masked_fill(~allowed, float("-inf"))

    wanted = {}
    for i, (layer, head) in enumerate(alignment_heads):
        wanted.setdefault(int(layer), []).append((int(head), i))
    align = [None] * len(alignment_heads)

    kv = []
    for l in range(blocks["attn_q_w"].shape[0]):
        blk = _layer(dec, l)
        h = layer_norm(x, blk["attn_ln_g"], blk["attn_ln_b"], 1e-5)
        q = h @ blk["attn_q_w"] + blk["attn_q_b"]
        k = h @ blk["attn_k_w"]
        v = h @ blk["attn_v_w"] + blk["attn_v_b"]
        x = x + _self_attention(q, k, v, mask, n_head) @ blk["attn_o_w"] + blk["attn_o_b"]
        if l in wanted:
            attn, scores = _cross_attention(x, blk, ck[l], cv[l], n_head, return_scores=True)
            for head, i in wanted[l]:
                align[i] = scores[:, head]
        else:
            attn = _cross_attention(x, blk, ck[l], cv[l], n_head)
        x = x + attn
        x = x + _mlp(x, blk)
        kv.append(torch.stack([k, v]))
    return layer_norm(x, dec["ln_g"], dec["ln_b"], 1e-5), torch.stack(kv), align


def prefill(dec, tokens, n_valid, ck, cv, *, n_head):
    """First decoder pass over a token block.

    tokens: (B, P) int, contents beyond n_valid arbitrary; ck/cv: (L, B, H,
    dh, 1500). Returns (hidden (B, P, d) final-LN'd, kv (L, 2, B, P, d)).
    Key positions >= n_valid are masked for every query; query rows >=
    n_valid are garbage that callers must not read."""
    hidden, kv, _ = _prefill(dec, tokens, n_valid, ck, cv, n_head, ())
    return hidden, kv


def prefill_with_alignment(dec, tokens, n_valid, ck, cv, *, n_head, alignment_heads):
    """`prefill` that also returns the cross-attention scores of the given
    (layer, head) pairs, the rows that word timing aligns on.

    tokens: (1, P). Returns (hidden (1, P, d), kv (L, 2, 1, P, d),
    align_scores (n_selected, P, 1500) float32, before the softmax)."""
    if tokens.shape[0] != 1:
        raise ValueError(f"the alignment replay runs one sequence, got {tokens.shape[0]}")
    hidden, kv, align = _prefill(dec, tokens, n_valid, ck, cv, n_head, alignment_heads)
    return hidden, kv, torch.stack(align)[:, 0]


def alignment_cost_matrix(align, n_valid, n_frames_half, qk_scale, medfilt_width):
    """The DTW cost matrix from the raw alignment-head scores: softmax over
    the valid frames, z-normalisation per head over the n_valid token rows
    (population std), the median filter along frames reflecting at
    n_frames_half, and the mean over heads (the counterpart of
    whisper_tpu/models/graphs.py:_alignment_cost_matrix).

    align: (Hn, P, F) f32. Returns (P, F) f32; rows >= n_valid and columns
    >= n_frames_half are junk (the columns NaN) that the caller slices off."""
    _, P, F = align.shape
    dev = align.device
    fmask = torch.arange(F, device=dev) < n_frames_half
    w = align.float() * qk_scale
    w = w.masked_fill(~fmask, float("-inf"))
    w = torch.softmax(w, dim=-1)  # invalid frames -> exactly 0

    rmask = (torch.arange(P, device=dev) < n_valid)[None, :, None]
    mean = torch.where(rmask, w, 0.0).sum(dim=1, keepdim=True) / n_valid
    var = torch.where(rmask, (w - mean) ** 2, 0.0).sum(dim=1, keepdim=True) / n_valid
    w = (w - mean) / torch.sqrt(var)

    w = median_filter(w.contiguous(), medfilt_width, n_valid=n_frames_half)
    return w.mean(dim=0)


def alignment_outputs(
    dec, tokens, n_valid, ck, cv, row_ids, n_frames_half, qk_scale, *,
    n_head, alignment_heads, eot, medfilt_width=7,
):  # fmt: skip
    """The word-timestamp replay: teacher-forced prefill with the alignment
    heads' scores, per-row text probabilities, and the DTW cost matrix.

    row_ids: (P,) int — row i reports the probability of token row_ids[i]
    over the text vocabulary. Returns (text_probs (P,) f32, matrix (P, F)
    f32)."""
    hidden, _, align = prefill_with_alignment(
        dec, tokens, n_valid, ck, cv, n_head=n_head, alignment_heads=alignment_heads
    )
    logits = hidden_to_logits(dec, hidden[0])[:, :eot]
    probs = torch.softmax(logits, dim=-1)
    text_probs = probs.gather(1, row_ids.long()[:, None])[:, 0]
    matrix = alignment_cost_matrix(align, n_valid, n_frames_half, qk_scale, medfilt_width)
    return text_probs, matrix


def hidden_to_logits(dec, hidden):
    """hidden (..., d) -> logits (..., n_vocab) float32."""
    emb = dec["tok_emb"]
    h = hidden.to(emb.dtype)
    return matmul_f32(h.reshape(-1, h.shape[-1]), emb.T).view(*h.shape[:-1], emb.shape[0])


def decode_step(dec, tokens, pos, cache, src, ck, cv, *, n_head):
    """One autoregressive step for all rows.

    tokens: (B,) int — the tokens sampled at the previous step
    pos:    int — the cache slot to write (number of tokens so far)
    cache:  (L, 2, B, 448, d) self-attention K/V, UPDATED IN PLACE
    src:    (B,) int or None — the beam reorder from the previous update:
            row b continues the history of row src[b]
    ck/cv:  (L, Bc, H, dh, 1500), B % Bc == 0, one entry per audio

    Returns (logits (B, n_vocab) f32, cache)."""
    pos = int(pos)
    if src is not None:
        # only the occupied slots carry history
        cache[:, :, :, :pos] = cache[:, :, src.long(), :pos]

    blocks = dec["blocks"]
    B = tokens.shape[0]
    d = dec["tok_emb"].shape[1]
    dh = d // n_head
    x = (dec["tok_emb"][tokens.long()] + dec["pos_emb"][pos])[:, None, :]  # (B, 1, d)

    for l in range(blocks["attn_q_w"].shape[0]):
        blk = _layer(dec, l)
        h = layer_norm(x, blk["attn_ln_g"], blk["attn_ln_b"], 1e-5)
        q = h @ blk["attn_q_w"] + blk["attn_q_b"]
        cache[l, 0, :, pos] = (h @ blk["attn_k_w"])[:, 0]
        cache[l, 1, :, pos] = (h @ blk["attn_v_w"] + blk["attn_v_b"])[:, 0]
        keys = cache[l, 0, :, : pos + 1].view(B, pos + 1, n_head, dh).transpose(1, 2)
        vals = cache[l, 1, :, : pos + 1].view(B, pos + 1, n_head, dh).transpose(1, 2)
        qh = (q * (dh**-0.5)).view(B, 1, n_head, dh).transpose(1, 2)  # (B, H, 1, dh)
        w = _softmax_f32(matmul_f32(qh, keys.transpose(-1, -2)), x.dtype)  # (B, H, 1, pos+1)
        x = x + _merge_heads(w @ vals) @ blk["attn_o_w"] + blk["attn_o_b"]
        x = x + _cross_attention(x, blk, ck[l], cv[l], n_head)
        x = x + _mlp(x, blk)
    x = layer_norm(x, dec["ln_g"], dec["ln_b"], 1e-5)
    return hidden_to_logits(dec, x[:, 0]), cache
