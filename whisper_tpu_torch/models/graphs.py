"""Whisper compute graphs as plain functions on tensors.

The counterpart of whisper_tpu/models/graphs.py with the same public
layouts, so that the tests compare like with like:

  encode      mel (B, n_mels, 3000)            -> xa (B, 1500, d)
  cross_kv    xa                               -> cK/cV (L, B, H, dh, 1500)
  prefill     tokens (B, P) + cross K/V        -> hidden (B, P, d), kv (L, 2, B, P, d)
  prefill_with_alignment                       -> ... + align scores (n_heads_sel, P, 1500)
  alignment_outputs  the word-timing replay    -> text_probs (P,), cost matrix (P, 1500)
  decode_step token (B,) + KV cache (L, 2, B, 448, d) -> logits (B, V) f32, cache
  decode_step_fixed  the same at fixed shapes: pos a 0-d tensor, every slot read
  decode_chunk K tokens (B, K) at per-row slots pos (B,) -> logits (B, K, V) f32, cache
  decoder_forward  tokens (B, T) teacher-forced    -> logits (B, T, V) f32

LayerNorm epsilons are 1e-7 in the audio encoder and 1e-5 in the text
decoder; GELU is exact. Attention scores and the logits are float32
products of the compute-dtype operands (`matmul_f32`, the counterpart of
XLA's preferred_element_type=float32) and the softmax runs in float32. The
forms that exist only for TPU layouts (one-hot slot writes, the row-map lazy
beam reorder, bucketed cache phases, query chunking) are not copied:
decode_step writes the new slot in place and reorders beams by an index
gather over the occupied slots; decode_chunk attends over the cache up to
the largest row position with a per-row key mask. decode_step_fixed is the
exported form (export.py): no shape in it depends on a host value.

A decoder tree from quant.quantize_decoder holds int8 weights with
'<name>@scale' siblings, and the cross-K/V may be int8 (tensor, scale)
pairs from quant.quantize_cross_kv: `_dot`, `tok_embedding`,
`_cross_attention` and `hidden_to_logits` read both forms, the plain one
exactly as before.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.median import median_filter
from ..comm import all_reduce, copy_to_group, gather_from_group, group_size, reduce_from_group

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


def _mm_f32(a, b):
    """cuBLAS's product of two bf16 (or f16) operands written as float32;
    a's and b's batch dims broadcast. Under torch.export a batched product
    takes another form: AOTInductor has a C shim for mm's out_dtype overload
    but none for bmm's, so an exported graph multiplies a 2-D `b` as one mm
    over a's flattened rows and widens the operands of any other batched
    product (the same bf16 products, summed in float32)."""
    if a.dim() == b.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    if torch.compiler.is_exporting():
        if b.dim() == 2:
            y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
            return y.view(*a.shape[:-1], b.shape[-1])
        return a.float() @ b.float()
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    (m, k), n = a.shape[-2:], b.shape[-1]
    a3 = a.expand(*batch, m, k).reshape(-1, m, k)
    b3 = b.expand(*batch, k, n).reshape(-1, k, n)
    return torch.bmm(a3, b3, out_dtype=torch.float32).view(*batch, m, n)


class _MatmulF32(torch.autograd.Function):
    """`_mm_f32` with a gradient: autograd has none for the out_dtype
    overloads of mm and bmm. Each operand's gradient is the product of the
    float32 cotangent with the other operand widened, summed over the dims
    it was broadcast along in float32, then rounded to the operand's dtype
    (JAX's transpose of a dot_general with preferred_element_type=float32).
    Only the operands are saved, never the float32 output."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g @ b.float().mT).sum_to_size(a.shape).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = (a.float().mT @ g).sum_to_size(b.shape).to(b.dtype)
        return ga, gb


def matmul_f32(a, b):
    """a @ b as a float32 result, the products summed in float32 and never
    rounded to the operands' dtype. On the card cuBLAS reads bf16 operands
    and writes f32 (out_dtype), through `_MatmulF32` where a gradient is
    wanted; elsewhere the operands are widened first, which gives the same
    products."""
    if not a.is_cuda or a.dtype == torch.float32:
        return a.float() @ b.float()
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MatmulF32.apply(a, b)
    return _mm_f32(a, b)


def _dot(x, blk, name):
    """x @ blk[name]. An int8 weight (quant.py) has a '<name>@scale' sibling,
    one float32 scale per output channel: the product of the bf16-rounded
    operands is summed in float32, scaled, and cast to x's dtype (as the
    JAX package's _dot rounds an f32 model's activations to bf16 too)."""
    w = blk[name]
    scale = blk.get(name + "@scale")
    if scale is None:
        return x @ w
    y = matmul_f32(x.to(torch.bfloat16), w.to(torch.bfloat16))
    return (y * scale).to(x.dtype)


def tok_embedding(dec, tokens, dtype):
    """Token-embedding rows in `dtype`, dequantized per row if int8."""
    tokens = tokens.long()
    rows = dec["tok_emb"][tokens]
    scale = dec.get("tok_emb@scale")
    if scale is None:
        return rows.to(dtype)
    return (rows.float() * scale[tokens][..., None]).to(dtype)


def ckv_layer(ckv, l):
    """Layer `l` of a cross-K/V operand: a stacked tensor or an int8
    (tensor, scale) pair."""
    if isinstance(ckv, tuple):
        return ckv[0][l], ckv[1][l]
    return ckv[l]


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


def _layers(tree):
    """Every layer's weights, each stacked leaf split by one unbind. Under
    autograd its backward writes the stacked gradient once; indexing layer
    by layer would write a zero tensor of the whole stack per layer."""
    blocks = tree["blocks"]
    return [dict(zip(blocks, ws)) for ws in zip(*(v.unbind(0) for v in blocks.values()))]


def encoder_stem(enc, mel):
    """The conv stem and the position embedding: mel (B, n_mels, 2T) ->
    (B, T, d) in the weights' dtype."""
    x = mel.to(enc["blocks"]["attn_q_w"].dtype)
    x = F.gelu(F.conv1d(x, enc["conv1_w"], enc["conv1_b"], padding=1))
    x = F.gelu(F.conv1d(x, enc["conv2_w"], enc["conv2_b"], stride=2, padding=1))
    return x.transpose(1, 2) + enc["pos_emb"]


def encoder_block(x, blk, n_head, tp=None, sp=None):
    """One encoder layer on x (B, T, d) with `n_head` local heads. Under tp
    the layer's weights are this rank's shards (parallel/sharding.py); under
    sp x holds this rank's frames, and each layer all-gathers K and V over
    the frames (parallel/sequence.py)."""
    h = copy_to_group(layer_norm(x, blk["attn_ln_g"], blk["attn_ln_b"], 1e-7), tp)
    q = h @ blk["attn_q_w"] + blk["attn_q_b"]
    k = gather_from_group(h @ blk["attn_k_w"], sp, dim=1)
    v = gather_from_group(h @ blk["attn_v_w"] + blk["attn_v_b"], sp, dim=1)
    x = x + reduce_from_group(_self_attention(q, k, v, None, n_head) @ blk["attn_o_w"], tp) + blk["attn_o_b"]
    h = copy_to_group(layer_norm(x, blk["mlp_ln_g"], blk["mlp_ln_b"], 1e-7), tp)
    h = F.gelu(h @ blk["mlp_fc1_w"] + blk["mlp_fc1_b"])
    return x + reduce_from_group(h @ blk["mlp_fc2_w"], tp) + blk["mlp_fc2_b"]


def encoder_ln_post(enc, x):
    return layer_norm(x, enc["ln_post_g"], enc["ln_post_b"], 1e-7)


def encode(enc, mel, *, n_head, tp=None):
    """mel: (B, n_mels, 3000) -> (B, 1500, d) audio features. `n_head` is
    the model's; with a tp group the tree is this rank's shard and each
    rank computes n_head / tp heads."""
    x = encoder_stem(enc, mel)  # (B, 1500, d)
    for blk in _layers(enc):
        x = encoder_block(x, blk, n_head // group_size(tp), tp)
    return encoder_ln_post(enc, x)


def cross_kv(dec, xa, *, n_head, tp=None):
    """xa: (B, 1500, d) -> (cK, cV) each (L, B, H, dh, 1500); with a tp
    group, this rank's H / tp heads."""
    blocks = dec["blocks"]
    xa = copy_to_group(xa.to(blocks["cross_k_w"].dtype), tp)
    B, T, _ = xa.shape
    n_local = n_head // group_size(tp)

    def split(y):  # (B, T, H * dh) -> (B, H, dh, T)
        return y.view(B, T, n_local, y.shape[-1] // n_local).permute(0, 2, 3, 1)

    ck = torch.stack([split(xa @ w) for w in blocks["cross_k_w"].unbind(0)])
    vs = zip(blocks["cross_v_w"].unbind(0), blocks["cross_v_b"].unbind(0))
    cv = torch.stack([split(xa @ w + b) for w, b in vs])
    return ck, cv


def _sp_softmax(scores, sp):
    """The softmax over frames split across the sp group: the row maxima
    all-reduced with MAX, the exp sums with SUM; float32 like the scores."""
    m = all_reduce(scores.amax(dim=-1, keepdim=True), sp, dist.ReduceOp.MAX)
    e = torch.exp(scores - m)
    return e / all_reduce(e.sum(dim=-1, keepdim=True), sp)


def _cross_attention(x, blk, ck_l, cv_l, n_head, return_scores=False, tp=None, sp=None):
    """x: (B, T, d); ck_l/cv_l: (Bc, H, dh, Tk) with B % Bc == 0 — each
    audio's K/V serves the B // Bc query rows of its group — or int8
    (tensor, (Bc, H, Tk) scale) pairs: the K scale multiplies the scores,
    the V scale the softmax weights before the AV product. With
    return_scores, also the float32 scores before the softmax, (Bc, H,
    g*T, Tk). `n_head` is the local head count (H). Under sp the K/V hold
    this rank's frames: the softmax is assembled over the group and the
    partial AV products summed (no scores are returned then)."""
    B, T, d = x.shape
    ck_a, ck_s = ck_l if isinstance(ck_l, tuple) else (ck_l, None)
    cv_a, cv_s = cv_l if isinstance(cv_l, tuple) else (cv_l, None)
    Bc = ck_a.shape[0]
    g = B // Bc
    h = copy_to_group(layer_norm(x, blk["cross_ln_g"], blk["cross_ln_b"], 1e-5), tp)
    q = _dot(h, blk, "cross_q_w") + blk["cross_q_b"]
    dh = q.shape[-1] // n_head
    q = q * (dh**-0.5)
    # (Bc, H, g*T, dh): the group's query rows share one K/V
    qh = q.view(Bc, g * T, n_head, dh).transpose(1, 2)
    if ck_s is None:
        scores = matmul_f32(qh, ck_a)  # (Bc, H, g*T, Tk)
    else:
        scores = matmul_f32(qh, ck_a.to(qh.dtype)) * ck_s[:, :, None, :]
    if sp is not None:
        w = _sp_softmax(scores.float(), sp)
        w = (w if cv_s is None else w * cv_s[:, :, None, :]).to(x.dtype)
        out = all_reduce(w @ cv_a.to(x.dtype).transpose(-1, -2), sp)
    elif cv_s is None:
        w = _softmax_f32(scores, x.dtype)
        out = w @ cv_a.transpose(-1, -2)  # (Bc, H, g*T, dh)
    else:
        w = (torch.softmax(scores.float(), dim=-1) * cv_s[:, :, None, :]).to(x.dtype)
        out = w @ cv_a.to(x.dtype).transpose(-1, -2)
    out = out.transpose(1, 2).reshape(B, T, n_head * dh)
    attn = reduce_from_group(_dot(out, blk, "cross_o_w"), tp) + blk["cross_o_b"]
    return (attn, scores) if return_scores else attn


def _mlp(x, blk, tp=None):
    h = copy_to_group(layer_norm(x, blk["mlp_ln_g"], blk["mlp_ln_b"], 1e-5), tp)
    h = F.gelu(_dot(h, blk, "mlp_fc1_w") + blk["mlp_fc1_b"])
    return reduce_from_group(_dot(h, blk, "mlp_fc2_w"), tp) + blk["mlp_fc2_b"]


def _self_attn_out(x, blk, attn, tp):
    """x plus the self-attention's out-projection of `attn` (B, T, d/tp):
    a row-parallel product, reduced over tp before its bias."""
    return x + reduce_from_group(_dot(attn, blk, "attn_o_w"), tp) + blk["attn_o_b"]


def _prefill(dec, tokens, n_valid, ck, cv, n_head, alignment_heads, keep_kv=True, tp=None, sp=None):
    """The prefill's layers; also collects the float32 cross-attention
    scores (B, P, Tk) of each (layer, head) in alignment_heads (unsharded
    only). Without keep_kv the K/V stack is None."""
    if alignment_heads and (tp is not None or sp is not None):
        raise ValueError("the alignment heads' scores need the whole cross-K/V: gather it first")
    blocks = dec["blocks"]
    B, P = tokens.shape
    dev = tokens.device
    n_head //= group_size(tp)

    x = tok_embedding(dec, tokens, blocks["attn_q_b"].dtype) + dec["pos_emb"][:P]
    pos = torch.arange(P, device=dev)
    allowed = (pos[None, :] <= pos[:, None]) & (pos[None, :] < int(n_valid))
    mask = torch.zeros((P, P), device=dev).masked_fill(~allowed, float("-inf"))

    wanted = {}
    for i, (layer, head) in enumerate(alignment_heads):
        wanted.setdefault(int(layer), []).append((int(head), i))
    align = [None] * len(alignment_heads)

    kv = []
    for l, blk in enumerate(_layers(dec)):
        h = copy_to_group(layer_norm(x, blk["attn_ln_g"], blk["attn_ln_b"], 1e-5), tp)
        q = _dot(h, blk, "attn_q_w") + blk["attn_q_b"]
        k = _dot(h, blk, "attn_k_w")
        v = _dot(h, blk, "attn_v_w") + blk["attn_v_b"]
        x = _self_attn_out(x, blk, _self_attention(q, k, v, mask, n_head), tp)
        ck_l, cv_l = ckv_layer(ck, l), ckv_layer(cv, l)
        if l in wanted:
            attn, scores = _cross_attention(x, blk, ck_l, cv_l, n_head, return_scores=True)
            for head, i in wanted[l]:
                align[i] = scores[:, head]
        else:
            attn = _cross_attention(x, blk, ck_l, cv_l, n_head, tp=tp, sp=sp)
        x = x + attn
        x = x + _mlp(x, blk, tp)
        if keep_kv:
            kv.append(torch.stack([k, v]))
    kv = torch.stack(kv) if keep_kv else None
    return layer_norm(x, dec["ln_g"], dec["ln_b"], 1e-5), kv, align


def prefill(dec, tokens, n_valid, ck, cv, *, n_head, tp=None, sp=None):
    """First decoder pass over a token block.

    tokens: (B, P) int, contents beyond n_valid arbitrary; ck/cv: (L, B, H,
    dh, 1500). Returns (hidden (B, P, d) final-LN'd, kv (L, 2, B, P, d)).
    Key positions >= n_valid are masked for every query; query rows >=
    n_valid are garbage that callers must not read. With a tp group the
    tree and ck/cv are this rank's shards and kv holds its d / tp columns;
    with an sp group ck/cv hold its frames."""
    hidden, kv, _ = _prefill(dec, tokens, n_valid, ck, cv, n_head, (), tp=tp, sp=sp)
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


def decoder_forward(dec, tokens, ck, cv, *, n_head, tp=None):
    """The teacher-forced decoder over full sequences, the training forward
    (whisper_tpu/models/graphs.py decoder_forward): the prefill's layers at
    n_valid = T, which is the plain causal mask, keeping no K/V.

    tokens: (B, T) int; ck/cv: (L, B, H, dh, 1500). Returns logits (B, T,
    V) float32, replicated over a tp group."""
    hidden, _, _ = _prefill(dec, tokens, tokens.shape[1], ck, cv, n_head, (), keep_kv=False, tp=tp)
    return hidden_to_logits(dec, hidden)


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
    """hidden (..., d) -> logits (..., n_vocab) float32; an int8 embedding
    multiplies its bf16 product by the per-row scale."""
    emb = dec["tok_emb"]
    scale = dec.get("tok_emb@scale")
    if scale is not None:
        emb = emb.to(torch.bfloat16)
    h = hidden.to(emb.dtype)
    logits = matmul_f32(h.reshape(-1, h.shape[-1]), emb.T).view(*h.shape[:-1], emb.shape[0])
    return logits if scale is None else logits * scale


def decode_step(dec, tokens, pos, cache, src, ck, cv, *, n_head, tp=None, sp=None):
    """One autoregressive step for all rows.

    tokens: (B,) int — the tokens sampled at the previous step
    pos:    int — the cache slot to write (number of tokens so far)
    cache:  (L, 2, B, 448, d) self-attention K/V, UPDATED IN PLACE
    src:    (B,) int or None — the beam reorder from the previous update:
            row b continues the history of row src[b]
    ck/cv:  (L, Bc, H, dh, 1500), B % Bc == 0, one entry per audio
    tp, sp: process groups, as in `prefill` (the cache holds d / tp)

    Returns (logits (B, n_vocab) f32, cache)."""
    pos = int(pos)
    if src is not None:
        # only the occupied slots carry history
        cache[:, :, :, :pos] = cache[:, :, src.long(), :pos]

    blocks = dec["blocks"]
    B = tokens.shape[0]
    d = dec["tok_emb"].shape[1]
    dh = d // n_head
    n_head //= group_size(tp)
    x = tok_embedding(dec, tokens, blocks["attn_q_b"].dtype) + dec["pos_emb"][pos]
    x = x[:, None, :]  # (B, 1, d)

    for l in range(blocks["attn_q_w"].shape[0]):
        blk = _layer(dec, l)
        h = copy_to_group(layer_norm(x, blk["attn_ln_g"], blk["attn_ln_b"], 1e-5), tp)
        q = _dot(h, blk, "attn_q_w") + blk["attn_q_b"]
        cache[l, 0, :, pos] = _dot(h, blk, "attn_k_w")[:, 0]
        cache[l, 1, :, pos] = (_dot(h, blk, "attn_v_w") + blk["attn_v_b"])[:, 0]
        keys = cache[l, 0, :, : pos + 1].view(B, pos + 1, n_head, dh).transpose(1, 2)
        vals = cache[l, 1, :, : pos + 1].view(B, pos + 1, n_head, dh).transpose(1, 2)
        qh = (q * (dh**-0.5)).view(B, 1, n_head, dh).transpose(1, 2)  # (B, H, 1, dh)
        w = _softmax_f32(matmul_f32(qh, keys.transpose(-1, -2)), x.dtype)  # (B, H, 1, pos+1)
        x = _self_attn_out(x, blk, _merge_heads(w @ vals), tp)
        x = x + _cross_attention(x, blk, ckv_layer(ck, l), ckv_layer(cv, l), n_head, tp=tp, sp=sp)
        x = x + _mlp(x, blk, tp)
    x = layer_norm(x, dec["ln_g"], dec["ln_b"], 1e-5)
    return hidden_to_logits(dec, x[:, 0]), cache


def decode_step_fixed(dec, tokens, pos, cache, src, ck, cv, *, n_head, window=None, tp=None, sp=None):
    """`decode_step` at fixed shapes, the form the exported step graphs and
    the captured decode loop take (whisper_tpu/models/graphs.py decode_step):
    nothing in it reads the device from the host.

    tokens: (B,) int — the tokens sampled at the previous step
    pos:    0-d or (1,) int tensor — the cache slot to write (< window)
    cache:  (L, 2, B, C, d) self-attention K/V, UPDATED IN PLACE: slot pos
            of every layer is written, then the first W slots are read with
            the keys past pos masked
    src:    (B,) int tensor or None — the beam reorder, a gather over the
            first W slots (None: no reorder, as greedy needs none)
    ck/cv:  (L, Bc, H, dh, 1500) or int8 pairs, B % Bc == 0
    window: W, the cache slots the step reads, masks and reorders (the
            loop's bucketed phases: 128, 256, 448); None reads all C
    tp, sp: process groups, as in `prefill` (the cache holds d / tp)

    Returns (logits (B, n_vocab) f32, cache)."""
    C = cache.shape[3]
    W = C if window is None else window
    view = cache if W == C else cache[:, :, :, :W]
    if src is not None:
        view.copy_(view.index_select(2, src.long()))
    blocks = dec["blocks"]
    B = tokens.shape[0]
    dh = dec["tok_emb"].shape[1] // n_head
    n_head //= group_size(tp)
    slot = pos.long().reshape(1)
    x = tok_embedding(dec, tokens, blocks["attn_q_b"].dtype) + dec["pos_emb"].index_select(0, slot)
    x = x[:, None, :]  # (B, 1, d)
    kmask = torch.zeros(W, device=x.device).masked_fill(
        torch.arange(W, device=x.device) > slot, float("-inf")
    )

    for l in range(blocks["attn_q_w"].shape[0]):
        blk = _layer(dec, l)
        h = copy_to_group(layer_norm(x, blk["attn_ln_g"], blk["attn_ln_b"], 1e-5), tp)
        q = _dot(h, blk, "attn_q_w") + blk["attn_q_b"]
        new = torch.stack([_dot(h, blk, "attn_k_w"), _dot(h, blk, "attn_v_w") + blk["attn_v_b"]])
        cache[l].index_copy_(2, slot, new.to(cache.dtype))  # (2, B, 1, d) into slot pos
        keys = view[l, 0].view(B, W, n_head, dh).transpose(1, 2)  # (B, H, W, dh)
        vals = view[l, 1].view(B, W, n_head, dh).transpose(1, 2)
        qh = (q * (dh**-0.5)).view(B, 1, n_head, dh).transpose(1, 2)  # (B, H, 1, dh)
        w = _softmax_f32(matmul_f32(qh, keys.transpose(-1, -2)) + kmask, x.dtype)
        x = _self_attn_out(x, blk, _merge_heads(w @ vals), tp)
        x = x + _cross_attention(x, blk, ckv_layer(ck, l), ckv_layer(cv, l), n_head, tp=tp, sp=sp)
        x = x + _mlp(x, blk, tp)
    x = layer_norm(x, dec["ln_g"], dec["ln_b"], 1e-5)
    return hidden_to_logits(dec, x[:, 0]), cache


def decode_chunk(dec, tokens_k, pos, cache, ck, cv, *, n_head, active=None, width=None, tp=None, sp=None):
    """K tokens per row at per-row cache slots, in one pass (the
    speculative engine's draft step at K = 1 and its verify pass). With a
    host-int `width` nothing in it reads the device from the host, so the
    captured speculative round runs it at a fixed window: the cache's
    width, its program's last window.

    tokens_k: (B, K) int — row b's tokens at positions pos[b] .. pos[b]+K-1
    pos:      (B,) int tensor — the first slot the chunk writes (the row's
              tokens so far); rows may differ
    cache:    (L, 2, B, C, d) self-attention K/V, valid below pos[b],
              UPDATED IN PLACE: slots [pos[b], pos[b]+K) of the active rows
              (pos[b] + K <= C for them)
    ck/cv:    (L, Bc, H, dh, T) or int8 pairs, B % Bc == 0
    active:   (B,) bool or None — rows with False write nothing; their
              logits are computed and must be ignored
    width:    a host int >= max(pos), at most C: the cache slots attended,
              those at or past pos[b] masked (the eager loop's host-known
              max(pos), or the captured round's window C; None reads
              max(pos) from the device)
    tp, sp:   process groups, as in `prefill` (the cache holds d / tp)

    Query i of row b sees the cached slots below pos[b] and the chunk's keys
    j <= i. Returns (logits (B, K, n_vocab) f32, cache)."""
    blocks = dec["blocks"]
    dtype = blocks["attn_q_b"].dtype
    B, K = tokens_k.shape
    n_head //= group_size(tp)
    C, d = cache.shape[3], cache.shape[4]
    dh = d // n_head
    dev = tokens_k.device
    pos = pos.long()
    W = int(pos.max()) if width is None else int(width)
    slots = (pos[:, None] + torch.arange(K, device=dev)).clamp_(0, C - 1)  # (B, K)
    rows = torch.arange(B, device=dev)[:, None].expand(B, K)
    x = tok_embedding(dec, tokens_k, dtype) + dec["pos_emb"][slots]

    inf = float("-inf")
    kmask = torch.zeros((B, W), device=dev).masked_fill(
        torch.arange(W, device=dev)[None, :] >= pos[:, None], inf
    )[:, None, None, :]  # (B, 1, 1, W)
    causal = torch.zeros((K, K), device=dev).masked_fill(
        torch.ones((K, K), dtype=torch.bool, device=dev).triu(1), inf
    )

    for l in range(blocks["attn_q_w"].shape[0]):
        blk = _layer(dec, l)
        h = copy_to_group(layer_norm(x, blk["attn_ln_g"], blk["attn_ln_b"], 1e-5), tp)
        q = _dot(h, blk, "attn_q_w") + blk["attn_q_b"]  # (B, K, d)
        k = _dot(h, blk, "attn_k_w")
        v = _dot(h, blk, "attn_v_w") + blk["attn_v_b"]
        qh = _heads(q * (dh**-0.5), n_head)  # (B, H, K, dh)
        kc, vc = _heads(cache[l, 0, :, :W], n_head), _heads(cache[l, 1, :, :W], n_head)
        kn, vn = _heads(k, n_head), _heads(v, n_head)
        s_cache = matmul_f32(qh, kc.transpose(-1, -2)) + kmask  # (B, H, K, W)
        s_chunk = matmul_f32(qh, kn.transpose(-1, -2)) + causal  # (B, H, K, K)
        w = _softmax_f32(torch.cat([s_cache, s_chunk], dim=-1), dtype)
        wv = w[..., :W] @ vc + w[..., W:] @ vn
        x = _self_attn_out(x, blk, _merge_heads(wv), tp)
        x = x + _cross_attention(x, blk, ckv_layer(ck, l), ckv_layer(cv, l), n_head, tp=tp, sp=sp)
        x = x + _mlp(x, blk, tp)

        new = torch.stack([k, v]).to(cache.dtype)  # (2, B, K, d)
        if active is not None:
            new = torch.where(active[None, :, None, None], new, cache[l][:, rows, slots])
        cache[l][:, rows, slots] = new
    x = layer_norm(x, dec["ln_g"], dec["ln_b"], 1e-5)
    return hidden_to_logits(dec, x), cache
