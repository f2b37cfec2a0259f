"""The yardstick's arithmetic: the operations and bytes that Whisper's math
needs, counted from a configuration's dims and a window's shapes, never from
the program's tensors or graphs. A multiply-add counts two operations.

Per 30 s window: the encoder (both convolutions, every layer over 1500
frames), the cross-K/V of every decoder layer, the prefill over the initial
tokens (its logits at the last position only), and the decoder per row and
token, attention over the positions decoded so far. Per decode step, the
bytes its math must move: the decoder's weights once (bf16; not the
cross-attention's K and V projections, whose products the cross-K/V holds),
each row's self-K/V up to its position, each audio's cross-K/V, and the
float32 logits written once.

Peaks: one H100 SXM, NVIDIA's data sheet, dense bf16 and HBM3 at 700 W.
"""

BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2
F32 = 4


def _shape(cfg: dict):
    return (
        cfg["d_model"], cfg["encoder_ffn_dim"], cfg["decoder_ffn_dim"], cfg["encoder_layers"],
        cfg["decoder_layers"], cfg["max_source_positions"], cfg["num_mel_bins"], cfg["vocab_size"],
    )  # fmt: skip


def encoder_flops(cfg: dict) -> float:
    """One window through the convolutions and every encoder layer."""
    d, ffn, _, La, _, T, m, _ = _shape(cfg)
    conv = 2 * (2 * T) * (3 * m) * d + 2 * T * (3 * d) * d
    layer = 4 * 2 * T * d * d + 2 * 2 * T * T * d + 2 * 2 * T * d * ffn
    return conv + La * layer


def cross_kv_flops(cfg: dict) -> float:
    d, _, _, _, Lt, T, _, _ = _shape(cfg)
    return Lt * 2 * 2 * T * d * d


def decoder_token_flops(cfg: dict, position: int) -> float:
    """One row's decoder pass for one token at `position` (0-based), its
    self-attention over position + 1 keys, and its logits."""
    d, _, ffn, _, Lt, T, _, V = _shape(cfg)
    keys = position + 1
    layer = 6 * 2 * d * d + 2 * 2 * keys * d + 2 * 2 * T * d + 2 * 2 * d * ffn
    return Lt * layer + 2 * d * V


def prefill_flops(cfg: dict, n_initial: int) -> float:
    """The first pass over the initial tokens, logits at the last only."""
    d, _, ffn, _, Lt, T, _, V = _shape(cfg)
    P = n_initial
    layer = 6 * 2 * P * d * d + 2 * 2 * P * (P + 1) // 2 * d + 2 * 2 * P * T * d + 2 * 2 * P * d * ffn
    return Lt * layer + 2 * d * V


def window_flops(cfg: dict, n_initial: int, sample_len: int, rows: int) -> float:
    """A whole window: encoder, cross-K/V, prefill, then `rows` rows (the
    beam or 1) each decoding tokens 1 .. sample_len - 1 (token 0 comes from
    the prefill's logits)."""
    steps = sum(decoder_token_flops(cfg, n_initial + i - 1) for i in range(1, sample_len))
    return encoder_flops(cfg) + cross_kv_flops(cfg) + prefill_flops(cfg, n_initial) + rows * steps


def decoder_weight_bytes(cfg: dict) -> float:
    """The decoder weights a step reads, bf16 (LayerNorms float32)."""
    d, _, ffn, _, Lt, _, _, V = _shape(cfg)
    per_layer = 6 * d * d + 2 * d * ffn  # self q k v o, cross q o, fc1 fc2
    vectors = 6 * d + ffn  # the biases read by a step
    norms = Lt * 3 * 2 * d + 2 * d  # three LayerNorms a layer and the final one
    return (Lt * (per_layer + vectors) + V * d) * BF16 + norms * F32


def step_bytes(cfg: dict, audios: int, group: int, position: int) -> float:
    """One decode step over audios * group rows at `position`."""
    d, _, _, _, Lt, T, _, V = _shape(cfg)
    rows = audios * group
    self_kv = Lt * 2 * rows * (position + 1) * d * BF16
    cross_kv = Lt * 2 * audios * T * d * BF16
    logits = rows * V * F32
    return decoder_weight_bytes(cfg) + self_kv + cross_kv + logits


def run_bytes(cfg: dict, audios: int, group: int, n_initial: int, sample_len: int) -> float:
    """Every decode step of one engine run (tokens 1 .. sample_len - 1)."""
    return sum(step_bytes(cfg, audios, group, n_initial + i - 1) for i in range(1, sample_len))
