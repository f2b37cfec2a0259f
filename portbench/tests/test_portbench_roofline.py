"""roofline.py's operations and bytes against hand counts, and its
operations against torch's counter over the reference at tiny dims."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import roofline
from portbench.reference.whisper_f32 import Reference

CFG = dict(d_model=4, encoder_ffn_dim=16, decoder_ffn_dim=8, encoder_layers=2, decoder_layers=3,
           max_source_positions=5, num_mel_bins=2, vocab_size=7)  # fmt: skip


def test_hand_counts():
    d, T, m, V = 4, 5, 2, 7
    enc = 2 * (2 * T) * (3 * m) * d + 2 * T * (3 * d) * d + 2 * (4 * 2 * T * d * d + 2 * 2 * T * T * d + 2 * 2 * T * d * 16)
    assert roofline.encoder_flops(CFG) == enc == 480 + 480 + 2 * (640 + 400 + 1280)
    assert roofline.cross_kv_flops(CFG) == 3 * 2 * 2 * T * d * d
    # a token at position 2 attends 3 keys
    layer = 6 * 2 * 16 + 2 * 2 * 3 * 4 + 2 * 2 * 5 * 4 + 2 * 2 * 4 * 8
    assert roofline.decoder_token_flops(CFG, 2) == 3 * layer + 2 * 4 * 7
    # bytes: decoder weights bf16 (self qkvo, cross q o, fc1 fc2; biases), the
    # LayerNorms float32, the logits head; one audio, two rows at position 2
    weights = (3 * (6 * 16 + 2 * 4 * 8 + 6 * 4 + 8) + 7 * 4) * 2 + (3 * 6 * 4 + 2 * 4) * 4
    assert roofline.decoder_weight_bytes(CFG) == weights
    assert roofline.step_bytes(CFG, 1, 2, 2) == weights + 3 * 2 * 2 * 3 * 4 * 2 + 3 * 2 * 1 * 5 * 4 * 2 + 2 * 7 * 4
    assert roofline.run_bytes(CFG, 1, 2, 4, 3) == roofline.step_bytes(CFG, 1, 2, 4) + roofline.step_bytes(CFG, 1, 2, 5)
    rows = 2
    steps = roofline.decoder_token_flops(CFG, 4) + roofline.decoder_token_flops(CFG, 5)
    assert roofline.window_flops(CFG, 4, 3, rows) == (
        roofline.encoder_flops(CFG) + roofline.cross_kv_flops(CFG) + roofline.prefill_flops(CFG, 4) + rows * steps
    )


@pytest.mark.parametrize("frames", [1500])
def test_encoder_flops_match_the_reference(frames):
    """torch's FLOP counter over the reference's encoder at tiny widths
    (1500 frames, as every window has) counts what roofline.py counts."""
    from portbench import inputs

    cfg = dict(CFG, d_model=8, encoder_attention_heads=2, decoder_attention_heads=2, num_mel_bins=80,
               max_source_positions=frames, max_target_positions=16, vocab_size=11)  # fmt: skip
    params = inputs.make_params(cfg, 0, "cpu", torch.float32)
    ref = Reference(params, n_audio_head=2, n_text_head=2, n_mels=80)
    mel = torch.randn(1, 80, 2 * frames)
    with FlopCounterMode(display=False) as counter:
        xa = ref.encode(mel)
    assert counter.get_total_flops() == roofline.encoder_flops(cfg)
    with FlopCounterMode(display=False) as counter:
        ref._lin(xa, params["decoder"]["blocks"]["cross_k_w"][0])
        ref._lin(xa, params["decoder"]["blocks"]["cross_v_w"][0])
    assert counter.get_total_flops() * cfg["decoder_layers"] == roofline.cross_kv_flops(cfg)
