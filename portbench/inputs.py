"""What the benchmark hands to the program and to the reference alike: the
weights, made on the device from the seed; the audio, made from the seed;
and the decoding options that fix the work of a window.

The parameter tree has the layout the program's `Whisper(params=...)` takes
(stacked layers, linear weights (in, out), conv weights (out, in, k)); the
reference reads the same tensors.
"""

import numpy as np
import torch

from .reference.whisper_f32 import sinusoids

SAMPLE_RATE = 16000
N_SAMPLES = 30 * SAMPLE_RATE
LN_GAIN_STD = 0.05
SMALL_STD = 0.02  # biases and LayerNorm shifts
TOK_EMB_STD = 0.05
TEXT_POS_STD = 0.1
# gains over N(0, 1/fan_in), so that the audio steers the decoder as in a
# trained model: the conv stem's output outweighs the sinusoid table, and
# the cross-attention's queries are sharp enough to pick frames
CONV_GAIN = 4.0
CROSS_Q_GAIN = 3.0
SYLLABLE = 4096  # samples of one synthetic syllable, 256 ms
SYLLABLES = 256  # the pool a run's audio is drawn from


def dims_of(cfg: dict):
    """The program's ModelDimensions for a configuration file."""
    from whisper_tpu_torch.models.dims import ModelDimensions

    return ModelDimensions(
        n_mels=cfg["num_mel_bins"],
        n_audio_ctx=cfg["max_source_positions"],
        n_audio_state=cfg["d_model"],
        n_audio_head=cfg["encoder_attention_heads"],
        n_audio_layer=cfg["encoder_layers"],
        n_vocab=cfg["vocab_size"],
        n_text_ctx=cfg["max_target_positions"],
        n_text_state=cfg["d_model"],
        n_text_head=cfg["decoder_attention_heads"],
        n_text_layer=cfg["decoder_layers"],
    )


def _leaves(cfg: dict):
    """(path, shape, kind) of every leaf; kind picks its distribution:
    ("w", fan_in, gain), "small", "gain", "tok", "text_pos", "sinusoid"."""
    d, ffn = cfg["d_model"], cfg["encoder_ffn_dim"]
    dt, ffn_t = cfg["d_model"], cfg["decoder_ffn_dim"]
    La, Lt, m = cfg["encoder_layers"], cfg["decoder_layers"], cfg["num_mel_bins"]

    def block(prefix, L, width, ffn_width, cross):
        names = ["attn"] + (["cross"] if cross else [])
        out = []
        for n in names:
            out += [
                (f"{prefix}/{n}_ln_g", (L, width), "gain"),
                (f"{prefix}/{n}_ln_b", (L, width), "small"),
                (f"{prefix}/{n}_q_w", (L, width, width), ("w", width, CROSS_Q_GAIN if n == "cross" else 1.0)),
                (f"{prefix}/{n}_q_b", (L, width), "small"),
                (f"{prefix}/{n}_k_w", (L, width, width), ("w", width, 1.0)),
                (f"{prefix}/{n}_v_w", (L, width, width), ("w", width, 1.0)),
                (f"{prefix}/{n}_v_b", (L, width), "small"),
                (f"{prefix}/{n}_o_w", (L, width, width), ("w", width, 1.0)),
                (f"{prefix}/{n}_o_b", (L, width), "small"),
            ]
        out += [
            (f"{prefix}/mlp_ln_g", (L, width), "gain"),
            (f"{prefix}/mlp_ln_b", (L, width), "small"),
            (f"{prefix}/mlp_fc1_w", (L, width, ffn_width), ("w", width, 1.0)),
            (f"{prefix}/mlp_fc1_b", (L, ffn_width), "small"),
            (f"{prefix}/mlp_fc2_w", (L, ffn_width, width), ("w", ffn_width, 1.0)),
            (f"{prefix}/mlp_fc2_b", (L, width), "small"),
        ]
        return out

    return [
        ("encoder/conv1_w", (d, m, 3), ("w", 3 * m, CONV_GAIN)),
        ("encoder/conv1_b", (d,), "small"),
        ("encoder/conv2_w", (d, d, 3), ("w", 3 * d, CONV_GAIN)),
        ("encoder/conv2_b", (d,), "small"),
        ("encoder/pos_emb", (cfg["max_source_positions"], d), "sinusoid"),
        *block("encoder/blocks", La, d, ffn, False),
        ("encoder/ln_post_g", (d,), "gain"),
        ("encoder/ln_post_b", (d,), "small"),
        ("decoder/tok_emb", (cfg["vocab_size"], dt), "tok"),
        ("decoder/pos_emb", (cfg["max_target_positions"], dt), "text_pos"),
        *block("decoder/blocks", Lt, dt, ffn_t, True),
        ("decoder/ln_g", (dt,), "gain"),
        ("decoder/ln_b", (dt,), "small"),
    ]


@torch.no_grad()
def make_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The configuration's parameter tree from `seed`: one draw of N(0, 1)
    for every leaf at once on `device` in `dtype` (a torch.Generator there),
    each leaf a view of it scaled in place; the encoder's position table is
    the sinusoid. Distributions: see the configuration file's `assumed`."""
    leaves = _leaves(cfg)
    total = sum(int(np.prod(s)) for _, s, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    tree: dict = {}
    offset = 0
    for path, shape, kind in leaves:
        n = int(np.prod(shape))
        t = flat[offset : offset + n].view(shape)
        offset += n
        if kind == "sinusoid":
            t.copy_(sinusoids(*shape).to(device=device, dtype=dtype))
        elif kind == "gain":
            t.mul_(LN_GAIN_STD).add_(1.0)
        elif kind == "small":
            t.mul_(SMALL_STD)
        elif kind == "tok":
            t.mul_(TOK_EMB_STD)
        elif kind == "text_pos":
            t.mul_(TEXT_POS_STD)
        else:
            t.mul_(kind[2] * kind[1] ** -0.5)
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def syllables(rng: np.random.Generator) -> np.ndarray:
    """(SYLLABLES, SYLLABLE) float32 speech-like sounds, each peak 1: three
    quarters voiced (noise through three formant bumps and a comb at a pitch
    of 90-260 Hz), a quarter fricative (noise above 2-4 kHz), Hann-shaped."""
    f = np.fft.rfftfreq(SYLLABLE, 1.0 / SAMPLE_RATE)
    formants = rng.uniform([300, 900, 2400], [900, 2400, 3600], size=(SYLLABLES, 3))
    pitch = rng.uniform(90, 260, size=(SYLLABLES, 1))
    bumps = np.exp(-0.5 * ((f[None, :, None] - formants[:, None, :]) / 150.0) ** 2).sum(2) + 0.02
    voiced = bumps * (0.5 + 0.5 * np.cos(2 * np.pi * f[None] / pitch)) ** 8
    fricative = (f[None] > rng.uniform(2000, 4000, size=(SYLLABLES, 1))) + 0.02
    env = np.where(rng.random((SYLLABLES, 1)) < 0.25, fricative, voiced)
    noise = np.fft.rfft(rng.standard_normal((SYLLABLES, SYLLABLE)), axis=1)
    seg = np.fft.irfft(noise * env, SYLLABLE, axis=1) * np.hanning(SYLLABLE)
    return (seg / np.abs(seg).max(axis=1, keepdims=True)).astype(np.float32)


def synth_audio(seconds: float, rng: np.random.Generator, pool: np.ndarray) -> np.ndarray:
    """Babble: syllables of `pool` drawn from rng, each at a level of
    0.02-0.25, with pauses of 0-200 ms, over a noise floor; rounded to
    16-bit PCM steps as a decoded file is (float32 i / 32768). Every
    window's content differs, so each decodes its own tokens."""
    n = int(round(seconds * SAMPLE_RATE))
    gaps = rng.integers(0, SAMPLE_RATE // 5, size=n // SYLLABLE + 2)
    starts = np.cumsum(SYLLABLE + gaps) - SYLLABLE - gaps[0]
    starts = starts[starts < n]
    floor = rng.standard_normal(SAMPLE_RATE).astype(np.float32) * 0.002
    out = np.tile(floor, n // SAMPLE_RATE + 2)[: n + SYLLABLE]
    levels = rng.uniform(0.02, 0.25, size=(len(starts), 1)).astype(np.float32)
    # syllables never overlap: each starts after the last one and its pause
    out[starts[:, None] + np.arange(SYLLABLE)] += pool[rng.integers(0, len(pool), size=len(starts))] * levels
    return np.clip(np.rint(out[:n] * 32768.0), -32767, 32767).astype(np.float32) * np.float32(1 / 32768.0)


def suppress_ids(cfg: dict) -> list:
    """What a window may not emit: the non-speech symbols (the ids of
    suppress_tokens=-1) and every id from EOT on (EOT, the specials, the
    languages and the timestamps), so that every window decodes exactly
    sample_len text tokens and advances a whole 30 s."""
    tok = cfg["tokens"]
    return sorted(set(tok["non_speech"]) | set(range(tok["eot"], cfg["vocab_size"])))


def initial_tokens(cfg: dict) -> list:
    """The window's first tokens: sot, English, transcribe, no-timestamps."""
    tok = cfg["tokens"]
    return [tok["sot"], tok["english"], tok["transcribe"], tok["no_timestamps"]]


def decode_kwargs(cfg: dict, mix: dict) -> dict:
    """The keywords of transcribe(), transcribe_batch and the batcher that
    fix the work: English, T = 0 alone, every quality gate off, no
    conditioning, no timestamps, sample_len tokens a window."""
    kw = dict(
        language="en",
        temperature=0.0,
        compression_ratio_threshold=None,
        logprob_threshold=None,
        no_speech_threshold=None,
        condition_on_previous_text=False,
        without_timestamps=True,
        sample_len=mix["sample_len"],
        suppress_tokens=suppress_ids(cfg),
    )
    if mix.get("beam_size"):
        kw["beam_size"] = mix["beam_size"]
    return kw
