"""The plain reference: Whisper's published forward pass in float32 PyTorch,
with no kernel, cache or batching of the program's.

It follows openai/whisper's model.py and audio.py: the log-mel of the
waveform padded by 30 s (torch.stft, periodic Hann, the final frame
dropped, log10 floored at 1e-10, clamped at the global max minus 8, then
(x + 4) / 4); the encoder (two GELU convolutions, the second of stride 2,
the sinusoid table, pre-LayerNorm blocks, ln_post); the decoder run
teacher-forced over whole token sequences (causal self-attention,
cross-attention over the encoder's output, the logits against the tied
token embedding), recomputed over the whole sequence at every step where
the comparison's control decodes with it. LayerNorm epsilon is 1e-5
throughout, as published.

It reads the parameter tree the benchmark made (stacked layers, linear
weights (in, out), conv weights (out, in, k)), widening each layer's
weights to float32 as it goes, so that a full-width model fits beside its
float32 activations. Matrix products run with TF32 off.

`precision="fp8"` is the control of the benchmark's comparison: every
matrix product's operands rounded to float8 e4m3 (weights per output
channel, activations per row, each scaled to the format's range), summed in
float32. It stands for a program that serves in the next precision below
bfloat16.

Nothing here imports the program or JAX.
"""

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from .mel_filters import mel_filters

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_SAMPLES = 30 * SAMPLE_RATE
N_FRAMES = N_SAMPLES // HOP
EPS = 1e-5
FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """Full float32 products inside the block; the previous flags after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim`
    (the scale maps the slice's largest magnitude to the format's), back
    in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """openai/whisper's encoder position table, (length, channels) float32."""
    log_timescale_increment = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale_increment * torch.arange(channels // 2, dtype=torch.float64))
    scaled = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1).float()


class Reference:
    """The float32 forward pass over a parameter tree on one device."""

    def __init__(self, params: dict, *, n_audio_head: int, n_text_head: int, n_mels: int, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.p = params
        self.n_audio_head = n_audio_head
        self.n_text_head = n_text_head
        self.n_mels = n_mels
        self.fp8 = precision == "fp8"
        self.device = params["decoder"]["tok_emb"].device
        self.filters = torch.from_numpy(mel_filters(n_mels)).to(self.device)

    # ---- products ----------------------------------------------------------

    def _mm(self, x, w):
        """x (..., k) @ w (k, n) in float32; in fp8 mode both operands
        rounded first (w per output column, x per row)."""
        x, w = x.float(), w.float()
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w

    def _lin(self, x, w, b=None):
        y = self._mm(x, w)
        return y if b is None else y + b.float()

    def _ln(self, x, g, b):
        return F.layer_norm(x, (x.shape[-1],), g.float(), b.float(), EPS)

    def _attention(self, q, k, v, n_head, mask=None):
        """q (B, Tq, d), k/v (B, Tk, d) -> (B, Tq, d), openai's scaling."""
        B, Tq, d = q.shape
        dh = d // n_head
        scale = dh**-0.25
        qh = q.view(B, Tq, n_head, dh).permute(0, 2, 1, 3) * scale
        kh = k.view(B, -1, n_head, dh).permute(0, 2, 3, 1) * scale
        vh = v.view(B, -1, n_head, dh).permute(0, 2, 1, 3)
        if self.fp8:
            qh, kh, vh = _fp8(qh, -1), _fp8(kh, -2), _fp8(vh, -2)
        s = qh @ kh
        if mask is not None:
            s = s + mask
        w = torch.softmax(s, dim=-1)
        if self.fp8:
            w = _fp8(w, -1)
        return (w @ vh).permute(0, 2, 1, 3).reshape(B, Tq, d)

    # ---- the log-mel -------------------------------------------------------

    def log_mel(self, audio: np.ndarray) -> torch.Tensor:
        """A 16 kHz waveform -> (n_mels, n // 160 + 3000) float32: the whole
        file's mel with 30 s of zeros after it, as transcribe() makes it."""
        with no_tf32():
            x = torch.from_numpy(np.asarray(audio, np.float32)).to(self.device)
            x = F.pad(x, (0, N_SAMPLES))
            window = torch.hann_window(N_FFT, device=self.device)
            stft = torch.stft(x, N_FFT, HOP, window=window, return_complex=True)
            magnitudes = stft[..., :-1].abs() ** 2
            mel = self.filters @ magnitudes
            log_spec = torch.clamp(mel, min=1e-10).log10()
            log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
            return (log_spec + 4.0) / 4.0

    @staticmethod
    def window(mel: torch.Tensor, seek: int, size: int) -> torch.Tensor:
        """The (n_mels, 3000) window at frame `seek`: its first `size`
        frames, zeros after them."""
        out = torch.zeros((mel.shape[0], N_FRAMES), dtype=mel.dtype, device=mel.device)
        out[:, :size] = mel[:, seek : seek + size]
        return out

    # ---- the encoder -------------------------------------------------------

    @torch.no_grad()
    def encode(self, mels: torch.Tensor, block: int = 4) -> torch.Tensor:
        """(N, n_mels, 3000) -> (N, 1500, d) float32, `block` windows at a
        time."""
        outs = []
        with no_tf32():
            for i in range(0, mels.shape[0], block):
                outs.append(self._encode(mels[i : i + block].float()))
        return torch.cat(outs)

    def _encode(self, mel):
        enc = self.p["encoder"]
        w1, w2 = enc["conv1_w"].float(), enc["conv2_w"].float()
        if self.fp8:
            mel, w1 = _fp8(mel, 1), _fp8(w1, 1)
        x = F.gelu(F.conv1d(mel, w1, enc["conv1_b"].float(), padding=1))
        if self.fp8:
            x, w2 = _fp8(x, 1), _fp8(w2, 1)
        x = F.gelu(F.conv1d(x, w2, enc["conv2_b"].float(), stride=2, padding=1))
        x = x.permute(0, 2, 1) + enc["pos_emb"].float()
        blocks = enc["blocks"]
        for l in range(blocks["attn_q_w"].shape[0]):
            b = {k: v[l] for k, v in blocks.items()}
            h = self._ln(x, b["attn_ln_g"], b["attn_ln_b"])
            q = self._lin(h, b["attn_q_w"], b["attn_q_b"])
            k = self._lin(h, b["attn_k_w"])
            v = self._lin(h, b["attn_v_w"], b["attn_v_b"])
            x = x + self._lin(self._attention(q, k, v, self.n_audio_head), b["attn_o_w"], b["attn_o_b"])
            h = self._ln(x, b["mlp_ln_g"], b["mlp_ln_b"])
            h = F.gelu(self._lin(h, b["mlp_fc1_w"], b["mlp_fc1_b"]))
            x = x + self._lin(h, b["mlp_fc2_w"], b["mlp_fc2_b"])
        return self._ln(x, enc["ln_post_g"], enc["ln_post_b"])

    # ---- the decoder -------------------------------------------------------

    @torch.no_grad()
    def cross_kv(self, xa: torch.Tensor) -> list:
        """Each decoder layer's cross-attention keys and values over xa
        (A, 1500, d) float32."""
        blocks = self.p["decoder"]["blocks"]
        with no_tf32():
            return [
                (self._lin(xa, blocks["cross_k_w"][l]), self._lin(xa, blocks["cross_v_w"][l], blocks["cross_v_b"][l]))
                for l in range(blocks["cross_k_w"].shape[0])
            ]

    @torch.no_grad()
    def logits(self, xa, tokens: torch.Tensor, *, last: bool = False) -> torch.Tensor:
        """Teacher-forced logits: xa (A, 1500, d) float32 or its `cross_kv`,
        tokens (A * G, T), each audio's G rows together -> (A * G, T, V)
        float32, row t the distribution of token t + 1; with `last` only
        the last position's, (A * G, V)."""
        dec = self.p["decoder"]
        cross = self.cross_kv(xa) if torch.is_tensor(xa) else xa
        with no_tf32():
            tokens = tokens.to(self.device).long()
            N, T = tokens.shape
            A = cross[0][0].shape[0]
            x = dec["tok_emb"][tokens].float() + dec["pos_emb"][:T].float()
            mask = torch.full((T, T), float("-inf"), device=self.device).triu(1)
            blocks = dec["blocks"]
            for l, (ck, cv) in enumerate(cross):
                b = {k: v[l] for k, v in blocks.items()}
                h = self._ln(x, b["attn_ln_g"], b["attn_ln_b"])
                q = self._lin(h, b["attn_q_w"], b["attn_q_b"])
                k = self._lin(h, b["attn_k_w"])
                v = self._lin(h, b["attn_v_w"], b["attn_v_b"])
                x = x + self._lin(self._attention(q, k, v, self.n_text_head, mask), b["attn_o_w"], b["attn_o_b"])
                h = self._ln(x, b["cross_ln_g"], b["cross_ln_b"])
                # an audio's rows attend its frames together: (A, G * T, d) queries
                q = self._lin(h, b["cross_q_w"], b["cross_q_b"]).reshape(A, -1, x.shape[-1])
                a = self._attention(q, ck, cv, self.n_text_head).reshape(N, T, -1)
                x = x + self._lin(a, b["cross_o_w"], b["cross_o_b"])
                h = self._ln(x, b["mlp_ln_g"], b["mlp_ln_b"])
                h = F.gelu(self._lin(h, b["mlp_fc1_w"], b["mlp_fc1_b"]))
                x = x + self._lin(h, b["mlp_fc2_w"], b["mlp_fc2_b"])
            if last:
                x = x[:, -1]
            x = self._ln(x, dec["ln_g"], dec["ln_b"])
            return self._mm(x, dec["tok_emb"].T)
