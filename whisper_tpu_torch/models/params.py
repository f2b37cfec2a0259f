"""Parameter trees: random init, checkpoint conversion, .npz loading.

The layout is the JAX package's (whisper_tpu/models/params.py): nested
dicts with per-layer weights STACKED along a leading layer axis, linear
weights stored (in_features, out_features) so that a projection is
`x @ w + b`, and convolution weights in torch's (out, in, k) layout. Keeping
that layout lets the tests compare the two packages tensor for tensor.
"""

from typing import Dict, Optional

import numpy as np
import torch

from .dims import ModelDimensions

_LN_KEYS = ("ln_g", "ln_b")


def sinusoid_position_embedding(length: int, channels: int, max_timescale=10000):
    """Fixed sinusoidal embedding used by the audio encoder (float32 numpy)."""
    if channels % 2:
        raise ValueError("channels must be even")
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(
        np.float32
    )


def _build_param_tree(dims: ModelDimensions, w, zeros, ones, pos_emb) -> Dict:
    """The parameter tree from array factories (copied from the JAX
    package): w(*shape) random weight, zeros/ones(*shape), pos_emb()."""
    d = dims.n_audio_state
    dt = dims.n_text_state
    La, Lt = dims.n_audio_layer, dims.n_text_layer

    def attn_block(n_layers, width, cross=False):
        blocks = {
            "attn_ln_g": ones(n_layers, width),
            "attn_ln_b": zeros(n_layers, width),
            "attn_q_w": w(n_layers, width, width),
            "attn_q_b": zeros(n_layers, width),
            "attn_k_w": w(n_layers, width, width),
            "attn_v_w": w(n_layers, width, width),
            "attn_v_b": zeros(n_layers, width),
            "attn_o_w": w(n_layers, width, width),
            "attn_o_b": zeros(n_layers, width),
            "mlp_ln_g": ones(n_layers, width),
            "mlp_ln_b": zeros(n_layers, width),
            "mlp_fc1_w": w(n_layers, width, 4 * width),
            "mlp_fc1_b": zeros(n_layers, 4 * width),
            "mlp_fc2_w": w(n_layers, 4 * width, width),
            "mlp_fc2_b": zeros(n_layers, width),
        }
        if cross:
            blocks.update(
                {
                    "cross_ln_g": ones(n_layers, width),
                    "cross_ln_b": zeros(n_layers, width),
                    "cross_q_w": w(n_layers, width, width),
                    "cross_q_b": zeros(n_layers, width),
                    "cross_k_w": w(n_layers, width, width),
                    "cross_v_w": w(n_layers, width, width),
                    "cross_v_b": zeros(n_layers, width),
                    "cross_o_w": w(n_layers, width, width),
                    "cross_o_b": zeros(n_layers, width),
                }
            )
        return blocks

    return {
        "encoder": {
            "conv1_w": w(d, dims.n_mels, 3),
            "conv1_b": zeros(d),
            "conv2_w": w(d, d, 3),
            "conv2_b": zeros(d),
            "pos_emb": pos_emb(),
            "blocks": attn_block(La, d),
            "ln_post_g": ones(d),
            "ln_post_b": zeros(d),
        },
        "decoder": {
            "tok_emb": w(dims.n_vocab, dt),
            "pos_emb": w(dims.n_text_ctx, dt),
            "blocks": attn_block(Lt, dt, cross=True),
            "ln_g": ones(dt),
            "ln_b": zeros(dt),
        },
    }


def init_random_params(
    dims: ModelDimensions, seed: int = 0, dtype=torch.bfloat16, device="cpu"
) -> Dict:
    """Random parameters N(0, 0.02) drawn from a seeded torch.Generator
    directly on `device` (no host->device weight copy)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def w(*shape):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return x.mul_(0.02).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    def pos_emb():
        emb = sinusoid_position_embedding(dims.n_audio_ctx, dims.n_audio_state)
        return torch.from_numpy(emb).to(device=device, dtype=dtype)

    return _build_param_tree(dims, w, zeros, ones, pos_emb)


def init_random_params_host(dims: ModelDimensions, seed: int = 0) -> Dict:
    """Random float32 CPU parameters drawn with numpy's RandomState(seed),
    N(0, 0.02), in the order of whisper_tpu/models/params.py
    init_random_params (copied), so that one seed gives the same tree in
    both packages."""
    rng = np.random.RandomState(seed)

    def w(*shape):
        return torch.from_numpy(rng.normal(0.0, 0.02, size=shape).astype(np.float32))

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32)

    def pos_emb():
        return torch.from_numpy(sinusoid_position_embedding(dims.n_audio_ctx, dims.n_audio_state))

    return _build_param_tree(dims, w, zeros, ones, pos_emb)


def map_tree(tree: Dict, fn, prefix: str = "") -> Dict:
    """The tree of fn(path, leaf) for each leaf, paths joined with '/'."""
    return {
        k: map_tree(v, fn, f"{prefix}{k}/") if isinstance(v, dict) else fn(f"{prefix}{k}", v)
        for k, v in tree.items()
    }


def cast_params(params: Dict, dtype, device) -> Dict:
    """Matmul weights to `dtype` on `device`; LayerNorm scale/shift stay
    float32 (they are consumed inside the f32 normalization)."""

    def cast(path, leaf):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
        if t.dtype == torch.int8 or path.endswith("@scale"):
            raise ValueError(
                f"{path} is quantized: a model holds plain weights (the engines "
                "quantize their own copy, FusedEngine(model, weights='int8'))"
            )
        keep_f32 = any(path.endswith(k) for k in _LN_KEYS)
        return t.to(device=device, dtype=torch.float32 if keep_f32 else dtype)

    return map_tree(params, cast)


def params_from_jax(tree: Dict) -> Dict:
    """The JAX package's parameter tree (numpy or jax arrays, any float
    dtype) as float32 CPU tensors in the same layout. A quantized tree
    (its quantize_decoder) keeps its int8 leaves int8 and its float32
    '@scale' leaves as they are."""

    def leaf(_, v):
        a = np.asarray(v)
        return torch.from_numpy(a.astype(np.int8 if a.dtype == np.int8 else np.float32))

    return map_tree(tree, leaf)


def params_from_torch_state_dict(state_dict, dims: ModelDimensions) -> Dict:
    """Convert an openai/whisper-format state dict into the stacked tree
    (key mapping of whisper_tpu/models/params.py). float32 CPU tensors."""

    def get(name) -> torch.Tensor:
        return torch.as_tensor(state_dict[name]).detach().to("cpu", torch.float32)

    def maybe(name) -> Optional[torch.Tensor]:
        return get(name) if name in state_dict else None

    def stack(fmt, L, linear=False):
        ts = [get(fmt.format(i)) for i in range(L)]
        return torch.stack([t.T.contiguous() if linear else t for t in ts])

    def blocks(p, L, cross):
        out = {
            "attn_ln_g": stack(p + ".{}.attn_ln.weight", L),
            "attn_ln_b": stack(p + ".{}.attn_ln.bias", L),
        }
        mods = [("attn", "attn")] + ([("cross", "cross_attn")] if cross else [])
        for short, mod in mods:
            out[f"{short}_q_w"] = stack(p + f".{{}}.{mod}.query.weight", L, True)
            out[f"{short}_q_b"] = stack(p + f".{{}}.{mod}.query.bias", L)
            out[f"{short}_k_w"] = stack(p + f".{{}}.{mod}.key.weight", L, True)
            out[f"{short}_v_w"] = stack(p + f".{{}}.{mod}.value.weight", L, True)
            out[f"{short}_v_b"] = stack(p + f".{{}}.{mod}.value.bias", L)
            out[f"{short}_o_w"] = stack(p + f".{{}}.{mod}.out.weight", L, True)
            out[f"{short}_o_b"] = stack(p + f".{{}}.{mod}.out.bias", L)
        if cross:
            out["cross_ln_g"] = stack(p + ".{}.cross_attn_ln.weight", L)
            out["cross_ln_b"] = stack(p + ".{}.cross_attn_ln.bias", L)
        out["mlp_ln_g"] = stack(p + ".{}.mlp_ln.weight", L)
        out["mlp_ln_b"] = stack(p + ".{}.mlp_ln.bias", L)
        out["mlp_fc1_w"] = stack(p + ".{}.mlp.0.weight", L, True)
        out["mlp_fc1_b"] = stack(p + ".{}.mlp.0.bias", L)
        out["mlp_fc2_w"] = stack(p + ".{}.mlp.2.weight", L, True)
        out["mlp_fc2_b"] = stack(p + ".{}.mlp.2.bias", L)
        return out

    enc_pos = maybe("encoder.positional_embedding")
    if enc_pos is None:
        enc_pos = torch.from_numpy(
            sinusoid_position_embedding(dims.n_audio_ctx, dims.n_audio_state)
        )

    return {
        "encoder": {
            "conv1_w": get("encoder.conv1.weight"),
            "conv1_b": get("encoder.conv1.bias"),
            "conv2_w": get("encoder.conv2.weight"),
            "conv2_b": get("encoder.conv2.bias"),
            "pos_emb": enc_pos,
            "blocks": blocks("encoder.blocks", dims.n_audio_layer, cross=False),
            "ln_post_g": get("encoder.ln_post.weight"),
            "ln_post_b": get("encoder.ln_post.bias"),
        },
        "decoder": {
            "tok_emb": get("decoder.token_embedding.weight"),
            "pos_emb": get("decoder.positional_embedding"),
            "blocks": blocks("decoder.blocks", dims.n_text_layer, cross=True),
            "ln_g": get("decoder.ln.weight"),
            "ln_b": get("decoder.ln.bias"),
        },
    }


def flatten_tree(tree: Dict, prefix: str = ""):
    """(path, leaf) pairs of a nested tree, paths joined with '/'."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flatten_tree(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def unflatten_tree(items) -> Dict:
    """The nested tree of (path, leaf) pairs with '/'-joined paths."""
    tree: Dict = {}
    for key, leaf in items:
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def save_params_npz(params: Dict, path: str):
    """Write a bare parameter tree as a flat '<a>/<b>/<leaf>' .npz (the JAX
    package's `save_params_npz` format). Tensor leaves go to the host in
    their dtype, bfloat16 as float32 (numpy has no bfloat16); numpy leaves
    are written as they are."""

    def host(leaf):
        if not isinstance(leaf, torch.Tensor):
            return np.asarray(leaf)
        leaf = leaf.detach().cpu()
        return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()

    np.savez(path, **{key: host(leaf) for key, leaf in flatten_tree(params)})


def load_params_npz(path: str) -> Dict:
    """A flat '<a>/<b>/<leaf>' .npz (the JAX package's format) as a nested
    dict of numpy arrays."""
    with np.load(path) as flat:
        return unflatten_tree((key, flat[key]) for key in flat.files)
