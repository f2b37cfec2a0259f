"""Graph export for the native runner (the counterpart of whisper_tpu/export.py).

Each graph is traced by torch.export on the model's device and saved as
`<name>.export.pt2`, beside `<name>.spec.json` and `<name>.spec.txt`, the I/O
manifest the C++ runner (csrc/wtt_transcribe.cpp) parses. AOTInductor
compiles an exported graph into `<name>.aoti.pt2` for the card
(runtime/aoti.py), which the runner loads with libtorch's package loader.

    export_graph(dir, fn, example_args)   # one graph
    export_model_graphs(dir, model)       # encoder / cross_kv, weights baked in
    export_pipeline(dir, model)           # everything wtt_transcribe needs

In the pipeline the weights are graph inputs, not constants: the first
`n_params` inputs of a graph are the leaves of its tree in sorted-key order
(jax.tree.leaves' order), read from one blob per tree that every graph of
the tree shares, so the card holds one copy of the decoder.
"""

import json
import os
import shutil
import time

import numpy as np
import torch
from torch.export.graph_signature import InputKind, OutputKind
from torch.utils import _pytree

from . import quant
from .models import graphs
from .ops.beam_kernel import apply_filters, build_penalty_vectors
from .tokenizer import ASSETS, get_tokenizer

# c10::ScalarType codes (c10/core/ScalarType.h), the runner's dtype table
SCALAR_TYPES = {
    torch.uint8: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3, torch.int64: 4,
    torch.float16: 5, torch.float32: 6, torch.float64: 7, torch.bool: 11, torch.bfloat16: 15,
}  # fmt: skip
MAX_INITIAL_TS_INDEX = 50  # pipeline.txt's max_initial_ts_index, as the JAX export writes it


def dtype_name(dtype) -> str:
    """numpy's name of a torch dtype ("float32", "bfloat16", ...)."""
    return str(dtype).removeprefix("torch.")


def sorted_tree(tree):
    """A copy of a nested dict with every level's keys sorted: torch.export
    flattens dicts in insertion order, so this puts a graph's weight inputs
    in jax.tree.leaves' order, the order of the params blob."""
    return {k: sorted_tree(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def param_leaves(tree):
    """The leaves of a parameter tree in the order the graphs take them."""
    return _pytree.tree_leaves(sorted_tree(tree))


class _Graph(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _tensor_spec(val):
    return {
        "shape": list(val.shape),
        "dtype": dtype_name(val.dtype),
        "scalar_type": SCALAR_TYPES[val.dtype],
    }


def export_graph(out_dir: str, fn, example_args, name: str = "graph", n_params: int = 0):
    """Trace `fn(*example_args)` with torch.export (under no_grad, on the
    device the arguments are on) and write `<name>.export.pt2`,
    `<name>.spec.json` and `<name>.spec.txt`. An argument may be a nested
    dict of tensors; the spec lists the flat inputs in the order the
    exported program takes them, unused ones included. Returns the spec."""
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    with torch.no_grad():
        ep = torch.export.export(_Graph(fn), tuple(example_args))
    torch.export.save(ep, os.path.join(out_dir, f"{name}.export.pt2"))
    nodes = {n.name: n for n in ep.graph.nodes}
    user_in = [s.arg.name for s in ep.graph_signature.input_specs if s.kind == InputKind.USER_INPUT]
    user_out = [
        s.arg.name for s in ep.graph_signature.output_specs if s.kind == OutputKind.USER_OUTPUT
    ]
    outputs = []
    for n in user_out:
        val = nodes[n].meta["val"]
        outputs.append({**_tensor_spec(val), "nbytes": val.numel() * val.element_size()})
    spec = {
        "name": name,
        "n_params": n_params,
        "inputs": [_tensor_spec(nodes[n].meta["val"]) for n in user_in],
        "outputs": outputs,
    }
    with open(os.path.join(out_dir, f"{name}.spec.json"), "w") as f:
        json.dump(spec, f, indent=1)
    with open(os.path.join(out_dir, f"{name}.spec.txt"), "w") as f:
        f.write(_spec_txt(spec))
    spec["export_s"] = time.perf_counter() - t0
    return spec


def _spec_txt(spec) -> str:
    """Flat text spec for the native runner (csrc/wtt_transcribe.cpp parses
    this instead of JSON), whisper_tpu/export.py's record layout with the
    c10::ScalarType code where JAX writes the PJRT type. One record a line:
        input  <scalar_type> <dtype> <ndim> <dims...>
        output <scalar_type> <dtype> <nbytes> <ndim> <dims...>
    The first `n_params` inputs are fed from the graph's params blob."""
    lines = [f"graph {spec['name']}", f"n_params {spec.get('n_params', 0)}"]
    lines.append(f"n_inputs {len(spec['inputs'])}")
    for i in spec["inputs"]:
        dims = " ".join(str(d) for d in i["shape"])
        lines.append(f"input {i['scalar_type']} {i['dtype']} {len(i['shape'])} {dims}".rstrip())
    lines.append(f"n_outputs {len(spec['outputs'])}")
    for o in spec["outputs"]:
        dims = " ".join(str(d) for d in o["shape"])
        lines.append(
            f"output {o['scalar_type']} {o['dtype']} {o['nbytes']} {len(o['shape'])} {dims}".rstrip()
        )
    return "\n".join(lines) + "\n"


def _write_params_blob(out_dir: str, name: str, params) -> int:
    """Concatenate the tree's leaves (`param_leaves` order, the order the
    graphs take them) into <name>.params.bin. Returns the leaf count."""
    leaves = param_leaves(params)
    with open(os.path.join(out_dir, f"{name}.params.bin"), "wb") as f:
        for leaf in leaves:
            f.write(leaf.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return len(leaves)


def export_model_graphs(out_dir: str, model):
    """Export the encoder and cross-K/V graphs of a model with its weights
    baked in as constants (whisper_tpu/export.py export_model_graphs)."""
    dims = model.dims
    enc, dec = model.params["encoder"], model.params["decoder"]
    mel = torch.zeros((1, dims.n_mels, 3000), dtype=torch.float32, device=model.device)
    export_graph(out_dir, lambda m: graphs.encode(enc, m, n_head=dims.n_audio_head), (mel,), "encoder")
    xa = torch.zeros((1, dims.n_audio_ctx, dims.n_audio_state), dtype=model.compute_dtype,
                     device=model.device)  # fmt: skip
    export_graph(out_dir, lambda x: graphs.cross_kv(dec, x, n_head=dims.n_text_head), (xa,), "cross_kv")
    return out_dir


# ---- the pipeline's graphs: weights first, then the runtime inputs ----------


def _quantized(ckv, int8):
    return quant.quantize_cross_kv(*ckv) if int8 else ckv


def _prefill(n_head, sot_index, no_speech, int8):
    """tokens (1, P) -> (logits at P - 1 (1, V) f32, no-speech probability
    (1,) f32, kv (L, 2, 1, P, d)), as FusedEngine.run's prefill."""

    def fn(dec, tokens, ck, cv):
        ck, cv = _quantized((ck, cv), int8)
        P = tokens.shape[1]
        hidden, kv = graphs.prefill(dec, tokens, P, ck, cv, n_head=n_head)
        logits = graphs.hidden_to_logits(dec, hidden[:, P - 1])
        sot_logits = graphs.hidden_to_logits(dec, hidden[:, sot_index])
        return logits, torch.softmax(sot_logits, dim=-1)[:, no_speech].float(), kv

    return fn


def _step(n_head, int8, beam):
    """One fixed-shape step (graphs.decode_step_fixed): the cache is
    written in place, the logits (B, V) f32 returned. The beam graph takes
    the reorder `src` after the cache; the greedy graph has none."""

    def greedy(dec, tokens, pos, cache, ck, cv):
        ck, cv = _quantized((ck, cv), int8)
        return graphs.decode_step_fixed(dec, tokens, pos, cache, None, ck, cv, n_head=n_head)[0]

    def beam_step(dec, tokens, pos, cache, src, ck, cv):
        ck, cv = _quantized((ck, cv), int8)
        return graphs.decode_step_fixed(dec, tokens, pos, cache, src, ck, cv, n_head=n_head)[0]

    return beam_step if beam else greedy


def _filters(sample_begin, eot, timestamp_begin):
    """The sampling path's filters (ops.beam_kernel.apply_filters) on one
    row: logits (1, V) f32, tokens (1, 448) i32, n_tokens (1,) i32 and the
    penalty vectors -> filtered logits (1, V) f32."""

    def fn(logits, tokens, n_tokens, suppress_pen, begin_pen):
        return apply_filters(
            logits, tokens, n_tokens, sample_begin, suppress_pen, begin_pen,
            use_timestamps=True, eot=eot, timestamp_begin=timestamp_begin,
        )  # fmt: skip

    return fn


def _tokenizer(model, language, task):
    multilingual = model.is_multilingual
    return get_tokenizer(
        multilingual,
        num_languages=model.num_languages,
        language=language if multilingual else None,
        task=task if multilingual else None,
    )


def _suppress_and_blank(tok):
    """The default suppression sets (DecodingTask._get_suppress_tokens with
    suppress_tokens="-1": non-speech tokens and specials; SuppressBlank)."""
    suppress = sorted(
        set(
            list(tok.non_speech_tokens)
            + [tok.transcribe, tok.translate, tok.sot, tok.sot_prev, tok.sot_lm]
            + ([tok.no_speech] if tok.no_speech is not None else [])
        )
    )
    return suppress, tok.encode(" ") + [tok.eot]


def pipeline_graphs(model, *, language="en", task="transcribe", beam_size=5, weights="bf16"):
    """The pipeline's graphs, {name: (fn, example_args, n_params)}, in the
    order they are exported: fn(*example_args) is the graph run eagerly, the
    first argument the weights tree (sorted keys) where n_params > 0, the
    example tensors on the model's device. weights="int8": prefill and the
    steps take quant.quantize_decoder's tree and quantize the cross-K/V
    inside the graph; the encoder and cross-K/V keep the model's dtype."""
    int8 = quant.check_weights_mode(weights) == "int8"
    dims = model.dims
    dev, dtype = model.device, model.compute_dtype
    tok = _tokenizer(model, language, task)
    initial = list(tok.sot_sequence)
    P = len(initial)
    no_speech = tok.no_speech if tok.no_speech is not None else 0
    enc, dec = sorted_tree(model.params["encoder"]), sorted_tree(model.params["decoder"])
    step_dec = sorted_tree(quant.quantize_decoder(dec)) if int8 else dec
    suppress, blank = _suppress_and_blank(tok)
    sup_pen, begin_pen = build_penalty_vectors(
        dims.n_vocab, suppress, blank, use_timestamps=True, no_timestamps=tok.no_timestamps,
        timestamp_begin=tok.timestamp_begin, max_initial_ts_index=MAX_INITIAL_TS_INDEX,
    )  # fmt: skip

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    i32 = torch.int32
    L, d, n_head, G = dims.n_text_layer, dims.n_text_state, dims.n_text_head, beam_size
    slots = graphs.CACHE_SLOTS
    mel = zeros((1, dims.n_mels, 3000), torch.float32)
    xa = zeros((1, dims.n_audio_ctx, dims.n_audio_state))
    ck = zeros((L, 1, n_head, d // n_head, dims.n_audio_ctx))
    cv = zeros((L, 1, n_head, d // n_head, dims.n_audio_ctx))
    pos = torch.tensor(P, dtype=i32, device=dev)
    pens = (torch.from_numpy(sup_pen).to(dev), torch.from_numpy(begin_pen).to(dev))
    tokens = torch.tensor([initial], dtype=i32, device=dev)
    n_dec, n_step = len(param_leaves(dec)), len(param_leaves(step_dec))
    return {
        "encoder": (lambda w, m: graphs.encode(w, m, n_head=dims.n_audio_head), (enc, mel),
                    len(param_leaves(enc))),
        "cross_kv": (lambda w, x: graphs.cross_kv(w, x, n_head=n_head), (dec, xa), n_dec),
        "prefill": (_prefill(n_head, 0, no_speech, int8), (step_dec, tokens, ck, cv), n_step),
        "step_greedy": (_step(n_head, int8, beam=False),
                        (step_dec, zeros((1,), i32), pos, zeros((L, 2, 1, slots, d)), ck, cv), n_step),
        "step_beam": (_step(n_head, int8, beam=True),
                      (step_dec, zeros((G,), i32), pos, zeros((L, 2, G, slots, d)),
                       torch.arange(G, dtype=i32, device=dev), ck, cv), n_step),
        "filters": (_filters(P, tok.eot, tok.timestamp_begin),
                    (zeros((1, dims.n_vocab), torch.float32), zeros((1, slots), i32),
                     torch.full((1,), P, dtype=i32, device=dev), *pens), 0),
    }  # fmt: skip


def export_pipeline(
    out_dir: str,
    model,
    *,
    language: str = "en",
    task: str = "transcribe",
    sample_len: int = 446,
    beam_size: int = 5,
    weights: str = "bf16",
    compile=None,
    cache_dir=None,
):
    """Export everything the native runner (csrc/wtt_transcribe.cpp) needs
    to transcribe without Python (whisper_tpu/export.py export_pipeline):

      encoder, cross_kv, prefill, step_greedy, step_beam, filters
          .export.pt2 / .spec.json / .spec.txt    (weights as inputs)
          .aoti.pt2                               (compile=True)
      encoder.params.bin / decoder.params.bin     (weight blobs)
      decoder_int8.params.bin                     (weights="int8")
      suppress_mask.bin / blank_mask.bin          (the JAX export's masks)
      suppress_pen.bin / begin_pen.bin            (the update kernels' penalties)
      <vocab>.tiktoken                            (for native detokenization)
      pipeline.txt                                (the JAX export's manifest)
      timings.json                                (each graph's export and compile s)

    The graphs are `pipeline_graphs`'. `compile` (default: the model is on
    CUDA) AOT-compiles every graph for the model's device in parallel worker
    processes, with Inductor's caches in `cache_dir`
    (runtime_config.configure_compile_cache). Returns out_dir."""
    if compile is None:
        compile = model.device.type == "cuda"
    os.makedirs(out_dir, exist_ok=True)
    dims = model.dims
    tok = _tokenizer(model, language, task)
    initial = list(tok.sot_sequence)
    specs = pipeline_graphs(model, language=language, task=task, beam_size=beam_size, weights=weights)
    _write_params_blob(out_dir, "encoder", specs["encoder"][1][0])
    n_dec = _write_params_blob(out_dir, "decoder", specs["cross_kv"][1][0])
    if specs["prefill"][2] != n_dec:  # int8: the steps' quantized tree
        _write_params_blob(out_dir, "decoder_int8", specs["prefill"][1][0])

    # ---- manifest: masks, penalty vectors, vocabulary, pipeline.txt ----
    suppress, blank = _suppress_and_blank(tok)
    smask = np.zeros(dims.n_vocab, np.bool_)
    smask[suppress] = True
    bmask = np.zeros(dims.n_vocab, np.bool_)
    bmask[blank] = True
    smask.tofile(os.path.join(out_dir, "suppress_mask.bin"))
    bmask.tofile(os.path.join(out_dir, "blank_mask.bin"))
    sup_pen, begin_pen = specs["filters"][1][3:]
    sup_pen.cpu().numpy().tofile(os.path.join(out_dir, "suppress_pen.bin"))
    begin_pen.cpu().numpy().tofile(os.path.join(out_dir, "begin_pen.bin"))
    vocab = "multilingual" if model.is_multilingual else "gpt2"
    shutil.copy(os.path.join(ASSETS, f"{vocab}.tiktoken"), os.path.join(out_dir, f"{vocab}.tiktoken"))
    manifest = [
        f"n_mels {dims.n_mels}",
        "sample_rate 16000",
        f"n_vocab {dims.n_vocab}",
        f"n_text_tokens {tok.eot}",  # ids < eot are plain text tokens
        f"eot {tok.eot}",
        f"timestamp_begin {tok.timestamp_begin}",
        "sot_index 0",
        f"sample_begin {len(initial)}",
        f"sample_len {sample_len}",
        f"max_initial_ts_index {MAX_INITIAL_TS_INDEX}",
        f"beam_size {beam_size}",
        f"tiktoken {vocab}.tiktoken",
        "initial_tokens " + " ".join(str(t) for t in initial),
    ]
    with open(os.path.join(out_dir, "pipeline.txt"), "w") as f:
        f.write("\n".join(manifest) + "\n")

    # ---- the graphs, traced on the model's device ----
    timings = {}
    for name, (fn, args, n_params) in specs.items():
        spec = export_graph(out_dir, fn, args, name=name, n_params=n_params)
        timings[name] = {"export_s": spec["export_s"]}
    if compile:
        from .runtime.aoti import compile_graphs

        paths = [os.path.join(out_dir, f"{name}.export.pt2") for name in specs]
        for name, (seconds, cached) in zip(timings, compile_graphs(paths, cache_dir)):
            timings[name].update(compile_s=seconds, cached=cached)
    with open(os.path.join(out_dir, "timings.json"), "w") as f:
        json.dump(timings, f, indent=1)
    return out_dir
