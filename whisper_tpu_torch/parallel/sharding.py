"""Megatron-style tensor-parallel rules for the stacked parameter tree
(the counterpart of whisper_tpu/parallel/sharding.py).

  * q/k/v and MLP fc1: the OUTPUT feature axis split over `tp` (heads split
    across ranks: n_head % tp must be 0) - column-parallel;
  * attention out-proj and MLP fc2: the INPUT feature axis split over `tp`,
    each rank's product a partial sum that graphs.py all-reduces before the
    bias - row-parallel;
  * embeddings, layer norms, the conv stem and the biases of row-parallel
    products: replicated.

A rule is a placement tuple, one entry per dim of the leaf, "tp" on the
split dim (JAX's PartitionSpec, whose table below is copied verbatim). The
shards are plain local tensors: `shard_params` gives this rank's tree,
`gather_params` the whole tree back (the checkpoint writer's input).
"""

from typing import Dict

from ..models.params import map_tree
from ..comm import all_gather, local_slice
from .mesh import axis_group, mesh_shape


def P(*axes):
    """A placement: the mesh axis that splits each dim, or None."""
    return tuple(axes)


# copied from whisper_tpu/parallel/sharding.py (framework-free table):
# mapping: param name suffix -> placement for the (L, in, out) stacks
_BLOCK_RULES = {
    "attn_q_w": P(None, None, "tp"),
    "attn_q_b": P(None, "tp"),
    "attn_k_w": P(None, None, "tp"),
    "attn_v_w": P(None, None, "tp"),
    "attn_v_b": P(None, "tp"),
    "attn_o_w": P(None, "tp", None),
    "attn_o_b": P(None, None),
    "cross_q_w": P(None, None, "tp"),
    "cross_q_b": P(None, "tp"),
    "cross_k_w": P(None, None, "tp"),
    "cross_v_w": P(None, None, "tp"),
    "cross_v_b": P(None, "tp"),
    "cross_o_w": P(None, "tp", None),
    "cross_o_b": P(None, None),
    "mlp_fc1_w": P(None, None, "tp"),
    "mlp_fc1_b": P(None, "tp"),
    "mlp_fc2_w": P(None, "tp", None),
    "mlp_fc2_b": P(None, None),
}


def spec_for(path: str, tp: int):
    """The placement of the leaf at `path` ('.../<name>') on a mesh whose
    tp axis has `tp` ranks; P() is replicated."""
    name = path.rsplit("/", 1)[-1]
    if name.endswith("@scale"):
        # int8 weight-only scale (quant.py): (L, N) per output channel -
        # split like the weight's output axis (replicated for the
        # row-parallel o/fc2 weights, whose output axis is not split)
        base = _BLOCK_RULES.get(name[: -len("@scale")])
        if base is not None and tp > 1:
            return P(base[0], base[2])
        return P()
    spec = _BLOCK_RULES.get(name)
    if spec is None or tp == 1:
        return P()  # replicated (embeddings, LNs, convs)
    return spec


def param_shardings(params: Dict, mesh) -> Dict:
    """The placement tree matching the params tree."""
    tp = mesh_shape(mesh).get("tp", 1)
    return map_tree(params, lambda path, _: spec_for(path, tp))


def _split_dim(spec):
    return spec.index("tp") if "tp" in spec else None


def shard_params(params: Dict, mesh) -> Dict:
    """This rank's tree: each split leaf's 1/tp slice along its "tp" dim
    (contiguous), every other leaf the caller's tensor itself."""
    tp = mesh_shape(mesh).get("tp", 1)
    group = axis_group(mesh, "tp")

    def shard(path, leaf):
        dim = _split_dim(spec_for(path, tp))
        return leaf if dim is None else local_slice(leaf, group, dim)

    return map_tree(params, shard)


def gather_params(params: Dict, mesh) -> Dict:
    """The inverse of shard_params: every split leaf all-gathered over tp.
    A collective: every rank of the mesh calls it."""
    tp = mesh_shape(mesh).get("tp", 1)
    group = axis_group(mesh, "tp")

    def gather(path, leaf):
        dim = _split_dim(spec_for(path, tp))
        leaf = leaf.detach()
        return leaf if dim is None else all_gather(leaf, group, dim)

    return map_tree(params, gather)
