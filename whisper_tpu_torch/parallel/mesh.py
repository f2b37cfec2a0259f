"""The device mesh (the counterpart of whisper_tpu/parallel/mesh.py).

The JAX package drives every device from one process and lets GSPMD insert
the collectives. The port runs SPMD over torch.distributed: one process
per device, each running the same program on the same inputs, with a
`DeviceMesh` of process groups, one group per axis:

  * `dp` - data parallel over audio streams / batched windows;
  * `pp` - pipeline stages of the encoder (pipeline.py);
  * `sp` - the 1500-frame audio context (sequence.py, and the cross-K/V
    frame axis of the decode, serve.py);
  * `tp` - megatron tensor parallel over attention heads / MLP hidden.

Axis order: `dp` outermost, then `pp`, `sp`, and `tp` innermost, so a tp
group is made of neighbouring ranks. The mesh is 2-axis (dp, tp) when pp ==
sp == 1.

The mesh runs on CUDA with NCCL unless the caller asks for another device
type (the CPU tests pass device_type="cpu", which takes gloo). A missing
card or a failed NCCL initialisation raises; nothing falls back to gloo or
to the CPU.
"""

import os
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def init_from_env(device_type: str = "cuda", backend: Optional[str] = None):
    """Initialise the default process group from torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) when it is not yet
    initialised; on CUDA, first select the card LOCAL_RANK names."""
    if dist.is_initialized():
        return
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available on this machine; pass device_type='cpu'")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend or ("nccl" if device_type == "cuda" else "gloo"))


def make_mesh(
    dp: Optional[int] = None,
    tp: int = 1,
    pp: int = 1,
    sp: int = 1,
    device_type: str = "cuda",
    backend: Optional[str] = None,
) -> DeviceMesh:
    """A DeviceMesh over the world with the axes that are > 1: always (dp,
    tp), plus `pp` and/or `sp` when requested. `dp=None` takes world //
    (tp * pp * sp). Initialises the default group from the environment
    first if needed (init_from_env)."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this machine; pass device_type='cpu'")
    init_from_env(device_type, backend)
    n = dist.get_world_size()
    if dp is None:
        if n % (tp * pp * sp) != 0:
            raise ValueError(f"{n} devices not divisible by tp*pp*sp={tp * pp * sp}")
        dp = n // (tp * pp * sp)
    if dp * tp * pp * sp != n:
        raise ValueError(f"mesh dp{dp}*pp{pp}*sp{sp}*tp{tp} != {n} devices")
    shape = [("dp", dp)]
    if pp > 1:
        shape.append(("pp", pp))
    if sp > 1:
        shape.append(("sp", sp))
    shape.append(("tp", tp))
    names, sizes = zip(*shape)
    return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=names)


def mesh_shape(mesh: Optional[DeviceMesh]) -> Dict[str, int]:
    """{axis name: size}, as JAX's `mesh.shape`; {} for no mesh."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_group(mesh: Optional[DeviceMesh], name: str):
    """The process group of this rank along axis `name`, or None when the
    mesh has no such axis or it has one rank (no communication needed)."""
    if mesh_shape(mesh).get(name, 1) == 1:
        return None
    return mesh.get_group(name)
