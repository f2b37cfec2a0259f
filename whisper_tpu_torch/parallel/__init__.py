"""Scale-out over a device mesh on torch.distributed (the counterpart of
whisper_tpu/parallel/): mesh.py builds the mesh, sharding.py holds the
tensor-parallel rules, serve.py the sharded engines, train.py the training
step, sequence.py and pipeline.py the sequence- and pipeline-parallel
encoders, launch.py starts a world of ranks on one machine. The
collectives they and the graphs call are whisper_tpu_torch/comm.py."""

from .mesh import make_mesh
from .pipeline import pp_encode
from .sequence import sp_encode
from .serve import DataParallelEngine, DataParallelSpeculativeEngine, dp_cross_kv, dp_encode
from .sharding import gather_params, param_shardings, shard_params

__all__ = [
    "DataParallelEngine",
    "DataParallelSpeculativeEngine",
    "dp_cross_kv",
    "dp_encode",
    "gather_params",
    "make_mesh",
    "param_shardings",
    "pp_encode",
    "shard_params",
    "sp_encode",
]
