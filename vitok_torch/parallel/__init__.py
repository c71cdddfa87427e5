"""Parallelism: device meshes, sharding rules, sequence and pipeline
parallelism.

The same exports as ``vitok_tpu.parallel``.
"""

from vitok_torch.parallel.mesh import (
    DATA_AXIS,
    FSDP_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    create_mesh,
    initialize_distributed,
)
from vitok_torch.parallel.pipeline import (
    make_pipeline_train_step,
    pipeline_param_specs,
    pipeline_parallel_decode,
    pipeline_parallel_value_and_grad,
)
from vitok_torch.parallel.sequence import (
    halo_attention,
    make_sp_train_step,
    place_batch_token_sharded,
    sequence_parallel_forward,
    sequence_parallel_value_and_grad,
)
from vitok_torch.parallel.sharding import (
    Layout,
    ae_param_specs,
    batch_specs,
    param_shardings,
    place_on_mesh,
    replicated,
    shard_batch,
    shard_params,
)

__all__ = [
    "DATA_AXIS",
    "FSDP_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "SEQ_AXIS",
    "create_mesh",
    "initialize_distributed",
    "Layout",
    "ae_param_specs",
    "batch_specs",
    "param_shardings",
    "place_on_mesh",
    "replicated",
    "shard_batch",
    "shard_params",
    "halo_attention",
    "make_sp_train_step",
    "place_batch_token_sharded",
    "sequence_parallel_forward",
    "sequence_parallel_value_and_grad",
    "make_pipeline_train_step",
    "pipeline_param_specs",
    "pipeline_parallel_decode",
    "pipeline_parallel_value_and_grad",
]
