"""Parallelism: device meshes, sharding rules, sequence parallelism.

The same exports as ``vitok_tpu.parallel``. The pipeline names
(``PIPE_AXIS`` aside) are not ported yet: they raise ``NotImplementedError``
(ROADMAP.md, Queue 1 item 12, ``parallel/pipeline.py``).
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

_PIPELINE = (
    "make_pipeline_train_step",
    "pipeline_param_specs",
    "pipeline_parallel_decode",
    "pipeline_parallel_value_and_grad",
)


def _not_ported(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"vitok_torch.parallel.{name}: pipeline parallelism (vitok_tpu/parallel/pipeline.py) is not ported "
            "yet (ROADMAP.md, Queue 1 item 12)")

    fn.__name__ = name
    return fn


def __getattr__(name):
    if name in _PIPELINE:
        return _not_ported(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
    *_PIPELINE,
]
