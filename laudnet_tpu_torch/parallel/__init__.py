"""Data, tensor, FSDP and pipeline parallelism over ``torch.distributed``
(counterpart of `laudnet_tpu/parallel/`, with its 18 exports)."""

from laudnet_tpu_torch.parallel.mesh import (
    data_parallel_shardings,
    initialize_distributed,
    make_mesh,
    put_global_batch,
    replicate,
    shard_batch,
)
from laudnet_tpu_torch.parallel.fsdp import fsdp_shard_params, fsdp_specs
from laudnet_tpu_torch.parallel.pp import pipeline_apply, stack_layer_params
from laudnet_tpu_torch.parallel.pp_train import (
    make_pp_mesh,
    make_pp_train_step,
    pp_vit_forward,
)
from laudnet_tpu_torch.parallel.tp import (
    RESNET_TP_RULES,
    VIT_TP_RULES,
    sequence_parallel_constraint,
    shard_params,
    tensor_parallel_specs,
)

__all__ = [
    "data_parallel_shardings",
    "initialize_distributed",
    "make_mesh",
    "put_global_batch",
    "replicate",
    "shard_batch",
    "pipeline_apply",
    "stack_layer_params",
    "make_pp_mesh",
    "make_pp_train_step",
    "pp_vit_forward",
    "tensor_parallel_specs",
    "shard_params",
    "sequence_parallel_constraint",
    "VIT_TP_RULES",
    "RESNET_TP_RULES",
    "fsdp_specs",
    "fsdp_shard_params",
]
