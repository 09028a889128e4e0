"""Data parallelism, fully sharded state and pipeline stages over a mesh of
devices, within one process or across a process group.

Port of ``livelyspeaker_tpu/parallel/``: the mesh, the parameter rules and
FSDP (``mesh.py``), the data-parallel and fully sharded train steps
(``training.py``), the sampler (``sampling.py``), multi-process training
(``multihost.py``) and GPipe stages (``pipeline.py``). Tensor-parallel
compute over a model axis above 1 is a later slice of the port: a mesh
with one raises ``NotImplementedError``.
"""

from .mesh import (
    DATA_AXIS,
    FSDP_MIN_SIZE,
    MODEL_AXIS,
    FSDPShards,
    Mesh,
    create_mesh,
    fold_in,
    fsdp_param_shardings,
    fsdp_shard_params,
    gather_batch,
    param_shardings,
    param_spec,
    preserve_state_shardings,
    replicate_module,
    shard_batch,
    shard_params,
)
from .multihost import global_batch, init_distributed, process_local_batch_size
from .pipeline import (
    STAGE_AXIS,
    PipelineMesh,
    create_pipeline_mesh,
    make_pipeline_backbone_factory,
    pipeline_forward,
    pipeline_spec,
    stack_block_params,
)
from .sampling import shard_sample_fn
from .training import fsdp_train_step, shard_train_step
