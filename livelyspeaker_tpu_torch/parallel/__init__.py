"""Data parallelism over a mesh of devices driven by one process.

Port of ``livelyspeaker_tpu/parallel/``: the mesh (``mesh.py``), the
data-parallel train step (``training.py``) and sampler (``sampling.py``).
Multi-process training (``multihost.py``), tensor parallelism, FSDP and
pipeline stages (``pipeline.py``) are later slices of the port: their
names here raise ``NotImplementedError``.
"""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    create_mesh,
    fold_in,
    fsdp_param_shardings,
    fsdp_shard_params,
    gather_batch,
    later_slice,
    param_shardings,
    preserve_state_shardings,
    replicate_module,
    shard_batch,
    shard_params,
)
from .sampling import shard_sample_fn
from .training import shard_train_step

STAGE_AXIS = "stage"
create_pipeline_mesh = later_slice("create_pipeline_mesh", "pipeline stages")
make_pipeline_backbone_factory = later_slice("make_pipeline_backbone_factory", "pipeline stages")
pipeline_forward = later_slice("pipeline_forward", "pipeline stages")
pipeline_spec = later_slice("pipeline_spec", "pipeline stages")
stack_block_params = later_slice("stack_block_params", "pipeline stages")
