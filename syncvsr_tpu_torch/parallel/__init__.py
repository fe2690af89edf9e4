"""Data-parallel, FSDP, tensor-parallel and sequence-parallel training over
a process group (port of ``syncvsr_tpu/parallel/``)."""

from syncvsr_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    TensorLayout,
    batch_shardings,
    create_mesh,
    host_local_batch,
    resident_bytes,
    shard_batch,
    shard_state,
    split_time,
    state_shardings,
)
