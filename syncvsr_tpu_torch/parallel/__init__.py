"""Data-parallel, FSDP and tensor-parallel training over a process group
(port of ``syncvsr_tpu/parallel/``)."""

from syncvsr_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    TensorLayout,
    create_mesh,
    host_local_batch,
    resident_bytes,
    shard_batch,
    shard_state,
    state_shardings,
)
