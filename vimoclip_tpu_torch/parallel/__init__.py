"""Data and tensor parallelism over ``torch.distributed`` (the port's
counterpart of ``vimoclip_tpu/parallel``): ``mesh`` for the process groups,
the batch split and the inference replicas, ``partition`` for the Megatron
layout of the weights."""

from vimoclip_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    Replicas,
    Shard,
    create_mesh,
    initialize_distributed,
    local_batch_slice,
    replica_devices,
    shard_batch,
)
from vimoclip_tpu_torch.parallel.partition import (  # noqa: F401
    STUDENT_PARTITION_RULES,
    TFAM_PARTITION_RULES,
    Partition,
    PartitionRules,
    parallelize_,
)
