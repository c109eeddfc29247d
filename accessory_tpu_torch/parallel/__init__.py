"""Parallelism over ``torch.distributed``: process groups, the device mesh
with its logical-axis rules, and context-parallel (sequence-sharded)
attention for training.

Port of ``accessory_tpu/parallel/``. A mesh is a DeviceMesh over the ranks of
the default process group (one rank a card) with named axes dp, fsdp, ep, cp
and tp; collectives run on each axis's group. Context parallelism
(``make_cp_attn_fn``) is what the port trains with today; placing parameters
by ``logical_to_pspec`` (tensor and FSDP sharding), ``pipeline.py`` and the
streaming checkpoint load wait for ROADMAP A10.
"""

from accessory_tpu_torch.parallel.context import (  # noqa: F401
    CPAttention,
    cp_attention,
    cp_shard_attention,
    make_cp_attn_fn,
    seq_shard,
)
from accessory_tpu_torch.parallel.distributed import (  # noqa: F401
    init_distributed_mode,
    make_global_mesh,
)
from accessory_tpu_torch.parallel.mesh import (  # noqa: F401
    DEFAULT_RULES,
    INFERENCE_RULES,
    PartitionSpec,
    local_mesh,
    logical_to_pspec,
    make_mesh,
)
