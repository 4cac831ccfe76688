"""Parallelism: device meshes, sharded values, the process group, ring
attention.

Port of ``nnstreamer_tpu/parallel/``: the mesh over a process's slots,
or every rank's (``mesh.py``), the sharded values placed on it and the
cross-slot and cross-rank sums (``sharding.py``), the process group
(``distributed.py``) and sequence parallelism (``ring.py``).
"""

from .mesh import (  # noqa: F401
    AXES,
    Mesh,
    Slot,
    device_coords,
    device_slots,
    local_batch,
    local_devices,
    make_mesh,
    mesh_axis_size,
    one_device_slots,
    single_device_mesh,
)
from .sharding import (  # noqa: F401
    P,
    NamedSharding,
    Sharded,
    batch_sharding,
    data_sharding,
    fixed_order_sum,
    replicate,
    shard_batch,
    shard_params,
)
from .ring import ring_attention, ring_attention_local  # noqa: F401
from .distributed import (  # noqa: F401
    global_device_count,
    global_mesh,
    initialize as distributed_initialize,
    is_initialized as distributed_is_initialized,
    local_device_count,
)
