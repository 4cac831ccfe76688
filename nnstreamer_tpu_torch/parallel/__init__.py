"""Parallelism: the in-process (data x model) mesh and sharded values.

Port of ``nnstreamer_tpu/parallel/``: the single-controller mesh one
process builds over its local slots (``mesh.py``) and the sharded values
placed on it (``sharding.py``).  The multi-process half
(``distributed.py``) and ring attention (``ring.py``) are not ported yet:
their names raise :class:`NotPortedError`.
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


class NotPortedError(NotImplementedError):
    """A name of the JAX package's ``parallel/`` whose module is not
    ported yet (``distributed.py``, ``ring.py``)."""


def _not_ported(name: str, module: str):
    def fn(*args, **kwargs):
        raise NotPortedError(
            f"nnstreamer_tpu_torch.parallel.{name}: the JAX package's "
            f"parallel/{module} is not ported yet")
    fn.__name__ = name
    return fn


ring_attention = _not_ported("ring_attention", "ring.py")
ring_attention_local = _not_ported("ring_attention_local", "ring.py")
global_device_count = _not_ported("global_device_count", "distributed.py")
global_mesh = _not_ported("global_mesh", "distributed.py")
distributed_initialize = _not_ported("distributed_initialize", "distributed.py")
distributed_is_initialized = _not_ported("distributed_is_initialized",
                                         "distributed.py")
local_device_count = _not_ported("local_device_count", "distributed.py")
