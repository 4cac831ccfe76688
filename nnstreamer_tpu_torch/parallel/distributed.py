"""The multi-process runtime: the process group a mesh spans.

Port of ``nnstreamer_tpu/parallel/distributed.py``.  The JAX package
joins ``jax.distributed`` (one controller process per host, every
device globally addressable) and lets XLA place the collectives.  Here
:func:`initialize` joins a ``torch.distributed`` process group, and the
port's collectives over it are explicit (``parallel/sharding.py``'s
cross-rank sum and gather, ``parallel/ring.py``'s K/V rotation).

* The group's backend is ``gloo``: NCCL refuses two ranks on one card,
  and gloo is the one backend a run on a one-card machine can check.
  gloo's all-gather takes card tensors as they are (it stages them
  through host memory itself).
* Each rank's slots (``parallel/mesh.local_devices``) are on its own
  card, chosen from its local index (``LOCAL_RANK``, else its rank)
  modulo the cards it sees: on a one-card machine every rank takes
  ``cuda:0``.  ``NNS_TPU_DEVICE_SLOTS`` gives each rank that many slots.
* The coordinator is ``host:port`` (the JAX form, a TCP store on rank
  0) or a ``file://`` path (torch's ``FileStore``: a rendezvous that
  races on no port, which the tests and the smoke run use).
* A rendezvous or a collective that does not complete raises within the
  group's timeout (``timeout_s``, else ``NNS_TPU_DIST_TIMEOUT_S``, else
  :data:`DEFAULT_TIMEOUT_S`), never torch's 30-minute default; a missing
  peer is never a silent local-only mesh.

Single process (no coordinator, or one process) is the quiet default:
every function degrades to the local slots.  The same three variables
as the JAX package's (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``) start either package from one launch line.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional

import torch

from ..core.log import logger

log = logger(__name__)

#: seconds a rendezvous or a collective waits before it raises
DEFAULT_TIMEOUT_S = 60.0
#: overrides :data:`DEFAULT_TIMEOUT_S` (read at :func:`initialize`)
TIMEOUT_ENV = "NNS_TPU_DIST_TIMEOUT_S"

_state: Dict[str, object] = {}


def _reset() -> None:
    _state.clear()
    #: ``kinds``: per rank, {device kind: (slots, card)}; ``remote``:
    #: the Slot objects of other ranks, made once
    _state.update(initialized=False, rank=0, world=1, local_index=0,
                  kinds=None, remote={})


_reset()


def is_initialized() -> bool:
    return bool(_state["initialized"])


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return int(_state["rank"])


def process_count() -> int:
    """Ranks in the group (1 without one)."""
    return int(_state["world"])


def init_method(address: str) -> str:
    """The ``init_process_group`` URL of a coordinator address:
    ``file://`` and ``tcp://`` URLs as given, ``host:port`` as TCP."""
    if address.startswith(("file://", "tcp://")):
        return address
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r}: expected host:port, "
                         "tcp://host:port or file:///path")
    return f"tcp://{address}"


def local_card(kind: str) -> torch.device:
    """The device this rank's slots are on: its card by local index, or
    the CPU."""
    if kind != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", int(_state["local_index"]) % torch.cuda.device_count())


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    timeout_s: Optional[float] = None,
) -> bool:
    """Join the process group.  Args default from the JAX package's env
    vars (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``).  Returns True when a multi-process group was
    joined, False for the single-process default (no coordinator
    configured, or ``num_processes == 1``).  A coordinator with counts
    missing or out of range raises ``ValueError``; one that does not
    answer, or peers that do not come, raise within ``timeout_s``.
    Idempotent."""
    if _state["initialized"]:
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        np_env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(np_env) if np_env is not None else None
    if process_id is None:
        pid = os.environ.get("JAX_PROCESS_ID")
        process_id = int(pid) if pid is not None else None

    if not coordinator_address:
        log.debug("single-process runtime (no coordinator configured)")
        return False
    if num_processes == 1:
        log.debug("single-process runtime (num_processes=1)")
        return False
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address!r} is configured but "
            f"num_processes={num_processes} process_id={process_id}: "
            "torch.distributed detects neither (set JAX_NUM_PROCESSES and "
            "JAX_PROCESS_ID)")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id={process_id} does not fit "
                         f"num_processes={num_processes}")
    if timeout_s is None:
        timeout_s = float(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_S))
    local_index = int(os.environ.get("LOCAL_RANK", process_id))

    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=init_method(coordinator_address),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    _state.update(initialized=True, rank=process_id, world=num_processes,
                  local_index=local_index)
    try:
        kinds = ["cuda", "cpu"] if torch.cuda.is_available() else ["cpu"]
        if torch.cuda.is_available():
            torch.cuda.set_device(local_card("cuda"))
        from .mesh import device_slots

        # every rank's slot count and card, gathered once
        mine = {k: (device_slots(), str(local_card(k))) for k in kinds}
        got: List = [None] * num_processes
        dist.all_gather_object(got, mine)
        _state.update(kinds=got)
    except BaseException:
        shutdown()
        raise
    log.info("joined the process group: rank %s of %s via %s",
             process_id, num_processes, coordinator_address)
    return True


def shutdown() -> None:
    """Leave the process group (destroy it); the slots turn local again.
    The JAX package has no counterpart: a process group must be torn
    down."""
    if _state["initialized"]:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    _reset()


def slot_offset(rank: int, kind: Optional[str] = None) -> int:
    """The id of ``rank``'s first slot: the slots of the ranks before it."""
    kind = kind or _kind()
    return sum(int(_state["kinds"][r][kind][0]) for r in range(rank))


def _kind() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def global_devices(kind: Optional[str] = None) -> list:
    """Every rank's slots in rank order (this rank's are
    ``local_devices``' own objects; another rank's hold no device work
    here): the port's ``jax.devices()`` after ``jax.distributed.
    initialize``.  Without a group, :func:`~.mesh.local_devices`."""
    from .mesh import Slot, local_devices

    if not is_initialized():
        return local_devices(kind)
    kind = "cuda" if kind in ("gpu", "cuda") else (kind or _kind())
    out = []
    remote = _state["remote"]
    for r, per in enumerate(_state["kinds"]):
        if kind not in per:
            raise RuntimeError(f"rank {r} has no {kind} slots")
        if r == process_index():
            out.extend(local_devices(kind))
            continue
        key = (kind, r)
        if key not in remote:
            n, card = per[kind]
            first = slot_offset(r, kind)
            remote[key] = [Slot(first + i, torch.device(card), i, r) for i in range(n)]
        out.extend(remote[key])
    return out


def global_device_count() -> int:
    return len(global_devices())


def local_device_count() -> int:
    from .mesh import local_devices

    return len(local_devices())


def global_mesh(**axes: int):
    """Mesh over every rank's slots (:func:`~.mesh.make_mesh` over
    :func:`global_devices`).  Axis sizes multiply to the global slot
    count; ``data=0`` (the default) absorbs the rest (make_mesh
    semantics)."""
    from .mesh import make_mesh

    return make_mesh(devices=global_devices(), **axes)


def group_of(slots) -> Optional[object]:
    """The process group whose collectives join ``slots``' owners: None
    when one process owns them all, the whole group when they span
    every rank.  A group over some of the ranks raises: its collectives
    would need a subgroup every rank creates in the same order."""
    ranks = sorted({s.rank for s in slots})
    if len(ranks) <= 1:
        return None
    if ranks != list(range(process_count())):
        raise ValueError(f"slots of ranks {ranks} out of {process_count()}: a "
                         "collective over some of the processes is not supported")
    import torch.distributed as dist

    return dist.group.WORLD


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype on each), in rank order,
    on ``t``'s device."""
    import torch.distributed as dist

    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, t, group=group)
    return outs


def agree_min(value: int, group=None) -> int:
    """The smallest of every rank's ``value``."""
    got = all_gather(torch.tensor([int(value)], dtype=torch.int64), group)
    return int(min(int(g[0]) for g in got))
