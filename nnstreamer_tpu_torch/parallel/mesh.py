"""Device meshes over the slots one process owns.

Port of ``nnstreamer_tpu/parallel/mesh.py``.  The JAX package builds one
``jax.sharding.Mesh`` over ``jax.devices()`` and lets XLA place the
collectives; the whole mesh belongs to one controller process.  Here a
mesh is the same named grid of positions, but each position is a
:class:`Slot`: a ``torch.device`` with a mesh id and a CUDA stream of its
own.  Sharded values are explicit (``parallel/sharding.py``): one tensor
per slot, and the one collective the serving paths need, the sum across
the ``model`` axis, is a fixed-order sum on the root slot.

:func:`local_devices` is the port's ``jax.devices()``: one slot per CUDA
card, or per CPU.  ``NNS_TPU_DEVICE_SLOTS=k`` (read there and nowhere
else; default 1) gives ``k`` slots that share each device, the
counterpart of XLA's ``--xla_force_host_platform_device_count``: the CPU
tests build their meshes from it, and on one card it runs the whole
sharded code on CUDA.  Slots that share a device share its memory; a
replicated value is then one tensor, not ``k`` copies.

Axis conventions (the JAX package's): ``data`` (batch), ``model``
(tensor parallel), ``seq``, ``expert`` and ``pipe``.  Any axis of size 1
is legal and free.  ``make_mesh``'s validation messages are the JAX
package's, word for word.

Not here: ``shard_map`` (the port has no tracer to map), and the
multi-process half (``distributed.py``).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("data", "model", "seq", "expert", "pipe")

#: slots per local device (default 1): the only place it is read
SLOTS_ENV = "NNS_TPU_DEVICE_SLOTS"


class Slot:
    """One mesh position: a device, its mesh id (``id``, the index in
    :func:`local_devices`) and a CUDA stream of its own (None on the CPU),
    made at first use."""

    def __init__(self, id: int, device: torch.device, index: int = 0):
        self.id = int(id)
        self.device = torch.device(device)
        #: which of the slots sharing ``device`` this is
        self.index = int(index)
        self._stream = None
        self._lock = threading.Lock()

    @property
    def stream(self):
        if self.device.type != "cuda":
            return None
        with self._lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            return self._stream

    def __repr__(self) -> str:
        return f"Slot(id={self.id}, device={self.device}, index={self.index})"


_slot_cache: Dict[Tuple[str, int], List[Slot]] = {}
_slot_lock = threading.Lock()


def device_slots() -> int:
    """``NNS_TPU_DEVICE_SLOTS`` (default 1): slots per local device."""
    raw = os.environ.get(SLOTS_ENV, "").strip()
    if not raw:
        return 1
    try:
        k = int(raw)
    except ValueError:
        raise ValueError(f"{SLOTS_ENV}={raw!r} is not an int") from None
    if k < 1:
        raise ValueError(f"{SLOTS_ENV} must be >= 1, got {k}")
    return k


def local_devices(kind: Optional[str] = None) -> List[Slot]:
    """The process's mesh slots: ``device_slots()`` per CUDA card
    (``kind="cuda"``) or on the CPU (``kind="cpu"``), consecutive slots
    sharing a device.  ``kind`` None takes the cards when there are any,
    else the CPU, as ``jax.devices()`` takes the accelerator.  The same
    list (the same Slot objects, so the same streams) comes back while the
    setting stays the same."""
    if kind is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    kind = "cuda" if kind in ("gpu", "cuda") else kind
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unknown device kind {kind!r} (cuda, cpu)")
    k = device_slots()
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for a cuda mesh")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device("cpu")]
    with _slot_lock:
        key = (kind, k, len(devs))
        got = _slot_cache.get(key)
        if got is None:
            got = _slot_cache[key] = [
                Slot(j * k + i, d, i) for j, d in enumerate(devs) for i in range(k)]
        return list(got)


def one_device_slots(slots: Sequence[Slot]) -> int:
    """How many of ``slots`` share the first one's device: all that an
    automatic ``data`` axis takes (``pipeline/plan.mesh_plan``'s
    ``absorb``), since no run over distinct cards exists yet."""
    return sum(1 for s in slots if s.device == slots[0].device) if slots else 0


def _as_slots(devices) -> List[Slot]:
    out = []
    for i, d in enumerate(devices):
        out.append(d if isinstance(d, Slot) else Slot(i, d))
    return out


class Mesh:
    """A named grid of slots (``devices``: an object array of
    :class:`Slot`, one dimension per name of ``axis_names``)."""

    def __init__(self, devices: np.ndarray, axis_names=AXES):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = {
            n: int(s) for n, s in zip(self.axis_names, devices.shape)}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> List[Slot]:
        """Every slot in mesh order (row-major over ``axis_names``)."""
        return list(self.devices.reshape(-1))

    @property
    def root(self) -> Slot:
        return self.devices.reshape(-1)[0]

    @property
    def kind(self) -> str:
        return self.root.device.type

    def one_device(self) -> bool:
        """True when every slot lies on the same device."""
        return len({str(s.device) for s in self.flat}) == 1

    def model_group(self, data_index: int = 0) -> List[Slot]:
        """The slots along ``model`` at ``data_index`` (every other axis
        at 0): one tensor-parallel group, its root first."""
        idx = [0] * len(self.axis_names)
        idx[self.axis_names.index("data")] = data_index
        mi = self.axis_names.index("model")
        out = []
        for m in range(self.shape["model"]):
            idx[mi] = m
            out.append(self.devices[tuple(idx)])
        return out

    def __repr__(self) -> str:
        shape = {k: v for k, v in self.shape.items() if v > 1} or {"data": 1}
        return f"Mesh({shape}, {self.root.device})"


def make_mesh(
    axis_sizes: Optional[Dict[str, int]] = None,
    *,
    devices=None,
    data: int = 0,
    model: int = 1,
    seq: int = 1,
    expert: int = 1,
    pipe: int = 1,
) -> Mesh:
    """A :class:`Mesh` with the framework's canonical axes over
    ``devices`` (default :func:`local_devices`).  ``data=0`` (default)
    absorbs every slot the other axes do not claim::

        mesh = make_mesh(model=2)          # on 8 slots -> data=4, model=2
        mesh = make_mesh({"data": 2, "seq": 4})
    """
    sizes = {"data": data, "model": model, "seq": seq, "expert": expert,
             "pipe": pipe}
    if axis_sizes:
        unknown = set(axis_sizes) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; valid: {AXES}")
        sizes.update(axis_sizes)
    # the plan is validated before the grid is shaped: only ``data`` may
    # be 0 / None (auto)
    for name in AXES:
        v = sizes[name]
        if name == "data" and (v is None or v == 0):
            continue
        if not isinstance(v, int) or isinstance(v, bool):
            raise ValueError(
                f"mesh axis {name!r} size must be an int, got {v!r}")
        if v < 1:
            raise ValueError(
                f"mesh axis {name!r} must be >= 1, got {v} "
                "(only 'data' supports 0/None = auto-absorb)")

    devs = _as_slots(devices if devices is not None else local_devices())
    n = len(devs)
    fixed = 1
    for name in AXES:
        if name != "data" and sizes[name] > 1:
            fixed *= sizes[name]
    requested = {a: sizes[a] for a in AXES if sizes[a] not in (0, 1, None)}
    if sizes["data"] in (0, None):
        if n % fixed:
            bad = next((a for a in AXES
                        if a != "data" and sizes[a] > 1 and n % sizes[a]),
                       None)
            detail = (f"axis {bad!r} = {sizes[bad]} does not divide the "
                      f"device count" if bad else
                      f"the fixed axes {requested} multiply to {fixed}, "
                      "which does not divide the device count")
            raise ValueError(
                f"cannot auto-size the 'data' axis over {n} device(s): "
                f"{detail} (requested {requested or '{}'}, "
                f"{n} device(s) available)")
        sizes["data"] = n // fixed
    total = sizes["data"] * fixed
    if total != n:
        bad = next((a for a in AXES if sizes[a] > 1 and n % sizes[a]), None)
        hint = (f"; axis {bad!r} = {sizes[bad]} does not divide "
                f"{n}" if bad else "")
        raise ValueError(
            f"mesh plan {requested or dict(sizes)} needs {total} device(s), "
            f"have {n}{hint}: axis sizes must multiply to the device count")
    kinds = {s.device.type for s in devs}
    if len(kinds) > 1:
        raise ValueError(f"a mesh takes one device kind, got {sorted(kinds)}")
    arr = np.empty(n, dtype=object)
    for i, s in enumerate(devs):
        arr[i] = s
    return Mesh(arr.reshape(tuple(sizes[a] for a in AXES)), AXES)


def single_device_mesh(device=None) -> Mesh:
    """A 1-slot mesh (every axis size 1): lets mesh-aware code run anywhere."""
    dev = device if device is not None else local_devices()[0]
    return make_mesh(data=1, devices=[dev])


def mesh_axis_size(mesh, name: str) -> int:
    return int(mesh.shape.get(name, 1))


def device_coords(mesh) -> Dict[int, Tuple[int, int]]:
    """``slot.id`` -> its ``(data, model)`` coordinate: how per-replica
    counters name a slot's position in a 2-D placement."""
    coords: Dict[int, Tuple[int, int]] = {}
    arr = mesh.devices
    di_axis = AXES.index("data")
    mi_axis = AXES.index("model")
    for idx in np.ndindex(arr.shape):
        coords[arr[idx].id] = (int(idx[di_axis]), int(idx[mi_axis]))
    return coords


def local_batch(mesh, global_batch: int) -> int:
    d = mesh_axis_size(mesh, "data")
    if global_batch % d:
        raise ValueError(f"global batch {global_batch} not divisible by data={d}")
    return global_batch // d
