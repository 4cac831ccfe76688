"""Sharded values: one tensor per mesh slot, and the helpers that place them.

Port of ``nnstreamer_tpu/parallel/sharding.py``.  Where the JAX package
annotates arrays with a ``NamedSharding`` and lets XLA move the bytes,
the port's sharded value is explicit: a :class:`Sharded` holds the spec
(:class:`P`, the port's own ``PartitionSpec``) and one tensor per slot
of the mesh, in mesh order.  A dim whose spec entry names mesh axes is
cut into equal contiguous pieces over those axes; every other dim is
whole, so slots that differ only along unnamed axes hold the same piece
(on one device, the same tensor).

* :func:`batch_sharding` / :func:`data_sharding` / :func:`shard_batch`:
  split the leading (batch) dim over the ``data`` axis.
* :func:`shard_params`: place a param tree by its ``param_pspecs``
  (``None`` replicates); :func:`replicate` copies a tree once per device.
* :func:`iter_param_specs`, :func:`spec_entry_axes`, :func:`spec_axes`,
  :func:`placement_split`: the one walk that pairs a tree with its
  (possibly partial) spec tree, shared with the deep lint.
* :func:`fixed_order_sum`: the cross-slot sum of the ``model`` axis,
  partials added in slot order on the root's device, so a replay is
  bitwise repeatable; :func:`cross_rank_sum` the same sum over a group
  whose slots span processes (an all-gather of the float32 partials,
  then :func:`fixed_order_sum` in rank order on every rank: each rank
  holds the in-process sum's bits), :func:`cross_rank_cat` a gather.
* Under a mesh that spans processes a :class:`Sharded` holds only its
  addressable shards (None for another rank's slots);
  :func:`put_process_local` places the process's own rows (the port's
  ``jax.make_array_from_process_local_data``).
* :func:`slot_tree`: a placed tree seen from one slot;
  :func:`check_pspecs`: a spec tree checked against a mesh, nothing
  placed.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import Mesh, Slot


class P(tuple):
    """A partition spec: one entry per leading dim, each None (whole), an
    axis name or a tuple of axis names; dims past the entries are whole."""

    def __new__(cls, *entries):
        return tuple.__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


class NamedSharding:
    """A spec bound to a mesh (the port's ``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    @property
    def num_devices(self) -> int:
        return self.mesh.size

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def spec_entry_axes(entry) -> tuple:
    """Mesh-axis names one spec entry maps a dim over (an entry is None,
    an axis name, or a tuple of axis names)."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def spec_axes(spec) -> set:
    """Every mesh-axis name a leaf's spec mentions."""
    out = set()
    for entry in (spec or ()):
        out.update(spec_entry_axes(entry))
    return out


def _piece(shape: Sequence[int], spec, mesh: Mesh, idx: Tuple[int, ...]
           ) -> Tuple[slice, ...]:
    """The slices of a ``shape`` value that the slot at grid index ``idx``
    holds under ``spec``."""
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = spec_entry_axes(entry)
        if not axes:
            out.append(slice(None))
            continue
        ways, pos = 1, 0
        for a in axes:
            if a not in mesh.shape:
                raise ValueError(f"spec {spec!r} names axis {a!r}, which the "
                                 f"mesh lacks ({tuple(mesh.shape)})")
            size = mesh.shape[a]
            pos = pos * size + idx[mesh.axis_names.index(a)]
            ways *= size
        if n % ways:
            raise ValueError(f"dim {d} of size {n} does not divide over "
                             f"{'x'.join(axes)}={ways} ({spec!r})")
        step = n // ways
        out.append(slice(pos * step, (pos + 1) * step))
    return tuple(out)


class Sharded:
    """A value split over ``mesh`` by ``spec``: ``shards[i]`` is the piece
    of ``mesh.flat[i]``, on that slot's device.  Pieces of a named dim are
    tensors of their own (contiguous); a piece that is the whole value on
    a slot of the source's device is the source tensor itself."""

    def __init__(self, mesh: Mesh, spec: P, shards: List[torch.Tensor],
                 global_shape: Tuple[int, ...], dtype, strides=None):
        self.mesh = mesh
        self.spec = P(*spec)
        self.shards = shards
        self.shape = tuple(global_shape)
        self.dtype = dtype
        #: the whole value's strides (its memory format: a channels_last
        #: kernel stays channels_last when gathered)
        self.strides = tuple(strides) if strides is not None else None

    def _empty(self, device) -> torch.Tensor:
        if self.strides is None:
            return torch.empty(self.shape, dtype=self.dtype, device=device)
        return torch.empty_strided(self.shape, self.strides, dtype=self.dtype,
                                   device=device)

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec)

    @property
    def addressable_shards(self) -> List[Tuple[Slot, torch.Tensor]]:
        """``(slot, piece)`` of the slots this process owns."""
        return [(s, t) for s, t in zip(self.mesh.flat, self.shards)
                if t is not None]

    def for_slot(self, slot: Slot) -> torch.Tensor:
        for s, t in zip(self.mesh.flat, self.shards):
            if s is slot:
                if t is None:
                    raise KeyError(f"{slot} belongs to rank {slot.rank}")
                return t
        raise KeyError(slot)

    def full(self, device=None) -> torch.Tensor:
        """The whole value on ``device`` (default the first addressable
        slot's), each piece copied in once, in mesh order.  A value with
        pieces only another rank holds raises."""
        own = self.addressable_shards
        dev = torch.device(device) if device is not None else own[0][0].device
        out = self._empty(dev)
        seen = set()
        for idx, t in zip(np.ndindex(self.mesh.devices.shape), self.shards):
            if t is None:
                continue
            sl = _piece(self.shape, self.spec, self.mesh, idx)
            key = tuple((s.start, s.stop) for s in sl)
            if key in seen:
                continue
            seen.add(key)
            out[sl].copy_(t)
        for idx in np.ndindex(self.mesh.devices.shape):
            sl = _piece(self.shape, self.spec, self.mesh, idx)
            if tuple((s.start, s.stop) for s in sl) not in seen:
                raise ValueError(f"{self!r}: a piece lies only on another rank")
        return out

    def __repr__(self) -> str:
        return f"Sharded({self.shape}, {self.dtype}, {self.spec!r})"


def put(x, mesh: Mesh, spec=None) -> Sharded:
    """One value placed over ``mesh`` by ``spec`` (None: replicated)."""
    spec = P(*spec) if spec is not None else P()
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    pieces: Dict[Tuple, torch.Tensor] = {}
    shards = []
    for idx, slot in zip(np.ndindex(mesh.devices.shape), mesh.flat):
        sl = _piece(tuple(t.shape), spec, mesh, idx)
        if not slot.addressable:  # another rank's piece: no work here
            shards.append(None)
            continue
        key = (tuple((s.start, s.stop) for s in sl), str(slot.device))
        got = pieces.get(key)
        if got is None:
            whole = all(s == slice(None) for s in sl)
            if whole and t.device == slot.device:
                got = t
            else:  # a tensor of its own, in the value's memory format
                got = t[sl].clone(memory_format=torch.preserve_format)
                if got.device != slot.device:
                    got = got.to(slot.device)
            pieces[key] = got
        shards.append(got)
    dense = t.is_contiguous() or (
        t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last))
    return Sharded(mesh, spec, shards, tuple(t.shape), t.dtype,
                   strides=t.stride() if dense else None)


def put_process_local(x, mesh: Mesh, axis: str = "data") -> Sharded:
    """The process's own rows of a batch split over ``axis`` (the port's
    ``jax.make_array_from_process_local_data``): ``x`` holds the rows of
    this process's positions along ``axis``, in order; the global value
    has the rows of every process's positions.  Every rank passes the
    same row count."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    ways = mesh.shape[axis]
    ai = mesh.axis_names.index(axis)
    own = sorted({idx[ai] for idx, s in zip(np.ndindex(mesh.devices.shape),
                                            mesh.flat) if s.addressable})
    if not own or t.shape[0] % len(own):
        raise ValueError(f"{t.shape[0]} local rows over this process's "
                         f"{len(own)} {axis!r} positions")
    per = t.shape[0] // len(own)
    shards = []
    for idx, slot in zip(np.ndindex(mesh.devices.shape), mesh.flat):
        if not slot.addressable:
            shards.append(None)
            continue
        j = own.index(idx[ai])
        piece = t[j * per:(j + 1) * per]
        shards.append(piece.to(slot.device) if piece.device != slot.device
                      else piece.clone())
    return Sharded(mesh, P(axis), shards, (per * ways,) + tuple(t.shape[1:]),
                   t.dtype)


def batch_sharding(mesh: Mesh, ndim: int, axis: str = "data") -> NamedSharding:
    """Dim 0 split over ``axis``, every other dim whole."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Rank-agnostic batch sharding: ``P(axis)`` splits dim 0 and leaves
    every trailing dim whole, so one sharding serves any mix of ranks."""
    return NamedSharding(mesh, P(axis))


def shard_batch(mesh: Mesh, x, axis: str = "data") -> Sharded:
    """A host or device batch split over the data axis."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return put(t, mesh, batch_sharding(mesh, t.dim(), axis).spec)


def _walk_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _walk_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_walk_map(fn, v) for v in tree)
    return fn(tree)


def replicate(mesh: Mesh, tree):
    """Every leaf whole on every slot: one tensor per device."""
    return _walk_map(lambda x: put(x, mesh, None), tree)


def shard_params(mesh: Mesh, params, pspecs: Optional[Any]):
    """Place params by a matching (possibly partial) tree of specs; a
    leaf without one is replicated."""
    if pspecs is None:
        return replicate(mesh, params)

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(v, (s or {}).get(k) if isinstance(s, dict) else None)
                    for k, v in p.items()}
        return put(p, mesh, s)

    return walk(params, pspecs)


def out_shardings_like(mesh: Mesh, tree_pspecs):
    """A tree of specs as a tree of :class:`NamedSharding` on ``mesh``."""
    return _walk_map(lambda s: NamedSharding(mesh, s), tree_pspecs)


def iter_param_specs(params, pspecs) -> Iterator[Tuple[str, Any, Any]]:
    """``(path, leaf, spec)`` for every param leaf, pairing a (possibly
    partial) spec tree with the same walk :func:`shard_params` places by
    (the placement metrics and the deep lint's spec audit share it)."""
    def walk(p, s, path):
        if isinstance(p, dict):
            for k, v in p.items():
                yield from walk(
                    v, (s or {}).get(k) if isinstance(s, dict) else None,
                    f"{path}.{k}" if path else str(k))
        else:
            yield path, p, s

    yield from walk(params, pspecs, "")


def placement_split(params, pspecs, axis: str = "model") -> Tuple[int, int]:
    """``(n_sharded, n_replicated)`` leaves: how :func:`shard_params` would
    place a tree over ``axis``; no device work."""
    sharded = replicated = 0
    for _, _, spec in iter_param_specs(params, pspecs):
        if axis in spec_axes(spec):
            sharded += 1
        else:
            replicated += 1
    return sharded, replicated


def fixed_order_sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The cross-slot sum: ``parts[0] + parts[1] + ...`` on ``device``
    (the root slot's), added in slot order, so the same partials give the
    same bits on every replay."""
    dev = torch.device(device)
    acc = parts[0] if parts[0].device == dev else parts[0].to(dev)
    for p in parts[1:]:
        acc = acc + (p if p.device == dev else p.to(dev))
    return acc


def cross_rank_sum(parts: Sequence[torch.Tensor], device, group) -> torch.Tensor:
    """The :func:`fixed_order_sum` of a group whose slots span processes:
    this process's partials (its slots', in slot order; every rank holds
    as many) all-gathered, then summed on ``device`` in rank order, so
    that every rank holds the same bits, the in-process sum's over the
    same partials."""
    from .distributed import all_gather

    dev = torch.device(device)
    local = torch.stack([p if p.device == dev else p.to(dev) for p in parts])
    got = all_gather(local, group)
    return fixed_order_sum([g[i] for g in got for i in range(len(parts))], dev)


def cross_rank_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order, on
    ``t``'s device."""
    from .distributed import all_gather

    return torch.cat(all_gather(t, group), dim=dim)


def slot_tree(tree, slot: Slot):
    """A tree of :class:`Sharded` leaves as one slot computes with it:
    each leaf's piece on ``slot`` (plain tensors; other leaves as they
    are)."""
    return _walk_map(lambda x: x.for_slot(slot) if isinstance(x, Sharded) else x,
                     tree)


def check_pspecs(mesh: Mesh, params, pspecs) -> int:
    """Check, with no copy, that :func:`shard_params` could place
    ``params`` by ``pspecs`` on ``mesh``: every axis a spec names is on the
    mesh and every dim it cuts divides (``ValueError`` otherwise, as the
    placement raises).  Returns the number of leaves."""
    n = 0
    for _, leaf, spec in iter_param_specs(params, pspecs):
        n += 1
        if spec is not None:
            for idx in np.ndindex(mesh.devices.shape):
                _piece(tuple(leaf.shape), P(*spec), mesh, idx)
    return n
