"""Micro-batch dispatch: N queued buffers -> one captured step.

Port of ``nnstreamer_tpu/pipeline/batching.py``.  The runner's unit of
work is one buffer, and a per-frame stage pays its host work and a
launch for every frame.  When a batchable stage's queue is backlogged,
:class:`BatchRunner` runs the drained rows as ONE step of the stage's
pure per-buffer callable ``tuple(tensors) -> tuple(tensors)``:

* the batch is padded up to a bucket of a closed ladder (default powers
  of two, ladder-rounded above the top), so the census holds one step per
  bucket, not per occupancy;
* padding repeats the last real row (:func:`~..core.buffer.pad_rows`):
  valid data, no mask;
* a bucket's step is ``torch.func.vmap(fn)`` (the counterpart of
  ``jax.vmap``) over a static ``[bucket, ...]`` input per row signature,
  captured once through the stage's :class:`~.graphs.Census` under the
  key ``(bucket, row signature)`` (a CUDA graph on the card, the same
  step run eagerly on the CPU).  Rows go into the static input by one ``torch.stack`` per
  tensor (host rows: into pinned memory, then one host-to-card copy),
  the step replays, and the real rows' outputs are split off.  ``vmap`` keeps rows apart, so a row's outputs are bitwise
  equal at every occupancy of its bucket (the same captured step).

:class:`AdaptiveLadder` refines a stage's ladder online from the
occupancies it drains (mint, budget, warm start, ``align``, ``export``).

With xray on, each bucket step registers as ``(stage, "batch")`` with its
bucket as the trigger batch dim (the runtime expects the ladder), and a
padded dispatch adds the pad rows' share of the step's FLOPs to
``<stage>.pad_waste_flops``.

**Sharded mode** (a pipeline mesh, ``parallel/mesh.py``): given a mesh
whose ``data`` or ``model`` axis is over 1, the bucket is rounded up to
a multiple of the ``data`` width (:func:`shard_bucket_for`), each data
replica takes an equal run of rows, and the replica's rows are split
further over its ``model`` slots in contiguous runs (the first slots one
row longer where they do not divide).  Every slot replays a step of its
own, captured on the slot's stream and device at the one-slot bucket's
row count (its own rows first, the rest pad: a kernel that picks its
algorithm by the row count computes each row as the one-slot step does,
at the price of every slot computing a whole bucket), over
the stage's parameters, placed once before the first sharded dispatch
(``prepare``: whole on every device, so a ``model`` axis splits rows as
``data`` does; only the llm filter computes on a cut).  All the slots'
replays are launched before the caller waits on any, so they overlap.
The real rows' outputs are copied onto the root slot's device in slot
order.
``vmap`` keeps rows apart, so a row's outputs do not depend on which
slot computed it: bitwise the one-slot run's.  Counters: ``<stage>.shard_dispatch``, and the rows each
slot ran under ``<stage>.shard_rows.d<slot id>`` (``.d<data>m<model>``
on a 2-D mesh).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.buffer import split_rows
from ..core.log import metrics
from .graphs import Census

#: default bucket ladder; :func:`bucket_for` LADDER-ROUNDS above it
#: (multiples of the top bucket), so steps stay bounded at any batch_max
DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def bucket_for(n: int, buckets: Optional[Sequence[int]] = None) -> int:
    """Smallest allowed batch size >= n.  Above the ladder the size is
    ladder-rounded (the next multiple of the top bucket), never the exact
    occupancy, which would capture one step per occupancy; the census
    stays at ``len(ladder) + batch_max // top`` steps (:func:`ladder`)."""
    bs = buckets or DEFAULT_BUCKETS
    for b in bs:
        if b >= n:
            return b
    top = bs[-1]
    return top * (-(-n // top))


def ladder(batch_max: int, buckets: Optional[Sequence[int]] = None
           ) -> Tuple[int, ...]:
    """Every bucket a runner with this ``batch_max`` can dispatch
    (ascending), mirroring :func:`bucket_for`: sizes above the top bucket
    appear as its multiples up to the rounded ``batch_max``."""
    bs = tuple(sorted(set(buckets))) if buckets else DEFAULT_BUCKETS
    bm = max(1, batch_max)
    top = bucket_for(bm, bs)
    out = [b for b in bs if b <= top]
    if top > bs[-1]:
        out.extend(range(2 * bs[-1], top + 1, bs[-1]))
    return tuple(out)


#: occupancy observations of one size before the adaptive ladder mints a
#: bucket for it: a transient burst never costs a capture, a persistent
#: drain pattern refines within the first seconds of a backlogged run
MINT_AFTER = 24


class AdaptiveLadder:
    """A stage's bucket ladder refined online from observed occupancies.

    The static ladder pads every drain up to the next power of two: a
    runner that keeps draining 5-7 rows pays bucket 8 forever
    (``<stage>.batch_pad_waste``).  This ladder watches the occupancy
    stream (``<stage>.batch_occupancy``) and mints an exact bucket for an
    occupancy the ladder would pad once it has been seen
    :data:`MINT_AFTER` times.

    Two bounds keep the census closed: ``budget``, the most ladder
    entries (base + minted, from
    ``pipeline/plan.adaptive_variant_budget``), and ``align``, which
    rounds minted sizes up to a multiple of a mesh's data width (1 on one
    card).  ``warm`` pre-mints sizes (a ``Pipeline.ladder_snapshot()``
    fed back through ``bucket_ladders``), so a deployment captures its
    refined ladder at warm-up.

    ``bucket_for``/``observe`` run on the owning stage thread;
    ``sizes``/``export`` may be read from the app thread: the ladder tuple
    is swapped under a small lock.
    """

    _GUARDED_BY = {"_minted": "_lock", "_sizes": "_lock", "_align": "_lock"}

    def __init__(self, base: Optional[Sequence[int]] = None, *,
                 budget: int = 0, align: int = 1,
                 warm: Optional[Sequence[int]] = None,
                 mint_after: int = MINT_AFTER, name: Optional[str] = None):
        self.base: Tuple[int, ...] = (tuple(sorted(set(base))) if base
                                      else DEFAULT_BUCKETS)
        self._align = max(1, align)
        self.budget = max(len(self.base), budget) if budget else 0
        self.mint_after = max(1, mint_after)
        self.name = name
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = {}
        self._minted: set = set()
        self._sizes = self.base
        self._minted_metric = f"{name}.ladder_minted" if name else None
        if warm:
            for s in warm:
                self._mint(int(s))

    @property
    def align(self) -> int:
        return self._align

    @align.setter
    def align(self, value: int) -> None:
        """Re-round every minted size to the new width (warm-start sizes
        are minted at align 1), dropping those that land on a base
        bucket, so none sits in the ladder undispatchable."""
        with self._lock:
            self._align = max(1, int(value))
            self._minted = {self._aligned(s) for s in self._minted}
            self._minted.difference_update(self.base)
            self._sizes = tuple(sorted(set(self.base) | self._minted))

    def sizes(self) -> Tuple[int, ...]:
        """The current ladder (base + minted, ascending)."""
        return self._sizes

    def export(self) -> List[int]:
        """The ladder as a warm-startable list (a ``bucket_ladders``
        value)."""
        return list(self._sizes)

    def _aligned(self, n: int) -> int:
        return n + (-n) % self.align

    def _room(self) -> bool:
        return self.budget <= 0 or len(self._sizes) < self.budget

    def _mint(self, n: int) -> None:
        n = self._aligned(n)
        if n in self._sizes or n <= 0 or not self._room():
            return
        with self._lock:
            self._minted.add(n)
            self._sizes = tuple(sorted(set(self.base) | self._minted))
        if self._minted_metric:
            metrics.count(self._minted_metric)

    def observe(self, n: int) -> None:
        """Record one drain's occupancy; mint an exact (aligned) bucket
        once the same padded occupancy has repeated ``mint_after`` times."""
        want = self._aligned(n)
        if want in self._sizes:
            return  # no pad at this occupancy: nothing to refine
        c = self._counts.get(want, 0) + 1
        self._counts[want] = c
        if c >= self.mint_after:
            del self._counts[want]
            self._mint(want)

    def bucket_for(self, n: int) -> int:
        """Observe ``n`` and return its bucket under the CURRENT ladder (a
        mint applies from the next drain on)."""
        sizes = self._sizes
        self.observe(n)
        return bucket_for(n, sizes)


def shard_bucket_for(n: int, replicas: int,
                     buckets: Optional[Sequence[int]] = None) -> int:
    """Bucket for a batch split over ``replicas``: the ladder bucket,
    rounded up to a multiple of the replica count so every replica gets
    the same number of rows (one captured step per bucket and slot, not
    per remainder)."""
    b = bucket_for(n, buckets)
    return b + (-b) % max(1, replicas)


def split_runs(n: int, parts: int) -> List[int]:
    """``n`` rows over ``parts`` slots in contiguous runs, the first
    ``n % parts`` one row longer."""
    q, r = divmod(n, max(1, parts))
    return [q + (1 if i < r else 0) for i in range(max(1, parts))]


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def _row_signature(row: Sequence[torch.Tensor]) -> Tuple:
    return tuple((tuple(t.shape), str(t.dtype)) for t in row)


class _BucketSet:
    """The static ``[bucket, ...]`` inputs of one (bucket, row signature)
    and its captured vmapped step (in sharded mode: one slot's rows of the
    bucket, on the slot's device and stream)."""

    def __init__(self, runner: "BatchRunner", key, bucket: int, rows,
                 fn=None, slot=None):
        dev = slot.device if slot is not None else runner.census.device
        self.bucket = bucket
        self.inputs = [torch.empty((bucket, *t.shape), dtype=t.dtype, device=dev)
                       for t in rows[0]]
        self.outputs: Tuple = ()
        self.fill(rows)
        vfn = torch.func.vmap(fn if fn is not None else runner.fn)

        def step():
            self.outputs = vfn(tuple(self.inputs))

        self.step = runner.census.capture(
            key, step, kind="batch", rows=bucket,
            stream=slot.stream if slot is not None else None)

    def fill(self, rows) -> None:
        n = len(rows)
        for t, dst in enumerate(self.inputs):
            col = [r[t] for r in rows]
            on_card = [c.is_cuda for c in col]
            if not dst.is_cuda or all(on_card):
                # one stack (a card column: one launch, not n copies)
                torch.stack(col, out=dst[:n])
            elif any(on_card):  # a mixed column: each row by itself
                for i, c in enumerate(col):
                    dst[i].copy_(c)
            else:  # host rows: stacked into pinned memory, one copy up
                host = torch.empty((n, *dst.shape[1:]), dtype=dst.dtype,
                                   pin_memory=True)
                torch.stack(col, out=host)
                dst[:n].copy_(host, non_blocking=True)
        if n < self.bucket:  # pad rows repeat the last real row
            for dst in self.inputs:
                dst[n:].copy_(dst[n - 1:n].expand_as(dst[n:]))


class BatchRunner:
    """A stage's bucket steps: ``torch.func.vmap(fn)`` captured once per
    (bucket, row signature) through ``census`` (the stage's own; None:
    one on the device of the first rows it is given)."""

    def __init__(self, fn: Callable, buckets: Optional[Sequence[int]] = None,
                 name: Optional[str] = None,
                 ladder: Optional[AdaptiveLadder] = None,
                 census: Optional[Census] = None, mesh=None,
                 prepare: Optional[Callable] = None):
        self.fn = fn
        self.buckets = tuple(sorted(set(buckets))) if buckets else None
        #: adaptive mode: the stage's AdaptiveLadder rounds (and observes
        #: every drain) in place of the static bucket list
        self.ladder = ladder
        self.census = census
        self._sets: Dict[Tuple, _BucketSet] = {}
        self._pad_metric = f"{name}.batch_pad_waste" if name else None
        self._waste_flops_metric = f"{name}.pad_waste_flops" if name else None
        self._shard_metric = f"{name}.shard_rows" if name else None
        self._dispatch_metric = f"{name}.shard_dispatch" if name else None
        #: sharded mode (a mesh with a data or model axis over 1): the
        #: mesh, its data width (``replicas``) and model width
        self.mesh = None
        self.replicas = 1
        self.model_axis = 1
        self._coords = None
        if mesh is not None:
            from ..parallel.mesh import device_coords, mesh_axis_size

            d = mesh_axis_size(mesh, "data")
            m = mesh_axis_size(mesh, "model")
            # a (1, 1) mesh is the unsharded path; a model axis over 1
            # engages the sharded path at data 1 too (the stage's params
            # are placed over ``model``)
            if d > 1 or m > 1:
                self.mesh = mesh
                self.replicas = d
                self.model_axis = m
                if m > 1:
                    self._coords = device_coords(mesh)
        #: ``prepare(mesh) -> slot_fn`` places the stage's params once,
        #: before the first sharded dispatch; ``slot_fn(slot)`` gives that
        #: slot's callable (None: ``fn`` on every slot)
        self._prepare = prepare
        self._slot_fns = None

    def dispatch(self, rows: List[Sequence]) -> Tuple[torch.Tensor, ...]:
        """Run per-buffer input rows as one replay of their bucket's step;
        returns the step's outputs cut to the real rows (``[n, ...]``
        views, valid until that step replays again: copy them before
        queuing the next dispatch).  Sharded: tensors of their own on the
        root slot's device."""
        rows = [tuple(_as_tensor(x) for x in r) for r in rows]
        if self.mesh is not None:
            return self._dispatch_sharded(rows)
        n = len(rows)
        bucket = (self.ladder.bucket_for(n) if self.ladder is not None
                  else bucket_for(n, self.buckets))
        if self.census is None:
            first = rows[0][0]
            self.census = Census(first.device if first.is_cuda else "cpu")
        key = (bucket, _row_signature(rows[0]))
        st = self._sets.get(key)
        if st is None:
            st = self._sets[key] = _BucketSet(self, key, bucket, rows)
        else:
            st.fill(rows)
        st.step.replay()
        if bucket > n and self._pad_metric:
            metrics.count(self._pad_metric, bucket - n)
            tr = st.step.track
            if tr is not None and tr.flops and self._waste_flops_metric:
                # xray: the pad rows priced in FLOPs, the bucket step's
                # count split per row
                metrics.count(self._waste_flops_metric,
                              tr.flops * (bucket - n) / bucket)
        return tuple(o[:n] for o in st.outputs)

    # -- sharded dispatch --------------------------------------------------
    def _placed(self):
        """Each mesh slot's callable, the stage's params placed on the
        first call."""
        if self._slot_fns is None:
            slot_fn = self._prepare(self.mesh) if self._prepare is not None else None
            self._slot_fns = [slot_fn(s) if slot_fn is not None else self.fn
                              for s in self.mesh.flat]
        return self._slot_fns

    def _dispatch_sharded(self, rows: List[Tuple]) -> Tuple[torch.Tensor, ...]:
        n = len(rows)
        fns = self._placed()
        if self.census is None:
            self.census = Census(self.mesh.root.device)
        if self.ladder is not None:
            # minted sizes are replica-aligned (AdaptiveLadder.align): the
            # rounding below leaves them as they are
            self.ladder.observe(n)
            sizes = self.ladder.sizes()
        else:
            sizes = self.buckets
        bucket = shard_bucket_for(n, self.replicas, sizes)
        # every slot's step runs at the one-slot bucket's row count, its
        # own rows first: a kernel that picks its algorithm by the row
        # count (a CPU GEMM, cuDNN) then computes each row as the
        # one-slot step does, bit for bit
        full = bucket_for(n, sizes)
        if bucket > n:
            rows = rows + [rows[-1]] * (bucket - n)  # pad rows repeat the last
            if self._pad_metric:
                metrics.count(self._pad_metric, bucket - n)
        per = bucket // self.replicas
        sig = _row_signature(rows[0])
        flat = self.mesh.flat
        runs = []  # (slot index, first row, rows)
        for di in range(self.replicas):
            start = di * per
            for mi, k in enumerate(split_runs(per, self.model_axis)):
                if k:
                    runs.append((di * self.model_axis + mi, start, k))
                start += k
        sets = []
        for i, start, k in runs:
            slot = flat[i]
            key = (bucket, full, sig, slot.id)
            st = self._sets.get(key)
            if st is None:
                st = self._sets[key] = _BucketSet(
                    self, key, full, rows[start:start + k], fn=fns[i], slot=slot)
            else:
                st.fill(rows[start:start + k])
            sets.append((slot, st))
        # every slot's replay on its own stream, then one join: the
        # slots' steps overlap (on one card too)
        for _, st in sets:
            st.step.launch()
        for _, st in sets:
            st.step.join()
        if self._dispatch_metric:
            metrics.count(self._dispatch_metric)
            for (i, _, k), (slot, _) in zip(runs, sets):
                if self._coords is None:
                    key = f"{self._shard_metric}.d{slot.id}"
                else:
                    di, mi = self._coords[slot.id]
                    key = f"{self._shard_metric}.d{di}m{mi}"
                metrics.count(key, k)
        root = self.mesh.root.device
        outs = []
        for t in range(len(sets[0][1].outputs)):
            parts = [st.outputs[t][:k] if st.outputs[t].device == root
                     else st.outputs[t][:k].to(root)
                     for (_, _, k), (_, st) in zip(runs, sets)]
            outs.append(torch.cat(parts, dim=0)[:n])
        return tuple(outs)

    def run(self, rows: List[Sequence]) -> List[Tuple]:
        """Per-buffer input rows -> one output row per input row, in order,
        each a view of tensors of its own (one copy per output tensor)."""
        outs = self.dispatch(rows)
        if self.mesh is not None:  # already tensors of their own
            return split_rows(list(outs), len(rows))
        return split_rows([o.clone() for o in outs], len(rows))
