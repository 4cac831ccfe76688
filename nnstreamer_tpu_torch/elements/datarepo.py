"""datareposrc / datareposink: file-backed training datasets.

Port of ``nnstreamer_tpu/elements/datarepo.py``: the same meta and data
files, byte for byte, and the same per-epoch shuffle, so a set written
by either package replays through the other in the same order.  Tensors
on the card are copied to the host as they are written (bf16 as its
2-byte words); a bf16 sample is read back as a torch bf16 tensor.

Reference analog: ``gst/datarepo/gstdatareposrc.c`` / ``gstdatareposink.c``
(SURVEY §2.8, upstream-reconstructed): raw fixed-size samples in one binary
file described by a small JSON meta (the reference stores ``gst_caps``,
``total_samples``, ``sample_size``), with ``start-sample-index`` /
``stop-sample-index`` / ``epochs`` / ``is-shuffle`` dataset iteration —
that plus trainer ``model-save-path`` is the reference's whole
checkpoint/resume story (SURVEY §5.4).

JSON meta here::

    {"dims": "4:1,1:1", "types": "float32,int32",
     "total_samples": 120, "sample_size": 20}

(dims/types are our caps-string equivalents of ``gst_caps``; sample_size is
the byte length of one sample = all tensors concatenated.)

Manifest file lists (nns-learn, docs/TRAINING.md): the meta may carry a
``"files"`` list instead of a single ``location`` data file::

    {"dims": "4,1", "types": "float32,int32", "sample_size": 20,
     "files": ["shard0.bin", "shard1.bin"]}

Relative entries resolve against the meta's own directory; each file must
hold a whole number of samples and the dataset is their concatenation in
list order — the replay contract for a ``datareposink``-captured stream
split across shards.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, Optional, Union

import numpy as np
import torch

from ..core.buffer import Buffer, Event
from ..core.caps import Caps
from ..core.registry import register_element
from ..core.types import TensorsSpec, dtype_name
from ..utils.wire import _host_payload
from .base import ElementError, Out, SinkElement, SourceElement


def _sample_tensor(raw: np.ndarray, spec):
    """One tensor of a sample: a view of the mapped file, or for bf16 a
    torch tensor over a copy of its 2-byte words."""
    if dtype_name(spec.dtype) == "bfloat16":
        words = torch.from_numpy(raw.view(np.int16).copy())
        return words.view(torch.bfloat16).reshape(spec.shape)
    return raw.view(spec.dtype).reshape(spec.shape)


@register_element("datareposrc")
class DataRepoSrc(SourceElement):
    """Reads (input, label) samples from a binary file + JSON meta.

    Props: ``location`` (data file; optional when the meta carries a
    ``files`` manifest list), ``json`` (meta file),
    ``start-sample-index``, ``stop-sample-index`` (inclusive; -1 = last),
    ``epochs`` (dataset repetitions; each epoch re-emits the samples — the
    reference drives multi-epoch training this way), ``is-shuffle``
    (per-epoch deterministic shuffle: epoch k's order is a pure function
    of ``(shuffle-seed, k)``, so replays reproduce exactly while every
    epoch still sees a DIFFERENT order), ``shuffle-seed`` (default 0).
    """

    kind = "datareposrc"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.location = str(self.props.get("location", ""))
        self.json_path = str(self.props.get("json", ""))
        self.start_idx = int(self.props.get("start_sample_index", 0))
        self.stop_idx = int(self.props.get("stop_sample_index", -1))
        self.epochs = int(self.props.get("epochs", 1))
        self.shuffle = str(self.props.get("is_shuffle", "false")).lower() in (
            "true",
            "1",
            "yes",
        )
        self.shuffle_seed = int(self.props.get("shuffle_seed", 0))
        self.spec: Optional[TensorsSpec] = None
        self._meta = None
        self._files: List[str] = []

    def _load_meta(self):
        if self._meta is not None:
            return
        if not self.json_path:
            raise ElementError("datareposrc requires json= meta path")
        with open(self.json_path, "r") as f:
            self._meta = json.load(f)
        self.spec = TensorsSpec.from_string(
            self._meta["dims"], self._meta.get("types", "uint8")
        )
        expect = sum(s.nbytes for s in self.spec)
        size = int(self._meta.get("sample_size", expect))
        if size != expect:
            raise ElementError(
                f"datarepo meta sample_size={size} != spec bytes {expect}"
            )
        files = self._meta.get("files")
        if files:
            base = os.path.dirname(os.path.abspath(self.json_path))
            self._files = [
                f if os.path.isabs(f) else os.path.join(base, f)
                for f in files
            ]
        elif self.location:
            self._files = [self.location]
        else:
            raise ElementError(
                "datareposrc needs location= or a 'files' manifest list "
                "in the json meta")

    def configure(self, in_caps, out_pads):
        self._load_meta()
        caps = Caps.tensors(self.spec)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    def generate(self) -> Iterator[Union[Buffer, Event]]:
        self._load_meta()
        sample_size = sum(s.nbytes for s in self.spec)
        # Memory-map the dataset: samples are zero-copy views into the OS
        # page cache (the reference's C reader streams from the file; a
        # Python read() would materialize the WHOLE set in process RAM and
        # copy every sample).  Views stay valid while the mappings are
        # held.  With a manifest ``files`` list the dataset is the
        # concatenation of the shards, each holding whole samples.
        sizes = [os.path.getsize(f) for f in self._files]
        for f, fsize in zip(self._files, sizes):
            if fsize % sample_size:
                raise ElementError(
                    f"datarepo shard {f} holds {fsize} bytes — not a "
                    f"whole number of {sample_size}-byte samples")
        file_samples = [fsize // sample_size for fsize in sizes]
        avail = sum(file_samples)
        total = int(self._meta.get("total_samples", avail))
        stop = total - 1 if self.stop_idx < 0 else min(self.stop_idx, total - 1)
        # Size check BEFORE the empty-file return: a truncated/zero file
        # whose meta still claims samples must error, not yield nothing.
        if stop + 1 > avail:
            raise ElementError(
                f"datarepo file(s) holds {sum(sizes)} bytes; meta claims "
                f"{total} samples of {sample_size}")
        indices = list(range(self.start_idx, stop + 1))
        if not indices or avail == 0:
            return  # empty dataset (mmap of an empty file is an error)
        maps = [np.memmap(f, dtype=np.uint8, mode="r")
                for f, fsize in zip(self._files, sizes) if fsize]
        # global sample index -> (mapping, local offset)
        starts: List[int] = []
        acc = 0
        for n in file_samples:
            if n:
                starts.append(acc)
                acc += n
        import bisect

        for epoch in range(self.epochs):
            order = list(indices)
            if self.shuffle:
                # epoch k's order is a pure function of (seed, k):
                # deterministic replay across runs, different order per
                # epoch — the reference's is-shuffle semantics
                np.random.default_rng(
                    (self.shuffle_seed, epoch)).shuffle(order)
            for i in order:
                fi = bisect.bisect_right(starts, i) - 1
                off = (i - starts[fi]) * sample_size
                data = maps[fi]
                tensors: List[np.ndarray] = []
                pos = off
                for s in self.spec:
                    n = s.nbytes
                    tensors.append(_sample_tensor(data[pos : pos + n], s))
                    pos += n
                yield Buffer(tensors, spec=self.spec, meta={"sample_index": i, "epoch": epoch})


@register_element("datareposink")
class DataRepoSink(SinkElement):
    """Writes incoming sample buffers to a binary file + JSON meta at EOS.

    Props: ``location``, ``json``, ``manifest`` (``true`` = the meta
    also lists the data file under ``files`` — a standalone manifest a
    ``datareposrc json=`` replays with no ``location=`` prop, the
    capture→replay contract for training on recorded live streams,
    docs/TRAINING.md).
    """

    kind = "datareposink"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.location = str(self.props.get("location", ""))
        self.json_path = str(self.props.get("json", ""))
        self.manifest = str(self.props.get("manifest", "false")).lower() in (
            "true", "1", "yes")
        self._f = None
        self._count = 0
        self._spec: Optional[TensorsSpec] = None

    def start(self) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.location)) or ".", exist_ok=True)
        self._f = open(self.location, "wb")
        self._count = 0

    def process(self, pad: str, buf: Buffer) -> Out:
        buf = buf.resolve()
        if self._spec is None:
            self._spec = buf.spec
        for t in buf.tensors:
            self._f.write(_host_payload(t)[2])
        self._count += 1
        return []

    def finalize(self) -> Out:
        self._write_meta()
        return []

    def stop(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def _write_meta(self) -> None:
        if self._f is not None:
            self._f.flush()
        if not self.json_path or self._spec is None:
            return
        sample_size = sum(s.nbytes for s in self._spec)
        meta = {
            "dims": ",".join(
                ":".join(str(d) for d in s.dims) for s in self._spec
            ),
            "types": ",".join(dtype_name(s.dtype) for s in self._spec),
            "total_samples": self._count,
            "sample_size": sample_size,
        }
        if self.manifest:
            # relative to the meta's directory when co-located (the
            # datareposrc resolution rule — the pair stays relocatable),
            # absolute otherwise; either way the captured set replays by
            # json= alone
            base = os.path.dirname(os.path.abspath(self.json_path))
            loc = os.path.abspath(self.location)
            meta["files"] = [os.path.basename(loc)
                             if os.path.dirname(loc) == base else loc]
        with open(self.json_path, "w") as f:
            json.dump(meta, f)
