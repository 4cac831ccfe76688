"""Minimal .tflite flatbuffer WRITER — test fixtures and simple exports.

A copy of ``nnstreamer_tpu/models/tflite_build.py`` (pure numpy, no
framework): the same writer emits the same bytes for the same model, so
a file written by either package loads in both.  The ingestion path
(``models/tflite.py``) needs real .tflite bytes to parse, and no
TensorFlow is at hand to produce them, so this module emits them
directly (the flatbuffer wire format and the tflite schema are both
public).  It writes bottom-up exactly like the official flatbuffer
builder: bytes are PREPENDED, positions are tracked as offsets from the
buffer END, and uoffset/soffset values fall out as simple differences of
those offsets.

Only the subset the supported operator set needs: tables with scalar and
offset fields, typed vectors, strings.  ``tests/test_torch_tflite.py``
builds its fixture graphs with :class:`ModelWriter`.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class Writer:
    def __init__(self):
        self.buf = bytearray()

    # -- primitives --------------------------------------------------------
    def _prepend(self, data: bytes) -> int:
        """Prepend raw bytes; return offset-from-end of their start."""
        self.buf[:0] = data
        return len(self.buf)

    def _align(self, size: int, extra: int = 0) -> None:
        """Pad so the NEXT ``extra``-byte prepend ends ``size``-aligned."""
        while (len(self.buf) + extra) % size:
            self.buf[:0] = b"\x00"

    def _uoffset_value(self, target: int) -> int:
        """uoffset stored at the position about to be written (4 bytes)."""
        return (len(self.buf) + 4) - target

    # -- vectors / strings -------------------------------------------------
    def vector_scalar(self, fmt: str, values: Sequence) -> int:
        """Typed vector (e.g. fmt '<i' for int32); returns its offset."""
        elem = struct.calcsize(fmt)
        payload = b"".join(struct.pack(fmt, v) for v in values)
        self._align(4, extra=len(payload) + 4)
        self._prepend(payload)
        return self._prepend(struct.pack("<I", len(values)))

    def vector_bytes(self, data: bytes) -> int:
        self._align(4, extra=len(data) + 4)
        self._prepend(bytes(data))
        return self._prepend(struct.pack("<I", len(data)))

    def string(self, s: str) -> int:
        raw = s.encode("utf-8") + b"\x00"
        self._align(4, extra=len(raw) + 4)
        self._prepend(raw)
        return self._prepend(struct.pack("<I", len(raw) - 1))

    def vector_offsets(self, targets: Sequence[int]) -> int:
        """Vector of uoffsets to already-written tables/strings."""
        self._align(4, extra=4 * len(targets) + 4)
        for t in reversed(targets):
            self._prepend(struct.pack("<I", self._uoffset_value(t)))
        return self._prepend(struct.pack("<I", len(targets)))

    # -- tables ------------------------------------------------------------
    def table(self, scalars: Dict[int, Tuple[str, object]] = None,
              offsets: Dict[int, int] = None) -> int:
        """Write a table.

        ``scalars``: field id -> (struct fmt, value); ``offsets``: field id
        -> offset-from-end of an already-written child.  Fields equal to
        schema defaults should simply be omitted by the caller.
        """
        scalars = dict(scalars or {})
        offsets = dict(offsets or {})
        field_off: Dict[int, int] = {}
        # Fields in descending id order (layout order is arbitrary; the
        # vtable records wherever each lands).
        for fid in sorted(set(scalars) | set(offsets), reverse=True):
            if fid in scalars:
                fmt, v = scalars[fid]
                size = struct.calcsize(fmt)
                self._align(size, extra=size)
                field_off[fid] = self._prepend(struct.pack(fmt, v))
            else:
                self._align(4, extra=4)
                field_off[fid] = self._prepend(
                    struct.pack("<I", self._uoffset_value(offsets[fid])))
        self._align(4, extra=4)
        table_off = self._prepend(struct.pack("<i", 0))  # soffset patched below
        n_fields = (max(field_off) + 1) if field_off else 0
        vsize = 4 + 2 * n_fields
        tsize = (table_off - min(field_off.values())) if field_off else 4
        entries = b"".join(
            struct.pack("<H", table_off - field_off[i] if i in field_off else 0)
            for i in range(n_fields))
        self._align(2, extra=vsize)
        vt_off = self._prepend(
            struct.pack("<HH", vsize, tsize) + entries)
        # soffset: table_pos - vtable_pos == vt_off - table_off
        idx = len(self.buf) - table_off
        struct.pack_into("<i", self.buf, idx, vt_off - table_off)
        return table_off

    def finish(self, root: int, file_id: bytes = b"TFL3") -> bytes:
        self._align(4, extra=8)
        self._prepend(file_id)
        self._prepend(struct.pack("<I", self._uoffset_value(root)))
        return bytes(self.buf)


# ---------------------------------------------------------------------------
# tflite model assembly
# ---------------------------------------------------------------------------

_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.int32): 2,
                np.dtype(np.uint8): 3, np.dtype(np.int64): 4,
                np.dtype(np.int8): 9}

_PAD_CODES = {"SAME": 0, "VALID": 1}
_ACT_CODES = {None: 0, "relu": 1, "relu6": 3, "tanh": 4}
_OP_CODES = {"ADD": 0, "AVERAGE_POOL_2D": 1, "CONCATENATION": 2,
             "CONV_2D": 3, "DEPTHWISE_CONV_2D": 4, "FULLY_CONNECTED": 9,
             "LOGISTIC": 14, "MAX_POOL_2D": 17, "MUL": 18, "RELU": 19,
             "RELU6": 21, "RESHAPE": 22, "RESIZE_BILINEAR": 23,
             "SOFTMAX": 25, "SPACE_TO_DEPTH": 26, "TANH": 28, "PAD": 34,
             "TRANSPOSE": 39, "MEAN": 40, "SUB": 41, "DIV": 42,
             "SQUEEZE": 43}


class ModelWriter:
    """Assemble a single-subgraph float32 tflite model op by op.

    >>> mw = ModelWriter()
    >>> x = mw.add_input([1, 8, 8, 3])
    >>> w = mw.add_const(np.zeros((4, 3, 3, 3), np.float32))
    >>> y = mw.add_op("CONV_2D", [x, w], out_shape=[1, 4, 4, 4],
    ...               options={"padding": "SAME", "stride": (2, 2)})
    >>> blob = mw.finish(outputs=[y])
    """

    def __init__(self):
        self.tensors: List[Tuple[List[int], np.dtype, str, int]] = []
        self.buffers: List[Optional[bytes]] = [None]  # buffer 0 = empty
        self.inputs: List[int] = []
        self.ops: List[Tuple[str, List[int], List[int], Dict]] = []

    def _tensor(self, shape, dtype, name, data: Optional[np.ndarray],
                quant: Optional[Dict] = None) -> int:
        if data is not None:
            self.buffers.append(np.ascontiguousarray(data).tobytes())
            bufidx = len(self.buffers) - 1
        else:
            bufidx = 0
        self.tensors.append(
            (list(shape), np.dtype(dtype), name, bufidx, quant))
        return len(self.tensors) - 1

    def add_input(self, shape, dtype=np.float32, name="input",
                  quant_scale: Optional[Sequence[float]] = None,
                  quant_zero_point: Optional[Sequence[int]] = None) -> int:
        quant = None
        if quant_scale:
            quant = {"scale": list(quant_scale)}
            if quant_zero_point:
                quant["zero_point"] = [int(z) for z in quant_zero_point]
        idx = self._tensor(shape, dtype, name, None, quant)
        self.inputs.append(idx)
        return idx

    def add_const(self, array: np.ndarray, name="const",
                  quant_scale: Optional[Sequence[float]] = None,
                  quant_zero_point: Optional[Sequence[int]] = None,
                  quant_axis: int = 0) -> int:
        """``quant_scale``/``quant_zero_point``/``quant_axis`` write a
        QuantizationParameters table (per-tensor or per-axis) — exercised
        by the reader's weight dequantization and the quantized-activation
        IO contract."""
        quant = None
        if quant_scale:
            quant = {"scale": list(quant_scale), "axis": int(quant_axis)}
            if quant_zero_point:
                quant["zero_point"] = [int(z) for z in quant_zero_point]
        return self._tensor(array.shape, array.dtype, name, array, quant)

    def add_op(self, kind: str, inputs: List[int], out_shape,
               out_dtype=np.float32, options: Optional[Dict] = None,
               quant_scale: Optional[Sequence[float]] = None,
               quant_zero_point: Optional[Sequence[int]] = None) -> int:
        """``quant_scale``/``quant_zero_point`` annotate the op's OUTPUT
        activation — with an integer ``out_dtype`` this is how a
        fully-quantized graph's interior is written."""
        quant = None
        if quant_scale:
            quant = {"scale": list(quant_scale)}
            if quant_zero_point:
                quant["zero_point"] = [int(z) for z in quant_zero_point]
        out = self._tensor(out_shape, out_dtype, f"{kind.lower()}_out",
                           None, quant)
        self.ops.append((kind, list(inputs), [out], dict(options or {})))
        return out

    # -- serialization -----------------------------------------------------
    @staticmethod
    def _options(w: Writer, kind: str, o: Dict) -> Tuple[int, Optional[int]]:
        """Returns (builtin_options_type enum, options table offset)."""
        act = _ACT_CODES[o.get("act")]
        pad = _PAD_CODES[o.get("padding", "SAME")]
        sh, sw = o.get("stride", (1, 1))
        if kind == "CONV_2D":
            return 1, w.table(scalars={0: ("<b", pad), 1: ("<i", sw),
                                       2: ("<i", sh), 3: ("<b", act)})
        if kind == "DEPTHWISE_CONV_2D":
            return 2, w.table(scalars={0: ("<b", pad), 1: ("<i", sw),
                                       2: ("<i", sh),
                                       3: ("<i", o.get("multiplier", 1)),
                                       4: ("<b", act)})
        if kind in ("AVERAGE_POOL_2D", "MAX_POOL_2D"):
            fh, fw = o["filter"]
            return 5, w.table(scalars={0: ("<b", pad), 1: ("<i", sw),
                                       2: ("<i", sh), 3: ("<i", fw),
                                       4: ("<i", fh), 5: ("<b", act)})
        if kind == "FULLY_CONNECTED":
            return 8, w.table(scalars={0: ("<b", act)})
        if kind == "SOFTMAX":
            return 9, w.table(scalars={0: ("<f", o.get("beta", 1.0))})
        if kind == "RESHAPE":
            if "new_shape" in o:
                vec = w.vector_scalar("<i", o["new_shape"])
                return 17, w.table(offsets={0: vec})
            return 17, None
        if kind == "ADD":
            return 11, w.table(scalars={0: ("<b", act)})
        if kind == "MUL":
            return 21, w.table(scalars={0: ("<b", act)})
        if kind == "SUB":
            return 28, w.table(scalars={0: ("<b", act)})
        if kind == "DIV":
            return 29, w.table(scalars={0: ("<b", act)})
        if kind == "TRANSPOSE":
            return 26, w.table()
        if kind == "SPACE_TO_DEPTH":
            return 19, w.table(scalars={0: ("<i", o["block"])})
        if kind == "RESIZE_BILINEAR":
            return 15, w.table(scalars={
                2: ("<B", 1 if o.get("align_corners") else 0),
                3: ("<B", 1 if o.get("half_pixel") else 0)})
        if kind == "CONCATENATION":
            return 10, w.table(scalars={0: ("<i", o.get("axis", 0)),
                                        1: ("<b", act)})
        if kind == "MEAN":
            return 27, w.table(scalars={0: ("<b", 1 if o.get("keep_dims") else 0)})
        if kind == "SQUEEZE":
            if "squeeze_dims" in o:
                vec = w.vector_scalar("<i", o["squeeze_dims"])
                return 30, w.table(offsets={0: vec})
            return 30, None
        if o:
            raise ValueError(
                f"{kind}: options {sorted(o)} given but this writer emits "
                "no options table for the op — they would be silently lost")
        return 0, None

    def finish(self, outputs: List[int]) -> bytes:
        w = Writer()
        # op codes, deduped, in first-use order
        kinds = []
        for kind, *_ in self.ops:
            if kind not in kinds:
                kinds.append(kind)
        opcode_tabs = []
        for kind in kinds:
            code = _OP_CODES[kind]
            # write both the deprecated byte field and the int32 field the
            # way current TF exports do
            opcode_tabs.append(w.table(
                scalars={0: ("<b", min(code, 127)), 3: ("<i", code)}))
        opcodes_vec = w.vector_offsets(opcode_tabs)

        buffer_tabs = []
        for data in self.buffers:
            if data is None:
                buffer_tabs.append(w.table())
            else:
                buffer_tabs.append(w.table(offsets={0: w.vector_bytes(data)}))
        buffers_vec = w.vector_offsets(buffer_tabs)

        tensor_tabs = []
        for shape, dtype, name, bufidx, quant in self.tensors:
            shape_vec = w.vector_scalar("<i", shape)
            name_off = w.string(name)
            offs = {0: shape_vec, 3: name_off}
            if quant is not None:
                q_offs = {2: w.vector_scalar("<f", quant["scale"])}
                if quant.get("zero_point"):
                    q_offs[3] = w.vector_scalar("<q", quant["zero_point"])
                q_scal = {}
                if quant.get("axis"):
                    q_scal[6] = ("<i", quant["axis"])
                offs[4] = w.table(scalars=q_scal, offsets=q_offs)
            tensor_tabs.append(w.table(
                scalars={1: ("<b", _DTYPE_CODES[dtype]),
                         2: ("<I", bufidx)},
                offsets=offs))
        tensors_vec = w.vector_offsets(tensor_tabs)

        op_tabs = []
        for kind, ins, outs, opts in self.ops:
            in_vec = w.vector_scalar("<i", ins)
            out_vec = w.vector_scalar("<i", outs)
            otype, otab = self._options(w, kind, opts)
            offs = {1: in_vec, 2: out_vec}
            scal = {0: ("<I", kinds.index(kind))}
            if otab is not None:
                scal[3] = ("<B", otype)
                offs[4] = otab
            op_tabs.append(w.table(scalars=scal, offsets=offs))
        ops_vec = w.vector_offsets(op_tabs)

        in_vec = w.vector_scalar("<i", self.inputs)
        out_vec = w.vector_scalar("<i", outputs)
        sg = w.table(offsets={0: tensors_vec, 1: in_vec, 2: out_vec,
                              3: ops_vec})
        sg_vec = w.vector_offsets([sg])
        desc = w.string("nnstreamer_tpu tflite_build")
        model = w.table(scalars={0: ("<I", 3)},
                        offsets={1: opcodes_vec, 2: sg_vec, 3: desc,
                                 4: buffers_vec})
        return w.finish(model)
