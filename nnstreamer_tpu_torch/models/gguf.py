"""GGUF model-file reader and writer: llama.cpp's checkpoint format <->
name->tensor dict.

Port of ``nnstreamer_tpu/models/gguf.py``.  The container is public and
simple: a little-endian header (magic "GGUF", version, tensor count, kv
count), typed metadata key-values, tensor descriptors (name, dims in ggml
fastest-first order, ggml type, data offset), then an aligned data blob.
The UNQUANTIZED types (F32/F16/BF16 and the integer types) load as CPU
tensors over numpy memmaps; k-quant block formats raise a clear error
naming the tensor and type.

BF16 (ggml type 30) is read as ``uint16`` and reinterpreted as
``torch.bfloat16``, and written from a torch bf16 tensor's raw 16 bits,
so it needs no numpy bfloat16 type (``ml_dtypes``).

``llama.load_checkpoint`` routes ``.gguf`` through here: tensor names map
from llama.cpp's ``blk.N.attn_q.weight`` convention, the model config is
read from the ``llama.*`` metadata keys, and q/k weights are re-laid from
ggml's interleaved-pair RoPE convention into the rotate-half layout
models/llama.py computes with.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Tuple

import numpy as np
import torch

from .checkpoint import as_tensor, host_bytes, memmap_tensor


class GGUFError(ValueError):
    pass


_MAGIC = 0x46554747  # "GGUF"

#: ggml type id -> (numpy dtype of the stored bytes, torch dtype) for the
#: UNQUANTIZED types
_GGML_DTYPES = {0: (np.float32, torch.float32), 1: (np.float16, torch.float16),
                24: (np.int8, torch.int8), 25: (np.int16, torch.int16),
                26: (np.int32, torch.int32), 27: (np.int64, torch.int64),
                28: (np.float64, torch.float64),
                30: (np.uint16, torch.bfloat16)}
_GGML_TYPES = {tdt: code for code, (_, tdt) in _GGML_DTYPES.items()}

_GGML_QUANT_NAMES = {2: "Q4_0", 3: "Q4_1", 6: "Q5_0", 7: "Q5_1",
                     8: "Q8_0", 9: "Q8_1", 10: "Q2_K", 11: "Q3_K",
                     12: "Q4_K", 13: "Q5_K", 14: "Q6_K", 15: "Q8_K"}


class _Reader:
    def __init__(self, f, size: int):
        self.f = f
        self.size = size

    def _read(self, n: int) -> bytes:
        data = self.f.read(n)
        if len(data) != n:
            raise GGUFError(
                f"{self.f.name}: truncated GGUF (wanted {n} bytes at "
                f"offset {self.f.tell() - len(data)}, file is "
                f"{self.size} bytes)")
        return data

    def u32(self):
        return struct.unpack("<I", self._read(4))[0]

    def u64(self):
        return struct.unpack("<Q", self._read(8))[0]

    def s(self):
        n = self.u64()
        if n > self.size:
            raise GGUFError(
                f"{self.f.name}: corrupt GGUF (string length {n} exceeds "
                f"file size {self.size})")
        return self._read(n).decode("utf-8", "replace")

    _SCALARS = {0: ("<B", 1), 1: ("<b", 1), 2: ("<H", 2), 3: ("<h", 2),
                4: ("<I", 4), 5: ("<i", 4), 6: ("<f", 4), 7: ("<B", 1),
                10: ("<Q", 8), 11: ("<q", 8), 12: ("<d", 8)}

    def value(self, vtype: int):
        if vtype in self._SCALARS:
            fmt, size = self._SCALARS[vtype]
            v = struct.unpack(fmt, self._read(size))[0]
            return bool(v) if vtype == 7 else v
        if vtype == 8:
            return self.s()
        if vtype == 9:  # array
            et = self.u32()
            n = self.u64()
            return [self.value(et) for _ in range(n)]
        raise GGUFError(f"unknown metadata value type {vtype}")


def _read_header(path: str, r: "_Reader") -> Tuple[int, Dict]:
    """magic + version + counts + key-value section, shared by
    :func:`read` and :func:`read_metadata`.  Returns (n_tensors, meta)
    with the reader positioned at the tensor-descriptor table."""
    if r.u32() != _MAGIC:
        raise GGUFError(f"{path}: not a GGUF file (bad magic)")
    version = r.u32()
    if version not in (2, 3):
        raise GGUFError(f"{path}: unsupported GGUF version {version}")
    n_tensors = r.u64()
    n_kv = r.u64()
    meta: Dict = {}
    for _ in range(n_kv):
        key = r.s()
        vtype = r.u32()
        meta[key] = r.value(vtype)
    return n_tensors, meta


def read_metadata(path: str) -> Dict:
    """Parse only the header + key-value section (no tensor descriptors):
    the cheap path for vocab/config sniffing (models/tokenizer.py)."""
    with open(path, "rb") as f:
        _, meta = _read_header(path, _Reader(f, os.path.getsize(path)))
        return meta


def read(path: str) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """Returns (metadata, tensors).  Tensors are CPU tensors over memmaps,
    shaped outermost-first — ggml dims are stored fastest-first, so they
    are reversed here."""
    with open(path, "rb") as f:
        r = _Reader(f, os.path.getsize(path))
        n_tensors, meta = _read_header(path, r)
        infos = []
        for _ in range(n_tensors):
            name = r.s()
            n_dims = r.u32()
            dims = [r.u64() for _ in range(n_dims)]
            ggml_type = r.u32()
            offset = r.u64()
            infos.append((name, dims, ggml_type, offset))
        align = meta.get("general.alignment", 32)
        if not isinstance(align, int) or align <= 0:
            raise GGUFError(
                f"{path}: invalid general.alignment {align!r}")
        pos = f.tell()
        data_start = (pos + align - 1) // align * align
        file_size = r.size

    tensors: Dict[str, torch.Tensor] = {}
    for name, dims, ggml_type, offset in infos:
        if ggml_type not in _GGML_DTYPES:
            qname = _GGML_QUANT_NAMES.get(ggml_type, str(ggml_type))
            raise GGUFError(
                f"{path}: tensor {name!r} uses quantized ggml type "
                f"{qname} — only F32/F16/BF16 GGUF loads here; dequantize "
                "offline (llama.cpp: llama-quantize --allow-requantize, "
                "or convert with outtype f16)")
        stored, tdt = _GGML_DTYPES[ggml_type]
        count = int(np.prod(dims)) if dims else 1
        nbytes = count * np.dtype(stored).itemsize
        if data_start + offset + nbytes > file_size:
            raise GGUFError(
                f"{path}: truncated GGUF — tensor {name!r} needs bytes "
                f"[{data_start + offset}, {data_start + offset + nbytes}) "
                f"but the file is {file_size} bytes")
        # ggml dims are fastest-first; torch wants outermost-first
        tensors[name] = memmap_tensor(path, data_start + offset, nbytes, stored,
                                      list(reversed(dims)), tdt)
    return meta, tensors


def llama_metadata(cfg) -> Dict:
    """The ``llama.*`` metadata keys llama.cpp reads for a model config."""
    return {
        "general.architecture": "llama",
        "llama.block_count": cfg.n_layers,
        "llama.embedding_length": cfg.dim,
        "llama.attention.head_count": cfg.n_heads,
        "llama.attention.head_count_kv": cfg.n_kv_heads,
        "llama.feed_forward_length": cfg.ffn_hidden,
        "llama.context_length": cfg.max_seq,
        "llama.rope.freq_base": cfg.rope_theta,
        "llama.attention.layer_norm_rms_epsilon": cfg.norm_eps,
    }


def _inv_rope_permute(w: torch.Tensor, n_heads: int) -> torch.Tensor:
    """rotate-half layout -> ggml interleaved-pair layout (inverse of
    llama._rope_permute)."""
    out, dim2 = w.shape
    hd = out // n_heads
    return w.reshape(n_heads, 2, hd // 2, dim2).transpose(1, 2).reshape(out, dim2)


def llama_to_tensors(params: Dict, cfg) -> Dict[str, torch.Tensor]:
    """models/llama.py stacked tree -> llama.cpp tensor naming/layout (2D
    mats transposed back to [out, in], q/k re-interleaved for ggml's RoPE
    convention), on the tree's device.  Transposes stay views, made
    contiguous one at a time by :func:`write`; only q/k are copied."""
    lay = params["layers"]
    out = {"token_embd.weight": params["embed"],
           "output_norm.weight": params["ln_out"],
           "output.weight": params["lm_head"].t()}
    for i in range(cfg.n_layers):
        out[f"blk.{i}.attn_q.weight"] = _inv_rope_permute(lay["wq"][i].t(),
                                                          cfg.n_heads)
        out[f"blk.{i}.attn_k.weight"] = _inv_rope_permute(lay["wk"][i].t(),
                                                          cfg.n_kv_heads)
        out[f"blk.{i}.attn_v.weight"] = lay["wv"][i].t()
        out[f"blk.{i}.attn_output.weight"] = lay["wo"][i].t()
        out[f"blk.{i}.ffn_gate.weight"] = lay["w_gate"][i].t()
        out[f"blk.{i}.ffn_up.weight"] = lay["w_up"][i].t()
        out[f"blk.{i}.ffn_down.weight"] = lay["w_down"][i].t()
        out[f"blk.{i}.attn_norm.weight"] = lay["ln_attn"][i]
        out[f"blk.{i}.ffn_norm.weight"] = lay["ln_mlp"][i]
    return out


def export_llama(path: str, params: Dict, cfg, tokenizer=None) -> None:
    """Write a llama-family tree as a .gguf llama.cpp can identify.
    ``tokenizer``: optional models/tokenizer.py SentencePieceTokenizer —
    its vocab is embedded as ``tokenizer.ggml.*`` metadata so the file
    carries its own text path, like real llama.cpp checkpoints."""
    meta = llama_metadata(cfg)
    if tokenizer is not None:
        meta.update(tokenizer.to_gguf_meta())
    write(path, meta, llama_to_tensors(params, cfg))


def write(path: str, meta: Dict, tensors: Dict[str, object],
          align: int = 32) -> None:
    """Emit a GGUF v3 file.  Values are torch tensors (any device) or
    numpy arrays; each is copied to the host and written one at a time,
    so a 7B export holds one matrix on the host."""

    def pack_s(s: str) -> bytes:
        raw = s.encode("utf-8")
        return struct.pack("<Q", len(raw)) + raw

    def pack_value(v) -> bytes:
        if isinstance(v, bool):
            return struct.pack("<IB", 7, int(v))
        if isinstance(v, int):
            return struct.pack("<Iq", 11, v)
        if isinstance(v, float):
            return struct.pack("<If", 6, v)
        if isinstance(v, str):
            return struct.pack("<I", 8) + pack_s(v)
        if isinstance(v, (list, tuple)):
            # element type from the first item (homogeneous arrays only —
            # what the tokenizer.ggml.* vocab keys need)
            if not v:
                raise GGUFError("cannot write an empty metadata array")
            e = v[0]
            if isinstance(e, str):
                body = b"".join(pack_s(str(x)) for x in v)
                et = 8
            elif isinstance(e, bool):
                body = b"".join(struct.pack("<B", int(x)) for x in v)
                et = 7
            elif isinstance(e, int):
                body = b"".join(struct.pack("<i", int(x)) for x in v)
                et = 5
            elif isinstance(e, float):
                body = b"".join(struct.pack("<f", float(x)) for x in v)
                et = 6
            else:
                raise GGUFError(
                    f"unsupported metadata array element {e!r}")
            return struct.pack("<IIQ", 9, et, len(v)) + body
        raise GGUFError(f"unsupported metadata value {v!r}")

    items = [(name, as_tensor(v)) for name, v in tensors.items()]
    header = bytearray()
    header += struct.pack("<IIQQ", _MAGIC, 3, len(items), len(meta))
    for k, v in meta.items():
        header += pack_s(k)
        header += pack_value(v)
    offset = 0
    for name, t in items:
        if t.dtype not in _GGML_TYPES:
            raise GGUFError(f"unsupported dtype {t.dtype} for {name}")
        dims = list(reversed(t.shape))  # ggml fastest-first
        header += pack_s(name)
        header += struct.pack("<I", len(dims))
        for d in dims:
            header += struct.pack("<Q", d)
        header += struct.pack("<IQ", _GGML_TYPES[t.dtype], offset)
        offset += (t.numel() * t.element_size() + align - 1) // align * align
    header += b"\x00" * ((-len(header)) % align)
    with open(path, "wb") as f:
        f.write(header)
        for name, t in items:
            raw = host_bytes(t)
            raw.tofile(f)
            f.write(b"\x00" * ((-raw.nbytes) % align))
