"""Capabilities and negotiation between pipeline elements.

Port of ``nnstreamer_tpu/core/caps.py`` (GstCaps with the nnstreamer media
types ``other/tensors`` / ``other/tensor`` plus raw media caps).

A :class:`Caps` is a media type + field dict where each field value is a
concrete value, a tuple of allowed options, or ``ANY``.  Negotiation
intersects the src pad's caps with the sink pad's; elements then "fixate"
remaining options.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any, Dict, Optional, Tuple, Union

from .types import TensorsSpec, parse_fraction


class MediaType(str, Enum):
    VIDEO = "video/x-raw"
    AUDIO = "audio/x-raw"
    TEXT = "text/x-raw"
    OCTET = "application/octet-stream"
    TENSORS = "other/tensors"
    FLEX_TENSORS = "other/tensors-flexible"  # flexible format on the wire
    ANY = "ANY"


class _Any:
    def __repr__(self):
        return "ANY"


ANY = _Any()

_VIDEO_FORMATS_BPP = {
    "RGB": 3,
    "BGR": 3,
    "RGBA": 4,
    "BGRA": 4,
    "ARGB": 4,
    "ABGR": 4,
    "RGBx": 4,
    "BGRx": 4,
    "GRAY8": 1,
    "GRAY16_LE": 2,
}


_AUDIO_FORMATS = {"S8": "int8", "U8": "uint8", "S16LE": "int16", "U16LE": "uint16",
                  "S32LE": "int32", "U32LE": "uint32", "F32LE": "float32",
                  "F64LE": "float64"}


def video_bpp(fmt: str) -> int:
    """Bytes per pixel of a raw video format (``RGB`` -> 3)."""
    try:
        return _VIDEO_FORMATS_BPP[fmt]
    except KeyError:
        raise ValueError(f"unsupported video format {fmt!r}") from None


def audio_dtype(fmt: str) -> str:
    """The sample dtype name of a raw audio format (``S16LE`` -> int16)."""
    try:
        return _AUDIO_FORMATS[fmt]
    except KeyError:
        raise ValueError(f"unsupported audio format {fmt!r}") from None


@dataclasses.dataclass(frozen=True)
class Caps:
    """Media type + constraint fields.  Field values: concrete | tuple | ANY."""

    media: MediaType
    fields: Tuple[Tuple[str, Any], ...] = ()

    @classmethod
    def new(cls, media: Union[MediaType, str], **fields) -> "Caps":
        if isinstance(media, str) and media not in MediaType._value2member_map_:
            raise ValueError(f"unknown media type {media!r}")
        return cls(MediaType(media), tuple(sorted(fields.items())))

    @classmethod
    def any(cls) -> "Caps":
        return cls(MediaType.ANY)

    @classmethod
    def tensors(cls, spec: Optional[TensorsSpec] = None) -> "Caps":
        if spec is None:
            return cls.new(MediaType.TENSORS)
        return cls.new(MediaType.TENSORS, spec=spec)

    @property
    def dict(self) -> Dict[str, Any]:
        return dict(self.fields)

    def get(self, key: str, default=None):
        return self.dict.get(key, default)

    @property
    def spec(self) -> Optional[TensorsSpec]:
        s = self.get("spec")
        return s if isinstance(s, TensorsSpec) else None

    def is_any(self) -> bool:
        return self.media == MediaType.ANY

    def intersect(self, other: "Caps") -> Optional["Caps"]:
        """Narrow two caps to their common subset; None when incompatible."""
        if self.is_any():
            return other
        if other.is_any():
            return self
        if self.media != other.media:
            # flexible tensors accept static tensors (upstream: flex pads).
            if {self.media, other.media} != {MediaType.TENSORS,
                                             MediaType.FLEX_TENSORS}:
                return None
        out: Dict[str, Any] = {}
        a, b = self.dict, other.dict
        for key in set(a) | set(b):
            v = _intersect_value(a.get(key, ANY), b.get(key, ANY))
            if v is _NO:
                return None
            if not isinstance(v, _Any):
                out[key] = v
        return Caps.new(self.media, **out)

    def __str__(self) -> str:  # pragma: no cover
        fs = ",".join(f"{k}={v}" for k, v in self.fields)
        return f"{self.media.value}" + (f",{fs}" if fs else "")


class _No:
    pass


_NO = _No()


def _intersect_value(a, b):
    if isinstance(a, _Any):
        return b
    if isinstance(b, _Any):
        return a
    if isinstance(a, TensorsSpec) or isinstance(b, TensorsSpec):
        if isinstance(a, TensorsSpec) and isinstance(b, TensorsSpec):
            return a if a.is_compatible(b) else _NO
        return a if isinstance(a, TensorsSpec) else b
    ta = a if isinstance(a, tuple) else (a,)
    tb = b if isinstance(b, tuple) else (b,)
    common = [x for x in ta if x in tb]
    if not common:
        return _NO
    if len(common) == 1:
        return common[0]
    return tuple(common)


def _split_caps_fields(text: str) -> list:
    """Split a caps string on ',' while keeping '{...}' option lists intact."""
    parts = []
    depth = 0
    cur = []
    for ch in text:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur).strip())
    return parts


def parse_caps_string(text: str) -> Caps:
    """Parse a gst-launch caps filter like ``video/x-raw,format=RGB,width=224``
    including option lists ``format={RGB,BGR}``."""
    parts = _split_caps_fields(text)
    media = parts[0]
    fields: Dict[str, Any] = {}
    for p in parts[1:]:
        if not p:
            continue
        if "=" not in p:
            raise ValueError(f"bad caps field {p!r} in {text!r}")
        k, v = p.split("=", 1)
        k = k.strip()
        v = v.strip()
        # (int)640 style type prefixes from gst-launch syntax
        if v.startswith("(") and ")" in v:
            v = v[v.index(")") + 1:]
        if "/" in v and k in ("framerate", "rate") and v.replace("/", "").isdigit():
            num, den = v.split("/")
            fields[k] = (int(num), int(den)) if k == "framerate" else int(num)
            continue
        if v.startswith("{") and v.endswith("}"):  # option list {RGB,BGR}
            opts = [o.strip() for o in v[1:-1].split(",") if o.strip()]
            fields[k] = tuple(_coerce(o) for o in opts)
            continue
        # Tensor-spec fields stay raw strings: '.' separates tensors there
        # (dimensions=4.10 is two 1-D tensors).
        fields[k] = v if k in ("dimensions", "types", "names") else _coerce(v)
    if media in (
        MediaType.TENSORS.value,
        MediaType.FLEX_TENSORS.value,
        "other/tensor",
    ) and "dimensions" in fields:
        # Reference caps syntax: tensors separated by '.' inside one field
        # (``dimensions=3:224:224:1.10:1:1:1,types=uint8.float32``).
        dims = str(fields.pop("dimensions")).replace(".", ",")
        types = str(fields.pop("types", "uint8")).replace(".", ",")
        names = str(fields.pop("names", "")).replace(".", ",")
        fields.pop("num_tensors", None)
        fmt = fields.pop("format", "static")
        rate = parse_fraction(fields.pop("framerate", (0, 1)))
        if media == MediaType.FLEX_TENSORS.value:
            fmt = "flexible"
        if media == "other/tensor":
            media = MediaType.TENSORS.value
        fields["spec"] = TensorsSpec.from_string(
            dims, types, names, format=fmt, rate=rate
        )
    return Caps.new(media, **fields)


def _coerce(v: str):
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v
