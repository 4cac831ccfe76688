"""tensor_if: conditional stream branching on tensor values.

Port of ``nnstreamer_tpu/elements/cond.py``.  Reference analog: ``gsttensor_if.c`` (SURVEY §2.2): compared-value
(A_VALUE / TENSOR_AVERAGE_VALUE), compared-value-option (tensor:element
indices), supplied-value, operator (EQ/NE/GT/GE/LT/LE/RANGE_*), then/else
actions (PASSTHROUGH / SKIP / TENSORPICK), plus registerable custom
condition callbacks (reference: nnstreamer_if_custom API).

TPU-native extension: ``compared_value=META_VALUE`` gates on a buffer
META key (compared_value_option names it) instead of tensor contents —
zero D2H, the routing surface for per-buffer flags stamped by upstream
stages (e.g. the LLM serve loop's speculative ``spec_draft``
accept/reject flag).  A tensor-valued condition on a card tensor reads
one value from the card a buffer (``A_VALUE``: the element;
``TENSOR_AVERAGE_VALUE``: the mean, taken on the card in float64), on the
host, outside any captured step; on a host array it is the JAX package's
numpy.  A custom condition gets host arrays (card tensors fetched).

Pads: ``src_0`` receives the THEN result, ``src_1`` (optional) the ELSE
result; with only one src pad linked, else falls back to SKIP semantics on
that pad (matching the common upstream usage of tensor_if as a gate).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import numpy as np

import torch

from ..core.buffer import Buffer, _to_numpy
from ..core.caps import Caps, MediaType
from ..core.registry import register_element
from .base import Element, ElementError, SRC

_custom_conditions: Dict[str, Callable[[List[np.ndarray]], bool]] = {}
_lock = threading.Lock()


def register_if_condition(name: str, fn: Callable[[List[np.ndarray]], bool]) -> None:
    """Register a custom condition callable (reference: custom condition cb)."""
    with _lock:
        _custom_conditions[name] = fn


_OPERATORS = {
    "EQ": lambda a, b: a == b,
    "NE": lambda a, b: a != b,
    "GT": lambda a, b: a > b,
    "GE": lambda a, b: a >= b,
    "LT": lambda a, b: a < b,
    "LE": lambda a, b: a <= b,
    "RANGE_INCLUSIVE": lambda a, b: b[0] <= a <= b[1],
    "RANGE_EXCLUSIVE": lambda a, b: b[0] < a < b[1],
    "NOT_IN_RANGE_INCLUSIVE": lambda a, b: not (b[0] <= a <= b[1]),
    "NOT_IN_RANGE_EXCLUSIVE": lambda a, b: not (b[0] < a < b[1]),
}


@register_element("tensor_if")
class TensorIf(Element):
    kind = "tensor_if"
    PAD_TEMPLATES = {"sink": Caps.new(MediaType.TENSORS)}

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.compared_value = str(self.props.get("compared_value", "A_VALUE")).upper()
        self.cv_option = str(self.props.get("compared_value_option", "0"))
        self.operator = str(self.props.get("operator", "GT")).upper()
        sv = str(self.props.get("supplied_value", "0"))
        self.supplied = [float(v) for v in sv.split(":") if v != ""]
        self.then_action = str(self.props.get("then", "PASSTHROUGH")).upper()
        self._else_explicit = "else" in self.props
        self.else_action = str(self.props.get("else", "SKIP")).upper()
        self.then_pick = _parse_pick(self.props.get("then_option"))
        self.else_pick = _parse_pick(self.props.get("else_option"))
        self.custom = self.props.get("custom")
        if self.operator not in _OPERATORS:
            raise ElementError(f"unknown tensor_if operator {self.operator!r}")

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        src = next(iter(in_caps.values()), Caps.any())
        self.out_caps = {p: src for p in out_pads}
        self._pads = sorted(out_pads)
        # two linked src pads: ELSE results flow to src_1 unless the
        # user asked for something explicitly (single-pad default stays
        # SKIP — the upstream gate idiom)
        if not self._else_explicit and len(self._pads) > 1:
            self.else_action = "PASSTHROUGH"
        return self.out_caps

    # -- condition ---------------------------------------------------------
    def _evaluate(self, buf: Buffer) -> bool:
        # Only fetch what the condition reads: a card tensor's copy to the
        # host waits for the card.
        if self.custom:
            with _lock:
                fn = _custom_conditions.get(str(self.custom))
            if fn is None:
                raise ElementError(f"no custom tensor_if condition {self.custom!r}")
            return bool(fn([_to_numpy(t) for t in buf.tensors]))
        if self.compared_value == "A_VALUE":
            # option "tensor_idx:flat_element_idx" (reference uses dim coords;
            # flat index covers the same selections deterministically)
            parts = [int(v) for v in self.cv_option.split(":") if v != ""]
            t_idx = parts[0] if parts else 0
            e_idx = parts[1] if len(parts) > 1 else 0
            value = _element(buf.tensors[t_idx], e_idx)
        elif self.compared_value == "TENSOR_AVERAGE_VALUE":
            t_idx = int(self.cv_option or 0)
            value = _average(buf.tensors[t_idx])
        elif self.compared_value == "META_VALUE":
            # Buffer-meta gate: compared_value_option names the meta key
            # (absent keys read 0).  The pipeline-native home for
            # routing on per-buffer decisions an upstream stage stamped
            # — e.g. the continuous LLM serve loop's speculative
            # accept/reject flag ``spec_draft``:
            # META_VALUE + operator=GE + supplied_value=1 gates
            # accepted-draft tokens.  Reads NO tensors: card tensors
            # route without a copy to the host.
            raw = buf.meta.get(self.cv_option or "", 0)
            try:
                value = float(raw if raw is not None else 0)
            except (TypeError, ValueError) as e:
                raise ElementError(
                    f"tensor_if META_VALUE key {self.cv_option!r} holds "
                    f"non-numeric {raw!r}") from e
        else:
            raise ElementError(f"unknown compared_value {self.compared_value!r}")
        op = _OPERATORS[self.operator]
        if "RANGE" in self.operator:
            if len(self.supplied) < 2:
                raise ElementError("range operators need supplied-value v1:v2")
            return bool(op(value, (self.supplied[0], self.supplied[1])))
        return bool(op(value, self.supplied[0]))

    # -- streaming ---------------------------------------------------------
    def process(self, pad, buf: Buffer):
        cond = self._evaluate(buf)
        action = self.then_action if cond else self.else_action
        pick = self.then_pick if cond else self.else_pick
        pads = getattr(self, "_pads", [SRC])
        target = pads[0] if cond or len(pads) == 1 else pads[-1]
        if action == "SKIP":
            return []
        if action == "PASSTHROUGH":
            return [(target, buf)]
        if action == "TENSORPICK":
            tensors = [buf.tensors[i] for i in (pick or [0])]
            return [(target, buf.with_tensors(tensors, spec=None))]
        raise ElementError(f"unknown tensor_if action {action!r}")


def _parse_pick(opt) -> Optional[List[int]]:
    if opt in (None, ""):
        return None
    return [int(v) for v in str(opt).replace(":", ",").split(",") if v != ""]


def _element(t, i: int) -> float:
    """Element ``i`` of ``t`` in C order (one value read from the card)."""
    if isinstance(t, torch.Tensor):
        return float(t.reshape(-1)[i])
    return float(np.asarray(t).ravel()[i])


def _average(t) -> float:
    """The float64 mean of ``t``: on the card for a card tensor (one value
    read back), else numpy's, as the JAX package takes it."""
    if isinstance(t, torch.Tensor) and t.is_cuda:
        return float(t.double().mean())
    return float(_to_numpy(t).astype(np.float64).mean())
