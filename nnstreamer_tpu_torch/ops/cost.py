"""Analytic cost of a step: the FLOPs and bytes xray attributes to it.

The JAX package asks XLA's cost analysis of a lowered program
(``nnstreamer_tpu/utils/xray.py`` ``_cost_of``).  A captured step here is
a CUDA graph of torch ops and hand-written kernels, so the cost is
counted while the step runs once eagerly, before its capture:

* torch ops through a :class:`~torch.utils._python_dispatch.
  TorchDispatchMode`: FLOPs from :mod:`torch.utils.flop_counter`'s
  formulas (matmuls, convolutions, attention) and one an output element
  for a pointwise op, bytes as every op's tensor
  inputs read once and outputs written once (view ops move nothing; a
  gather reads its output's size of its source, a scatter into a pool or
  a cache moves only what it writes);
* each hand-written kernel's entry (``matmul_int4``, ``flash_attention``,
  ``paged_attention``, ``int8_conv``) reports its own FLOPs and bytes by
  :func:`report`, with the formulas of its bound, and runs under
  :func:`paused` so that the torch ops of its plain version (the CPU
  route) or its allocations are not counted a second time.

With no :func:`counting` block open on the thread, :func:`report` and
:func:`paused` cost one attribute read.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_state = threading.local()


class Cost:
    """FLOPs and bytes counted in one :func:`counting` block."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self._paused = 0


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


#: ops that read only the rows they gather from their first operand: it
#: counts as their output's size, not its whole size
_GATHERS = frozenset({"embedding", "index_select", "index", "gather", "take",
                      "take_along_dim"})
#: ops that write into their first operand (a pool, a cache) only what
#: their other operands hold: the destination's whole size is not moved
_SCATTERS = frozenset({"index_put_", "index_put", "_index_put_impl_",
                       "index_copy_", "index_copy", "scatter_", "scatter",
                       "scatter_add_", "index_add_", "index_add",
                       "masked_scatter_", "slice_scatter", "select_scatter",
                       "copy_"})


def _op_bytes(name: str, args, kwargs, out) -> int:
    rest = _tensor_bytes(list(args[1:])) + _tensor_bytes(list(kwargs.values()))
    if name in _GATHERS:
        return 2 * _tensor_bytes(out) + rest
    if name in _SCATTERS:
        return 2 * rest
    ins = _tensor_bytes(args[:1]) + rest
    return ins + _tensor_bytes(out) if ins else 0  # an allocation moves nothing


class _CostMode(TorchDispatchMode):
    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        cost = self.cost
        if cost._paused:
            return out
        formula = self._flops.get(func._overloadpacket)
        if formula is not None:
            cost.flops += float(formula(*args, **kwargs, out_val=out))
        elif torch.Tag.pointwise in func.tags and isinstance(out, torch.Tensor):
            cost.flops += out.numel()  # one operation an element
        if not func.is_view:
            cost.bytes += _op_bytes(func._overloadpacket.__name__, args,
                                    kwargs, out)
        return out


@contextlib.contextmanager
def counting() -> Iterator[Cost]:
    """Count the cost of what runs on this thread inside the block."""
    cost = Cost()
    prev = getattr(_state, "cost", None)
    _state.cost = cost
    try:
        with _CostMode(cost):
            yield cost
    finally:
        _state.cost = prev


def report(flops: float, nbytes: float) -> None:
    """A kernel entry's analytic cost, added to the open count (if any)."""
    cost = getattr(_state, "cost", None)
    if cost is not None and not cost._paused:
        cost.flops += float(flops)
        cost.bytes += float(nbytes)


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """Stop counting torch ops for the block (a kernel entry's internals)."""
    cost = getattr(_state, "cost", None)
    if cost is None:
        yield
        return
    cost._paused += 1
    try:
        yield
    finally:
        cost._paused -= 1
