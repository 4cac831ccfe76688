"""The port's pipeline substrate against the JAX package's: the parser
and caps, buffers holding torch tensors, and the framework contract."""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core.caps import parse_caps_string as jax_caps
from nnstreamer_tpu.pipeline.parser import parse as jax_parse
from nnstreamer_tpu_torch.core.buffer import Buffer, split_rows, stack_tensors
from nnstreamer_tpu_torch.core.caps import parse_caps_string
from nnstreamer_tpu_torch.core.types import TensorSpec
from nnstreamer_tpu_torch.filters.base import Framework
from nnstreamer_tpu_torch.pipeline.parser import ParseError, parse

torch.set_num_threads(2)

PIPELINES = [
    "appsrc name=src ! tensor_filter framework=llm model=llama_tiny "
    "custom=max_new:5,dtype:float32 invoke-dynamic=true ! tensor_sink name=out",
    "appsrc caps=other/tensors,dimensions=4:1,types=int32 name=a ! "
    "other/tensors,dimensions=4:1,types=int32 ! tensor_sink name=b",
    "appsrc name=s ! tee name=t t. ! tensor_sink name=x t. ! tensor_sink name=y",
    'appsrc name=s prop="quoted ! value" ! tensor_sink',
]


def _shape(g):
    return ([(n.id, n.kind, n.name, sorted(n.props.items(), key=str),
              str(n.caps)) for n in g.nodes.values()],
            sorted((e.src, e.src_pad, e.dst, e.dst_pad) for e in g.edges))


@pytest.mark.parametrize("desc", PIPELINES)
def test_parser_matches_jax_package(desc):
    assert _shape(parse(desc)) == _shape(jax_parse(desc))


@pytest.mark.parametrize("desc", ["appsrc !", "! tensor_sink",
                                  "appsrc ! ! tensor_sink", "a. ! tensor_sink"])
def test_parser_rejects_like_jax_package(desc):
    with pytest.raises(ParseError):
        parse(desc)
    with pytest.raises(ValueError):
        jax_parse(desc)


def test_caps_string_matches_jax_package():
    s = "other/tensors,dimensions=3:4.10:1,types=uint8.float32,framerate=30/1"
    a, b = parse_caps_string(s), jax_caps(s)
    assert a.media.value == b.media.value
    assert a.spec.to_string() == b.spec.to_string()
    assert a.spec.rate == b.spec.rate == (30, 1)


def test_buffer_holds_torch_tensors():
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    buf = Buffer([t, np.zeros(4, np.uint8)])
    assert buf.spec[0].shape == (2, 3) and buf.spec[0] == TensorSpec.of(t)
    assert not buf.on_device
    host = buf.to_host()
    assert isinstance(host.tensors[0], np.ndarray)
    np.testing.assert_array_equal(host.tensors[0], t.numpy())
    dev = buf.to_device("cpu")
    assert all(isinstance(x, torch.Tensor) for x in dev.tensors)
    rows = [(torch.full((2,), i),) for i in range(3)]
    (stacked,) = stack_tensors(rows, pad_to=4)
    assert stacked.shape == (4, 2) and stacked[3].tolist() == [2, 2]
    assert [r[0].tolist() for r in split_rows((stacked,), 3)] == \
        [[0, 0], [1, 1], [2, 2]]


def test_abstract_invoke_runs_on_meta_tensors():
    class Doubler(Framework):
        def pure_fn(self):
            return lambda xs: (xs[0] * 2, xs[0].sum(dim=0))

    spec = TensorSpec.from_shape((5, 3), np.float32)
    out = Doubler().abstract_invoke([spec])
    assert [tuple(o.shape) for o in out] == [(5, 3), (3,)]
    assert all(o.device.type == "meta" for o in out)
    assert Framework().abstract_invoke([spec]) is None
