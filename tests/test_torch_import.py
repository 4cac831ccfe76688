"""nnstreamer_tpu_torch stands alone: it imports torch and never jax, and
no module of it imports the JAX package.  Its registry is its own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "nnstreamer_tpu_torch"


def test_import_leaves_jax_out_of_sys_modules():
    # A subprocess: this test process already holds jax (conftest.py).
    code = (
        "import importlib, pkgutil, sys\n"
        "import nnstreamer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'nnstreamer_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'nnstreamer_tpu.')) or m == 'nnstreamer_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_continuous_serving_runs_without_jax():
    """The serve thread, the paged path and the async emit import nothing
    of jax either: serve two prompts on the CPU in a fresh process."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import nnstreamer_tpu_torch as ntt\n"
        "p = ntt.Pipeline('appsrc name=src ! tensor_filter framework=llm "
        "model=llama_tiny custom=max_new:3,dtype:float32,serve:continuous,"
        "slots:2,block_size:8,prefill_chunk:8 accelerator=true:cpu ! "
        "tensor_sink name=out')\n"
        "with p:\n"
        "    p.push('src', np.arange(1, 6, dtype=np.int32))\n"
        "    p.push('src', np.arange(1, 12, dtype=np.int32))\n"
        "    bufs = [p.pull('out', timeout=60) for _ in range(6)]\n"
        "    p.eos('src')\n"
        "    p.wait(timeout=60)\n"
        "assert sum(bool(b.meta.get('stream_last')) for b in bufs) == 2\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'nnstreamer_tpu.')) or m == 'nnstreamer_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_imports_jax_or_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "nnstreamer_tpu"), (path, mod)


def test_registry_is_the_ports_own():
    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu.core import registry as jax_registry

    assert ntt.registry.names("element") == [
        "appsrc", "audiotestsrc", "tensor_converter", "tensor_decoder",
        "tensor_filter", "tensor_query_client", "tensor_query_serversink",
        "tensor_query_serversrc", "tensor_sink", "tensor_transform",
        "videotestsrc"]
    assert ntt.registry.get("element", "tensor_query_client").__module__ \
        == "nnstreamer_tpu_torch.elements.query"
    assert ntt.registry.names("filter") == ["jax", "llm"]
    port_llm = ntt.registry.get("filter", "llm")
    assert port_llm.__module__ == "nnstreamer_tpu_torch.filters.llm"
    assert jax_registry.get("filter", "llm").__module__ == \
        "nnstreamer_tpu.filters.llm"
    # framework=jax runs the JAX package's strings on the port's device
    # framework; torch/pytorch stay free for a TorchScript counterpart
    assert ntt.registry.get("filter", "jax").__module__ == \
        "nnstreamer_tpu_torch.filters.device_fw"
    assert ntt.registry.lookup("filter", "torch") is None
    assert ntt.registry.names("decoder") == [
        "bounding_boxes", "ctc", "image_labeling", "image_segment",
        "pose_estimation"]
    assert jax_registry.get("decoder", "image_labeling").__module__ == \
        "nnstreamer_tpu.decoders.image_labeling"


#: the vision slice's modules, each imported alone in a fresh process
VISION_MODULES = [
    "core.registry", "core.caps", "core.buffer", "elements.base",
    "elements.transform", "models.backbone", "models.mobilenet", "models.zoo",
    "filters.device_fw", "elements.filter", "decoders.base",
    "decoders.image_labeling", "elements.decoder", "pipeline.plan",
    "pipeline.runtime", "elements.sink", "elements.source", "models.ssd",
    "ops.nms", "decoders.bounding_boxes", "elements.converter",
    # the rest of the vision and audio path
    "models.yolo", "models.posenet", "models.segment", "models.audio",
    "decoders.pose", "decoders.image_segment", "decoders.ctc",
    "pipeline.residency"]


def test_vision_modules_import_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {VISION_MODULES!r}:\n"
        "    importlib.import_module('nnstreamer_tpu_torch.' + m)\n"
        "    assert 'jax' not in sys.modules, m\n"
        "import nnstreamer_tpu_torch as p\n"
        "pipe = p.Pipeline('videotestsrc device=true batch=2 num-buffers=3 width=32 '\n"
        "    'height=32 name=src ! tensor_transform mode=arithmetic '\n"
        "    'option=typecast:float32,add:-127.5,div:127.5 ! tensor_filter '\n"
        "    'framework=jax model=ssd_mobilenet custom=size:32,classes:3,batch:2,'\n"
        "    'width:0.25 accelerator=true:cpu ! tensor_decoder mode=bounding_boxes '\n"
        "    'option3=0.0 option6=4 option7=device option9=tensors ! tensor_sink name=out')\n"
        "with pipe:\n"
        "    outs = [pipe.pull('out', timeout=60) for _ in range(2)]\n"
        "    pipe.wait(timeout=60)\n"
        "assert [o.tensors[0].shape for o in outs] == [(2, 4, 4), (1, 4, 4)]\n"
        "for desc in ('audiotestsrc device=true batch=2 num-buffers=2 samplesperbuffer=1600 '\n"
        "             'rate=16000 ! tensor_filter framework=jax model=wav2vec2 '\n"
        "             'custom=batch:2,samples:1600,dim:32,n_layers:1 accelerator=true:cpu ! '\n"
        "             'tensor_decoder mode=ctc ! tensor_sink name=out',\n"
        "             'videotestsrc device=true batch=2 num-buffers=2 width=32 height=32 ! '\n"
        "             'tensor_transform mode=arithmetic option=typecast:float32,div:255.0 ! '\n"
        "             'tensor_filter framework=jax model=deeplab_mobilenet custom=size:32,'\n"
        "             'batch:2,width:0.25 accelerator=true:cpu ! tensor_decoder '\n"
        "             'mode=image_segment option1=classmap ! tensor_sink name=out'):\n"
        "    pipe = p.Pipeline(desc)\n"
        "    with pipe:\n"
        "        pipe.pull('out', timeout=60)\n"
        "        pipe.wait(timeout=60)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'nnstreamer_tpu.')) or m == 'nnstreamer_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
