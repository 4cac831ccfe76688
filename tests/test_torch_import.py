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
        "appsrc", "audiotestsrc", "compositor", "datareposink", "datareposrc",
        "edgesink", "edgesrc", "fakesink", "filesink", "filesrc", "join",
        "mqttsink", "mqttsrc", "queue", "shmsink", "shmsrc", "tee",
        "tensor_aggregator", "tensor_converter",
        "tensor_crop", "tensor_debug", "tensor_decoder", "tensor_demux",
        "tensor_filter", "tensor_if", "tensor_merge", "tensor_mux",
        "tensor_query_client", "tensor_query_serversink", "tensor_query_serversrc",
        "tensor_rateadjust", "tensor_reposink", "tensor_reposrc", "tensor_sink",
        "tensor_sink_grpc", "tensor_sparse_dec", "tensor_sparse_enc", "tensor_split",
        "tensor_src_grpc", "tensor_src_iio", "tensor_trainer", "tensor_transform",
        "v4l2src", "videoconvert", "videoscale", "videotestsrc"]
    assert ntt.registry.names("trainer") == ["jax"]
    assert ntt.registry.get("trainer", "jax").__module__ == \
        "nnstreamer_tpu_torch.trainer.subplugin"
    assert ntt.registry.get("element", "tensor_aggregator").__module__ == \
        "nnstreamer_tpu_torch.elements.aggregator"
    assert ntt.registry.get("element", "tee").__module__ == \
        "nnstreamer_tpu_torch.elements.routing"
    assert ntt.registry.names("converter") == ["flatbuf", "flexbuf", "protobuf",
                                               "python3"]
    assert ntt.registry.get("element", "tensor_query_client").__module__ \
        == "nnstreamer_tpu_torch.elements.query"
    assert ntt.registry.names("filter") == [
        "custom", "custom-easy", "jax", "llm", "onnx", "onnxruntime", "python3",
        "pytorch", "tensorflow-lite", "tensorflow1-lite", "tensorflow2-lite", "torch"]
    for name in ("custom", "custom-so", "cpp"):
        assert ntt.registry.get("filter", name).__module__ == \
            "nnstreamer_tpu_torch.filters.custom_so"
    assert ntt.registry.get("filter", "custom-easy").__module__ == \
        "nnstreamer_tpu_torch.filters.custom_easy"
    port_llm = ntt.registry.get("filter", "llm")
    assert port_llm.__module__ == "nnstreamer_tpu_torch.filters.llm"
    assert jax_registry.get("filter", "llm").__module__ == \
        "nnstreamer_tpu.filters.llm"
    # framework=jax runs the JAX package's strings on the port's device
    # framework; torch/pytorch are the user-module framework
    assert ntt.registry.get("filter", "jax").__module__ == \
        "nnstreamer_tpu_torch.filters.device_fw"
    for name in ("torch", "pytorch"):
        assert ntt.registry.get("filter", name).__module__ == \
            "nnstreamer_tpu_torch.filters.torch_fw"
    assert ntt.registry.get("filter", "python").__module__ == \
        "nnstreamer_tpu_torch.filters.python3"
    assert ntt.registry.get("element", "shmsrc").__module__ == \
        "nnstreamer_tpu_torch.elements.shm"
    assert ntt.registry.names("decoder") == [
        "bounding_boxes", "ctc", "direct_video", "flatbuf", "flexbuf",
        "image_labeling", "image_segment", "octet_stream", "pose_estimation",
        "protobuf", "tensor_region"]
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


#: the model-file slice's modules and the micro-batching slice's, each
#: imported alone in a fresh process
FILE_MODULES = ["models.checkpoint", "models.gguf", "models.tokenizer",
                "models.llama", "models.zoo", "filters.llm",
                "pipeline.batching"]


@pytest.mark.parametrize("module", FILE_MODULES)
def test_model_file_modules_import_without_jax(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('nnstreamer_tpu_torch.{module}')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'nnstreamer_tpu.')) or m == 'nnstreamer_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


#: the camera slice's modules, each imported alone in a fresh process
CAMERA_MODULES = ["converters.serialize", "decoders.serialize",
                  "decoders.direct_video", "elements.routing", "elements.crop",
                  "elements.converter"]


@pytest.mark.parametrize("module", CAMERA_MODULES)
def test_camera_modules_import_without_jax(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('nnstreamer_tpu_torch.{module}')\n"
        "assert 'jax' not in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m.startswith('nnstreamer_tpu.') "
        "or m == 'nnstreamer_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


#: the sensor, file-replay and stream-element slice's modules, each
#: imported alone in a fresh process
STREAM_MODULES = ["elements.source", "elements.sink", "elements.aggregator",
                  "elements.video", "elements.cond", "elements.rate", "elements.repo",
                  "elements.sparse", "elements.debug"]


@pytest.mark.parametrize("module", STREAM_MODULES)
def test_stream_modules_import_without_jax(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('nnstreamer_tpu_torch.{module}')\n"
        "assert 'jax' not in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m.startswith('nnstreamer_tpu.') "
        "or m == 'nnstreamer_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


#: the remote-offload slice's modules, each imported alone in a fresh
#: process
TRANSPORT_MODULES = ["utils.watchdog", "elements.edge", "utils.broker", "elements.mqtt",
                     "elements.grpc_io", "elements.shm", "elements.datarepo",
                     "filters.python3", "filters.torch_fw", "filters.gated"]


@pytest.mark.parametrize("module", TRANSPORT_MODULES)
def test_transport_modules_import_without_jax(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('nnstreamer_tpu_torch.{module}')\n"
        "assert 'jax' not in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m.startswith('nnstreamer_tpu.') "
        "or m == 'nnstreamer_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


#: the C side's modules, each imported alone in a fresh process
C_SIDE_MODULES = ["capi", "native", "filters.custom_so"]


@pytest.mark.parametrize("module", C_SIDE_MODULES)
def test_c_side_modules_import_without_jax(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('nnstreamer_tpu_torch.{module}')\n"
        "assert 'jax' not in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m.startswith('nnstreamer_tpu.') "
        "or m == 'nnstreamer_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_the_smoke_script_imports_neither_jax_nor_the_jax_package():
    for mod in _imported_modules(REPO / "chip_smoke.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "nnstreamer_tpu"), mod


def test_analysis_xray_and_tools_run_without_jax():
    """The analyzer (its deep pass pricing llama2_7b int4 on meta), xray on
    a running pipeline, the profiler's scrape and the lint and doctor CLIs
    all run in a fresh process that never imports jax."""
    code = (
        "import contextlib, io, sys\n"
        "import numpy as np\n"
        "import nnstreamer_tpu_torch as ntt\n"
        "from nnstreamer_tpu_torch.tools import doctor, lint\n"
        "from nnstreamer_tpu_torch.utils.profiler import metrics_text\n"
        "r = ntt.analyze('appsrc ! tensor_filter framework=llm model=llama2_7b "
        "custom=quant:int4,serve:continuous invoke-dynamic=true ! tensor_sink', "
        "deep=True)\n"
        "assert r.ok and r.resources.stages[0].param_bytes > 3e9, r.render()\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert lint.main(['--dogfood']) == 0\n"
        "    assert doctor.main(['--cpu', '--frames', '16', '--gate']) == 0\n"
        "from nnstreamer_tpu_torch.utils.xray import registry\n"
        "registry.publish()\n"
        "assert 'nnstpu_f_compiles' in metrics_text()\n"
        "assert 'nnstpu_xray_census_drift 0' in metrics_text()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'nnstreamer_tpu.')) or m == 'nnstreamer_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
