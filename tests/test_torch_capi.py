"""The port's C API against the JAX package's: the same C driver source,
built against each package's ``libnnstpu_capi``, run in a child process
of each, prints the same values; the Python half of the port's bridge
(``nnstreamer_tpu_torch.capi``) against the JAX package's on the same
inputs; and the ini's ``[filter-<name>]`` sections.

Counterpart of ``tests/test_capi.py``.  The JAX test's driver opens
``framework=jax``, which in the port runs on the card: this driver opens
a ``.so`` filter (``framework=custom``, host compute) instead, and a
second program shows that a card framework opened with no card fails
with the port's message in the C caller's ``err``.  No library is loaded
in the test worker: the C programs run as child processes.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
JAX_NATIVE = REPO / "nnstreamer_tpu" / "native"
PORT_NATIVE = REPO / "nnstreamer_tpu_torch" / "native"

SCALER = r"""
#include <cstring>
#include <cstdlib>
#include "nnstpu_cppclass.hh"

// [1, 4] float32 times scale:<f> (default 2)
class Scaler : public nnstpu::Filter {
 public:
  explicit Scaler(const char *props) : scale_(2.0f) {
    const char *p = std::strstr(props, "scale:");
    if (p) scale_ = std::strtof(p + 6, nullptr);
  }
  int getInputInfo(nnstpu_tensors_info *i) override {
    i->num = 1;
    i->info[0].rank = 2;
    i->info[0].dims[0] = 1;
    i->info[0].dims[1] = 4;
    i->info[0].dtype = NNSTPU_FLOAT32;
    return 0;
  }
  int getOutputInfo(nnstpu_tensors_info *i) override { return getInputInfo(i); }
  int invoke(const void *const *in, void *const *out) override {
    const float *x = static_cast<const float *>(in[0]);
    float *y = static_cast<float *>(out[0]);
    for (int k = 0; k < 4; ++k) y[k] = x[k] * scale_;
    return 0;
  }
 private:
  float scale_;
};
NNSTPU_REGISTER_FILTER(Scaler)
"""

#: the JAX test's C driver with its jax single-shot replaced by the .so
#: filter named on the command line
C_DRIVER = textwrap.dedent("""
    #include <stdio.h>
    #include <string.h>
    #include "nnstpu_capi.h"

    int main(int argc, char **argv) {
        char err[1024] = "";
        char in_desc[256], out_desc[256];
        if (argc < 2) { fprintf(stderr, "usage: %s <filter.so>\\n", argv[0]); return 9; }
        nnstpu_single_h h = nnstpu_single_open(
            argv[1], "custom", "scale:2.5", err, sizeof err);
        if (h < 0) { fprintf(stderr, "open: %s\\n", err); return 1; }
        if (nnstpu_single_info(h, in_desc, sizeof in_desc,
                               out_desc, sizeof out_desc,
                               err, sizeof err) != 0) {
            fprintf(stderr, "info: %s\\n", err); return 1;
        }
        printf("IN %s OUT %s\\n", in_desc, out_desc);

        float in[4] = {1.0f, 2.0f, 3.0f, 4.0f};
        const void *ins[1] = {in};
        size_t in_sz[1] = {sizeof in};
        void *outs[4];
        size_t out_sz[4];
        int n = nnstpu_single_invoke(h, ins, in_sz, 1, outs, out_sz, 4,
                                     err, sizeof err);
        if (n < 0) { fprintf(stderr, "invoke: %s\\n", err); return 1; }
        float *o = (float *)outs[0];
        printf("N %d BYTES %zu VAL %.3f %.3f %.3f %.3f\\n", n, out_sz[0],
               o[0], o[1], o[2], o[3]);
        if (n != 1 || o[0] != 2.5f || o[3] != 10.0f) return 2;

        /* error path: wrong payload size must fail with a message */
        size_t bad_sz[1] = {7};
        if (nnstpu_single_invoke(h, ins, bad_sz, 1, outs, out_sz, 4,
                                 err, sizeof err) != -1 ||
            strstr(err, "bytes") == NULL) {
            fprintf(stderr, "bad-size accepted? err=%s\\n", err); return 3;
        }
        printf("BAD SIZE %s\\n", err);

        nnstpu_free(outs[0]);
        nnstpu_single_close(h);

        /* pipeline surface: construct from the DSL, push, pull, eos */
        nnstpu_pipeline_h p = nnstpu_pipeline_open(
            "appsrc name=src caps=other/tensors,dimensions=4:1,"
            "types=float32 ! "
            "tensor_transform mode=arithmetic option=add:1.0 ! "
            "tensor_sink name=out", err, sizeof err);
        if (p < 0) { fprintf(stderr, "popen: %s\\n", err); return 4; }
        /* a single handle on the pipeline surface fails loudly */
        if (nnstpu_single_info(p, in_desc, sizeof in_desc, out_desc,
                               sizeof out_desc, err, sizeof err) != -1) return 7;
        printf("KIND %s\\n", err);
        float pin[4] = {1.0f, 2.0f, 3.0f, 4.0f};
        const void *pins[1] = {pin};
        size_t pin_sz[1] = {sizeof pin};
        for (int b = 0; b < 3; b++) {
            if (nnstpu_pipeline_push(p, "src", pins, pin_sz, 1,
                                     err, sizeof err) != 0) {
                fprintf(stderr, "push: %s\\n", err); return 4;
            }
            pin[0] += 10.0f;
        }
        for (int b = 0; b < 3; b++) {
            char pdesc[128];
            n = nnstpu_pipeline_pull(p, "out", 30000, outs, out_sz, 4,
                                     pdesc, sizeof pdesc, err, sizeof err);
            if (n != 1) { fprintf(stderr, "pull: %s\\n", err); return 4; }
            float *po = (float *)outs[0];
            printf("PIPE %s %.1f %.1f %.1f %.1f\\n", pdesc,
                   po[0], po[1], po[2], po[3]);
            if (po[0] != 2.0f + 10.0f * b || po[3] != 5.0f) return 5;
            nnstpu_free(outs[0]);
        }
        size_t short_sz[1] = {5};
        if (nnstpu_pipeline_push(p, "src", pins, short_sz, 1, err,
                                 sizeof err) != -1) return 8;
        printf("PUSH SIZE %s\\n", err);
        if (nnstpu_pipeline_eos(p, "src", err, sizeof err) != 0) return 6;
        nnstpu_pipeline_close(p);

        printf("CAPI OK\\n");
        return 0;
    }
""")

#: a card framework on a machine with no card: both surfaces fail with
#: the port's message
C_NO_CARD = textwrap.dedent("""
    #include <stdio.h>
    #include "nnstpu_capi.h"

    int main(void) {
        char err[1024] = "";
        nnstpu_single_h h = nnstpu_single_open(
            "mobilenet_v1", "jax", "size:32,batch:1,width:0.25", err, sizeof err);
        if (h >= 0) return 1;
        printf("SINGLE %s\\n", err);
        err[0] = 0;
        nnstpu_pipeline_h p = nnstpu_pipeline_open(
            "appsrc name=src caps=other/tensors,dimensions=4:1,types=float32 ! "
            "tensor_filter framework=jax model=average custom=dims:4:1 ! "
            "tensor_sink name=out", err, sizeof err);
        if (p >= 0) return 2;
        printf("PIPELINE %s\\n", err);
        return 0;
    }
""")

#: a package named jax that fails to import: first on the port's
#: programs' PYTHONPATH, it shows that nothing they run imports jax
FAKE_JAX = "raise ImportError('the port imported jax')\n"


def _run(cmd, **kw):
    return subprocess.run(cmd, check=True, capture_output=True, text=True,
                          timeout=180, **kw)


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """Builds both packages' libnnstpu_capi, the driver against each, the
    no-card program and the .so filter; runs the three programs."""
    from nnstreamer_tpu_torch import native

    td = tmp_path_factory.mktemp("capi")
    # the running interpreter's, libpython found through an rpath
    cflags, ldflags = native.embed_flags()
    (td / "scaler.cc").write_text(SCALER)
    (td / "driver.c").write_text(C_DRIVER)
    (td / "no_card.c").write_text(C_NO_CARD)
    so = td / "libscaler.so"
    _run(["g++", "-O2", "-shared", "-fPIC", f"-I{PORT_NATIVE / 'include'}",
          str(td / "scaler.cc"), "-o", str(so)])
    exes = {}
    for pkg, native in (("port", PORT_NATIVE), ("jax", JAX_NATIVE)):
        lib_dir = td / pkg
        lib_dir.mkdir()
        lib = lib_dir / "libnnstpu_capi.so"
        _run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
              str(native / "src" / "nnstpu_capi.cpp"), *cflags, *ldflags, "-o", str(lib)])
        for prog in ("driver", "no_card") if pkg == "port" else ("driver",):
            exe = lib_dir / prog
            _run(["g++", "-O2", str(td / f"{prog}.c"), f"-I{native / 'include'}", str(lib),
                  *ldflags, f"-Wl,-rpath,{lib_dir}", "-o", str(exe)])
            exes[f"{pkg}_{prog}"] = str(exe)
    fake = td / "fake" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text(FAKE_JAX)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    here = [p for p in sys.path if p]
    port_env = dict(env, PYTHONPATH=os.pathsep.join([str(td / "fake"), str(REPO), *here]))
    jax_env = dict(env, PYTHONPATH=os.pathsep.join([str(REPO), *here]))
    out = {}
    for key, exe in exes.items():
        args = [exe, str(so)] if key.endswith("driver") else [exe]
        out[key] = subprocess.run(args, env=port_env if key.startswith("port") else jax_env,
                                  capture_output=True, text=True, timeout=180, cwd=str(td))
    return out


def _check_driver(proc):
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-4000:])
    assert "CAPI OK" in proc.stdout
    assert "IN 4:1,float32 OUT 4:1,float32" in proc.stdout
    assert "VAL 2.500 5.000 7.500 10.000" in proc.stdout
    assert "PIPE 4:1,float32 2.0 3.0 4.0 5.0" in proc.stdout
    assert "PIPE 4:1,float32 22.0 3.0 4.0 5.0" in proc.stdout
    assert re.search(r"KIND handle \d+ is a pipeline handle, not single", proc.stdout)
    assert re.search(r"PUSH SIZE tensor 0: 5 bytes, spec 4:1,float32 needs 16", proc.stdout)


def test_c_program_against_the_port(programs):
    _check_driver(programs["port_driver"])


def test_c_program_against_the_jax_package(programs):
    _check_driver(programs["jax_driver"])


def test_the_same_driver_prints_the_same_values(programs):
    assert programs["port_driver"].stdout == programs["jax_driver"].stdout


def test_c_program_without_a_card_gets_the_ports_message(programs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the card framework opens")
    proc = programs["port_no_card"]
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-4000:])
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines())
    for surface in ("SINGLE", "PIPELINE"):
        assert "no CUDA device is available" in lines[surface], lines
        assert "accelerator=true:cpu" in lines[surface], lines


def test_port_library_imports_the_ports_bridge():
    src = (PORT_NATIVE / "src" / "nnstpu_capi.cpp").read_text()
    assert src.count('PyImport_ImportModule("nnstreamer_tpu_torch.capi")') == 2
    assert '"nnstreamer_tpu.capi"' not in src
    assert "_on_fresh_embed" not in src


def _declarations(path):
    text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    return " ".join(text.split())


def test_the_headers_declare_the_same_abi():
    assert _declarations(PORT_NATIVE / "include" / "nnstpu_capi.h") == \
        _declarations(JAX_NATIVE / "include" / "nnstpu_capi.h")


class TestBridgeModule:
    """The Python half, exercised directly beside the JAX package's (fast,
    no compiler, no library)."""

    def test_open_invoke_close(self):
        from nnstreamer_tpu import capi as jcapi
        from nnstreamer_tpu_torch import capi

        x = np.random.default_rng(3).standard_normal(16).astype(np.float32)
        h = capi.single_open("average", "jax", "dims:8:2", accelerator="true:cpu")
        j = jcapi.single_open("average", "jax", "dims:8:2")
        try:
            assert capi.single_info(h) == jcapi.single_info(j) == \
                ("8:2,float32", "1:2,float32")
            got = np.frombuffer(capi.single_invoke_bytes(h, [x.tobytes()])[0], np.float32)
            want = np.frombuffer(jcapi.single_invoke_bytes(j, [x.tobytes()])[0], np.float32)
            # a mean of 8 standard normal float32 values: torch, XLA and
            # numpy add them in other orders, a few ulps of 1 apart
            np.testing.assert_allclose(got, x.reshape(2, 8).mean(axis=1), rtol=0, atol=1e-6)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        finally:
            capi.single_close(h)
            jcapi.single_close(j)

    def test_wrong_size_and_count_rejected(self):
        from nnstreamer_tpu_torch import capi

        h = capi.single_open("average", "jax", "dims:4:1", accelerator="true:cpu")
        try:
            with pytest.raises(ValueError, match="bytes"):
                capi.single_invoke_bytes(h, [b"\x00" * 7])
            with pytest.raises(ValueError, match="input tensor"):
                capi.single_invoke_bytes(h, [b"\x00" * 16, b"\x00" * 16])
        finally:
            capi.single_close(h)

    def test_invalid_handle(self):
        from nnstreamer_tpu_torch import capi

        with pytest.raises(KeyError):
            capi.single_info(999999)

    def test_handle_kind_checked(self):
        from nnstreamer_tpu_torch import capi

        h = capi.pipeline_open("appsrc name=src ! tensor_sink name=out")
        try:
            with pytest.raises(TypeError, match="pipeline handle, not single"):
                capi.single_close(h)
        finally:
            capi.pipeline_close(h)

    def test_pipeline_bridge(self):
        from nnstreamer_tpu import capi as jcapi
        from nnstreamer_tpu_torch import capi

        desc = ("appsrc name=src caps=other/tensors,dimensions=4:2,types=float32 ! "
                "tensor_transform mode=arithmetic option=mul:2.0 ! tensor_sink name=out")
        x = np.random.default_rng(4).standard_normal(8).astype(np.float32)
        got = {}
        for name, mod in (("port", capi), ("jax", jcapi)):
            h = mod.pipeline_open(desc)
            try:
                mod.pipeline_push(h, "src", [x.tobytes()])
                got[name] = mod.pipeline_pull(h, "out", timeout=15.0)
                mod.pipeline_eos(h, "src")
            finally:
                mod.pipeline_close(h)
        blobs, desc_out = got["port"]
        assert desc_out == "4:2,float32"
        np.testing.assert_array_equal(np.frombuffer(blobs[0], np.float32), x * 2)
        assert got["port"] == got["jax"]

    def test_pipeline_push_size_validated(self):
        from nnstreamer_tpu_torch import capi

        h = capi.pipeline_open(
            "appsrc name=src caps=other/tensors,dimensions=4:1,"
            "types=float32 ! tensor_sink name=out")
        try:
            with pytest.raises(ValueError, match="bytes"):
                capi.pipeline_push(h, "src", [b"\x00" * 5])
        finally:
            capi.pipeline_close(h)

    def test_pushed_bytes_are_the_pipelines_own(self):
        # an element that writes into its input in place works: the blob
        # was copied into writable memory before it entered the pipeline
        from nnstreamer_tpu_torch import capi
        from nnstreamer_tpu_torch.core.types import TensorsSpec
        from nnstreamer_tpu_torch.filters.custom_easy import (register_custom_easy,
                                                             unregister_custom_easy)

        def add_in_place(ins):
            ins[0] += 1.0
            return [ins[0]]

        spec = TensorsSpec.from_string("4:1", "float32")
        register_custom_easy("capi_in_place", add_in_place, spec, spec)
        h = capi.pipeline_open(
            "appsrc name=src caps=other/tensors,dimensions=4:1,types=float32 ! "
            "tensor_filter framework=custom-easy model=capi_in_place ! tensor_sink name=out")
        try:
            blob = np.arange(4, dtype=np.float32).tobytes()
            capi.pipeline_push(h, "src", [blob])
            blobs, _ = capi.pipeline_pull(h, "out", timeout=15.0)
            np.testing.assert_array_equal(np.frombuffer(blobs[0], np.float32),
                                          np.arange(4) + 1.0)
            assert blob == np.arange(4, dtype=np.float32).tobytes()
        finally:
            capi.pipeline_close(h)
            unregister_custom_easy("capi_in_place")

    def test_bf16_crosses_as_raw_words(self):
        from nnstreamer_tpu_torch import capi
        from nnstreamer_tpu_torch.core.types import TensorsSpec
        from nnstreamer_tpu_torch.filters.custom_easy import (register_custom_easy,
                                                             unregister_custom_easy)

        spec = TensorsSpec.from_string("4:1", "bfloat16")
        register_custom_easy("capi_bf16_double", lambda ins: [ins[0] * 2], spec, spec)
        x = torch.tensor([[1.5, -2.0, 0.1, 300.0]], dtype=torch.bfloat16)
        words = x.view(torch.int16).numpy().tobytes()
        h = capi.single_open("capi_bf16_double", "custom-easy")
        try:
            assert capi.single_info(h) == ("4:1,bfloat16", "4:1,bfloat16")
            out = capi.single_invoke_bytes(h, [words])[0]
            got = torch.frombuffer(bytearray(out), dtype=torch.bfloat16)
            assert torch.equal(got, (x * 2).reshape(-1))
        finally:
            capi.single_close(h)
            unregister_custom_easy("capi_bf16_double")
        p = capi.pipeline_open(
            "appsrc name=src caps=other/tensors,dimensions=4:1,types=bfloat16 ! "
            "tensor_sink name=out to-host=false")
        try:
            capi.pipeline_push(p, "src", [words])
            blobs, desc = capi.pipeline_pull(p, "out", timeout=15.0)
            assert (blobs, desc) == ([words], "4:1,bfloat16")
        finally:
            capi.pipeline_close(p)

    def test_card_framework_without_a_card_raises_the_ports_message(self):
        from nnstreamer_tpu_torch import capi
        from nnstreamer_tpu_torch.elements.base import ElementError

        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the card framework opens")
        with pytest.raises(ElementError, match="no CUDA device is available"):
            capi.single_open("average", "jax", "dims:4:1")

    def test_model_file_through_capi(self, tmp_path):
        # the C API loads model FILES too (the reference's default shape)
        from nnstreamer_tpu import capi as jcapi
        from nnstreamer_tpu_torch import capi
        from nnstreamer_tpu_torch.models import tflite_build

        mw = tflite_build.ModelWriter()
        x = mw.add_input([1, 4])
        w = mw.add_const(np.eye(4, dtype=np.float32) * 3, "w")
        y = mw.add_op("FULLY_CONNECTED", [x, w], [1, 4])
        path = tmp_path / "m.tflite"
        path.write_bytes(mw.finish(outputs=[y]))
        inp = np.random.default_rng(5).standard_normal(4).astype(np.float32)
        h = capi.single_open(str(path), "jax", "", accelerator="true:cpu")
        j = jcapi.single_open(str(path), "jax", "")
        try:
            got = np.frombuffer(capi.single_invoke_bytes(h, [inp.tobytes()])[0], np.float32)
            want = np.frombuffer(jcapi.single_invoke_bytes(j, [inp.tobytes()])[0],
                                 np.float32)
            np.testing.assert_allclose(got, 3.0 * inp, rtol=1e-6)
            np.testing.assert_allclose(got, want, rtol=1e-6)
        finally:
            capi.single_close(h)
            jcapi.single_close(j)


INI = """
[common]
queue_capacity = 6

[filter-jax]
cache = /var/cache/models
Precision = bf16

[filter-custom]
threads = 4

[ladders]
f = 1,2,4
"""


def test_framework_options_equal_the_jax_packages(tmp_path, monkeypatch):
    from nnstreamer_tpu.core import config as jconfig
    from nnstreamer_tpu_torch.core import config

    path = tmp_path / "nnstreamer.ini"
    path.write_text(INI)
    monkeypatch.setenv("NNS_TPU_CONF", str(path))
    got = config.Config.load().framework_options
    assert got == jconfig.Config.load().framework_options
    assert got == {"jax": {"cache": "/var/cache/models", "precision": "bf16"},
                   "custom": {"threads": "4"}}
    monkeypatch.delenv("NNS_TPU_CONF")
    assert config.Config.load().framework_options == {}


def test_capi_phase_rehearsal(tmp_path, monkeypatch):
    """chip_smoke.py's ``capi`` phase on the CPU at a tiny size: the
    build, the C program in its child process (the .so and both
    pipelines; the single-shot card models are left out there) and the
    bitwise checks against this process's runs."""
    import chip_smoke

    # both processes' torch computes on the CPU here, on stage threads with
    # an OpenMP team each: beside the other test workers, spinning teams
    # slowed the C program past WAIT_S, so each takes one thread (the
    # child reads the variable when its torch starts)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, so, program = chip_smoke.build_native()
        r = chip_smoke.phase_capi(torch.device("cpu"), so, program, size=32, batch=2,
                                  invokes=2, warm=1, timed=2, window=2,
                                  files_dir=str(tmp_path))
    finally:
        torch.set_num_threads(threads)
    assert r["swap"]["differ"] == 0 and r["swap"]["outputs"] == 2 * 32 * 32 * 3
    assert r["pipe"]["differ"] == 0 and r["pipe"]["batches"] == 3
    assert r["pipe_check"]["differ"] == 0 and r["pipe_check"]["distinct"] > 1
    assert r["pipe"]["device"] == "cpu" and r["bridge"]["differ"] == 0
    assert r["pipe"]["census"]["replays"] == 3  # one fused stage, a replay a batch
    assert r["c"]["pipe_frames"] == 4 and r["c_frames_per_s"] > 0
    assert not os.path.exists(tmp_path / "capi")
