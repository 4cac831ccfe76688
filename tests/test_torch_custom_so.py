"""The port's loadable custom filters (``framework=custom``) against the
JAX package's: the same ``.so`` files, compiled with the system toolchain,
driven through both packages' ``CustomSoFramework``, ``SingleShot`` and
pipelines on the same seeded inputs, bitwise.

Counterpart of ``tests/test_custom_so.py``.  No ``.so`` is loaded in the
test worker: one child process per module builds and loads every filter,
runs every case and hands back its results, which the tests below assert
one by one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_INCLUDE = REPO / "nnstreamer_tpu" / "native" / "include"
PORT_INCLUDE = REPO / "nnstreamer_tpu_torch" / "native" / "include"

CPP_SCALER = r"""
#include <cstring>
#include <cstdlib>
#include "nnstpu_cppclass.hh"

// scale:<f> parsed from the custom= prop string.
class Scaler : public nnstpu::Filter {
 public:
  explicit Scaler(const char *props) : scale_(2.0f) {
    const char *p = std::strstr(props, "scale:");
    if (p) scale_ = std::strtof(p + 6, nullptr);
  }
  int getInputInfo(nnstpu_tensors_info *i) override {
    i->num = 1;
    i->info[0].rank = 2;
    i->info[0].dims[0] = 2;
    i->info[0].dims[1] = 3;
    i->info[0].dtype = NNSTPU_FLOAT32;
    return 0;
  }
  int getOutputInfo(nnstpu_tensors_info *i) override { return getInputInfo(i); }
  int invoke(const void *const *in, void *const *out) override {
    const float *x = static_cast<const float *>(in[0]);
    float *y = static_cast<float *>(out[0]);
    for (int k = 0; k < 6; ++k) y[k] = x[k] * scale_;
    return 0;
  }
 private:
  float scale_;
};
NNSTPU_REGISTER_FILTER(Scaler)
"""

C_VTABLE = r"""
/* Hand-rolled C vtable (no C++ class sugar): u8 -> i32 cast + add. */
#include <stdlib.h>
#include "nnstpu_custom.h"

#ifndef ABI
#define ABI NNSTPU_CUSTOM_ABI_VERSION
#endif

static void *c_init(const char *props) { (void)props; return malloc(1); }
static void c_finish(void *p) { free(p); }
static int c_in(void *p, nnstpu_tensors_info *i) {
  (void)p;
  i->num = 1;
  i->info[0].rank = 1;
  i->info[0].dims[0] = 4;
  i->info[0].dtype = NNSTPU_UINT8;
  return 0;
}
static int c_out(void *p, nnstpu_tensors_info *i) {
  (void)p;
  i->num = 1;
  i->info[0].rank = 1;
  i->info[0].dims[0] = 4;
  i->info[0].dtype = NNSTPU_INT32;
  return 0;
}
static int c_invoke(void *p, const void *const *in, void *const *out) {
  (void)p;
  const unsigned char *x = (const unsigned char *)in[0];
  int *y = (int *)out[0];
  for (int k = 0; k < 4; ++k) y[k] = (int)x[k] + 100;
  return 0;
}
static const nnstpu_custom_class vt = {ABI, c_init, c_finish, c_in, c_out, c_invoke};
const nnstpu_custom_class *nnstpu_custom_get(void) { return &vt; }
"""

EMPTY = 'extern "C" int unrelated(void) { return 0; }\n'

#: the child: loads every .so through both packages and records what it
#: saw; arrays go back as (dtype, shape, hex bytes)
CHILD = textwrap.dedent(r"""
    import json, sys
    import numpy as np
    import torch

    import nnstreamer_tpu as nt
    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu.filters import custom_so as jso
    from nnstreamer_tpu_torch.filters import custom_so as pso

    so = json.loads(sys.argv[1])
    out = {}

    def enc(a):
        a = np.ascontiguousarray(np.asarray(a))
        return [str(a.dtype), list(a.shape), a.tobytes().hex()]

    def err(fn):
        try:
            fn()
        except Exception as e:  # the case records the message
            return f"{type(e).__name__}: {e}"
        return None

    rng = np.random.default_rng(7)
    x23 = rng.standard_normal((2, 3)).astype(np.float32)
    u4 = rng.integers(0, 256, 4).astype(np.uint8)
    xs = [rng.standard_normal((2, 3)).astype(np.float32) for _ in range(3)]

    for pkg, mod in (("jax", nt), ("port", ntt)):
        s = mod.SingleShot(framework="custom", model=so["scaler_port"], custom="scale:3.0")
        out[f"{pkg}_scaler_spec"] = [list(s.in_spec[0].shape), str(s.in_spec[0].dtype),
                                     list(s.out_spec[0].shape), str(s.out_spec[0].dtype)]
        out[f"{pkg}_scaler"] = enc(s.invoke(x23)[0])
        s.close()
        s = mod.SingleShot(framework="custom", model=so["adder"])
        out[f"{pkg}_adder_dtypes"] = [str(s.in_spec[0].dtype), str(s.out_spec[0].dtype)]
        out[f"{pkg}_adder"] = enc(s.invoke(u4)[0])
        out[f"{pkg}_adder_fixed"] = enc(s.invoke(np.array([1, 2, 3, 4], np.uint8))[0])
        s.close()
        # the same source built against each package's headers
        for hdr in ("port", "jax"):
            s = mod.SingleShot(framework="custom", model=so[f"scaler_{hdr}"],
                               custom="scale:0.5")
            out[f"{pkg}_headers_{hdr}"] = enc(s.invoke(x23)[0])
            s.close()
        p = mod.Pipeline(
            f"appsrc name=src ! tensor_filter framework=custom model={so['scaler_port']} "
            "custom=scale:2.0 ! tensor_sink name=out", fuse=False)
        with p:
            for x in xs:
                p.push("src", x)
            got = [np.asarray(p.pull("out", timeout=30).tensors[0]) for _ in xs]
            p.eos()
            p.wait(timeout=30)
        out[f"{pkg}_pipeline"] = [enc(g) for g in got]
        out[f"{pkg}_pipeline_inputs"] = [enc(x) for x in xs]
        # the .so in front of a device stage (the CPU here)
        acc = "accelerator=true:cpu" if pkg == "port" else ""
        p = mod.Pipeline(
            f"appsrc name=src caps=other/tensors,dimensions=3:2,types=float32 ! "
            f"tensor_filter framework=custom model={so['scaler_port']} custom=scale:2.0 ! "
            f"tensor_filter framework=jax model=average custom=dims:3:2 {acc} ! "
            "tensor_sink name=out")
        with p:
            p.push("src", x23)
            out[f"{pkg}_then_device"] = enc(p.pull("out", timeout=30).tensors[0])
            p.eos()
            p.wait(timeout=30)
        fw_cls = (pso if pkg == "port" else jso).CustomSoFramework
        out[f"{pkg}_missing_symbol"] = err(lambda: fw_cls().open({"model": so["empty"]}))
        out[f"{pkg}_abi_2"] = err(lambda: fw_cls().open({"model": so["abi2"]}))

    for alias in ("custom", "custom-so", "cpp"):
        s = ntt.SingleShot(framework=alias, model=so["scaler_port"], custom="scale:3.0")
        out[f"alias_{alias}"] = enc(s.invoke(x23)[0])
        s.close()

    fw = pso.CustomSoFramework()
    fw.open({"model": so["scaler_port"]})
    out["bf16_invoke"] = err(lambda: fw.invoke([torch.zeros(2, 3, dtype=torch.bfloat16)]))
    # a card tensor goes through one host copy: a CPU tensor here
    out["tensor_input"] = enc(fw.invoke([torch.from_numpy(x23)])[0])
    fw.close()
    out["bf16_negotiation"] = err(lambda: ntt.Pipeline(
        "appsrc name=src caps=other/tensors,dimensions=3:2,types=bfloat16 ! "
        f"tensor_filter framework=custom model={so['scaler_port']} ! tensor_sink name=out"))
    print(json.dumps(out))
""")


def _compile(cc, source_text, path, include, extra=()):
    src = path.with_suffix(".c" if cc == "gcc" else ".cc")
    src.write_text(source_text)
    subprocess.run([cc, "-O2", "-shared", "-fPIC", f"-I{include}", *extra,
                    "-o", str(path), str(src)], check=True, capture_output=True,
                   timeout=120)
    return str(path)


@pytest.fixture(scope="module")
def seen(tmp_path_factory):
    td = tmp_path_factory.mktemp("custom_so")
    so = dict(
        scaler_port=_compile("g++", CPP_SCALER, td / "libscaler_port.so", PORT_INCLUDE),
        scaler_jax=_compile("g++", CPP_SCALER, td / "libscaler_jax.so", JAX_INCLUDE),
        adder=_compile("gcc", C_VTABLE, td / "libadder.so", PORT_INCLUDE),
        abi2=_compile("gcc", C_VTABLE, td / "libabi2.so", PORT_INCLUDE, ("-DABI=2u",)),
        empty=_compile("g++", EMPTY, td / "libempty.so", PORT_INCLUDE))
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(so)], cwd=str(td),
                          env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _dec(enc):
    dtype, shape, hexbytes = enc
    return np.frombuffer(bytes.fromhex(hexbytes), dtype).reshape(shape)


def test_cpp_class_filter_single_shot(seen):
    assert seen["port_scaler_spec"] == [[2, 3], "float32", [2, 3], "float32"]
    x = np.random.default_rng(7).standard_normal((2, 3)).astype(np.float32)
    np.testing.assert_array_equal(_dec(seen["port_scaler"]), np.float32(3.0) * x)


def test_cpp_class_filter_bitwise_the_jax_package(seen):
    assert seen["port_scaler_spec"] == seen["jax_scaler_spec"]
    assert seen["port_scaler"] == seen["jax_scaler"]


def test_c_vtable_filter_dtype_mapping(seen):
    assert seen["port_adder_dtypes"] == ["uint8", "int32"]
    np.testing.assert_array_equal(_dec(seen["port_adder_fixed"]), [101, 102, 103, 104])
    assert seen["port_adder"] == seen["jax_adder"]
    assert seen["port_adder_dtypes"] == seen["jax_adder_dtypes"]


def test_so_filter_in_pipeline(seen):
    for x, y in zip(seen["port_pipeline_inputs"], seen["port_pipeline"]):
        np.testing.assert_array_equal(_dec(y), np.float32(2.0) * _dec(x))


def test_so_filter_pipeline_bitwise_the_jax_package(seen):
    assert seen["port_pipeline_inputs"] == seen["jax_pipeline_inputs"]
    assert seen["port_pipeline"] == seen["jax_pipeline"]


def test_so_filter_feeds_a_device_stage(seen):
    # the .so's host output moves into the device framework's stage as
    # any host input does; the mean of 6 floats within an f32 rounding
    x = np.random.default_rng(7).standard_normal((2, 3)).astype(np.float32)
    port, ref = _dec(seen["port_then_device"]), _dec(seen["jax_then_device"])
    assert port.shape == ref.shape == (2, 1)
    np.testing.assert_allclose(port, (2.0 * x).mean(axis=1, keepdims=True), rtol=1e-6)
    np.testing.assert_allclose(port, ref, rtol=1e-6)


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("headers", ["port", "jax"])
def test_so_built_against_either_headers_loads_in_both(seen, package, headers):
    x = np.random.default_rng(7).standard_normal((2, 3)).astype(np.float32)
    np.testing.assert_array_equal(_dec(seen[f"{package}_headers_{headers}"]),
                                  np.float32(0.5) * x)


@pytest.mark.parametrize("alias", ["custom", "custom-so", "cpp"])
def test_every_alias_opens_the_filter(seen, alias):
    assert seen[f"alias_{alias}"] == seen["port_scaler"]


def test_missing_symbol_rejected(seen):
    assert "FrameworkError" in seen["port_missing_symbol"]
    assert "nnstpu_custom_get" in seen["port_missing_symbol"]
    assert "nnstpu_custom_get" in seen["jax_missing_symbol"]


def test_abi_version_checked(seen):
    assert "ABI version 2 != 1" in seen["port_abi_2"]
    assert "ABI version 2 != 1" in seen["jax_abi_2"]


def test_bad_path_rejected():
    # no dlopen happens: the path check comes first
    from nnstreamer_tpu_torch.filters.base import FrameworkError
    from nnstreamer_tpu_torch.filters.custom_so import CustomSoFramework

    with pytest.raises(FrameworkError, match="existing .so"):
        CustomSoFramework().open({"model": "no/such/filter.so"})


def test_bf16_input_refused_naming_the_dtype(seen):
    assert seen["bf16_invoke"].startswith("FrameworkError")
    assert "bfloat16" in seen["bf16_invoke"]
    assert "bfloat16" in seen["bf16_negotiation"]


def test_tensor_input_goes_through_one_host_copy(seen):
    x = np.random.default_rng(7).standard_normal((2, 3)).astype(np.float32)
    np.testing.assert_array_equal(_dec(seen["tensor_input"]), np.float32(2.0) * x)


def test_registry_and_include_dir():
    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.filters import custom_so

    for name in ("custom", "custom-so", "cpp"):
        assert ntt.registry.get("filter", name) is custom_so.CustomSoFramework
    assert Path(custom_so.include_dir()) == PORT_INCLUDE
    for header in ("nnstpu_custom.h", "nnstpu_cppclass.hh"):
        assert (PORT_INCLUDE / header).read_bytes() == (JAX_INCLUDE / header).read_bytes()


def test_custom_filter_example_runs_on_the_cpu():
    """``examples/torch_custom_filter_so.py --cpu`` in a child process: it
    compiles the MeanBias filter and runs it in front of the scaler."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, str(REPO / "examples" / "torch_custom_filter_so.py"),
                           "--cpu"], env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "(row means + 10) x 2 on cpu: [27. 43. 59. 75.]" in proc.stdout
