"""Loadable custom-filter example on the port: compile a C++ filter to a
.so and run it in front of a card stage.

Port of ``examples/custom_filter_so.py`` (reference analog: the
custom_example_* filters of the reference's test tree).  The filter
subclasses ``nnstpu::Filter`` (``nnstreamer_tpu_torch/native/include/
nnstpu_cppclass.hh``, the JAX package's header unchanged) and is compiled
with the system toolchain at run time; real deployments ship the prebuilt
.so and point ``model=`` at it.  It runs on the host; its output moves to
the card for the ``scaler`` stage below it.

    python examples/torch_custom_filter_so.py          # the card stage on the GPU
    python examples/torch_custom_filter_so.py --cpu    # everything on the CPU
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import nnstreamer_tpu_torch as ntt  # noqa: E402
from nnstreamer_tpu_torch.filters.custom_so import include_dir  # noqa: E402

SOURCE = r"""
#include <cstring>
#include <cstdlib>
#include "nnstpu_cppclass.hh"

// Mean over the innermost dim; `custom=bias:<f>` adds a constant.
class MeanBias : public nnstpu::Filter {
 public:
  explicit MeanBias(const char *props) : bias_(0.f) {
    const char *p = std::strstr(props, "bias:");
    if (p) bias_ = std::strtof(p + 5, nullptr);
  }
  int getInputInfo(nnstpu_tensors_info *i) override {
    i->num = 1;
    i->info[0].rank = 2;       // [4, 8] float32
    i->info[0].dims[0] = 4;
    i->info[0].dims[1] = 8;
    i->info[0].dtype = NNSTPU_FLOAT32;
    return 0;
  }
  int getOutputInfo(nnstpu_tensors_info *i) override {
    i->num = 1;
    i->info[0].rank = 1;       // [4] float32
    i->info[0].dims[0] = 4;
    i->info[0].dtype = NNSTPU_FLOAT32;
    return 0;
  }
  int invoke(const void *const *in, void *const *out) override {
    const float *x = static_cast<const float *>(in[0]);
    float *y = static_cast<float *>(out[0]);
    for (int r = 0; r < 4; ++r) {
      float s = 0.f;
      for (int c = 0; c < 8; ++c) s += x[r * 8 + c];
      y[r] = s / 8.f + bias_;
    }
    return 0;
  }
 private:
  float bias_;
};
NNSTPU_REGISTER_FILTER(MeanBias)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run the card stage on the CPU")
    args = ap.parse_args()
    acc = "accelerator=true:cpu" if args.cpu else ""
    with tempfile.TemporaryDirectory(prefix="nnstpu_custom_") as tmp:
        src = os.path.join(tmp, "meanbias.cc")
        so = os.path.join(tmp, "libmeanbias.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", f"-I{include_dir()}", "-o", so,
                        src], check=True)
        print(f"built {so}")

        p = ntt.Pipeline(
            "appsrc name=src caps=other/tensors,dimensions=8:4,types=float32 ! "
            f"tensor_filter framework=custom model={so} custom=bias:10.0 ! "
            f"tensor_filter framework=jax model=scaler custom=dims:4,scale:2.0 {acc} ! "
            "tensor_sink name=out")
        card = [st.element.fw.device for st in p.stages
                if getattr(getattr(st.element, "fw", None), "device", None) is not None]
        with p:
            x = np.arange(32, dtype=np.float32).reshape(4, 8)
            p.push("src", x)
            out = np.asarray(p.pull("out", timeout=30).tensors[0])
            p.eos()
            p.wait(timeout=30)
    want = 2.0 * (x.mean(axis=1) + 10.0)
    print(f"(row means + 10) x 2 on {card[0]}: {out}")
    assert np.array_equal(out, want.astype(np.float32)), (out, want)


if __name__ == "__main__":
    main()
