// A loadable filter for `tensor_filter framework=custom`: swaps the first
// and last channel of interleaved uint8 frames (BGR <-> RGB), the host
// pre-step a camera application runs before its classifier.
//
// custom=size:<edge>,batch:<frames> sets the input and output shape
// [batch, edge, edge, 3] (default 224 and 1).  Build it against either
// package's headers:
//
//   g++ -O2 -shared -fPIC -I nnstreamer_tpu_torch/native/include \
//       -o libtorch_channel_swap.so examples/torch_channel_swap.cc
#include <cstdint>
#include <cstdlib>
#include <cstring>

#include "nnstpu_cppclass.hh"

class ChannelSwap : public nnstpu::Filter {
 public:
  explicit ChannelSwap(const char *props) {
    const char *p = std::strstr(props, "size:");
    if (p) edge_ = std::strtoull(p + 5, nullptr, 10);
    p = std::strstr(props, "batch:");
    if (p) batch_ = std::strtoull(p + 6, nullptr, 10);
  }
  int getInputInfo(nnstpu_tensors_info *info) override {
    info->num = 1;
    info->info[0].rank = 4;
    info->info[0].dims[0] = batch_;
    info->info[0].dims[1] = edge_;
    info->info[0].dims[2] = edge_;
    info->info[0].dims[3] = 3;
    info->info[0].dtype = NNSTPU_UINT8;
    return 0;
  }
  int getOutputInfo(nnstpu_tensors_info *info) override { return getInputInfo(info); }
  int invoke(const void *const *in, void *const *out) override {
    const uint8_t *x = static_cast<const uint8_t *>(in[0]);
    uint8_t *y = static_cast<uint8_t *>(out[0]);
    const uint64_t pixels = batch_ * edge_ * edge_;
    for (uint64_t i = 0; i < pixels; ++i) {
      y[3 * i] = x[3 * i + 2];
      y[3 * i + 1] = x[3 * i + 1];
      y[3 * i + 2] = x[3 * i];
    }
    return 0;
  }

 private:
  uint64_t edge_ = 224;
  uint64_t batch_ = 1;
};

NNSTPU_REGISTER_FILTER(ChannelSwap)
