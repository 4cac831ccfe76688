/* C++ class filter API: subclass-as-model.
 *
 * Reference analog: tensor_filter_cpp.cc + nnstreamer_cppplugin_api_filter.hh
 * (SURVEY §2.3 [UNVERIFIED]).  Subclass nnstpu::Filter, then emit the C ABI
 * vtable with one macro:
 *
 *     class Scale2 : public nnstpu::Filter {
 *      public:
 *       explicit Scale2(const char *props) {}
 *       int getInputInfo(nnstpu_tensors_info *i) override { ... }
 *       int getOutputInfo(nnstpu_tensors_info *i) override { ... }
 *       int invoke(const void *const *in, void *const *out) override { ... }
 *     };
 *     NNSTPU_REGISTER_FILTER(Scale2)
 *
 * Compile:  g++ -O2 -shared -fPIC -I<this dir> -o libmyfilter.so my.cc
 * Use:      tensor_filter framework=custom model=/path/libmyfilter.so
 */
#ifndef NNSTPU_CPPCLASS_HH
#define NNSTPU_CPPCLASS_HH

#include "nnstpu_custom.h"

namespace nnstpu {

class Filter {
 public:
  virtual ~Filter() = default;
  virtual int getInputInfo(nnstpu_tensors_info *info) = 0;
  virtual int getOutputInfo(nnstpu_tensors_info *info) = 0;
  virtual int invoke(const void *const *inputs, void *const *outputs) = 0;
};

}  // namespace nnstpu

#define NNSTPU_REGISTER_FILTER(Cls)                                          \
  extern "C" {                                                               \
  static void *nnstpu_reg_init_(const char *props) {                         \
    try {                                                                    \
      return new Cls(props ? props : "");                                    \
    } catch (...) {                                                          \
      return nullptr;                                                        \
    }                                                                        \
  }                                                                          \
  static void nnstpu_reg_finish_(void *p) {                                  \
    delete static_cast<Cls *>(p);                                            \
  }                                                                          \
  static int nnstpu_reg_in_(void *p, nnstpu_tensors_info *i) {               \
    return static_cast<Cls *>(p)->getInputInfo(i);                           \
  }                                                                          \
  static int nnstpu_reg_out_(void *p, nnstpu_tensors_info *i) {              \
    return static_cast<Cls *>(p)->getOutputInfo(i);                          \
  }                                                                          \
  static int nnstpu_reg_invoke_(void *p, const void *const *in,              \
                                void *const *out) {                          \
    return static_cast<Cls *>(p)->invoke(in, out);                           \
  }                                                                          \
  static const nnstpu_custom_class nnstpu_reg_vtable_ = {                    \
      NNSTPU_CUSTOM_ABI_VERSION, nnstpu_reg_init_,   nnstpu_reg_finish_,     \
      nnstpu_reg_in_,            nnstpu_reg_out_,    nnstpu_reg_invoke_};    \
  const nnstpu_custom_class *nnstpu_custom_get(void) {                       \
    return &nnstpu_reg_vtable_;                                              \
  }                                                                          \
  }

#endif /* NNSTPU_CPPCLASS_HH */
