/* Loadable custom-filter C ABI.
 *
 * Reference analog: tensor_filter_custom.c + tensor_filter_custom.h
 * (SURVEY §2.3 [UNVERIFIED]) — a user-compiled .so registers an
 * NNStreamer_custom_class vtable and becomes a tensor_filter model.  This
 * is the TPU build's own ABI (host-side compute; device compute enters
 * through the jax framework instead): a filter shared object exports ONE
 * symbol,
 *
 *     const nnstpu_custom_class *nnstpu_custom_get(void);
 *
 * and the "custom" framework (filters/custom_so.py) dlopens it, queries
 * I/O specs, and drives invoke() with raw host buffers.  C++ authors can
 * subclass nnstpu::Filter (nnstpu_cppclass.hh) instead of hand-rolling
 * the vtable — the reference's tensor_filter_cpp.cc analog.
 */
#ifndef NNSTPU_CUSTOM_H
#define NNSTPU_CUSTOM_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define NNSTPU_CUSTOM_ABI_VERSION 1u
#define NNSTPU_RANK_LIMIT 8u
#define NNSTPU_TENSOR_LIMIT 16u

/* Order matches nnstreamer_tpu.core.types dtype naming. */
typedef enum {
  NNSTPU_INT8 = 0,
  NNSTPU_UINT8 = 1,
  NNSTPU_INT16 = 2,
  NNSTPU_UINT16 = 3,
  NNSTPU_INT32 = 4,
  NNSTPU_UINT32 = 5,
  NNSTPU_INT64 = 6,
  NNSTPU_UINT64 = 7,
  NNSTPU_FLOAT16 = 8,
  NNSTPU_FLOAT32 = 9,
  NNSTPU_FLOAT64 = 10,
} nnstpu_dtype;

typedef struct {
  uint32_t rank;                       /* dims[0..rank), numpy (row-major) order */
  uint64_t dims[NNSTPU_RANK_LIMIT];
  int32_t dtype;                       /* nnstpu_dtype */
} nnstpu_tensor_info;

typedef struct {
  uint32_t num;
  nnstpu_tensor_info info[NNSTPU_TENSOR_LIMIT];
} nnstpu_tensors_info;

typedef struct {
  uint32_t abi_version;                /* must be NNSTPU_CUSTOM_ABI_VERSION */
  /* Build the filter from the tensor_filter `custom=` property string
   * (may be NULL); returns a private handle passed to every other hook. */
  void *(*init)(const char *props);
  void (*finish)(void *priv);
  /* Fill `info`; return 0 on success. */
  int (*get_input_info)(void *priv, nnstpu_tensors_info *info);
  int (*get_output_info)(void *priv, nnstpu_tensors_info *info);
  /* inputs/outputs: one contiguous host buffer per tensor, sized and
   * typed per the info structs; outputs are caller-allocated.  Return 0
   * on success. */
  int (*invoke)(void *priv, const void *const *inputs, void *const *outputs);
} nnstpu_custom_class;

typedef const nnstpu_custom_class *(*nnstpu_custom_get_fn)(void);

#ifdef __cplusplus
}
#endif

#endif /* NNSTPU_CUSTOM_H */
