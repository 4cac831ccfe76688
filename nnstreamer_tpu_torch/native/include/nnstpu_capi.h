/* nnstpu C API — single-shot model invoke from C/C++ programs.
 *
 * Reference analog: the ML C-API's ml_single_open / ml_single_invoke /
 * ml_single_close surface over gsttensor_filter_single.c (SURVEY §3.5).
 * The library embeds CPython: link against libnnstpu_capi.so (built from
 * ../src/nnstpu_capi.cpp with `python3-config --includes --embed`, or by
 * nnstreamer_tpu_torch.native.build()) and make sure PYTHONPATH reaches
 * the nnstreamer_tpu_torch package and torch.  This header is the JAX
 * package's nnstpu_capi.h with the same declarations: a program written
 * for one library builds against the other unchanged.
 *
 * Devices: a model runs where its framework's accelerator= property says,
 * which is the CUDA card unless it names the CPU; with no card, opening a
 * card framework fails with the port's "no CUDA device" message in err.
 *
 * Thread-safety: all entry points acquire the embedded interpreter's GIL;
 * handles may be used from any thread, one invoke at a time per handle.
 *
 * Minimal use:
 *
 *   nnstpu_single_h h = nnstpu_single_open("mobilenet_v1", "jax",
 *                                          "size:224,batch:1",
 *                                          err, sizeof err);
 *   const void *in[1] = {frame};  size_t in_sz[1] = {frame_bytes};
 *   void *out[4]; size_t out_sz[4];
 *   int n = nnstpu_single_invoke(h, in, in_sz, 1, out, out_sz, 4,
 *                                err, sizeof err);
 *   ... use out[0..n-1] ...
 *   for (int i = 0; i < n; i++) nnstpu_free(out[i]);
 *   nnstpu_single_close(h);
 */
#ifndef NNSTPU_CAPI_H
#define NNSTPU_CAPI_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef long long nnstpu_single_h; /* < 0 means error */

/* Initialize the embedded interpreter and import the bridge module.
 * Idempotent; called automatically by nnstpu_single_open.  Returns 0 on
 * success, -1 on failure (diagnostics on stderr). */
int nnstpu_init(void);

/* Open a model for single-shot invoke.  `framework` may be NULL/"auto";
 * `custom` may be NULL/"" (same syntax as the pipeline `custom=` prop);
 * `model` is a zoo name or a model FILE path (.tflite/.onnx/.gguf/
 * .safetensors...).  On failure returns < 0 and writes a message into
 * `err` (errlen bytes, always NUL-terminated). */
nnstpu_single_h nnstpu_single_open(const char *model, const char *framework,
                                   const char *custom,
                                   char *err, size_t errlen);

/* Input/output tensor descriptions as "dims,dtype;dims,dtype" strings
 * (dims innermost-first, e.g. "3:224:224:1,float32").  Returns 0/-1. */
int nnstpu_single_info(nnstpu_single_h h, char *in_desc, size_t in_len,
                       char *out_desc, size_t out_len,
                       char *err, size_t errlen);

/* Invoke with n_in raw little-endian tensor payloads (sizes must match
 * the input spec exactly).  On success returns the number of output
 * tensors (<= max_out) and fills out_data/out_sizes with malloc'd
 * buffers the caller releases via nnstpu_free.  Returns -1 on error. */
int nnstpu_single_invoke(nnstpu_single_h h,
                         const void *const *in_data, const size_t *in_sizes,
                         int n_in, void **out_data, size_t *out_sizes,
                         int max_out, char *err, size_t errlen);

void nnstpu_single_close(nnstpu_single_h h);

/* ---- pipeline surface (ml_pipeline_* analog) -------------------------
 * Construct + start a pipeline from the gst-launch-style description,
 * feed named appsrc elements, pull named tensor_sink elements. */

typedef long long nnstpu_pipeline_h; /* < 0 means error */

nnstpu_pipeline_h nnstpu_pipeline_open(const char *description,
                                       char *err, size_t errlen);

/* Push one buffer (n_in raw tensor payloads) into appsrc `name`.  Sizes
 * must match the source's negotiated caps spec when it carries one. */
int nnstpu_pipeline_push(nnstpu_pipeline_h h, const char *name,
                         const void *const *in_data, const size_t *in_sizes,
                         int n_in, char *err, size_t errlen);

/* Pull one buffer from tensor_sink `name` (blocks up to timeout_ms).
 * Returns the number of tensors (<= max_out); fills out_data/out_sizes
 * with malloc'd buffers (caller frees via nnstpu_free) and writes the
 * per-tensor "dims,dtype;..." description into desc. */
int nnstpu_pipeline_pull(nnstpu_pipeline_h h, const char *name,
                         long timeout_ms, void **out_data,
                         size_t *out_sizes, int max_out,
                         char *desc, size_t desc_len,
                         char *err, size_t errlen);

/* Signal end-of-stream on appsrc `name`, or on every app source when
 * name is NULL/"". */
int nnstpu_pipeline_eos(nnstpu_pipeline_h h, const char *name,
                        char *err, size_t errlen);

void nnstpu_pipeline_close(nnstpu_pipeline_h h);

void nnstpu_free(void *p);

#ifdef __cplusplus
}
#endif

#endif /* NNSTPU_CAPI_H */
