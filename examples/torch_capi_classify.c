/* Classify camera frames from a C program through the C API of
 * nnstreamer_tpu_torch (nnstpu_capi.h), the counterpart of upstream
 * nnstreamer's ML C-API apps.  It embeds the interpreter and runs:
 *
 *  - the single-shot surface: mobilenet_v1 (bf16, on the card) as the
 *    header's own example opens it, then two fully-quantized MobileNet-v1
 *    .tflite files (integer execution on the card), and a .so filter;
 *  - the pipeline surface: uint8 frames pushed into
 *        appsrc ! tensor_filter framework=custom model=<swap.so>
 *               ! tensor_filter framework=jax model=<.tflite>
 *               ! tensor_transform (dequantize) ! tensor_sink
 *    (the classifier and its dequantization: one captured card stage),
 *    a few batches to warm up, then timed batches with up to WINDOW in
 *    flight (the seconds inside push and inside pull calls summed
 *    apart), and the check file's pipeline for two batches.
 *
 * Inputs are made from a counter hash (frame_byte below), so that a
 * program in another language makes the same frames; every model's last
 * output is written under OUTDIR (<tag>.bin) for the caller to compare,
 * and the last line of standard output holds the times:
 *
 *   capi-c-result key=value ...
 *
 * usage: torch_capi_classify OUTDIR SIZE BATCH SWAP_SO MODEL CHECK_MODEL
 *                            DEVICE INVOKES WARM TIMED WINDOW
 *   DEVICE "card" runs everything; "cpu" adds accelerator=true:cpu to the
 *   pipelines and leaves out the single-shot card models (the C API opens
 *   a card framework on the card or fails).
 *
 * Build: g++ -O2 examples/torch_capi_classify.c \
 *          -I nnstreamer_tpu_torch/native/include <libnnstpu_capi.so> \
 *          -L<python LIBDIR> -lpython3.X  (nnstreamer_tpu_torch.native
 *          .program_job gives the command)
 */
#include <dirent.h>
#include <limits.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include <unistd.h>

#include "nnstpu_capi.h"

static double now_s(void) {
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return t.tv_sec + t.tv_nsec * 1e-9;
}

/* byte i of the input stream `seed` */
static uint8_t frame_byte(uint32_t seed, uint32_t i) {
    uint32_t h = (i * 2654435761u) ^ (seed * 0x9E3779B9u);
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return (uint8_t)h;
}

static void fill_u8(uint8_t *dst, size_t n, uint32_t seed, uint32_t first) {
    for (size_t i = 0; i < n; i++) dst[i] = frame_byte(seed, first + (uint32_t)i);
}

/* (byte - 128) / 128, exact in float32 */
static void fill_f32(float *dst, size_t n, uint32_t seed) {
    for (size_t i = 0; i < n; i++)
        dst[i] = ((float)frame_byte(seed, (uint32_t)i) - 128.0f) * 0.0078125f;
}

static int fail(const char *what, const char *err) {
    fprintf(stderr, "%s: %s\n", what, err);
    return 1;
}

static int save(const char *dir, const char *tag, const void *p, size_t n) {
    char path[PATH_MAX];
    snprintf(path, sizeof path, "%s/%s.bin", dir, tag);
    FILE *f = fopen(path, "wb");
    if (!f || fwrite(p, 1, n, f) != n) return fail(path, "cannot write");
    return fclose(f) == 0 ? 0 : fail(path, "cannot close");
}

/* open, `invokes` calls on `in` (the first timed alone), save the last
 * output, close */
static int single(const char *dir, const char *tag, const char *model, const char *fw,
                  const char *custom, const void *in, size_t in_bytes, int invokes,
                  double *open_s, double *first_ms, double *ms) {
    char err[2048] = "", in_desc[256], out_desc[256];
    double t0 = now_s();
    nnstpu_single_h h = nnstpu_single_open(model, fw, custom, err, sizeof err);
    if (h < 0) return fail(tag, err);
    *open_s = now_s() - t0;
    if (nnstpu_single_info(h, in_desc, sizeof in_desc, out_desc, sizeof out_desc, err,
                           sizeof err) != 0)
        return fail(tag, err);
    printf("capi-c: %s in %s out %s\n", tag, in_desc, out_desc);
    const void *ins[1] = {in};
    size_t in_sz[1] = {in_bytes};
    double sum = 0.0;
    for (int k = 0; k < invokes; k++) {
        void *outs[4];
        size_t out_sz[4];
        double t = now_s();
        int n = nnstpu_single_invoke(h, ins, in_sz, 1, outs, out_sz, 4, err, sizeof err);
        if (n < 0) return fail(tag, err);
        t = (now_s() - t) * 1e3;
        if (n != 1) return fail(tag, "not one output tensor");
        if (k == 0) *first_ms = t;
        else sum += t;
        if (k == invokes - 1 && save(dir, tag, outs[0], out_sz[0])) return 1;
        nnstpu_free(outs[0]);
    }
    *ms = invokes > 1 ? sum / (invokes - 1) : *first_ms;
    nnstpu_single_close(h);
    return 0;
}

static int pull_into(nnstpu_pipeline_h h, const char *tag, uint8_t *dst, size_t bytes) {
    char err[2048] = "", desc[256];
    void *outs[4];
    size_t out_sz[4];
    int n = nnstpu_pipeline_pull(h, "out", 60000, outs, out_sz, 4, desc, sizeof desc, err,
                                 sizeof err);
    if (n < 0) return fail(tag, err);
    if (n != 1 || out_sz[0] != bytes) return fail(tag, "unexpected output");
    memcpy(dst, outs[0], bytes);
    nnstpu_free(outs[0]);
    return 0;
}

/* `warm` batches one at a time, then `timed` batches with up to `window`
 * in flight; every output saved */
static int pipeline(const char *dir, const char *tag, const char *desc, size_t in_bytes,
                    size_t out_bytes, uint32_t seed, int warm, int timed, int window,
                    double *open_s, double *timed_s, double *push_s, double *pull_s) {
    char err[2048] = "";
    const int total = warm + timed;
    uint8_t *frames = malloc(in_bytes * total), *outs = malloc(out_bytes * total);
    if (!frames || !outs) return fail(tag, "out of memory");
    for (int b = 0; b < total; b++)
        fill_u8(frames + b * in_bytes, in_bytes, seed, (uint32_t)(b * in_bytes));
    double t0 = now_s();
    nnstpu_pipeline_h h = nnstpu_pipeline_open(desc, err, sizeof err);
    if (h < 0) return fail(tag, err);
    *open_s = now_s() - t0;
    int pulled = 0;
    *push_s = *pull_s = 0.0;
    for (int b = 0; b < total; b++) {
        if (b == warm) t0 = now_s();
        const void *ins[1] = {frames + b * in_bytes};
        size_t in_sz[1] = {in_bytes};
        double t = now_s();
        if (nnstpu_pipeline_push(h, "src", ins, in_sz, 1, err, sizeof err) != 0)
            return fail(tag, err);
        if (b >= warm) *push_s += now_s() - t;
        while (pulled <= b && (b < warm || b - pulled + 1 >= window || b == total - 1)) {
            t = now_s();
            if (pull_into(h, tag, outs + pulled * out_bytes, out_bytes)) return 1;
            if (b >= warm) *pull_s += now_s() - t;
            pulled++;
        }
    }
    *timed_s = now_s() - t0;
    if (nnstpu_pipeline_eos(h, "src", err, sizeof err) != 0) return fail(tag, err);
    nnstpu_pipeline_close(h);
    int rc = save(dir, tag, outs, out_bytes * total);
    free(frames);
    free(outs);
    return rc;
}

/* open handles on the card's device nodes: the CUDA context of this process */
static int card_handles(void) {
    DIR *d = opendir("/proc/self/fd");
    if (!d) return -1;
    int n = 0;
    struct dirent *e;
    while ((e = readdir(d)) != NULL) {
        char path[PATH_MAX], target[PATH_MAX];
        snprintf(path, sizeof path, "/proc/self/fd/%s", e->d_name);
        ssize_t len = readlink(path, target, sizeof target - 1);
        if (len <= 0) continue;
        target[len] = 0;
        if (strncmp(target, "/dev/nvidia", 11) == 0) n++;
    }
    closedir(d);
    return n;
}

int main(int argc, char **argv) {
    if (argc != 12) {
        fprintf(stderr, "usage: %s OUTDIR SIZE BATCH SWAP_SO MODEL CHECK_MODEL DEVICE "
                        "INVOKES WARM TIMED WINDOW\n", argv[0]);
        return 2;
    }
    const char *dir = argv[1], *so = argv[4], *model = argv[5], *check = argv[6];
    const int size = atoi(argv[2]), batch = atoi(argv[3]), invokes = atoi(argv[8]);
    const int warm = atoi(argv[9]), timed = atoi(argv[10]), window = atoi(argv[11]);
    const int card = strcmp(argv[7], "cpu") != 0;
    const char *acc = card ? "" : " accelerator=true:cpu";
    const size_t frame = (size_t)batch * size * size * 3;
    char custom[128], desc[4096];
    snprintf(custom, sizeof custom, "size:%d,batch:%d", size, batch);

    double t0 = now_s();
    if (nnstpu_init() != 0) return fail("nnstpu_init", "see stderr");
    const double init_s = now_s() - t0;

    double bf16_open_s = -1, bf16_first_ms = -1, bf16_ms = -1;
    double quant_open_s = -1, quant_first_ms = -1, quant_ms = -1, x, y, z;
    uint8_t *xq = malloc(frame);
    float *xf = malloc(frame * sizeof(float));
    if (!xq || !xf) return fail("inputs", "out of memory");
    fill_u8(xq, frame, 2, 0);
    fill_f32(xf, frame, 1);
    if (card) {
        /* the first open of the process: CUDA context and weights */
        if (single(dir, "bf16", "mobilenet_v1", "jax", custom, xf, frame * sizeof(float),
                   invokes, &bf16_open_s, &bf16_first_ms, &bf16_ms) ||
            single(dir, "quant", model, "jax", "", xq, frame, invokes, &quant_open_s,
                   &quant_first_ms, &quant_ms) ||
            single(dir, "check", check, "jax", "", xq, frame, 1, &x, &y, &z))
            return 1;
    }
    double swap_open_s, swap_ms;
    if (single(dir, "swap", so, "custom", custom, xq, frame, 1, &swap_open_s, &swap_ms, &z))
        return 1;

    const char *form =
        "appsrc name=src caps=other/tensors,num_tensors=1,dimensions=3:%d:%d:%d,"
        "types=uint8 ! tensor_filter framework=custom model=%s custom=%s ! "
        "tensor_filter framework=jax model=%s%s ! tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-128.0,mul:0.1 ! tensor_sink name=out";
    const size_t out_bytes = (size_t)batch * 1001 * sizeof(float);
    double pipe_open_s, pipe_s, push_s, pull_s;
    snprintf(desc, sizeof desc, form, size, size, batch, so, custom, model, acc);
    if (pipeline(dir, "pipe", desc, frame, out_bytes, 3, warm, timed, window, &pipe_open_s,
                 &pipe_s, &push_s, &pull_s))
        return 1;
    snprintf(desc, sizeof desc, form, size, size, batch, so, custom, check, acc);
    if (pipeline(dir, "pipe_check", desc, frame, out_bytes, 3, 0, 2, 1, &x, &y, &z, &z))
        return 1;
    free(xq);
    free(xf);
    printf("capi-c-result init_s=%.6f bf16_open_s=%.6f bf16_first_ms=%.4f bf16_ms=%.4f "
           "quant_open_s=%.6f quant_first_ms=%.4f quant_ms=%.4f swap_ms=%.4f "
           "pipe_open_s=%.6f pipe_frames=%d pipe_s=%.6f push_s=%.6f pull_s=%.6f "
           "card_handles=%d\n",
           init_s, bf16_open_s, bf16_first_ms, bf16_ms, quant_open_s, quant_first_ms,
           quant_ms, swap_ms, pipe_open_s, timed * batch, pipe_s, push_s, pull_s,
           card_handles());
    return 0;
}
