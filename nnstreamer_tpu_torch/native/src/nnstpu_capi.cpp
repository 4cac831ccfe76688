/* C ABI for single-shot invoke, embedding CPython.
 *
 * Reference analog: the ML C-API implementation over
 * gsttensor_filter_single.c (SURVEY §3.5).  All Python-object lifetime
 * stays on this side of the boundary; the C caller sees integer handles
 * and malloc'd byte buffers.  See ../include/nnstpu_capi.h for the
 * contract and tests/test_torch_capi.py for a real C driver program built
 * and executed against this library.
 *
 * The JAX package's nnstpu_capi.cpp with two changes: it imports
 * nnstreamer_tpu_torch.capi, and a fresh embed configures nothing before
 * the first call (each filter's accelerator= property chooses its device,
 * so there is no platform pin to honour).
 */
#include <Python.h>

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>

#include "../include/nnstpu_capi.h"

/* g_mod is published with release ordering after a successful init and
 * read with acquire in every entry point: the any-thread promise in the
 * header must not rest on a data race. */
static std::atomic<PyObject *> g_mod{NULL};
static std::atomic<int> g_inited{0};
static std::mutex g_init_mu;

static PyObject *mod_acquire(void) {
    return g_mod.load(std::memory_order_acquire);
}

static void set_err(char *err, size_t errlen, const char *msg);

/* Build a Python list of bytes from C payloads; NULL on failure (GIL
 * held).  Shared by single_invoke and pipeline_push. */
static PyObject *make_blob_list(const void *const *in_data,
                                const size_t *in_sizes, int n_in) {
    PyObject *blobs = PyList_New(n_in);
    if (!blobs) {
        return NULL;
    }
    for (int i = 0; i < n_in; i++) {
        PyObject *b = PyBytes_FromStringAndSize(
            (const char *)in_data[i], (Py_ssize_t)in_sizes[i]);
        if (!b) {
            Py_DECREF(blobs);
            return NULL;
        }
        PyList_SET_ITEM(blobs, i, b); /* steals */
    }
    return blobs;
}

/* Copy a Python list of bytes into malloc'd C buffers.  Returns the
 * count, or -1 (err set, any partially-written buffers freed).  GIL
 * held.  Shared by single_invoke and pipeline_pull. */
static int copy_out_blobs(PyObject *list, void **out_data,
                          size_t *out_sizes, int max_out, char *err,
                          size_t errlen) {
    Py_ssize_t n = PyList_Size(list);
    if ((int)n > max_out) {
        set_err(err, errlen, "max_out too small for outputs");
        return -1;
    }
    int written = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        char *p = NULL;
        Py_ssize_t len = 0;
        if (PyBytes_AsStringAndSize(PyList_GET_ITEM(list, i), &p, &len) !=
            0) {
            break;
        }
        void *buf = malloc((size_t)len ? (size_t)len : 1);
        if (!buf) {
            set_err(err, errlen, "out of memory");
            break;
        }
        memcpy(buf, p, (size_t)len);
        out_data[i] = buf;
        out_sizes[i] = (size_t)len;
        written++;
    }
    if (written == (int)n) {
        return (int)n;
    }
    /* free exactly the buffers handed out before the failure (later
     * slots are caller-owned uninitialized memory) */
    for (int i = 0; i < written; i++) {
        free(out_data[i]);
        out_data[i] = NULL;
    }
    return -1;
}

static void set_err(char *err, size_t errlen, const char *msg) {
    if (err && errlen) {
        snprintf(err, errlen, "%s", msg ? msg : "unknown error");
    }
}

/* Capture the pending Python exception into err (GIL held).  Always
 * leaves NO exception pending — a secondary failure in str()/utf-8 must
 * not leak into the caller's next Python call. */
static void fetch_py_err(char *err, size_t errlen) {
    PyObject *type = NULL, *value = NULL, *tb = NULL;
    PyErr_Fetch(&type, &value, &tb);
    PyErr_NormalizeException(&type, &value, &tb);
    if (value) {
        PyObject *s = PyObject_Str(value);
        if (s) {
            const char *msg = PyUnicode_AsUTF8(s);
            set_err(err, errlen, msg ? msg : "python error (undecodable)");
            Py_DECREF(s);
        } else {
            set_err(err, errlen, "python error (unprintable)");
        }
    } else {
        set_err(err, errlen, "python error (no value)");
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
    PyErr_Clear();
}

extern "C" int nnstpu_init(void) {
    /* Serialized: concurrent first calls must not race Py_InitializeEx or
     * observe a half-published g_mod (header promises any-thread use). */
    std::lock_guard<std::mutex> lk(g_init_mu);
    if (g_inited.load(std::memory_order_acquire)) {
        return 0;
    }
    if (!Py_IsInitialized()) {
        /* InitializeEx(0): skip signal handlers — the host C program owns
         * its signal disposition. */
        Py_InitializeEx(0);
        PyObject *mod = PyImport_ImportModule("nnstreamer_tpu_torch.capi");
        if (mod) {
            g_mod.store(mod, std::memory_order_release);
            g_inited.store(1, std::memory_order_release);
        } else {
            PyErr_Print();
        }
        /* Release the GIL the init thread holds — on SUCCESS so other
         * threads can PyGILState_Ensure, and on FAILURE so they don't
         * deadlock behind a dead init. */
        PyEval_SaveThread();
        return g_inited.load(std::memory_order_acquire) ? 0 : -1;
    }
    /* Already-initialized interpreter (e.g. loaded from a Python
     * process): just import the bridge under the GIL. */
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *mod = PyImport_ImportModule("nnstreamer_tpu_torch.capi");
    int rc = -1;
    if (mod) {
        g_mod.store(mod, std::memory_order_release);
        g_inited.store(1, std::memory_order_release);
        rc = 0;
    } else {
        PyErr_Print();
    }
    PyGILState_Release(st);
    return rc;
}

extern "C" nnstpu_single_h nnstpu_single_open(const char *model,
                                              const char *framework,
                                              const char *custom,
                                              char *err, size_t errlen) {
    if (!model || !*model) {
        set_err(err, errlen, "model must be non-empty");
        return -1;
    }
    if (!g_inited.load(std::memory_order_acquire) && nnstpu_init() != 0) {
        set_err(err, errlen, "nnstpu_init failed (see stderr)");
        return -1;
    }
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(mod_acquire(), "single_open", "sss", model,
                                      framework && *framework ? framework
                                                              : "auto",
                                      custom ? custom : "");
    long long h = -1;
    if (r) {
        h = PyLong_AsLongLong(r);
        Py_DECREF(r);
    } else {
        fetch_py_err(err, errlen);
    }
    PyGILState_Release(st);
    return h;
}

extern "C" int nnstpu_single_info(nnstpu_single_h h, char *in_desc,
                                  size_t in_len, char *out_desc,
                                  size_t out_len, char *err, size_t errlen) {
    if (!g_inited.load(std::memory_order_acquire)) {
        set_err(err, errlen, "not initialized");
        return -1;
    }
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(mod_acquire(), "single_info", "L", h);
    int rc = -1;
    if (r && PyTuple_Check(r) && PyTuple_Size(r) == 2) {
        const char *a = PyUnicode_AsUTF8(PyTuple_GET_ITEM(r, 0));
        const char *b = PyUnicode_AsUTF8(PyTuple_GET_ITEM(r, 1));
        if (a && b) {
            if (in_desc && in_len) {
                snprintf(in_desc, in_len, "%s", a);
            }
            if (out_desc && out_len) {
                snprintf(out_desc, out_len, "%s", b);
            }
            rc = 0;
        }
    }
    if (rc != 0 && PyErr_Occurred()) {
        fetch_py_err(err, errlen);
    }
    Py_XDECREF(r);
    PyGILState_Release(st);
    return rc;
}

extern "C" int nnstpu_single_invoke(nnstpu_single_h h,
                                    const void *const *in_data,
                                    const size_t *in_sizes, int n_in,
                                    void **out_data, size_t *out_sizes,
                                    int max_out, char *err, size_t errlen) {
    if (!g_inited.load(std::memory_order_acquire)) {
        set_err(err, errlen, "not initialized");
        return -1;
    }
    if (n_in < 0 || (n_in > 0 && (!in_data || !in_sizes))) {
        set_err(err, errlen, "bad input arguments");
        return -1;
    }
    PyGILState_STATE st = PyGILState_Ensure();
    int n_out = -1;
    PyObject *r = NULL;
    PyObject *blobs = make_blob_list(in_data, in_sizes, n_in);
    if (blobs) {
        r = PyObject_CallMethod(mod_acquire(), "single_invoke_bytes", "LO",
                                h, blobs);
        Py_DECREF(blobs);
    }
    if (r && PyList_Check(r)) {
        n_out = copy_out_blobs(r, out_data, out_sizes, max_out, err,
                               errlen);
    }
    if (n_out < 0 && PyErr_Occurred()) {
        fetch_py_err(err, errlen);
    }
    Py_XDECREF(r);
    PyGILState_Release(st);
    return n_out;
}

extern "C" nnstpu_pipeline_h nnstpu_pipeline_open(const char *description,
                                                  char *err, size_t errlen) {
    if (!description || !*description) {
        set_err(err, errlen, "description must be non-empty");
        return -1;
    }
    if (!g_inited.load(std::memory_order_acquire) && nnstpu_init() != 0) {
        set_err(err, errlen, "nnstpu_init failed (see stderr)");
        return -1;
    }
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(mod_acquire(), "pipeline_open", "s",
                                      description);
    long long h = -1;
    if (r) {
        h = PyLong_AsLongLong(r);
        Py_DECREF(r);
    } else {
        fetch_py_err(err, errlen);
    }
    PyGILState_Release(st);
    return h;
}

extern "C" int nnstpu_pipeline_push(nnstpu_pipeline_h h, const char *name,
                                    const void *const *in_data,
                                    const size_t *in_sizes, int n_in,
                                    char *err, size_t errlen) {
    if (!g_inited.load(std::memory_order_acquire)) {
        set_err(err, errlen, "not initialized");
        return -1;
    }
    if (!name || n_in <= 0 || !in_data || !in_sizes) {
        set_err(err, errlen, "bad input arguments");
        return -1;
    }
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = -1;
    PyObject *blobs = make_blob_list(in_data, in_sizes, n_in);
    if (blobs) {
        PyObject *r = PyObject_CallMethod(
            mod_acquire(), "pipeline_push", "LsO", h, name, blobs);
        if (r) {
            rc = 0;
            Py_DECREF(r);
        }
        Py_DECREF(blobs);
    }
    if (rc != 0) {
        fetch_py_err(err, errlen);
    }
    PyGILState_Release(st);
    return rc;
}

extern "C" int nnstpu_pipeline_pull(nnstpu_pipeline_h h, const char *name,
                                    long timeout_ms, void **out_data,
                                    size_t *out_sizes, int max_out,
                                    char *desc, size_t desc_len,
                                    char *err, size_t errlen) {
    if (!g_inited.load(std::memory_order_acquire)) {
        set_err(err, errlen, "not initialized");
        return -1;
    }
    int n_out = -1;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(mod_acquire(), "pipeline_pull", "Lsd",
                                      h, name, timeout_ms / 1000.0);
    if (r && PyTuple_Check(r) && PyTuple_Size(r) == 2) {
        PyObject *blobs = PyTuple_GET_ITEM(r, 0);
        const char *d = PyUnicode_AsUTF8(PyTuple_GET_ITEM(r, 1));
        if (PyList_Check(blobs) && d) {
            if (desc && desc_len) {
                snprintf(desc, desc_len, "%s", d);
            }
            n_out = copy_out_blobs(blobs, out_data, out_sizes, max_out,
                                   err, errlen);
        }
    }
    if (n_out < 0 && PyErr_Occurred()) {
        fetch_py_err(err, errlen);
    }
    Py_XDECREF(r);
    PyGILState_Release(st);
    return n_out;
}

extern "C" int nnstpu_pipeline_eos(nnstpu_pipeline_h h, const char *name,
                                   char *err, size_t errlen) {
    if (!g_inited.load(std::memory_order_acquire)) {
        set_err(err, errlen, "not initialized");
        return -1;
    }
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(mod_acquire(), "pipeline_eos", "Ls",
                                      h, name ? name : "");
    int rc = 0;
    if (!r) {
        fetch_py_err(err, errlen);
        rc = -1;
    }
    Py_XDECREF(r);
    PyGILState_Release(st);
    return rc;
}

extern "C" void nnstpu_pipeline_close(nnstpu_pipeline_h h) {
    if (!g_inited.load(std::memory_order_acquire)) {
        return;
    }
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(mod_acquire(), "pipeline_close", "L",
                                      h);
    if (!r) {
        PyErr_Clear();
    }
    Py_XDECREF(r);
    PyGILState_Release(st);
}

extern "C" void nnstpu_single_close(nnstpu_single_h h) {
    if (!g_inited.load(std::memory_order_acquire)) {
        return;
    }
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(mod_acquire(), "single_close", "L", h);
    if (!r) {
        PyErr_Clear();
    }
    Py_XDECREF(r);
    PyGILState_Release(st);
}

extern "C" void nnstpu_free(void *p) {
    free(p);
}
