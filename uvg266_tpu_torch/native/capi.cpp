// C-ABI vtable for the PyTorch/CUDA port: the uvg_api_get-shaped entry
// point (uvg266's src/uvg266.h:707-869, uvg266.c:421) backed by the port's
// Python encoder (uvg266_tpu_torch.capi_bridge) through an embedded (or
// already-running) CPython interpreter. The encoder runs on the CUDA
// device unless the config pair device=cpu asks for the CPU. Build:
//   g++ -O2 -shared -fPIC -std=c++17 capi.cpp -o libuvg266gpu.so \
//       $(python3-config --includes) $(python3-config --ldflags --embed)
//
// The vtable covers the reference's lifecycle: config alloc/parse,
// encoder open/headers/encode/close, picture alloc/free, chunk_free.
// encoder_encode(NULL picture) drains buffered frames (flush), matching
// the reference's end-of-stream convention (uvg266.c:244-314).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <vector>

extern "C" {

typedef struct uvgtpu_data_chunk {
    uint8_t* data;
    uint32_t len;
    struct uvgtpu_data_chunk* next;
} uvgtpu_data_chunk;

typedef struct uvgtpu_picture {
    uint8_t* fulldata;
    uint8_t* y;
    uint8_t* u;
    uint8_t* v;
    int32_t width;
    int32_t height;
    int64_t pts;
} uvgtpu_picture;

typedef struct uvgtpu_config uvgtpu_config;
typedef struct uvgtpu_encoder uvgtpu_encoder;

typedef struct uvgtpu_api {
    uvgtpu_config* (*config_alloc)(void);
    int (*config_init)(uvgtpu_config*);
    int (*config_destroy)(uvgtpu_config*);
    int (*config_parse)(uvgtpu_config*, const char* name,
                        const char* value);
    uvgtpu_picture* (*picture_alloc)(int32_t width, int32_t height);
    void (*picture_free)(uvgtpu_picture*);
    void (*chunk_free)(uvgtpu_data_chunk*);
    uvgtpu_encoder* (*encoder_open)(const uvgtpu_config*);
    void (*encoder_close)(uvgtpu_encoder*);
    int (*encoder_headers)(uvgtpu_encoder*, uvgtpu_data_chunk** out,
                           uint32_t* len);
    int (*encoder_encode)(uvgtpu_encoder*, uvgtpu_picture* pic_in,
                          uvgtpu_data_chunk** out, uint32_t* len);
} uvgtpu_api;

}  // extern "C"

struct uvgtpu_config {
    std::map<std::string, std::string> kv;
};

struct uvgtpu_encoder {
    long handle;
};

namespace {

bool g_we_initialized = false;

bool ensure_python() {
    if (!Py_IsInitialized()) {
        Py_Initialize();
        g_we_initialized = true;
    }
    return Py_IsInitialized();
}

PyObject* bridge() {
    static PyObject* mod = nullptr;
    if (mod == nullptr)
        mod = PyImport_ImportModule("uvg266_tpu_torch.capi_bridge");
    return mod;
}

uvgtpu_data_chunk* bytes_to_chunk(PyObject* b, uint32_t* len) {
    char* buf = nullptr;
    Py_ssize_t n = 0;
    if (PyBytes_AsStringAndSize(b, &buf, &n) != 0) return nullptr;
    auto* c = (uvgtpu_data_chunk*)malloc(sizeof(uvgtpu_data_chunk));
    c->len = (uint32_t)n;
    c->next = nullptr;
    c->data = (uint8_t*)malloc(n > 0 ? n : 1);
    memcpy(c->data, buf, n);
    if (len) *len = (uint32_t)n;
    return c;
}

// --- vtable implementations ----------------------------------------------

uvgtpu_config* config_alloc_impl() { return new uvgtpu_config(); }

int config_init_impl(uvgtpu_config* c) {
    if (!c) return 0;
    c->kv.clear();
    return 1;
}

int config_destroy_impl(uvgtpu_config* c) {
    delete c;
    return 1;
}

int config_parse_impl(uvgtpu_config* c, const char* name,
                      const char* value) {
    if (!c || !name) return 0;
    c->kv[name] = value ? value : "";
    return 1;
}

uvgtpu_picture* picture_alloc_impl(int32_t w, int32_t h) {
    auto* p = (uvgtpu_picture*)calloc(1, sizeof(uvgtpu_picture));
    size_t luma = (size_t)w * h;
    p->fulldata = (uint8_t*)malloc(luma * 3 / 2);
    p->y = p->fulldata;
    p->u = p->fulldata + luma;
    p->v = p->fulldata + luma + luma / 4;
    p->width = w;
    p->height = h;
    return p;
}

void picture_free_impl(uvgtpu_picture* p) {
    if (!p) return;
    free(p->fulldata);
    free(p);
}

void chunk_free_impl(uvgtpu_data_chunk* c) {
    while (c) {
        uvgtpu_data_chunk* n = c->next;
        free(c->data);
        free(c);
        c = n;
    }
}

uvgtpu_encoder* encoder_open_impl(const uvgtpu_config* c) {
    if (!c || !ensure_python()) return nullptr;
    PyGILState_STATE g = PyGILState_Ensure();
    uvgtpu_encoder* enc = nullptr;
    PyObject* mod = bridge();
    if (mod) {
        PyObject* pairs = PyList_New(0);
        for (const auto& [k, v] : c->kv) {
            PyObject* t = Py_BuildValue("(ss)", k.c_str(), v.c_str());
            PyList_Append(pairs, t);
            Py_DECREF(t);
        }
        PyObject* r = PyObject_CallMethod(mod, "encoder_open", "(O)",
                                          pairs);
        Py_DECREF(pairs);
        if (r) {
            enc = new uvgtpu_encoder{PyLong_AsLong(r)};
            Py_DECREF(r);
        } else {
            PyErr_Print();
        }
    }
    PyGILState_Release(g);
    return enc;
}

void encoder_close_impl(uvgtpu_encoder* e) {
    if (!e) return;
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject* r = PyObject_CallMethod(bridge(), "encoder_close", "(l)",
                                      e->handle);
    Py_XDECREF(r);
    PyGILState_Release(g);
    delete e;
}

int encoder_headers_impl(uvgtpu_encoder* e, uvgtpu_data_chunk** out,
                         uint32_t* len) {
    if (!e || !out) return 0;
    PyGILState_STATE g = PyGILState_Ensure();
    int ok = 0;
    PyObject* r = PyObject_CallMethod(bridge(), "encoder_headers", "(l)",
                                      e->handle);
    if (r) {
        *out = bytes_to_chunk(r, len);
        ok = *out != nullptr;
        Py_DECREF(r);
    } else {
        PyErr_Print();
    }
    PyGILState_Release(g);
    return ok;
}

int encoder_encode_impl(uvgtpu_encoder* e, uvgtpu_picture* pic,
                        uvgtpu_data_chunk** out, uint32_t* len) {
    if (!e || !out) return 0;
    PyGILState_STATE g = PyGILState_Ensure();
    int ok = 0;
    PyObject* r;
    if (pic == nullptr) {
        r = PyObject_CallMethod(bridge(), "encoder_flush", "(l)",
                                e->handle);
    } else {
        size_t luma = (size_t)pic->width * pic->height;
        r = PyObject_CallMethod(
            bridge(), "encoder_encode", "(ly#y#y#)", e->handle,
            (const char*)pic->y, (Py_ssize_t)luma,
            (const char*)pic->u, (Py_ssize_t)(luma / 4),
            (const char*)pic->v, (Py_ssize_t)(luma / 4));
    }
    if (r) {
        *out = bytes_to_chunk(r, len);
        ok = *out != nullptr;
        Py_DECREF(r);
    } else {
        PyErr_Print();
    }
    PyGILState_Release(g);
    return ok;
}

const uvgtpu_api g_api = {
    config_alloc_impl,  config_init_impl,    config_destroy_impl,
    config_parse_impl,  picture_alloc_impl,  picture_free_impl,
    chunk_free_impl,    encoder_open_impl,   encoder_close_impl,
    encoder_headers_impl, encoder_encode_impl,
};

}  // namespace

extern "C" const uvgtpu_api* uvgtpu_api_get(int bitdepth) {
    (void)bitdepth;
    return &g_api;
}
