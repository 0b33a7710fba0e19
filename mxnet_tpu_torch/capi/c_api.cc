// C ABI over the PyTorch/CUDA port (ref: src/c_api/c_api.cc —
// MXNDArrayCreate / MXImperativeInvokeEx / MXNDArraySyncCopyToCPU).
//
// The counterpart of the JAX package's src/c_api.cc, section by section:
// the runtime is Python and PyTorch, so the C surface embeds CPython and
// drives the port's op registry, autograd, kvstore and nd file I/O as a
// Python caller does.  A C program linked against this library invokes
// any registered operator end to end on the card; FusedNormReluConv,
// flash_attention and paged_decode_attention reach the port's
// hand-written CUDA kernels (see c_api_smoke.c, which trains an MLP from
// C and drives those three ops forward and backward).
//
// Device: mxtpu_init_device picks "cuda", "cuda:N" or "cpu" and keeps the
// port's Context for it here.  Every call hands that Context on — as
// ctx= to nd.array / nd.load, and as the scope an op or a kvstore is made
// in — because the port's context stack and autograd's flags are
// thread-local Python state, which PyGILState_Release deletes for a
// thread Python did not create.  mxtpu_init() is the card; without one it
// fails and never carries on on the host.
//
// Build: as a Python extension module is built, without -lpython: the
// Python symbols resolve from the process that loads the library (a C
// client links libpython; a Python process has it already).  Only the
// port, torch, numpy and the standard library are imported.

#include <Python.h>

#include "mxtpu_capi.h"

#include <cstdio>
#include <cstring>
#include <string>

namespace {

std::string g_last_error;

void capture_py_error(const char *fallback) {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  if (value != nullptr) {
    PyObject *s = PyObject_Str(value);
    if (s != nullptr) {
      const char *c = PyUnicode_AsUTF8(s);
      g_last_error = c != nullptr ? c : fallback;
      Py_DECREF(s);
    } else {
      g_last_error = fallback;
    }
  } else {
    g_last_error = fallback;
  }
  PyErr_Clear();
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
}

PyObject *g_nd_module = nullptr;  // mxnet_tpu_torch.ndarray
PyObject *g_ctx = nullptr;        // the selected device's Context
bool g_on_card = false;

struct Gil {
  PyGILState_STATE state;
  Gil() : state(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state); }
};

// `with g_ctx:` for the length of one call (the GIL held): ops that make
// arrays without an input (uniform, zeros, ...) take the current context.
struct InContext {
  bool entered = false;
  InContext() {
    PyObject *r = PyObject_CallMethod(g_ctx, "__enter__", nullptr);
    if (r != nullptr) {
      Py_DECREF(r);
      entered = true;
    }
  }
  ~InContext() {
    if (!entered) return;
    PyObject *type, *value, *trace;  // keep the call's error, if any
    PyErr_Fetch(&type, &value, &trace);
    PyObject *r = PyObject_CallMethod(g_ctx, "__exit__", "OOO", Py_None,
                                      Py_None, Py_None);
    if (r == nullptr) PyErr_Clear();
    Py_XDECREF(r);
    PyErr_Restore(type, value, trace);
  }
};

// Shared pre-init guard: a handle can only have come from a successful
// post-init call, so g_nd_module==nullptr means the client skipped
// mxtpu_init*() (or called after shutdown) — and taking the GIL of an
// uninitialized interpreter would crash instead of error-returning.
bool require_init() {
  if (g_nd_module == nullptr) {
    g_last_error = "mxtpu_init() not called";
    return false;
  }
  return true;
}

// Import the port, resolve `device` to its Context and keep both.
// Called with the GIL held.  Returns 0, or -1 with the error set.
int select_device(const char *device) {
  PyObject *nd = PyImport_ImportModule("mxnet_tpu_torch.ndarray");
  if (nd == nullptr) {
    capture_py_error("import mxnet_tpu_torch.ndarray failed (set PYTHONPATH)");
    return -1;
  }
  PyObject *ctxmod = PyImport_ImportModule("mxnet_tpu_torch.context");
  PyObject *dev = ctxmod != nullptr
                      ? PyObject_CallMethod(ctxmod, "resolve_device", "s",
                                            device)
                      : nullptr;
  PyObject *ctx = dev != nullptr
                      ? PyObject_CallMethod(ctxmod, "Context", "O", dev)
                      : nullptr;
  PyObject *kind = ctx != nullptr
                       ? PyObject_GetAttrString(ctx, "device_type")
                       : nullptr;
  Py_XDECREF(dev);
  Py_XDECREF(ctxmod);
  const char *k = kind != nullptr ? PyUnicode_AsUTF8(kind) : nullptr;
  if (k == nullptr) {
    capture_py_error("device selection failed");
    g_last_error = std::string("mxtpu_init_device(\"") + device +
                   "\"): " + g_last_error;
    Py_XDECREF(kind);
    Py_XDECREF(ctx);
    Py_DECREF(nd);
    return -1;
  }
  g_on_card = std::strcmp(k, "gpu") == 0;
  Py_DECREF(kind);
  Py_XSETREF(g_ctx, ctx);
  Py_XSETREF(g_nd_module, nd);
  return 0;
}

}  // namespace

extern "C" {

const char *mxtpu_last_error() { return g_last_error.c_str(); }

// Start the interpreter, import the port and select the device.
// Returns 0 on success.
int mxtpu_init_device(const char *device) {
  if (device == nullptr) device = "cuda";
  bool fresh = !Py_IsInitialized();
  if (fresh) {
    Py_InitializeEx(0);
  }
  int rc;
  {
    Gil gil;
    rc = select_device(device);
  }
  if (fresh) {
    // Py_InitializeEx leaves the init thread holding the GIL; release it
    // so later calls (this thread or any other) can PyGILState_Ensure.
    PyEval_SaveThread();
  }
  return rc;
}

int mxtpu_init() { return mxtpu_init_device("cuda"); }

}  // extern "C"

namespace {

// Supported dtype table: name, element size, and the numpy type its raw
// bytes are read as (bfloat16 as int16, then viewed as torch.bfloat16:
// no ml_dtypes needed).
struct DtypeInfo {
  const char *name;
  long itemsize;
  const char *numpy_name;
};

const DtypeInfo kDtypes[] = {
    {"float32", 4, "float32"}, {"float16", 2, "float16"},
    {"bfloat16", 2, "int16"},  {"int32", 4, "int32"},
    {"uint8", 1, "uint8"},     {"int8", 1, "int8"},
};

const DtypeInfo *lookup_dtype(const char *dtype) {
  for (const auto &d : kDtypes) {
    if (std::strcmp(d.name, dtype) == 0) return &d;
  }
  return nullptr;
}

// The array's torch.Tensor as a host numpy array (new reference): cast
// to float32 when `as_f32`, bfloat16 as its int16 bits otherwise.
PyObject *host_numpy(PyObject *handle, bool as_f32) {
  PyObject *torch = PyImport_ImportModule("torch");
  if (torch == nullptr) return nullptr;
  PyObject *data = PyObject_GetAttrString(handle, "_data");
  PyObject *t = data != nullptr
                    ? PyObject_CallMethod(data, "detach", nullptr)
                    : nullptr;
  Py_XDECREF(data);
  if (t != nullptr && as_f32) {
    PyObject *f = PyObject_CallMethod(t, "float", nullptr);
    Py_SETREF(t, f);
  }
  if (t != nullptr) {
    PyObject *c = PyObject_CallMethod(t, "cpu", nullptr);
    Py_SETREF(t, c);
  }
  if (t != nullptr) {
    PyObject *c = PyObject_CallMethod(t, "contiguous", nullptr);
    Py_SETREF(t, c);
  }
  if (t != nullptr) {
    PyObject *dt = PyObject_GetAttrString(t, "dtype");
    PyObject *bf16 = PyObject_GetAttrString(torch, "bfloat16");
    if (dt != nullptr && dt == bf16) {
      PyObject *i16 = PyObject_GetAttrString(torch, "int16");
      PyObject *v = i16 != nullptr
                        ? PyObject_CallMethod(t, "view", "O", i16)
                        : nullptr;
      Py_XDECREF(i16);
      Py_SETREF(t, v);
    }
    Py_XDECREF(dt);
    Py_XDECREF(bf16);
  }
  PyObject *arr = t != nullptr ? PyObject_CallMethod(t, "numpy", nullptr)
                               : nullptr;
  Py_XDECREF(t);
  Py_DECREF(torch);
  return arr;
}

// The host copy's raw bytes (new reference), or NULL with the error set.
PyObject *host_bytes(void *handle, bool as_f32) {
  PyObject *arr = host_numpy(reinterpret_cast<PyObject *>(handle), as_f32);
  if (arr == nullptr) {
    capture_py_error("device->host copy failed");
    return nullptr;
  }
  PyObject *bytes = PyObject_CallMethod(arr, "tobytes", nullptr);
  Py_DECREF(arr);
  if (bytes == nullptr) capture_py_error("tobytes failed");
  return bytes;
}

}  // namespace

extern "C" {

// Create an NDArray on the device by COPYING a host buffer (ref:
// MXNDArraySyncCopyFromCPU copy-in semantics — the caller may free/reuse
// `data` immediately).  numpy and torch view the caller's bytes without
// a copy; nd.array then copies them (as_tensor never shares memory with
// its source), so no view survives this call.
void *mxtpu_ndarray_create_dtype(const void *data, const long *shape,
                                 int ndim, const char *dtype) {
  if (!require_init()) return nullptr;
  const DtypeInfo *info = lookup_dtype(dtype != nullptr ? dtype : "float32");
  if (info == nullptr) {
    // float64/int64 deliberately absent, for parity with the JAX ABI:
    // its runtime computes in 32-bit, and a client must get the same
    // dtypes from either library.
    g_last_error = std::string("unsupported dtype: ") +
                   (dtype != nullptr ? dtype : "(null)") +
                   " (supported: float32 float16 bfloat16 int32 uint8 "
                   "int8; 64-bit dtypes are refused as the JAX ABI "
                   "refuses them — convert to the 32-bit kind host-side)";
    return nullptr;
  }
  Gil gil;
  long total = 1;
  PyObject *shp = PyTuple_New(ndim);
  for (int i = 0; i < ndim; ++i) {
    total *= shape[i];
    PyTuple_SET_ITEM(shp, i, PyLong_FromLong(shape[i]));
  }
  PyObject *np = PyImport_ImportModule("numpy");
  PyObject *torch = np != nullptr ? PyImport_ImportModule("torch") : nullptr;
  if (torch == nullptr) {
    capture_py_error("import numpy / torch failed");
    Py_XDECREF(np);
    Py_DECREF(shp);
    return nullptr;
  }
  // A writable view (nothing writes through it) so that torch.from_numpy
  // takes the array without a read-only warning.
  PyObject *mv = PyMemoryView_FromMemory(
      reinterpret_cast<char *>(const_cast<void *>(data)),
      total * info->itemsize, PyBUF_WRITE);
  PyObject *view = mv != nullptr
                       ? PyObject_CallMethod(np, "frombuffer", "Os", mv,
                                             info->numpy_name)
                       : nullptr;
  Py_XDECREF(mv);
  Py_DECREF(np);
  PyObject *t = view != nullptr
                    ? PyObject_CallMethod(torch, "from_numpy", "O", view)
                    : nullptr;
  Py_XDECREF(view);
  if (t != nullptr && std::strcmp(info->name, "bfloat16") == 0) {
    PyObject *bf16 = PyObject_GetAttrString(torch, "bfloat16");
    PyObject *v = bf16 != nullptr ? PyObject_CallMethod(t, "view", "O", bf16)
                                  : nullptr;
    Py_XDECREF(bf16);
    Py_SETREF(t, v);
  }
  Py_DECREF(torch);
  PyObject *shaped = t != nullptr
                         ? PyObject_CallMethod(t, "reshape", "O", shp)
                         : nullptr;
  Py_XDECREF(t);
  Py_DECREF(shp);
  if (shaped == nullptr) {
    capture_py_error("host buffer view failed");
    return nullptr;
  }
  PyObject *array = PyObject_GetAttrString(g_nd_module, "array");
  PyObject *pos = PyTuple_Pack(1, shaped);
  PyObject *kw = Py_BuildValue("{sO}", "ctx", g_ctx);
  PyObject *nd = array != nullptr && pos != nullptr && kw != nullptr
                     ? PyObject_Call(array, pos, kw)
                     : nullptr;
  Py_XDECREF(kw);
  Py_XDECREF(pos);
  Py_XDECREF(array);
  Py_DECREF(shaped);
  if (nd == nullptr) {
    capture_py_error("nd.array failed");
    return nullptr;
  }
  return nd;
}

// float32 convenience wrapper.
void *mxtpu_ndarray_create(const float *data, const long *shape, int ndim) {
  return mxtpu_ndarray_create_dtype(data, shape, ndim, "float32");
}

int mxtpu_ndarray_free(void *handle) {
  if (handle == nullptr || !require_init()) return -1;
  Gil gil;
  Py_DECREF(reinterpret_cast<PyObject *>(handle));
  return 0;
}

int mxtpu_ndarray_ndim(void *handle) {
  if (!require_init()) return -1;
  Gil gil;
  PyObject *shp = PyObject_GetAttrString(
      reinterpret_cast<PyObject *>(handle), "shape");
  if (shp == nullptr) {
    capture_py_error("no shape");
    return -1;
  }
  int n = static_cast<int>(PyTuple_Size(shp));
  Py_DECREF(shp);
  return n;
}

int mxtpu_ndarray_shape(void *handle, long *out) {
  if (!require_init()) return -1;
  Gil gil;
  PyObject *shp = PyObject_GetAttrString(
      reinterpret_cast<PyObject *>(handle), "shape");
  if (shp == nullptr) {
    capture_py_error("no shape");
    return -1;
  }
  int n = static_cast<int>(PyTuple_Size(shp));
  for (int i = 0; i < n; ++i) {
    out[i] = PyLong_AsLong(PyTuple_GET_ITEM(shp, i));
  }
  Py_DECREF(shp);
  return n;
}

// Write the array's dtype name into out; returns 0 (or -1).
int mxtpu_ndarray_dtype(void *handle, char *out, int capacity) {
  if (!require_init()) return -1;
  Gil gil;
  PyObject *base = PyImport_ImportModule("mxnet_tpu_torch.base");
  PyObject *data = base != nullptr
                       ? PyObject_GetAttrString(
                             reinterpret_cast<PyObject *>(handle), "_data")
                       : nullptr;
  PyObject *dt = data != nullptr ? PyObject_GetAttrString(data, "dtype")
                                 : nullptr;
  PyObject *name = dt != nullptr
                       ? PyObject_CallMethod(base, "dtype_name", "O", dt)
                       : nullptr;
  Py_XDECREF(dt);
  Py_XDECREF(data);
  Py_XDECREF(base);
  if (name == nullptr) {
    capture_py_error("dtype name");
    return -1;
  }
  const char *c = PyUnicode_AsUTF8(name);
  if (c == nullptr || static_cast<int>(std::strlen(c)) >= capacity) {
    Py_DECREF(name);
    PyErr_Clear();
    g_last_error = "dtype buffer too small";
    return -1;
  }
  std::strcpy(out, c);  // NOLINT(runtime/printf) - length checked above
  Py_DECREF(name);
  return 0;
}

// Blocking device->host copy in the array's OWN dtype.  capacity in
// bytes; returns bytes copied or -1.
long mxtpu_ndarray_to_host_bytes(void *handle, void *out, long capacity) {
  if (!require_init()) return -1;
  Gil gil;
  PyObject *bytes = host_bytes(handle, false);
  if (bytes == nullptr) return -1;
  long nbytes = static_cast<long>(PyBytes_Size(bytes));
  if (nbytes > capacity) {
    Py_DECREF(bytes);
    g_last_error = "output buffer too small";
    return -1;
  }
  std::memcpy(out, PyBytes_AsString(bytes), nbytes);
  Py_DECREF(bytes);
  return nbytes;
}

// Blocking device->host copy converted to float32 (ref:
// MXNDArraySyncCopyToCPU).  capacity is the element count of out.
int mxtpu_ndarray_to_host(void *handle, float *out, long capacity) {
  if (!require_init()) return -1;
  Gil gil;
  PyObject *bytes = host_bytes(handle, true);
  if (bytes == nullptr) return -1;
  long nbytes = static_cast<long>(PyBytes_Size(bytes));
  long nelem = nbytes / static_cast<long>(sizeof(float));
  if (nelem > capacity) {
    Py_DECREF(bytes);
    g_last_error = "output buffer too small";
    return -1;
  }
  std::memcpy(out, PyBytes_AsString(bytes), nbytes);
  Py_DECREF(bytes);
  return static_cast<int>(nelem);
}

}  // extern "C"

namespace {

// Parse a JSON object of attrs into a dict (new reference); NULL with
// the error set when it is not one.  "" or NULL gives NULL and *ok.
PyObject *json_kwargs(const char *kwargs_json, bool *ok) {
  *ok = true;
  if (kwargs_json == nullptr || kwargs_json[0] == '\0') return nullptr;
  PyObject *json = PyImport_ImportModule("json");
  PyObject *kw = json != nullptr
                     ? PyObject_CallMethod(json, "loads", "s", kwargs_json)
                     : nullptr;
  Py_XDECREF(json);
  if (kw == nullptr || !PyDict_Check(kw)) {
    capture_py_error("kwargs_json is not a JSON object");
    Py_XDECREF(kw);
    *ok = false;
    return nullptr;
  }
  return kw;
}

// Shared invoke core: returns the raw nd.invoke result (NDArray, or a
// tuple of NDArrays for multi-output ops) as a new reference, or NULL.
// Runs inside the selected device's context.
PyObject *invoke_raw(const char *op_name, void **args, int nargs,
                     const char *kwargs_json) {
  PyObject *invoke = PyObject_GetAttrString(g_nd_module, "invoke");
  if (invoke == nullptr) {
    capture_py_error("nd.invoke missing");
    return nullptr;
  }
  bool ok;
  PyObject *kw = json_kwargs(kwargs_json, &ok);
  if (!ok) {
    Py_DECREF(invoke);
    return nullptr;
  }
  PyObject *pos = PyTuple_New(nargs + 1);
  PyTuple_SET_ITEM(pos, 0, PyUnicode_FromString(op_name));
  for (int i = 0; i < nargs; ++i) {
    PyObject *a = reinterpret_cast<PyObject *>(args[i]);
    Py_INCREF(a);
    PyTuple_SET_ITEM(pos, i + 1, a);
  }
  PyObject *res;
  {
    InContext scope;
    res = scope.entered ? PyObject_Call(invoke, pos, kw) : nullptr;
  }
  Py_XDECREF(kw);
  Py_DECREF(pos);
  Py_DECREF(invoke);
  if (res == nullptr) capture_py_error("op invocation failed");
  return res;
}

}  // namespace

extern "C" {

// Invoke a registered operator by name (ref: MXImperativeInvokeEx).
// args: NDArray handles; kwargs_json: JSON object of op attrs ("" or
// NULL for none).  Returns the FIRST output NDArray handle or NULL;
// for multi-output ops the rest are discarded — use mxtpu_invoke_n.
void *mxtpu_invoke(const char *op_name, void **args, int nargs,
                   const char *kwargs_json) {
  if (!require_init()) return nullptr;
  Gil gil;
  PyObject *res = invoke_raw(op_name, args, nargs, kwargs_json);
  if (res == nullptr) return nullptr;
  if (PyTuple_Check(res)) {  // multi-output op: hand back the first
    PyObject *first = PyTuple_GET_ITEM(res, 0);
    Py_INCREF(first);
    Py_DECREF(res);
    return first;
  }
  return res;
}

// Multi-output invoke (ref: MXImperativeInvokeEx num_outputs out-param):
// fills outs[0..min(n, out_capacity)) with owned handles, returns the
// op's full output count n (callers detect truncation by n > capacity),
// or -1 on failure.
int mxtpu_invoke_n(const char *op_name, void **args, int nargs,
                   const char *kwargs_json, void **outs, int out_capacity) {
  if (!require_init()) return -1;
  Gil gil;
  PyObject *res = invoke_raw(op_name, args, nargs, kwargs_json);
  if (res == nullptr) return -1;
  if (!PyTuple_Check(res)) {  // single output
    if (out_capacity >= 1) {
      outs[0] = res;
    } else {
      Py_DECREF(res);
    }
    return 1;
  }
  int n = static_cast<int>(PyTuple_Size(res));
  for (int i = 0; i < n && i < out_capacity; ++i) {
    PyObject *o = PyTuple_GET_ITEM(res, i);
    Py_INCREF(o);
    outs[i] = o;
  }
  Py_DECREF(res);
  return n;
}

// ---- autograd / training surface (ref: MXAutogradSetIsRecording,
//      MXAutogradBackwardEx, MXNDArrayGetGrad) ------------------------------

// Toggle tape recording and training mode together, like
// `with autograd.record()`.  Returns the previous recording flag or -1.
int mxtpu_autograd_set_recording(int on) {
  if (!require_init()) return -1;
  Gil gil;
  PyObject *ag = PyImport_ImportModule("mxnet_tpu_torch.autograd");
  if (ag == nullptr) {
    capture_py_error("import mxnet_tpu_torch.autograd failed");
    return -1;
  }
  PyObject *prev = PyObject_CallMethod(ag, "set_recording", "i", on != 0);
  PyObject *prev_t =
      prev != nullptr ? PyObject_CallMethod(ag, "set_training", "i", on != 0)
                      : nullptr;
  Py_DECREF(ag);
  if (prev == nullptr || prev_t == nullptr) {
    capture_py_error(prev == nullptr ? "set_recording failed"
                                     : "set_training failed");
    Py_XDECREF(prev);
    Py_XDECREF(prev_t);
    return -1;
  }
  Py_DECREF(prev_t);
  int was = PyObject_IsTrue(prev);
  Py_DECREF(prev);
  return was;
}

// Allocate a gradient buffer on the array so the tape tracks it.
int mxtpu_ndarray_attach_grad(void *handle) {
  if (!require_init()) return -1;
  Gil gil;
  PyObject *r = PyObject_CallMethod(reinterpret_cast<PyObject *>(handle),
                                    "attach_grad", nullptr);
  if (r == nullptr) {
    capture_py_error("attach_grad failed");
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

// Run backward from a (scalar) head, filling attached grads.
int mxtpu_backward(void *handle) {
  if (!require_init()) return -1;
  Gil gil;
  PyObject *r = PyObject_CallMethod(reinterpret_cast<PyObject *>(handle),
                                    "backward", nullptr);
  if (r == nullptr) {
    capture_py_error("backward failed");
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

// Owned handle to the array's accumulated gradient, or NULL when no
// grad is attached (distinguish from errors via mxtpu_last_error()).
void *mxtpu_ndarray_grad(void *handle) {
  if (!require_init()) return nullptr;
  Gil gil;
  PyObject *g = PyObject_GetAttrString(reinterpret_cast<PyObject *>(handle),
                                       "grad");
  if (g == nullptr) {
    capture_py_error("no grad attribute");
    return nullptr;
  }
  if (g == Py_None) {
    Py_DECREF(g);
    g_last_error.clear();
    return nullptr;
  }
  return g;
}

// ---- kvstore surface (ref: MXKVStoreCreate, MXKVStoreInit,
//      MXKVStorePushEx, MXKVStorePullEx, MXKVStorePushPullEx,
//      MXKVStoreSetOptimizer) ----------------------------------------------

// Create a KVStore ("local", "device", ...) in the selected device's
// context.  Returns an owned handle.
void *mxtpu_kvstore_create(const char *type) {
  if (!require_init()) return nullptr;
  Gil gil;
  PyObject *kvmod = PyImport_ImportModule("mxnet_tpu_torch.kvstore");
  if (kvmod == nullptr) {
    capture_py_error("import mxnet_tpu_torch.kvstore failed");
    return nullptr;
  }
  PyObject *kv;
  {
    InContext scope;
    kv = scope.entered
             ? PyObject_CallMethod(kvmod, "create", "s",
                                   type != nullptr ? type : "local")
             : nullptr;
  }
  Py_DECREF(kvmod);
  if (kv == nullptr) capture_py_error("kvstore create failed");
  return kv;
}

int mxtpu_kvstore_free(void *kv) {
  if (!require_init()) return -1;
  Gil gil;
  Py_XDECREF(reinterpret_cast<PyObject *>(kv));
  return 0;
}

}  // extern "C"

namespace {

// Shared no-result method call on the kvstore handle.
int kv_call(void *kv, const char *method, const char *key, void *value) {
  if (!require_init()) return -1;
  Gil gil;
  PyObject *r = PyObject_CallMethod(reinterpret_cast<PyObject *>(kv),
                                    method, "sO", key,
                                    reinterpret_cast<PyObject *>(value));
  if (r == nullptr) {
    capture_py_error(method);
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

}  // namespace

extern "C" {

// Register the key with its initial value (ref: MXKVStoreInit).
int mxtpu_kvstore_init(void *kv, const char *key, void *value) {
  return kv_call(kv, "init", key, value);
}

// Push a value (gradient) for aggregation / store-side update
// (ref: MXKVStorePushEx).
int mxtpu_kvstore_push(void *kv, const char *key, void *value) {
  return kv_call(kv, "push", key, value);
}

// Pull the stored value.  Returns an owned NDArray handle or NULL
// (ref: MXKVStorePullEx).  The handle is a COPY: KVStore.pull hands back
// the live stored array, which later pushes update in place — a C client
// snapshot must not change under it.
void *mxtpu_kvstore_pull(void *kv, const char *key) {
  if (!require_init()) return nullptr;
  Gil gil;
  PyObject *r = PyObject_CallMethod(reinterpret_cast<PyObject *>(kv),
                                    "pull", "s", key);
  if (r == nullptr) {
    capture_py_error("kvstore pull failed");
    return nullptr;
  }
  PyObject *snap = PyObject_CallMethod(r, "copy", nullptr);
  Py_DECREF(r);
  if (snap == nullptr) capture_py_error("kvstore pull copy failed");
  return snap;
}

// Fused push+pull (ref: MXKVStorePushPullEx): pushes `value`, then
// returns the freshly aggregated/updated stored value as an owned handle.
void *mxtpu_kvstore_pushpull(void *kv, const char *key, void *value) {
  if (mxtpu_kvstore_push(kv, key, value) != 0) return nullptr;
  return mxtpu_kvstore_pull(kv, key);
}

// Install a store-side optimizer so push applies an update instead of
// overwrite/accumulate (ref: MXKVStoreSetOptimizer).  kwargs_json: JSON
// object of optimizer args ({"learning_rate": 0.1}), "" or NULL for none.
int mxtpu_kvstore_set_optimizer(void *kv, const char *name,
                                const char *kwargs_json) {
  if (!require_init()) return -1;
  Gil gil;
  PyObject *optmod = PyImport_ImportModule("mxnet_tpu_torch.optimizer");
  if (optmod == nullptr) {
    capture_py_error("import mxnet_tpu_torch.optimizer failed");
    return -1;
  }
  PyObject *create = PyObject_GetAttrString(optmod, "create");
  Py_DECREF(optmod);
  if (create == nullptr) {
    capture_py_error("optimizer.create missing");
    return -1;
  }
  bool ok;
  PyObject *kw = json_kwargs(kwargs_json, &ok);
  if (!ok) {
    Py_DECREF(create);
    return -1;
  }
  PyObject *pos = Py_BuildValue("(s)", name);
  PyObject *opt = PyObject_Call(create, pos, kw);
  Py_DECREF(pos);
  Py_XDECREF(kw);
  Py_DECREF(create);
  if (opt == nullptr) {
    capture_py_error("optimizer create failed");
    return -1;
  }
  PyObject *r = PyObject_CallMethod(reinterpret_cast<PyObject *>(kv),
                                    "set_optimizer", "O", opt);
  Py_DECREF(opt);
  if (r == nullptr) {
    capture_py_error("set_optimizer failed");
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

}  // extern "C"

// ---- runtime introspection / utilities (ref: MXGetVersion,
//      MXListAllOpNames, MXSymbolGetAtomicSymbolInfo, MXRandomSeed,
//      MXNDArrayWaitAll, MXGetGPUCount) ------------------------------------

namespace {

// Copy `s` into out (capacity bytes incl. NUL).  Returns the byte length
// the full string needs INCLUDING the NUL, so callers can size-and-retry;
// writes a truncated NUL-terminated prefix when capacity is short.
long copy_out_string(const std::string &s, char *out, long capacity) {
  long need = static_cast<long>(s.size()) + 1;
  if (out != nullptr && capacity > 0) {
    long n = need <= capacity ? need - 1 : capacity - 1;
    std::memcpy(out, s.data(), n);
    out[n] = '\0';
  }
  return need;
}

// Call module.fn() and return 0, or -1 with the error set.
int call_void(const char *module, const char *fn, const char *what) {
  PyObject *mod = PyImport_ImportModule(module);
  PyObject *r = mod != nullptr ? PyObject_CallMethod(mod, fn, nullptr)
                               : nullptr;
  Py_XDECREF(mod);
  if (r == nullptr) {
    capture_py_error(what);
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

}  // namespace

extern "C" {

// Framework version as major*10000 + minor*100 + patch
// (ref: MXGetVersion's MXNET_VERSION encoding).  -1 on failure.
int mxtpu_version() {
  if (!require_init()) return -1;
  Gil gil;
  PyObject *mod = PyImport_ImportModule("mxnet_tpu_torch");
  PyObject *v = mod != nullptr ? PyObject_GetAttrString(mod, "__version__")
                               : nullptr;
  Py_XDECREF(mod);
  if (v == nullptr) {
    capture_py_error("__version__ missing");
    return -1;
  }
  const char *c = PyUnicode_AsUTF8(v);
  if (c == nullptr) {
    capture_py_error("__version__ not a string");
    Py_DECREF(v);
    return -1;
  }
  int maj = 0, min = 0, pat = 0;
  std::sscanf(c, "%d.%d.%d", &maj, &min, &pat);
  Py_DECREF(v);
  return maj * 10000 + min * 100 + pat;
}

// CUDA devices on the card (context.num_gpus()), 1 on the host
// (ref: MXGetGPUCount).
int mxtpu_num_devices() {
  if (!require_init()) return -1;
  if (!g_on_card) return 1;
  Gil gil;
  PyObject *ctxmod = PyImport_ImportModule("mxnet_tpu_torch.context");
  PyObject *n = ctxmod != nullptr
                    ? PyObject_CallMethod(ctxmod, "num_gpus", nullptr)
                    : nullptr;
  Py_XDECREF(ctxmod);
  if (n == nullptr) {
    capture_py_error("context.num_gpus failed");
    return -1;
  }
  int count = static_cast<int>(PyLong_AsLong(n));
  Py_DECREF(n);
  return count;
}

// Platform name of the selected device, "gpu" or "cpu" (JAX's backend
// names), into out.  Returns needed byte length incl. NUL, or -1.
long mxtpu_device_platform(char *out, long capacity) {
  if (!require_init()) return -1;
  return copy_out_string(g_on_card ? "gpu" : "cpu", out, capacity);
}

// Seed the framework RNG streams (ref: MXRandomSeed).
int mxtpu_random_seed(int seed) {
  if (!require_init()) return -1;
  Gil gil;
  PyObject *rnd = PyImport_ImportModule("mxnet_tpu_torch.random");
  PyObject *r = rnd != nullptr ? PyObject_CallMethod(rnd, "seed", "i", seed)
                               : nullptr;
  Py_XDECREF(rnd);
  if (r == nullptr) {
    capture_py_error("random.seed failed");
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

// Block until every queued kernel on the cards has finished
// (ref: MXNDArrayWaitAll; the port's engine.waitall).
int mxtpu_wait_all() {
  if (!require_init()) return -1;
  Gil gil;
  return call_void("mxnet_tpu_torch.engine", "waitall",
                   "engine.waitall failed");
}

// Newline-joined sorted registry op names into out (ref: MXListAllOpNames).
// Returns the byte length the full listing needs incl. NUL (call with
// capacity 0 to size a buffer), or -1.
long mxtpu_list_ops(char *out, long capacity) {
  if (!require_init()) return -1;
  Gil gil;
  PyObject *reg = PyImport_ImportModule("mxnet_tpu_torch.ops.registry");
  PyObject *ops = reg != nullptr ? PyObject_GetAttrString(reg, "OPS")
                                 : nullptr;
  Py_XDECREF(reg);
  if (ops == nullptr) {
    capture_py_error("ops.registry.OPS missing");
    return -1;
  }
  PyObject *keys = PyDict_Keys(ops);
  Py_DECREF(ops);
  if (keys == nullptr || PyList_Sort(keys) != 0) {
    capture_py_error("op name listing failed");
    Py_XDECREF(keys);
    return -1;
  }
  std::string joined;
  Py_ssize_t n = PyList_Size(keys);
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char *c = PyUnicode_AsUTF8(PyList_GET_ITEM(keys, i));
    if (c == nullptr) continue;
    if (!joined.empty()) joined += '\n';
    joined += c;
  }
  Py_DECREF(keys);
  return copy_out_string(joined, out, capacity);
}

// Docstring of a registered op into out (ref: MXSymbolGetAtomicSymbolInfo's
// description field).  Returns needed byte length incl. NUL, or -1.
long mxtpu_op_doc(const char *op_name, char *out, long capacity) {
  if (!require_init()) return -1;
  Gil gil;
  PyObject *reg = PyImport_ImportModule("mxnet_tpu_torch.ops.registry");
  PyObject *fn = reg != nullptr
                     ? PyObject_CallMethod(reg, "get_op", "s", op_name)
                     : nullptr;
  Py_XDECREF(reg);
  if (fn == nullptr) {
    capture_py_error("unknown op");
    return -1;
  }
  PyObject *doc = PyObject_GetAttrString(fn, "__doc__");
  Py_DECREF(fn);
  std::string text;
  if (doc != nullptr && doc != Py_None) {
    const char *c = PyUnicode_AsUTF8(doc);
    if (c != nullptr) text = c;
  }
  Py_XDECREF(doc);
  PyErr_Clear();
  return copy_out_string(text, out, capacity);
}

// ---- NDArray file I/O (ref: MXNDArraySave / MXNDArrayLoad) ----------------

// Save n arrays to fname.  keys==NULL saves positionally (loads back as a
// list); otherwise keys[i] names handles[i] (loads back as a dict).
int mxtpu_ndarray_save(const char *fname, const char **keys, void **handles,
                       int n) {
  if (!require_init()) return -1;
  Gil gil;
  PyObject *payload;
  if (keys != nullptr) {
    payload = PyDict_New();
    for (int i = 0; i < n; ++i) {
      PyDict_SetItemString(payload, keys[i],
                           reinterpret_cast<PyObject *>(handles[i]));
    }
  } else {
    payload = PyList_New(n);
    for (int i = 0; i < n; ++i) {
      PyObject *h = reinterpret_cast<PyObject *>(handles[i]);
      Py_INCREF(h);
      PyList_SET_ITEM(payload, i, h);
    }
  }
  PyObject *r = PyObject_CallMethod(g_nd_module, "save", "sO", fname,
                                    payload);
  Py_DECREF(payload);
  if (r == nullptr) {
    capture_py_error("nd.save failed");
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

// Load arrays from fname onto the selected device.  Fills
// outs[0..min(count, out_capacity)) with owned handles; for dict-saved
// files also writes the newline-joined key order into names
// (names_capacity bytes; "" for list saves).  Returns the total array
// count (callers detect truncation), or -1.
int mxtpu_ndarray_load(const char *fname, void **outs, int out_capacity,
                       char *names, long names_capacity) {
  if (!require_init()) return -1;
  Gil gil;
  PyObject *load = PyObject_GetAttrString(g_nd_module, "load");
  PyObject *pos = Py_BuildValue("(s)", fname);
  PyObject *kw = Py_BuildValue("{sO}", "ctx", g_ctx);
  PyObject *r = load != nullptr && pos != nullptr && kw != nullptr
                    ? PyObject_Call(load, pos, kw)
                    : nullptr;
  Py_XDECREF(kw);
  Py_XDECREF(pos);
  Py_XDECREF(load);
  if (r == nullptr) {
    capture_py_error("nd.load failed");
    return -1;
  }
  std::string joined;
  int n = 0;
  if (PyDict_Check(r)) {
    PyObject *key = nullptr, *val = nullptr;
    Py_ssize_t at = 0;
    while (PyDict_Next(r, &at, &key, &val)) {
      if (n < out_capacity) {
        Py_INCREF(val);
        outs[n] = val;
      }
      const char *c = PyUnicode_AsUTF8(key);
      if (c != nullptr) {
        if (!joined.empty()) joined += '\n';
        joined += c;
      }
      ++n;
    }
  } else if (PyList_Check(r)) {
    n = static_cast<int>(PyList_Size(r));
    for (int i = 0; i < n && i < out_capacity; ++i) {
      PyObject *o = PyList_GET_ITEM(r, i);
      Py_INCREF(o);
      outs[i] = o;
    }
  } else {
    Py_DECREF(r);
    g_last_error = "nd.load returned neither list nor dict";
    return -1;
  }
  Py_DECREF(r);
  if (names != nullptr) copy_out_string(joined, names, names_capacity);
  return n;
}

// Wait for the card's queued work and drop the runtime's references.  The
// interpreter stays up (tearing down torch's CUDA state at Py_Finalize is
// not worth the risk for a long-lived serving process; the OS reclaims).
int mxtpu_shutdown() {
  if (g_nd_module == nullptr) return 0;
  Gil gil;
  int rc = call_void("mxnet_tpu_torch.engine", "waitall",
                     "engine.waitall failed");
  Py_CLEAR(g_nd_module);
  Py_CLEAR(g_ctx);
  return rc;
}

}  // extern "C"
