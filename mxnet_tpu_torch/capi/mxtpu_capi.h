/* mxtpu C ABI over the PyTorch/CUDA port (ref: include/mxnet/c_api.h —
 * the MX* surface all language bindings sit on).  Handles are opaque
 * pointers owning a CPython reference into the embedded mxnet_tpu_torch
 * runtime; every entry point acquires the GIL, so the library is safe
 * from any single client thread at a time.
 *
 * The same functions, names and signatures as the JAX package's header
 * (src/mxtpu_capi.h), so a client written for one compiles against the
 * other, plus mxtpu_init_device, which picks the device.
 *
 * Device: everything runs on the CUDA card that mxtpu_init_device named
 * ("cuda", "cuda:N"), or on the host when it named "cpu".  mxtpu_init()
 * is mxtpu_init_device("cuda"): without a card it fails and never falls
 * back to the host.  (MXNet's own counterpart is the dev_type/dev_id of
 * MXNDArrayCreateEx.)
 *
 * Threads: autograd's recording flag and the port's context stack live
 * in the calling thread's Python state.  The library keeps the chosen
 * device itself and hands it to every call, so arrays and op results
 * land on it from any thread; recording (mxtpu_autograd_set_recording)
 * lasts across calls on the thread that called mxtpu_init*, as in the
 * JAX ABI.
 *
 * Error contract: failing calls return NULL / negative and set a
 * thread-global message readable via mxtpu_last_error() (ref:
 * MXGetLastError). */
#ifndef MXTPU_CAPI_H_
#define MXTPU_CAPI_H_

#ifdef __cplusplus
extern "C" {
#endif

/* ---- lifecycle ---------------------------------------------------------- */

/* Start the embedded interpreter (unless the process already runs one),
 * import the port and select the device: "cuda", "cuda:N" or "cpu".
 * Returns 0, or -1 with mxtpu_last_error() saying why (a missing CUDA
 * device among the reasons).  Imports resolve via PYTHONPATH (the repo
 * root and the site-packages holding torch and numpy).  Calling it again
 * selects another device for the calls that follow. */
int mxtpu_init_device(const char *device);
/* mxtpu_init_device("cuda"). */
int mxtpu_init(void);
/* Waits for the card's queued work and drops the runtime's references;
 * the interpreter stays up. */
int mxtpu_shutdown(void);
const char *mxtpu_last_error(void);

/* ---- NDArray ------------------------------------------------------------ */

/* Create an NDArray on the device by COPYING ndim-dimensional host data
 * (ref: MXNDArraySyncCopyFromCPU — same copy-in semantics: the caller's
 * buffer is free to be reused or freed the moment the call returns).
 * dtype: "float32" | "float16" | "bfloat16" | "int32" | "uint8" |
 * "int8".  data is raw bytes in that dtype's layout (bfloat16 = high 16
 * bits of the IEEE f32 pattern).  float64 and int64 are rejected, for
 * parity with the JAX ABI, whose runtime computes in 32-bit: a client
 * converts them to the 32-bit kind host-side with either library. */
void *mxtpu_ndarray_create_dtype(const void *data, const long *shape,
                                 int ndim, const char *dtype);

/* float32 convenience wrapper over mxtpu_ndarray_create_dtype. */
void *mxtpu_ndarray_create(const float *data, const long *shape, int ndim);

int mxtpu_ndarray_free(void *handle);
int mxtpu_ndarray_ndim(void *handle);
/* Writes the shape into out (caller sizes it via mxtpu_ndarray_ndim);
 * returns ndim. */
int mxtpu_ndarray_shape(void *handle, long *out);
/* Writes the dtype name (as above) into out; returns 0. */
int mxtpu_ndarray_dtype(void *handle, char *out, int capacity);

/* Blocking device->host copy converted to float32 (ref:
 * MXNDArraySyncCopyToCPU).  capacity in ELEMENTS; returns elements
 * copied. */
int mxtpu_ndarray_to_host(void *handle, float *out, long capacity);
/* Blocking device->host copy in the array's OWN dtype; capacity in
 * BYTES; returns bytes copied. */
long mxtpu_ndarray_to_host_bytes(void *handle, void *out, long capacity);

/* ---- operator invocation ------------------------------------------------ */

/* Invoke a registered operator by name (ref: MXImperativeInvokeEx) on
 * the device.  args: NDArray handles; kwargs_json: JSON object of op
 * attrs (NULL or "" for none).  Returns the FIRST output handle — for
 * multi-output ops (BatchNorm, FusedNormReluConv, ...) the remaining
 * outputs are DISCARDED; use mxtpu_invoke_n when you need them.  On the
 * card, FusedNormReluConv, flash_attention and paged_decode_attention
 * run the port's hand-written CUDA kernels. */
void *mxtpu_invoke(const char *op_name, void **args, int nargs,
                   const char *kwargs_json);

/* Multi-output invoke: fills outs[0..n) with owned handles and returns
 * n, the op's output count (even when n > out_capacity — in that case
 * only out_capacity handles are written, the rest are released; call
 * again with a bigger array if truncated).  Returns -1 on failure. */
int mxtpu_invoke_n(const char *op_name, void **args, int nargs,
                   const char *kwargs_json, void **outs, int out_capacity);

/* ---- autograd / training (ref: MXAutogradSetIsRecording,
 *      MXAutogradBackwardEx, MXNDArrayGetGrad) ---------------------------- */

/* Toggle tape recording AND training mode together (the common case,
 * like `with autograd.record()`) on the calling thread.  Returns the
 * previous recording flag, or -1 on failure. */
int mxtpu_autograd_set_recording(int on);

/* Allocate a gradient buffer on the array so the tape tracks it. */
int mxtpu_ndarray_attach_grad(void *handle);

/* Run backward from a (scalar) head, filling attached grads. */
int mxtpu_backward(void *handle);

/* Owned handle to the array's accumulated gradient (NULL if none /
 * never attached). */
void *mxtpu_ndarray_grad(void *handle);

/* ---- kvstore (ref: MXKVStoreCreate, MXKVStoreInit, MXKVStorePushEx,
 *      MXKVStorePullEx, MXKVStorePushPullEx, MXKVStoreSetOptimizer) ------- */

/* Create a KVStore handle; type: "local" | "device" (the dist types need
 * a process group and are the Python launcher's territory). */
void *mxtpu_kvstore_create(const char *type);
int mxtpu_kvstore_free(void *kv);

/* Register `key` with its initial value. */
int mxtpu_kvstore_init(void *kv, const char *key, void *value);

/* Push a value (gradient); with an optimizer installed the store
 * applies the update, otherwise pushes accumulate reference-style. */
int mxtpu_kvstore_push(void *kv, const char *key, void *value);

/* Pull the stored value as a new owned NDArray handle (NULL on error). */
void *mxtpu_kvstore_pull(void *kv, const char *key);

/* Fused push+pull: returns the post-push stored value (owned handle). */
void *mxtpu_kvstore_pushpull(void *kv, const char *key, void *value);

/* Install a store-side optimizer by registry name ("sgd", "adam", ...)
 * with JSON kwargs ({"learning_rate": 0.1}; NULL or "" for defaults), so
 * subsequent pushes of gradients update the stored weights in place. */
int mxtpu_kvstore_set_optimizer(void *kv, const char *name,
                                const char *kwargs_json);

/* ---- runtime introspection / utilities (ref: MXGetVersion,
 *      MXListAllOpNames, MXSymbolGetAtomicSymbolInfo, MXRandomSeed,
 *      MXNDArrayWaitAll, MXGetGPUCount) --------------------------------- */

/* Framework version, major*10000 + minor*100 + patch (ref: MXGetVersion). */
int mxtpu_version(void);

/* CUDA devices visible on the card, 1 on the host (ref: MXGetGPUCount). */
int mxtpu_num_devices(void);

/* Platform name of the selected device: "gpu" on the card, "cpu" on the
 * host.  Returns the byte length the name needs INCLUDING the NUL
 * (size-and-retry contract shared by every string-returning call below),
 * or -1. */
long mxtpu_device_platform(char *out, long capacity);

/* Seed the framework RNG streams of every device (ref: MXRandomSeed). */
int mxtpu_random_seed(int seed);

/* Block until all queued device computations finish (ref: MXNDArrayWaitAll). */
int mxtpu_wait_all(void);

/* Newline-joined sorted op names (ref: MXListAllOpNames).  Call with
 * capacity 0 to size the buffer; returns needed bytes incl. NUL, or -1. */
long mxtpu_list_ops(char *out, long capacity);

/* Docstring of one registered op (ref: MXSymbolGetAtomicSymbolInfo
 * description).  Same size-and-retry contract; -1 on unknown op. */
long mxtpu_op_doc(const char *op_name, char *out, long capacity);

/* ---- NDArray file I/O (ref: MXNDArraySave / MXNDArrayLoad) ------------- */

/* Save n arrays (numpy .npz, the JAX package's container).  keys==NULL:
 * positional (loads back as a list); else keys[i] names handles[i]
 * (loads back as a dict). */
int mxtpu_ndarray_save(const char *fname, const char **keys, void **handles,
                       int n);

/* Load arrays onto the device; fills outs[0..min(count, out_capacity))
 * with owned handles.  For dict-saved files writes newline-joined keys
 * into names ("" for list saves).  Returns total count (n > out_capacity
 * signals truncation), -1 on error. */
int mxtpu_ndarray_load(const char *fname, void **outs, int out_capacity,
                       char *names, long names_capacity);

#ifdef __cplusplus
}
#endif

#endif  /* MXTPU_CAPI_H_ */
