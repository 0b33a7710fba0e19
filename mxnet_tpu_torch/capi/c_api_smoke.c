/* C smoke client for the port's mxtpu C ABI (ref: the reference's C API
 * tests — a non-Python caller creates NDArrays, invokes ops, reads
 * results, and TRAINS: the reference's bar for its C surface is
 * MXAutogradBackwardEx driving real updates, so this client fits a
 * 2-layer MLP from C and asserts the loss drops).  The same checks as the
 * JAX package's client (src/tests/c_api_smoke.c), on the device named by
 * argv[1] ("cuda", "cuda:N" or "cpu"; default "cuda").
 *
 *     c_api_smoke [device [inputs.npz outputs.npz]]
 *
 * With an inputs file (written with the port's nd.save) it also drives
 * the ops whose card path is a hand-written kernel: FusedNormReluConv
 * and flash_attention forward and backward, paged_decode_attention with
 * and without impl="jnp", and saves every output and gradient to the
 * outputs file for the caller to hold against the plain versions.
 * Built by mxnet_tpu_torch.capi.build_client(). */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#include "mxtpu_capi.h"

#define CHECK(cond, msg)                                            \
  do {                                                              \
    if (!(cond)) {                                                  \
      fprintf(stderr, "FAIL: %s (%s)\n", msg, mxtpu_last_error());  \
      return 1;                                                     \
    }                                                               \
  } while (0)

/* forward: loss = mean((relu(x@w1 + b1) @ w2 + b2 - y)^2); returns the
 * loss handle (caller frees) or NULL. */
static void *mlp_forward(void *x, void *w1, void *b1, void *w2, void *b2,
                         void *y) {
  void *a1[2] = {x, w1};
  void *z1 = mxtpu_invoke("dot", a1, 2, NULL);
  if (!z1) return NULL;
  void *a2[2] = {z1, b1};
  void *z1b = mxtpu_invoke("broadcast_add", a2, 2, NULL);
  mxtpu_ndarray_free(z1);
  if (!z1b) return NULL;
  void *a3[1] = {z1b};
  void *h = mxtpu_invoke("relu", a3, 1, NULL);
  mxtpu_ndarray_free(z1b);
  if (!h) return NULL;
  void *a4[2] = {h, w2};
  void *z2 = mxtpu_invoke("dot", a4, 2, NULL);
  mxtpu_ndarray_free(h);
  if (!z2) return NULL;
  void *a5[2] = {z2, b2};
  void *pred = mxtpu_invoke("broadcast_add", a5, 2, NULL);
  mxtpu_ndarray_free(z2);
  if (!pred) return NULL;
  void *a6[2] = {pred, y};
  void *diff = mxtpu_invoke("broadcast_sub", a6, 2, NULL);
  mxtpu_ndarray_free(pred);
  if (!diff) return NULL;
  void *a7[1] = {diff};
  void *sq = mxtpu_invoke("square", a7, 1, NULL);
  mxtpu_ndarray_free(diff);
  if (!sq) return NULL;
  void *a8[1] = {sq};
  void *loss = mxtpu_invoke("mean", a8, 1, NULL);
  mxtpu_ndarray_free(sq);
  return loss;
}

/* one SGD update: param <- sgd_update(param, grad, lr); frees the old
 * param handle and returns the new one. */
static void *sgd(void *param, const char *lr_json) {
  void *g = mxtpu_ndarray_grad(param);
  if (!g) return NULL;
  void *a[2] = {param, g};
  void *updated = mxtpu_invoke("sgd_update", a, 2, lr_json);
  mxtpu_ndarray_free(g);
  mxtpu_ndarray_free(param);
  return updated;
}

static float frand(unsigned *seed) { /* deterministic LCG in [-0.5, 0.5) */
  *seed = *seed * 1664525u + 1013904223u;
  return ((*seed >> 8) & 0xFFFF) / 65536.0f - 0.5f;
}

/* The handle loaded under `key` (names: newline-joined keys), or NULL. */
static void *named(const char *names, void **handles, int n,
                   const char *key) {
  const char *p = names;
  for (int i = 0; i < n && p != NULL; ++i) {
    const char *end = strchr(p, '\n');
    size_t len = end != NULL ? (size_t)(end - p) : strlen(p);
    if (len == strlen(key) && strncmp(p, key, len) == 0) return handles[i];
    p = end != NULL ? end + 1 : NULL;
  }
  return NULL;
}

/* sum(out * w): a scalar head whose gradient in `out` is `w`. */
static void *weighted_sum(void *out, void *w) {
  void *a[2] = {out, w};
  void *prod = mxtpu_invoke("broadcast_mul", a, 2, NULL);
  if (!prod) return NULL;
  void *s[1] = {prod};
  void *head = mxtpu_invoke("sum", s, 1, NULL);
  mxtpu_ndarray_free(prod);
  return head;
}

/* The kernel section: the inputs file's arrays through the three ops
 * whose card path is a hand-written kernel, every output and gradient
 * saved to `outputs`. */
static int kernels(const char *inputs, const char *outputs) {
  enum { MAX_IN = 32, N_OUT = 13 };
  void *in[MAX_IN] = {NULL};
  static char names[4096];
  int n = mxtpu_ndarray_load(inputs, in, MAX_IN, names, sizeof names);
  CHECK(n > 0 && n <= MAX_IN, "load the kernel inputs");
  void *cx = named(names, in, n, "conv_x"), *cw = named(names, in, n, "conv_w");
  void *cg = named(names, in, n, "conv_gamma");
  void *cb = named(names, in, n, "conv_beta");
  void *cmm = named(names, in, n, "conv_moving_mean");
  void *cmv = named(names, in, n, "conv_moving_var");
  void *cdo = named(names, in, n, "conv_dout");
  void *fq = named(names, in, n, "flash_q"), *fk = named(names, in, n, "flash_k");
  void *fv = named(names, in, n, "flash_v");
  void *fdo = named(names, in, n, "flash_dout");
  void *fh = named(names, in, n, "flash_heads");
  void *pq = named(names, in, n, "paged_q");
  void *pk = named(names, in, n, "paged_k_pages");
  void *pv = named(names, in, n, "paged_v_pages");
  void *pt = named(names, in, n, "paged_page_tables");
  void *pl = named(names, in, n, "paged_lengths");
  CHECK(cx && cw && cg && cb && cmm && cmv && cdo && fq && fk && fv && fdo &&
            fh && pq && pk && pv && pt && pl,
        "the inputs file holds every kernel input");

  /* FusedNormReluConv, training mode: forward, then backward from
   * sum(out * dout), which reaches the dX and dW kernels */
  void *conv_leaves[4] = {cx, cw, cg, cb};
  for (int i = 0; i < 4; ++i) {
    CHECK(mxtpu_ndarray_attach_grad(conv_leaves[i]) == 0, "attach conv");
  }
  CHECK(mxtpu_autograd_set_recording(1) >= 0, "record on");
  void *cargs[6] = {cx, cw, cg, cb, cmm, cmv};
  void *conv[3] = {NULL, NULL, NULL};
  int nconv = mxtpu_invoke_n("FusedNormReluConv", cargs, 6, NULL, conv, 3);
  void *chead = nconv == 3 ? weighted_sum(conv[0], cdo) : NULL;
  CHECK(mxtpu_autograd_set_recording(0) >= 0, "record off");
  CHECK(nconv == 3 && chead != NULL, "FusedNormReluConv forward");
  CHECK(mxtpu_backward(chead) == 0, "FusedNormReluConv backward");

  /* flash_attention over (B, S, H*D): forward, then backward, which
   * reaches the dQ and dK/dV kernels */
  int heads = 0;
  CHECK(mxtpu_ndarray_to_host_bytes(fh, &heads, sizeof heads) ==
            (long)sizeof heads,
        "flash heads");
  char flash_kw[64];
  snprintf(flash_kw, sizeof flash_kw, "{\"heads\": %d}", heads);
  void *flash_leaves[3] = {fq, fk, fv};
  for (int i = 0; i < 3; ++i) {
    CHECK(mxtpu_ndarray_attach_grad(flash_leaves[i]) == 0, "attach flash");
  }
  CHECK(mxtpu_autograd_set_recording(1) >= 0, "record on");
  void *fo = mxtpu_invoke("flash_attention", flash_leaves, 3, flash_kw);
  void *fhead = fo != NULL ? weighted_sum(fo, fdo) : NULL;
  CHECK(mxtpu_autograd_set_recording(0) >= 0, "record off");
  CHECK(fo != NULL && fhead != NULL, "flash_attention forward");
  CHECK(mxtpu_backward(fhead) == 0, "flash_attention backward");

  /* paged_decode_attention: the kernel (no impl) and its plain version
   * (impl="jnp") on the same device */
  void *pargs[5] = {pq, pk, pv, pt, pl};
  void *paged = mxtpu_invoke("paged_decode_attention", pargs, 5, NULL);
  void *paged_plain = mxtpu_invoke("paged_decode_attention", pargs, 5,
                                   "{\"impl\": \"jnp\"}");
  CHECK(paged != NULL && paged_plain != NULL, "paged_decode_attention");

  const char *keys[N_OUT] = {
      "conv_out", "conv_new_moving_mean", "conv_new_moving_var", "conv_dx",
      "conv_dw", "conv_dgamma", "conv_dbeta", "flash_out", "flash_dq",
      "flash_dk", "flash_dv", "paged_out", "paged_plain"};
  void *vals[N_OUT] = {conv[0], conv[1], conv[2],
                       mxtpu_ndarray_grad(cx), mxtpu_ndarray_grad(cw),
                       mxtpu_ndarray_grad(cg), mxtpu_ndarray_grad(cb), fo,
                       mxtpu_ndarray_grad(fq), mxtpu_ndarray_grad(fk),
                       mxtpu_ndarray_grad(fv), paged, paged_plain};
  for (int i = 0; i < N_OUT; ++i) CHECK(vals[i] != NULL, keys[i]);
  CHECK(mxtpu_ndarray_save(outputs, keys, vals, N_OUT) == 0,
        "save the kernel outputs");
  long xs[4], qs[3];
  CHECK(mxtpu_ndarray_shape(cx, xs) == 4 && mxtpu_ndarray_shape(fq, qs) == 3,
        "kernel input shapes");
  char xdt[16], qdt[16];
  CHECK(mxtpu_ndarray_dtype(cx, xdt, sizeof xdt) == 0 &&
            mxtpu_ndarray_dtype(fq, qdt, sizeof qdt) == 0,
        "kernel input dtypes");
  printf("c_api kernels: FusedNormReluConv (%ld, %ld, %ld, %ld) %s, "
         "flash_attention (%ld, %ld, %ld) x %d heads %s, "
         "paged_decode_attention x2; %d outputs and gradients saved\n",
         xs[0], xs[1], xs[2], xs[3], xdt, qs[0], qs[1], qs[2], heads, qdt,
         N_OUT);
  for (int i = 0; i < N_OUT; ++i) mxtpu_ndarray_free(vals[i]);
  mxtpu_ndarray_free(chead);
  mxtpu_ndarray_free(fhead);
  for (int i = 0; i < n; ++i) mxtpu_ndarray_free(in[i]);
  return 0;
}

int main(int argc, char **argv) {
  const char *device = argc > 1 ? argv[1] : "cuda";
  const char *inputs = argc > 2 ? argv[2] : NULL;
  const char *outputs = argc > 3 ? argv[3] : NULL;
  if (inputs != NULL && outputs == NULL) {
    fprintf(stderr, "usage: %s [device [inputs.npz outputs.npz]]\n",
            argv[0]);
    return 2;
  }
  CHECK(mxtpu_init_device(device) == 0, "init");
  printf("c_api smoke: device %s\n", device);

  float a_data[6] = {1, 2, 3, 4, 5, 6};
  float b_data[6] = {10, 20, 30, 40, 50, 60};
  long shape[2] = {2, 3};
  void *a = mxtpu_ndarray_create(a_data, shape, 2);
  void *b = mxtpu_ndarray_create(b_data, shape, 2);
  CHECK(a && b, "ndarray_create");
  CHECK(mxtpu_ndarray_ndim(a) == 2, "ndim");
  long got_shape[2];
  CHECK(mxtpu_ndarray_shape(a, got_shape) == 2 && got_shape[0] == 2 &&
            got_shape[1] == 3,
        "shape");
  char dt[16];
  CHECK(mxtpu_ndarray_dtype(a, dt, sizeof dt) == 0 &&
            strcmp(dt, "float32") == 0,
        "dtype query");

  /* copy-in semantics: mutate the caller buffer after create — the
   * NDArray must NOT see it (the ADVICE r4 aliasing fix). */
  a_data[0] = 999.0f;
  float echo[6];
  CHECK(mxtpu_ndarray_to_host(a, echo, 6) == 6, "to_host");
  CHECK(fabsf(echo[0] - 1.0f) < 1e-6f, "create copies, not aliases");
  a_data[0] = 1.0f;

  /* elementwise op */
  void *args[2] = {a, b};
  void *sum = mxtpu_invoke("broadcast_add", args, 2, NULL);
  CHECK(sum != NULL, "invoke broadcast_add");
  float out[6];
  CHECK(mxtpu_ndarray_to_host(sum, out, 6) == 6, "to_host");
  for (int i = 0; i < 6; ++i) {
    CHECK(fabsf(out[i] - (a_data[i] + b_data[i])) < 1e-5f, "add values");
  }

  /* op with attrs through the JSON kwargs path */
  void *args1[1] = {a};
  void *summed = mxtpu_invoke("sum", args1, 1, "{\"axis\": 1}");
  CHECK(summed != NULL, "invoke sum axis=1");
  float out2[2];
  CHECK(mxtpu_ndarray_to_host(summed, out2, 2) == 2, "sum to_host");
  CHECK(fabsf(out2[0] - 6.0f) < 1e-5f && fabsf(out2[1] - 15.0f) < 1e-5f,
        "sum values");

  /* matmul hits the MXU path op */
  long bt_shape[2] = {3, 2};
  float bt_data[6] = {1, 0, 0, 1, 1, 1};
  void *bt = mxtpu_ndarray_create(bt_data, bt_shape, 2);
  void *args2[2] = {a, bt};
  void *prod = mxtpu_invoke("dot", args2, 2, NULL);
  CHECK(prod != NULL, "invoke dot");
  float out3[4];
  CHECK(mxtpu_ndarray_to_host(prod, out3, 4) == 4, "dot to_host");
  CHECK(fabsf(out3[0] - 4.0f) < 1e-5f, "dot values"); /* 1*1+2*0+3*1 */

  /* ---- dtype-generic create/read-back ---------------------------------- */
  int i32_data[4] = {-2, 0, 7, 123456};
  long s4[1] = {4};
  void *i32 = mxtpu_ndarray_create_dtype(i32_data, s4, 1, "int32");
  CHECK(i32 != NULL, "int32 create");
  CHECK(mxtpu_ndarray_dtype(i32, dt, sizeof dt) == 0 &&
            strcmp(dt, "int32") == 0,
        "int32 dtype");
  int i32_back[4];
  CHECK(mxtpu_ndarray_to_host_bytes(i32, i32_back, sizeof i32_back) ==
            (long)sizeof i32_back,
        "int32 to_host_bytes");
  for (int i = 0; i < 4; ++i) CHECK(i32_back[i] == i32_data[i], "int32 rt");

  /* float64 is rejected LOUDLY (the runtime computes in 32-bit; a
   * silent downcast under an f64 label would corrupt round-trips). */
  double f64_data[4] = {1.0, -2.5, 3.0, 4.0};
  CHECK(mxtpu_ndarray_create_dtype(f64_data, s4, 1, "float64") == NULL,
        "float64 rejected");
  CHECK(strstr(mxtpu_last_error(), "float64") != NULL,
        "float64 rejection names the dtype");
  long long i64_data[4] = {1, 2, 3, 1LL << 40};
  CHECK(mxtpu_ndarray_create_dtype(i64_data, s4, 1, "int64") == NULL,
        "int64 rejected (would truncate to int32 silently)");

  unsigned char u8_data[4] = {0, 1, 128, 255};
  void *u8 = mxtpu_ndarray_create_dtype(u8_data, s4, 1, "uint8");
  CHECK(u8 != NULL, "uint8 create");
  unsigned char u8_back[4];
  CHECK(mxtpu_ndarray_to_host_bytes(u8, u8_back, 4) == 4, "uint8 rt bytes");
  for (int i = 0; i < 4; ++i) CHECK(u8_back[i] == u8_data[i], "uint8 rt");

  /* bfloat16 = high 16 bits of the f32 pattern; 1.0, 2.5, -3.0, 0.25 are
   * exactly representable so truncation is exact. */
  float bf_vals[4] = {1.0f, 2.5f, -3.0f, 0.25f};
  unsigned short bf_bits[4];
  for (int i = 0; i < 4; ++i) {
    unsigned int u;
    memcpy(&u, &bf_vals[i], 4);
    bf_bits[i] = (unsigned short)(u >> 16);
  }
  void *bf = mxtpu_ndarray_create_dtype(bf_bits, s4, 1, "bfloat16");
  CHECK(bf != NULL, "bfloat16 create");
  CHECK(mxtpu_ndarray_dtype(bf, dt, sizeof dt) == 0 &&
            strcmp(dt, "bfloat16") == 0,
        "bfloat16 dtype");
  float bf_back[4];
  CHECK(mxtpu_ndarray_to_host(bf, bf_back, 4) == 4, "bf16 to f32 host");
  for (int i = 0; i < 4; ++i) {
    CHECK(fabsf(bf_back[i] - bf_vals[i]) < 1e-6f, "bf16 values");
  }
  CHECK(mxtpu_ndarray_create_dtype(bf_bits, s4, 1, "complex128") == NULL,
        "unsupported dtype rejected");

  /* ---- multi-output invoke --------------------------------------------- */
  void *outs[2] = {NULL, NULL};
  void *argk[1] = {a};
  int nout = mxtpu_invoke_n("topk", argk, 1, "{\"k\": 2, \"ret_typ\": \"both\"}",
                            outs, 2);
  CHECK(nout == 2 && outs[0] && outs[1], "invoke_n topk gives 2 outputs");
  float tv[4], ti[4];
  CHECK(mxtpu_ndarray_to_host(outs[0], tv, 4) == 4, "topk values host");
  CHECK(mxtpu_ndarray_to_host(outs[1], ti, 4) == 4, "topk indices host");
  CHECK(fabsf(tv[0] - 3.0f) < 1e-5f && fabsf(ti[0] - 2.0f) < 1e-5f,
        "topk row0 = (3, idx 2)");
  mxtpu_ndarray_free(outs[0]);
  mxtpu_ndarray_free(outs[1]);
  /* capacity-0 probe: count comes back, nothing written */
  CHECK(mxtpu_invoke_n("topk", argk, 1, "{\"k\": 2, \"ret_typ\": \"both\"}",
                       NULL, 0) == 2,
        "invoke_n capacity probe");

  /* unknown op surfaces a clean error, no crash */
  void *bad = mxtpu_invoke("definitely_not_an_op", args, 2, NULL);
  CHECK(bad == NULL, "unknown op returns NULL");
  CHECK(strlen(mxtpu_last_error()) > 0, "unknown op sets error");

  /* ---- train a 2-layer MLP from C (ref: MXAutogradBackwardEx) ---------- */
  enum { N = 16, DIN = 4, DH = 8 };
  static float x_data[N * DIN], y_data[N * 1];
  unsigned seed = 42;
  for (int i = 0; i < N; ++i) { /* y = sum(x) — learnable by a small MLP */
    float s = 0;
    for (int j = 0; j < DIN; ++j) {
      x_data[i * DIN + j] = frand(&seed);
      s += x_data[i * DIN + j];
    }
    y_data[i] = s;
  }
  static float w1_d[DIN * DH], b1_d[DH], w2_d[DH], b2_d[1];
  for (int i = 0; i < DIN * DH; ++i) w1_d[i] = frand(&seed);
  for (int i = 0; i < DH; ++i) b1_d[i] = 0.0f;
  for (int i = 0; i < DH; ++i) w2_d[i] = frand(&seed);
  b2_d[0] = 0.0f;

  long xs[2] = {N, DIN}, ys[2] = {N, 1}, w1s[2] = {DIN, DH}, b1s[1] = {DH},
       w2s[2] = {DH, 1}, b2s[1] = {1};
  void *x = mxtpu_ndarray_create(x_data, xs, 2);
  void *y = mxtpu_ndarray_create(y_data, ys, 2);
  void *w1 = mxtpu_ndarray_create(w1_d, w1s, 2);
  void *b1 = mxtpu_ndarray_create(b1_d, b1s, 1);
  void *w2 = mxtpu_ndarray_create(w2_d, w2s, 2);
  void *b2 = mxtpu_ndarray_create(b2_d, b2s, 1);
  CHECK(x && y && w1 && b1 && w2 && b2, "mlp tensors");

  const char *lr = "{\"lr\": 0.2}";
  enum { STEPS = 30 };
  float losses[STEPS];
  float first_loss = -1, last_loss = -1;
  for (int step = 0; step < STEPS; ++step) {
    CHECK(mxtpu_ndarray_attach_grad(w1) == 0, "attach w1");
    CHECK(mxtpu_ndarray_attach_grad(b1) == 0, "attach b1");
    CHECK(mxtpu_ndarray_attach_grad(w2) == 0, "attach w2");
    CHECK(mxtpu_ndarray_attach_grad(b2) == 0, "attach b2");
    CHECK(mxtpu_autograd_set_recording(1) >= 0, "record on");
    void *loss = mlp_forward(x, w1, b1, w2, b2, y);
    CHECK(mxtpu_autograd_set_recording(0) >= 0, "record off");
    CHECK(loss != NULL, "mlp forward");
    float lv;
    CHECK(mxtpu_ndarray_to_host(loss, &lv, 1) == 1, "loss to host");
    if (step == 0) first_loss = lv;
    last_loss = lv;
    losses[step] = lv;
    CHECK(mxtpu_backward(loss) == 0, "backward");
    mxtpu_ndarray_free(loss);
    w1 = sgd(w1, lr);
    b1 = sgd(b1, lr);
    w2 = sgd(w2, lr);
    b2 = sgd(b2, lr);
    CHECK(w1 && b1 && w2 && b2, "sgd updates");
  }
  printf("c_api mlp train: loss %.5f -> %.5f over %d steps\n", first_loss,
         last_loss, STEPS);
  printf("c_api mlp losses:");
  for (int step = 0; step < STEPS; ++step) printf(" %.9g", losses[step]);
  printf("\n");
  CHECK(first_loss > 0.0f, "initial loss positive");
  CHECK(last_loss < 0.5f * first_loss, "loss halves under C-driven SGD");

  /* ---- kvstore from C (ref: MXKVStorePushPullEx) ----------------------- */
  void *kv = mxtpu_kvstore_create("local");
  CHECK(kv != NULL, "kvstore create");
  float wv[4] = {1.f, 2.f, 3.f, 4.f};
  float gv[4] = {0.5f, 0.5f, 0.5f, 0.5f};
  long kvs[1] = {4};
  void *w0 = mxtpu_ndarray_create(wv, kvs, 1);
  void *g0 = mxtpu_ndarray_create(gv, kvs, 1);
  CHECK(w0 && g0, "kvstore tensors");
  CHECK(mxtpu_kvstore_init(kv, "w", w0) == 0, "kvstore init");
  CHECK(mxtpu_kvstore_set_optimizer(kv, "sgd",
                                    "{\"learning_rate\": 0.1}") == 0,
        "kvstore set_optimizer");
  void *pulled = mxtpu_kvstore_pushpull(kv, "w", g0);
  CHECK(pulled != NULL, "kvstore pushpull");
  float pv[4];
  CHECK(mxtpu_ndarray_to_host(pulled, pv, 4) == 4, "pull to host");
  /* server-side sgd: w <- w - 0.1 * 0.5 */
  CHECK(fabsf(pv[0] - 0.95f) < 1e-5f && fabsf(pv[3] - 3.95f) < 1e-5f,
        "server-side sgd applied on push");
  mxtpu_ndarray_free(pulled);
  /* unknown key surfaces a clean error */
  CHECK(mxtpu_kvstore_pull(kv, "nope") == NULL, "pull unknown key NULL");
  CHECK(strlen(mxtpu_last_error()) > 0, "pull unknown key sets error");
  mxtpu_ndarray_free(w0);
  mxtpu_ndarray_free(g0);
  mxtpu_kvstore_free(kv);

  /* ---- introspection / utilities (ref: MXGetVersion, MXListAllOpNames,
   *      MXRandomSeed, MXNDArrayWaitAll) -------------------------------- */
  CHECK(mxtpu_version() >= 100, "version encodes major.minor.patch");
  CHECK(mxtpu_num_devices() >= 1, "at least one device");
  char plat[16];
  CHECK(mxtpu_device_platform(plat, sizeof plat) > 1, "platform name");
  CHECK(strcmp(plat, strncmp(device, "cuda", 4) == 0 ? "gpu" : "cpu") == 0,
        "platform names the selected device");
  CHECK(mxtpu_wait_all() == 0, "wait_all");

  long ops_need = mxtpu_list_ops(NULL, 0);
  CHECK(ops_need > 1000, "op listing is substantial"); /* 290+ names */
  char *ops_buf = (char *)malloc(ops_need);
  CHECK(mxtpu_list_ops(ops_buf, ops_need) == ops_need, "op listing fills");
  CHECK(strstr(ops_buf, "broadcast_add") != NULL &&
            strstr(ops_buf, "Convolution") != NULL &&
            strstr(ops_buf, "sgd_update") != NULL,
        "op listing has core names");
  free(ops_buf);
  char doc[4096];
  /* the JAX client also asks for the doc's "ref:" citation, which few of
   * the port's op docstrings carry (a divergence ROADMAP.md lists) */
  CHECK(mxtpu_op_doc("dot", doc, sizeof doc) > 1, "op doc");
  CHECK(strlen(doc) > 0, "op doc non-empty");
  CHECK(mxtpu_op_doc("definitely_not_an_op", doc, sizeof doc) == -1,
        "op doc unknown op errors");

  /* random seed determinism: same seed -> same uniform sample */
  CHECK(mxtpu_random_seed(7) == 0, "seed");
  void *r1 = mxtpu_invoke("uniform", NULL, 0,
                          "{\"shape\": [4], \"low\": 0.0, \"high\": 1.0}");
  CHECK(mxtpu_random_seed(7) == 0, "re-seed");
  void *r2 = mxtpu_invoke("uniform", NULL, 0,
                          "{\"shape\": [4], \"low\": 0.0, \"high\": 1.0}");
  CHECK(r1 && r2, "uniform samples");
  float rv1[4], rv2[4];
  CHECK(mxtpu_ndarray_to_host(r1, rv1, 4) == 4 &&
            mxtpu_ndarray_to_host(r2, rv2, 4) == 4,
        "uniform to host");
  for (int i = 0; i < 4; ++i) {
    CHECK(fabsf(rv1[i] - rv2[i]) < 1e-7f, "seeded streams reproduce");
    CHECK(rv1[i] >= 0.0f && rv1[i] < 1.0f, "uniform in range");
  }
  mxtpu_ndarray_free(r1);
  mxtpu_ndarray_free(r2);

  /* ---- NDArray save/load round-trip (ref: MXNDArraySave/Load) --------- */
  /* beside the outputs file, else in $TMPDIR */
  char dict_path[4096], list_path[4096];
  const char *tmp = getenv("TMPDIR");
  if (outputs != NULL) {
    snprintf(dict_path, sizeof dict_path, "%s.dict.npz", outputs);
    snprintf(list_path, sizeof list_path, "%s.list.npz", outputs);
  } else {
    snprintf(dict_path, sizeof dict_path, "%s/mxtpu_torch_smoke.%d.npz",
             tmp != NULL ? tmp : "/tmp", (int)getpid());
    snprintf(list_path, sizeof list_path, "%s/mxtpu_torch_smoke_list.%d.npz",
             tmp != NULL ? tmp : "/tmp", (int)getpid());
  }
  const char *save_keys[2] = {"alpha", "beta"};
  void *save_vals[2] = {a, b};
  CHECK(mxtpu_ndarray_save(dict_path, save_keys, save_vals,
                           2) == 0,
        "ndarray_save dict");
  void *loaded[2] = {NULL, NULL};
  char names[64];
  int nloaded = mxtpu_ndarray_load(dict_path, loaded, 2, names,
                                   sizeof names);
  CHECK(nloaded == 2 && loaded[0] && loaded[1], "ndarray_load dict");
  CHECK(strstr(names, "alpha") != NULL && strstr(names, "beta") != NULL,
        "loaded names round-trip");
  /* find which handle is "alpha" (dict order) and check its payload */
  void *alpha = strncmp(names, "alpha", 5) == 0 ? loaded[0] : loaded[1];
  float alpha_back[6];
  CHECK(mxtpu_ndarray_to_host(alpha, alpha_back, 6) == 6, "alpha host");
  for (int i = 0; i < 6; ++i) {
    CHECK(fabsf(alpha_back[i] - a_data[i]) < 1e-6f, "alpha values survive");
  }
  mxtpu_ndarray_free(loaded[0]);
  mxtpu_ndarray_free(loaded[1]);
  /* positional save loads back as a list (names empty) */
  CHECK(mxtpu_ndarray_save(list_path, NULL, save_vals,
                           2) == 0,
        "ndarray_save list");
  void *loaded2[2] = {NULL, NULL};
  CHECK(mxtpu_ndarray_load(list_path, loaded2, 2, names,
                           sizeof names) == 2,
        "ndarray_load list");
  CHECK(names[0] == '\0', "list load has no names");
  mxtpu_ndarray_free(loaded2[0]);
  mxtpu_ndarray_free(loaded2[1]);
  remove(dict_path);
  remove(list_path);

  mxtpu_ndarray_free(x);
  mxtpu_ndarray_free(y);
  mxtpu_ndarray_free(w1);
  mxtpu_ndarray_free(b1);
  mxtpu_ndarray_free(w2);
  mxtpu_ndarray_free(b2);
  mxtpu_ndarray_free(sum);
  mxtpu_ndarray_free(summed);
  mxtpu_ndarray_free(prod);
  mxtpu_ndarray_free(a);
  mxtpu_ndarray_free(b);
  mxtpu_ndarray_free(bt);
  mxtpu_ndarray_free(i32);
  mxtpu_ndarray_free(u8);
  mxtpu_ndarray_free(bf);
  if (inputs != NULL && kernels(inputs, outputs) != 0) return 1;
  CHECK(mxtpu_shutdown() == 0, "shutdown");
  printf("c_api smoke: all checks passed\n");
  return 0;
}
