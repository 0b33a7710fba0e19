"""The port's C ABI (``mxnet_tpu_torch/capi``) against the JAX package.

``libmxtpu_capi`` and the C client ``c_api_smoke.c`` are built once for
the module (g++ and cc; the file skips without them or without
``Python.h``) and the client runs on the CPU (``"cpu"``, the device the
caller must ask for), with an inputs file for its kernel section:

- every check of the client passes, also with a ``PYTHONPATH`` whose
  first entry holds a ``jax`` and a ``mxnet_tpu`` that raise on import:
  the embedded port imports neither;
- its 30-step MLP loss trajectory (the client's LCG inputs and initial
  weights) equals the JAX package's ``mxnet_tpu.nd`` running the same SGD
  steps, within MLP_LOSS_RTOL (the two sum the same f32 terms in
  another order);
- its kernel section's outputs and gradients, at a small size in f32,
  equal the JAX package's ``FusedNormReluConv`` (Pallas in interpret
  mode), ``flash_attention`` (interpret mode) and
  ``paged_decode_attention`` (the jnp path) under the tolerances of
  ``test_torch_fused_conv.py`` (2e-4 forward, 2e-3 gradients),
  ``test_torch_flash_attention.py``'s op test (1e-5 / 1e-6 forward,
  1e-5 gradients) and ``test_torch_paged_attention.py`` (1e-5);
- loaded into a Python process with ``ctypes`` (``capi.load()``):
  ``mxtpu_init()`` without a card returns -1 and its error names CUDA,
  no call works before an init succeeds, and float64 and int64 are
  refused as the JAX ABI refuses them.

The header declares every function of the JAX ABI's header with the same
signature, and ``capi.SIGNATURES`` every function of the header.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import sysconfig

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.ndarray import invoke as jinvoke
import mxnet_tpu_torch.capi as capi
from mxnet_tpu_torch import nd as tnd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP_LOSS_RTOL = 1e-4
CONV_FWD = dict(rtol=2e-4, atol=2e-4)
CONV_GRAD = dict(rtol=2e-3, atol=2e-3)
FLASH_FWD = dict(rtol=1e-5, atol=1e-6)
FLASH_GRAD = dict(rtol=1e-5, atol=1e-5)
PAGED = dict(rtol=1e-5, atol=1e-5)
# the kernel section's sizes: NHWC conv input and 3x3 filters, flash
# (B, S, heads, D), paged (lengths, pages per slot, page size, heads, D)
CONV = (2, 8, 8, 16)
FLASH = (2, 32, 2, 8)
PAGED_CASE = ((11, 5, 0, 1, 4, 12), 3, 4, 2, 8)


def _have_toolchain():
    inc = sysconfig.get_paths()["include"]
    return (shutil.which("g++") and shutil.which("cc")
            and os.path.isfile(os.path.join(inc, "Python.h")))


def _inputs():
    """The kernel section's inputs, from a seed, as numpy arrays."""
    rng = np.random.RandomState(0)
    n, h, ci, co = CONV
    f32 = np.float32
    x = {"conv_x": rng.randn(n, h, h, ci),
         "conv_w": 0.2 * rng.randn(3, 3, ci, co),
         "conv_gamma": rng.rand(ci) + 0.5,
         "conv_beta": 0.1 * rng.randn(ci),
         "conv_moving_mean": np.zeros(ci), "conv_moving_var": np.ones(ci),
         "conv_dout": rng.randn(n, h, h, co)}
    b, s, heads, d = FLASH
    for k in ("flash_q", "flash_k", "flash_v", "flash_dout"):
        x[k] = rng.randn(b, s, heads * d)
    lengths, pps, page, ph, pd = PAGED_CASE
    slots = len(lengths)
    n_pages = 1 + slots * pps
    x["paged_q"] = rng.randn(slots, ph, pd)
    x["paged_k_pages"] = rng.randn(n_pages, page, ph, pd)
    x["paged_v_pages"] = rng.randn(n_pages, page, ph, pd)
    x = {k: v.astype(f32) for k, v in x.items()}
    x["flash_heads"] = np.asarray([heads], np.int32)
    x["paged_page_tables"] = rng.permutation(np.arange(1, n_pages)) \
        .astype(np.int32).reshape(slots, pps)
    x["paged_lengths"] = np.asarray(lengths, np.int32)
    return x


def _start(exe, env, tmp, name):
    """Start the client on the CPU with an inputs file of its own."""
    ins, outs = tmp / f"{name}-in.npz", tmp / f"{name}-out.npz"
    x = _inputs()
    assert sorted(x) == sorted(capi.KERNEL_INPUTS)
    tnd.save(str(ins), {k: tnd.array(v, ctx="cpu") for k, v in x.items()})
    proc = subprocess.Popen([str(exe), "cpu", str(ins), str(outs)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, outs


def _finish(proc, outs):
    out, err = proc.communicate(timeout=180)
    res = subprocess.CompletedProcess(proc.args, proc.returncode, out, err)
    return res, np.load(outs) if res.returncode == 0 else None


@pytest.fixture(scope="module")
def client(tmp_path_factory):
    """The client's two runs: plain, and under the poisoned path."""
    if not _have_toolchain():
        pytest.skip("needs g++, cc and Python.h to build the C ABI")
    tmp = tmp_path_factory.mktemp("capi")
    exe = capi.build_client()
    poison = tmp / "poison"
    for mod in ("jax", "mxnet_tpu"):
        (poison / mod).mkdir(parents=True)
        (poison / mod / "__init__.py").write_text(
            "import sys\n"
            f"sys.stderr.write('POISON: {mod} imported\\n')\n"
            f"raise ImportError('{mod} must not be imported by the port')\n")
    started = {"plain": _start(exe, capi.client_env(), tmp, "plain"),
               "poisoned": _start(exe, capi.client_env([poison]), tmp,
                                  "poisoned")}
    try:
        runs = {k: _finish(*v) for k, v in started.items()}
    finally:            # both, also when one timed out
        for proc, _outs in started.values():
            proc.kill()
            proc.wait()
    yield runs
    for _res, saved in runs.values():
        if saved is not None:
            saved.close()


@pytest.mark.parametrize("run", ["plain", "poisoned"])
def test_client_passes_every_check_on_the_cpu(client, run):
    res, saved = client[run]
    assert res.returncode == 0, res.stdout + res.stderr
    assert "c_api smoke: device cpu" in res.stdout
    assert "c_api smoke: all checks passed" in res.stdout
    assert "POISON" not in res.stderr
    assert sorted(saved.files) == sorted(capi.KERNEL_OUTPUTS)


def _lcg_mlp():
    """The client's inputs and initial weights: its LCG, seed 42."""
    seed = [42]

    def frand():
        seed[0] = (seed[0] * 1664525 + 1013904223) % 2 ** 32
        return np.float32(((seed[0] >> 8) & 0xFFFF) / 65536.0) - \
            np.float32(0.5)

    n, din, dh = 16, 4, 8
    x = np.zeros((n, din), np.float32)
    for i in range(n):
        for j in range(din):
            x[i, j] = frand()
    y = x.sum(axis=1, dtype=np.float32).reshape(n, 1)
    w1 = np.asarray([frand() for _ in range(din * dh)],
                    np.float32).reshape(din, dh)
    w2 = np.asarray([frand() for _ in range(dh)], np.float32).reshape(dh, 1)
    return x, y, w1, np.zeros(dh, np.float32), w2, np.zeros(1, np.float32)


def test_mlp_trajectory_matches_the_jax_package(client):
    res, _ = client["plain"]
    line = next(ln for ln in res.stdout.splitlines()
                if ln.startswith("c_api mlp losses:"))
    got = np.asarray(line.split(":")[1].split(), np.float64)
    x, y, *params = (jmx.nd.array(a) for a in _lcg_mlp())
    want = []
    for _ in range(30):
        for p in params:
            p.attach_grad()
        w1, b1, w2, b2 = params
        with jag.record():
            h = jinvoke("relu", jinvoke("broadcast_add",
                                        jinvoke("dot", x, w1), b1))
            pred = jinvoke("broadcast_add", jinvoke("dot", h, w2), b2)
            loss = jinvoke("mean", jinvoke("square",
                                           jinvoke("broadcast_sub", pred, y)))
        want.append(float(loss.asnumpy()))
        loss.backward()
        params = [jinvoke("sgd_update", p, p.grad, lr=0.2) for p in params]
    assert len(got) == 30 and got[-1] < 0.5 * got[0]
    np.testing.assert_allclose(got, want, rtol=MLP_LOSS_RTOL)


def _jax_leaves(names, op, nargs, head_grad, **kw):
    """The JAX op on the inputs ``names`` (the first ``nargs`` marked for
    gradients), backward from sum(out * head_grad): the outputs, then
    the gradients."""
    x = _inputs()
    args = [jmx.nd.array(x[k]) for k in names]
    for a in args[:nargs]:
        a.attach_grad()
    with jag.record():
        out = jinvoke(op, *args, **kw)
        first = out[0] if isinstance(out, tuple) else out
        head = (first * jmx.nd.array(x[head_grad])).sum()
    head.backward()
    outs = out if isinstance(out, tuple) else (out,)
    return [o.asnumpy() for o in outs] + [a.grad.asnumpy()
                                          for a in args[:nargs]]


def test_fused_conv_outputs_and_gradients_match_jax(client):
    _res, saved = client["plain"]
    want = _jax_leaves(("conv_x", "conv_w", "conv_gamma", "conv_beta",
                        "conv_moving_mean", "conv_moving_var"),
                       "FusedNormReluConv", 4, "conv_dout")
    names = ("conv_out", "conv_new_moving_mean", "conv_new_moving_var",
             "conv_dx", "conv_dw", "conv_dgamma", "conv_dbeta")
    for i, (name, w) in enumerate(zip(names, want)):
        tol = CONV_FWD if i < 3 else CONV_GRAD
        np.testing.assert_allclose(saved[name], w, err_msg=name, **tol)


def test_flash_outputs_and_gradients_match_jax(client):
    _res, saved = client["plain"]
    want = _jax_leaves(("flash_q", "flash_k", "flash_v"), "flash_attention",
                       3, "flash_dout", heads=FLASH[2], block_q=16,
                       block_k=16)
    names = ("flash_out", "flash_dq", "flash_dk", "flash_dv")
    for i, (name, w) in enumerate(zip(names, want)):
        tol = FLASH_FWD if i == 0 else FLASH_GRAD
        np.testing.assert_allclose(saved[name], w, err_msg=name, **tol)


def test_paged_outputs_match_jax(client):
    _res, saved = client["plain"]
    x = _inputs()
    want = jinvoke("paged_decode_attention", *(
        jmx.nd.array(x[k]) for k in ("paged_q", "paged_k_pages",
                                     "paged_v_pages", "paged_page_tables",
                                     "paged_lengths"))).asnumpy()
    for name in ("paged_out", "paged_plain"):
        np.testing.assert_allclose(saved[name], want, err_msg=name, **PAGED)


PROBE = r"""
import ctypes, json
import numpy as np
import mxnet_tpu_torch.capi as capi
lib = capi.load()
err = lambda: lib.mxtpu_last_error().decode()
out = {"version_first": [lib.mxtpu_version(), err()],
       "init": [lib.mxtpu_init(), err()],
       "version_after_failed_init": [lib.mxtpu_version(), err()],
       "cpu": [lib.mxtpu_init_device(b"cpu"), err()]}
shape = (ctypes.c_long * 1)(4)
for name in ("float64", "int64", "int32"):
    a = np.arange(4, dtype=name)
    h = lib.mxtpu_ndarray_create_dtype(a.ctypes.data, shape, 1,
                                       name.encode())
    out[name] = [h is not None, err()]
    if h is not None:
        lib.mxtpu_ndarray_free(h)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def probe(client):
    res = subprocess.run([sys.executable, "-c", PROBE],
                         env=capi.client_env(), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_init_without_a_card_fails_and_names_cuda(probe):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert probe["version_first"] == [-1, "mxtpu_init() not called"]
    rc, msg = probe["init"]
    assert rc == -1 and "CUDA" in msg and 'mxtpu_init_device("cuda")' in msg
    # the failed init left nothing half set up; the host on request works
    assert probe["version_after_failed_init"][0] == -1
    assert probe["cpu"][0] == 0


@pytest.mark.parametrize("dtype", ["float64", "int64"])
def test_64_bit_dtypes_are_refused(probe, dtype):
    made, msg = probe[dtype]
    assert not made and f"unsupported dtype: {dtype}" in msg
    assert probe["int32"][0]


def _declarations(path):
    """{function: its declaration, whitespace collapsed} of a header."""
    text = re.sub(r"/\*.*?\*/", "", open(path, encoding="utf-8").read(),
                  flags=re.S)
    decls = re.findall(r"^[a-z][^;#{}]*\bmxtpu_\w+\s*\([^;]*\);", text,
                       flags=re.M)
    return {re.search(r"(mxtpu_\w+)\s*\(", d).group(1):
            " ".join(d.split()) for d in decls}


def test_header_keeps_the_jax_abi_and_the_signature_table_covers_it():
    port = _declarations(capi.HEADER)
    jax_abi = _declarations(os.path.join(REPO, "src", "mxtpu_capi.h"))
    assert len(jax_abi) == 33
    for name, decl in jax_abi.items():
        assert port.get(name) == decl, name
    assert set(port) - set(jax_abi) == {"mxtpu_init_device"}
    assert set(capi.SIGNATURES) == set(port)
