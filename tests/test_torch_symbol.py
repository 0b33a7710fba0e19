"""``mx.sym`` and the executor of the port (``mxnet_tpu_torch/symbol.py``,
``executor.py``) against the JAX package's, on the CPU.

The cases of ``tests/test_symbol.py``, each run through both packages:
the same symbol built in each (fresh name scopes, so auto-names agree),
the same seeded numpy inputs, and the port's listing, shapes, json,
outputs and gradients held to the JAX package's.  Tolerances: float32
forward values and gradients within rtol/atol 1e-5 (1e-4 for the
Pallas kernels in interpret mode and for conv/BatchNorm chains);
listings, shapes, json and DOT text equal.

Beyond them:

- ``n_out`` (the static output arity, the port's ``meta`` probe against
  ``jax.eval_shape``) and the builders' positional-to-attr order, for
  every registry name both packages have (one parametrised case each);
- a symbol holding a ``FusedNormReluConv`` node and one holding
  ``flash_attention``, against the JAX package's Pallas kernels in
  interpret mode, forward and backward with ``out_grads``;
- the kernel wrappers on ``meta`` tensors (shape inference) and their
  device rules: a mix of devices raises, a CUDA tensor never reaches a
  plain body;
- the executor's one deliberate divergence: the gradient is taken
  under the dropout mask of the outputs the caller saw (at ``p=0`` the
  gradients equal JAX's; at ``p>0`` the gradient is zero wherever the
  forward's output was dropped).
"""
import contextlib
import inspect
import io as _io
import json
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import symbol as jsym
from mxnet_tpu.ops.registry import OPS as JOPS
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.ops.registry import OPS as TOPS

TOL = dict(rtol=1e-5, atol=1e-5)
CHAIN_TOL = dict(rtol=1e-4, atol=1e-4)
SHARED = sorted(set(JOPS) & set(TOPS))
PKGS = {"jax": (jmx, jsym, jnd), "port": (tmx, tsym, tnd)}


@pytest.fixture(autouse=True)
def _fresh_scopes():
    """Auto-names from 0 in both packages, the port on the CPU."""
    with jmx.name.NameManager(), tmx.name.NameManager(), tmx.cpu():
        yield


def both(build):
    """``build(sym)`` in each package: ``(jax symbol, port symbol)``."""
    return build(jsym), build(tsym)


def _mlp(S):
    data = S.Variable("data")
    fc1 = S.FullyConnected(data, name="fc1", num_hidden=8)
    act = S.Activation(fc1, name="relu1", act_type="relu")
    fc2 = S.FullyConnected(act, name="fc2", num_hidden=3)
    return S.SoftmaxOutput(fc2, name="softmax")


def _conv_bn(S):
    d = S.Variable("data")
    c = S.Convolution(d, name="conv1", kernel=(3, 3), num_filter=4,
                      pad=(1, 1))
    b = S.BatchNorm(c, name="bn1", momentum=0.8)
    p = S.Pooling(b, kernel=(2, 2), stride=(2, 2), pool_type="max")
    return S.SoftmaxOutput(S.FullyConnected(S.Flatten(p), name="fc",
                                            num_hidden=2), name="softmax")


def _values(sym_j, shapes, seed=0, scale=0.3, ints=None):
    """Seeded float32 arrays for every argument (``ints``: name -> class
    count, for labels)."""
    rng = np.random.RandomState(seed)
    arg, _, aux = sym_j.infer_shape(**shapes)
    vals = {}
    for n, s in zip(sym_j.list_arguments(), arg):
        if ints and n in ints:
            vals[n] = rng.randint(0, ints[n], s).astype(np.float32)
        else:
            vals[n] = (rng.randn(*s) * scale).astype(np.float32)
    auxv = {n: (rng.rand(*s) + 0.5).astype(np.float32)
            for n, s in zip(sym_j.list_auxiliary_states(), aux)}
    return vals, auxv


def run(pkg, symbol, vals, grad_req="write", aux=None, is_train=True,
        out_grads=None, backward=True, steps=1):
    """Bind ``symbol`` in package ``pkg`` over ``vals``; forward (and
    backward) ``steps`` times.  Returns numpy (outputs, grads, aux)."""
    _, _, nd = PKGS[pkg]
    reqs = grad_req if isinstance(grad_req, dict) else \
        {n: grad_req for n in vals}
    args = {k: nd.array(v) for k, v in vals.items()}
    grads = {k: nd.zeros(v.shape) for k, v in vals.items()
             if reqs.get(k, "null") != "null"}
    ex = symbol.bind(args=args, args_grad=grads, grad_req=reqs,
                     aux_states={k: nd.array(v) for k, v in
                                 (aux or {}).items()})
    for _ in range(steps):
        outs = ex.forward(is_train=is_train)
        if backward:
            ex.backward(None if out_grads is None else
                        [nd.array(g) for g in out_grads])
    return ([o.asnumpy() for o in outs],
            {k: g.asnumpy() for k, g in ex.grad_dict.items()
             if g is not None},
            {k: a.asnumpy() for k, a in ex.aux_dict.items()})


def assert_runs_equal(a, b, tol=TOL):
    (oa, ga, xa), (ob, gb, xb) = a, b
    assert len(oa) == len(ob)
    for x, y in zip(oa, ob):
        np.testing.assert_allclose(x, y, **tol)
    assert sorted(ga) == sorted(gb)
    for k in ga:
        np.testing.assert_allclose(ga[k], gb[k], **tol, err_msg=k)
    assert sorted(xa) == sorted(xb)
    for k in xa:
        np.testing.assert_allclose(xa[k], xb[k], **tol, err_msg=k)


def both_run(build, shapes, ints=None, **kw):
    js, ts = both(build)
    vals, aux = _values(js, shapes, ints=ints)
    return run("jax", js, vals, aux=aux, **kw), \
        run("port", ts, vals, aux=aux, **kw)


# --------------------------------------------------------- composition --
def test_composition_and_listing():
    js, ts = both(_mlp)
    assert ts.list_arguments() == js.list_arguments() == [
        "data", "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias",
        "softmax_label"]
    assert ts.list_outputs() == js.list_outputs() == ["softmax_output"]
    assert ts.list_auxiliary_states() == js.list_auxiliary_states() == []
    assert ts.name == js.name == "softmax"


def test_no_bias_skips_variable():
    js, ts = both(lambda S: S.FullyConnected(S.Variable("data"), name="fc",
                                             num_hidden=4, no_bias=True))
    assert ts.list_arguments() == js.list_arguments() == ["data",
                                                          "fc_weight"]


def test_auto_naming():
    def build(S):
        d = S.Variable("data")
        return (S.FullyConnected(d, num_hidden=2).name,
                S.FullyConnected(d, num_hidden=2).name)
    j, t = both(build)
    assert t == j == ("fullyconnected0", "fullyconnected1")


def test_name_scopes():
    def build(S):
        mx = jmx if S is jsym else tmx
        d = S.Variable("data")
        names = []
        with mx.name.Prefix("net_"):
            a = S.FullyConnected(d, num_hidden=2)
            names += [a.name, a.list_arguments()[1]]
        names.append(S.FullyConnected(d, num_hidden=2).name)
        with mx.name.NameManager():
            names.append(S.FullyConnected(d, num_hidden=2).name)
        with mx.name.Prefix("a_"):
            ta = S.FullyConnected(d, name="fc", num_hidden=2)
        with mx.name.Prefix("b_"):
            tb = S.FullyConnected(d, name="fc", num_hidden=2)
        return names + [ta.name, tb.name,
                        S.Group([ta, tb]).list_arguments()]
    j, t = both(build)
    assert t == j
    assert t[:2] == ["net_fullyconnected0", "net_fullyconnected0_weight"]
    assert not t[2].startswith("net_") and t[3] == "fullyconnected0"
    assert t[4:6] == ["a_fc", "b_fc"]
    assert "a_fc_weight" in t[6] and "b_fc_weight" in t[6]


def test_get_internals():
    j, t = both(lambda S: [s.name for s in
                           _mlp(S).get_internals()._outputs_list()])
    assert t == j and "fc1" in t and "relu1" in t


def test_unbound_argument_errors():
    o = tsym.make_loss(tsym.Variable("data") * 2)
    ex = o.bind(args={}, grad_req="null")
    with pytest.raises(ValueError, match="unbound argument 'data'"):
        ex.forward()


# --------------------------------------------------------------- shapes --
def test_infer_shape_mlp():
    j, t = both(lambda S: _mlp(S).infer_shape(data=(4, 5)))
    assert t == j
    assert t[1] == [(4, 3)] and t[2] == []


def test_infer_shape_conv_bn_chain():
    j, t = both(lambda S: _conv_bn(S).infer_shape(data=(2, 3, 8, 8)))
    assert t == j
    assert (4, 3, 3, 3) in t[0] and (2, 64) in t[0] and t[2] == [(4,), (4,)]


def test_infer_shape_graph_with_zeros():
    """A creation op inside the graph: traced on meta tensors, never
    placed on a device by the shape inference."""
    def build(S):
        x = S.Variable("x")
        h = S.FullyConnected(x + S.zeros(shape=(3, 5)), name="fc",
                             num_hidden=4)
        return S.make_loss(h * S.ones(shape=(3, 4)) + 2)
    j, t = both(lambda S: build(S).infer_shape(x=(3, 5)))
    assert t == j == ([(3, 5), (4, 5), (4,)], [(3, 4)], [])


def test_softmax_output_multi_output_label_shape():
    def build(S):
        d = S.Variable("data")
        conv = S.Convolution(d, kernel=(1, 1), num_filter=5, name="cv")
        return S.SoftmaxOutput(conv, multi_output=True, name="sm")
    j, t = both(build)
    ex = t.simple_bind(data=(2, 3, 4, 4))
    assert ex.arg_dict["sm_label"].shape == (2, 4, 4) \
        == j.simple_bind(data=(2, 3, 4, 4)).arg_dict["sm_label"].shape
    vals, _ = _values(j, {"data": (2, 3, 4, 4)}, ints={"sm_label": 5})
    assert_runs_equal(run("jax", j, vals), run("port", t, vals), CHAIN_TOL)


# ------------------------------------------------------- eval / executor --
def test_arithmetic_sugar_eval():
    def build(S):
        a, b = S.Variable("a"), S.Variable("b")
        return (a + b) * 2 - b / 2 + 1 - (3 - a) ** 2 / (1 + b) + (-a)
    j, t = both(build)
    av, bv = np.float32([1.0, 2.0]), np.float32([4.0, 6.0])
    jo = j.eval(a=jnd.array(av), b=jnd.array(bv))[0].asnumpy()
    to = t.eval(a=tnd.array(av), b=tnd.array(bv))[0].asnumpy()
    np.testing.assert_allclose(to, jo, **TOL)


def test_executor_grad_matches_jax():
    jr, tr = both_run(_mlp, {"data": (4, 5)}, ints={"softmax_label": 3},
                      grad_req={n: "write" for n in ("fc1_weight",
                                                     "fc1_bias",
                                                     "fc2_weight",
                                                     "fc2_bias")})
    assert_runs_equal(jr, tr)
    assert sorted(tr[1]) == ["fc1_bias", "fc1_weight", "fc2_bias",
                             "fc2_weight"]


def test_grad_req_add_and_null():
    def build(S):
        x = S.Variable("x")
        return S.make_loss(x * x)
    j, t = both(build)
    vals = {"x": np.float32([3.0, -1.5])}
    jr, tr = run("jax", j, vals, "add", steps=2), \
        run("port", t, vals, "add", steps=2)
    assert_runs_equal(jr, tr)
    np.testing.assert_allclose(tr[1]["x"], [12.0, -6.0])   # 2 x 2x
    ex = t.bind(args={"x": tnd.array(vals["x"])}, grad_req="null")
    ex.forward(is_train=True)
    ex.backward()
    assert ex.grad_dict.get("x") is None


@pytest.mark.parametrize("head", ["LinearRegressionOutput",
                                  "MAERegressionOutput",
                                  "LogisticRegressionOutput", "make_loss"])
def test_regression_head_grads_match_jax(head):
    def build(S):
        h = S.FullyConnected(S.Variable("x"), name="fc", num_hidden=3)
        return getattr(S, head)(h, name="out", grad_scale=0.5)
    jr, tr = both_run(build, {"x": (4, 5)})
    assert_runs_equal(jr, tr)
    assert np.abs(tr[1]["fc_weight"]).sum() > 0


@pytest.mark.parametrize("norm", ["null", "batch", "valid"])
def test_softmax_output_ignore_and_normalization_match_jax(norm):
    def build(S):
        return S.SoftmaxOutput(S.Variable("x"), name="softmax",
                               use_ignore=True, ignore_label=-1,
                               normalization=norm, grad_scale=2.0)
    j, t = both(build)
    vals = {"x": np.float32([[2.0, 0.0], [0.0, 2.0], [1.0, 1.0],
                             [0.5, -1.0]]),
            "softmax_label": np.float32([0, 1, -1, 1])}
    req = {"x": "write"}
    jr, tr = run("jax", j, vals, req), run("port", t, vals, req)
    assert_runs_equal(jr, tr)
    np.testing.assert_allclose(tr[1]["x"][2], [0.0, 0.0], atol=1e-7)


def test_batchnorm_aux_updates_and_grads_match_jax():
    jr, tr = both_run(_conv_bn, {"data": (2, 3, 4, 4)},
                      ints={"softmax_label": 2}, steps=2)
    assert_runs_equal(jr, tr, CHAIN_TOL)
    assert sorted(tr[2]) == ["bn1_moving_mean", "bn1_moving_var"]


def test_batchnorm_output_mean_var_heads():
    """output_mean_var=True: three user-visible heads, no aux update."""
    def build(S):
        return S.BatchNorm(S.FullyConnected(S.Variable("data"), name="fc",
                                            num_hidden=4),
                           name="bn", output_mean_var=True)
    jr, tr = both_run(build, {"data": (8, 3)},
                      out_grads=[np.ones((8, 4), np.float32)] * 3)
    assert_runs_equal(jr, tr, CHAIN_TOL)
    assert len(tr[0]) == 3


def test_multi_output_and_group():
    def build(S):
        k = S.topk(S.Variable("data"), k=2, ret_typ="both")
        return S.Group([k[0], k[1]]), k[0].list_outputs()[0]
    (jg, jname), (tg, tname) = both(build)
    x = np.float32([[3, 1, 2]])
    jv = [v.asnumpy() for v in jg.eval(data=jnd.array(x))]
    tv = [v.asnumpy() for v in tg.eval(data=tnd.array(x))]
    for a, b in zip(jv, tv):
        np.testing.assert_array_equal(a, b)
    assert tname == jname and tname.endswith("_output0")


def test_multi_output_head_binds_all_outputs():
    """A whole multi-output head yields every output, and out_grads
    reach each of them."""
    def build(S):
        return S.SliceChannel(S.Variable("data") * 2, num_outputs=2,
                              name="sc")
    j, t = both(build)
    assert t.list_outputs() == j.list_outputs() == ["sc_output0",
                                                    "sc_output1"]
    vals = {"data": np.float32([[1, 2, 3, 4]])}
    og = [np.float32([[1, -1]]), np.float32([[0.5, 2]])]
    assert_runs_equal(run("jax", j, vals, out_grads=og),
                      run("port", t, vals, out_grads=og))
    one = t[1].bind(args={"data": tnd.array(vals["data"])}, grad_req="null")
    np.testing.assert_allclose(one.forward()[0].asnumpy(), [[6, 8]])


def test_custom_label_variable_name():
    """Loss-head labels are found by SLOT, not by a '_label' suffix."""
    def build(S):
        return S.SoftmaxOutput(S.FullyConnected(S.Variable("x"), name="fc",
                                                num_hidden=3),
                               label=S.Variable("y"), name="softmax")
    j, t = both(build)
    assert "y" in tsym.label_variables(t)
    vals, _ = _values(j, {"x": (4, 5), "y": (4,)}, ints={"y": 3})
    req = {"fc_weight": "write", "fc_bias": "write"}
    assert_runs_equal(run("jax", j, vals, req), run("port", t, vals, req))
    blk = tmx.gluon.SymbolBlock(t, ["x"])
    blk.initialize()
    assert "y" not in blk.collect_params()
    assert blk(tnd.array(vals["x"])).shape == (4, 3)


def test_simple_bind_dict_grad_req_skips_null():
    t = _mlp(tsym)
    req = {n: "null" if n in ("data", "softmax_label") else "write"
           for n in t.list_arguments()}
    ex = t.simple_bind(grad_req=req, data=(4, 5))
    assert "data" not in ex.grad_dict and "fc1_weight" in ex.grad_dict
    assert ex.arg_dict["fc1_weight"].shape == (8, 5)


def test_creation_ops():
    def build(S):
        x = S.Variable("x")
        return S.Group([S.zeros(shape=(2, 3)), S.ones(shape=(2, 3)),
                        S.full(shape=(2,), value=7.5),
                        S.arange(start=2, stop=8, step=2),
                        x + S.ones(shape=(3,)),
                        S.arange(start=3, repeat=2), S.zeros((2, 3)),
                        S.arange(2, 8, 2), S.full((2,), 7.5)])
    j, t = both(build)
    x = np.float32([1, 2, 3])
    jv = j.eval(x=jnd.array(x))
    tv = t.eval(x=tnd.array(x))
    assert len(jv) == len(tv) == 9
    for a, b in zip(jv, tv):
        np.testing.assert_allclose(b.asnumpy(), a.asnumpy())
    np.testing.assert_allclose(
        tnd.invoke("_full", shape=(2,), val=3.0).asnumpy(), [3.0, 3.0])


def test_builder_errors_match_jax():
    for S in (jsym, tsym):
        with pytest.raises(TypeError, match="multiple values"):
            S.full((2,), 7.5, value=3.0)
        with pytest.raises(TypeError, match="keywords"):
            S.Concat(S.Variable("a"), S.Variable("b"), 1)
        with pytest.raises(TypeError, match="at most"):
            S.arange(1, 2, 3, 4, 5, 6, 7, 8)


def test_symbol_sub_namespaces():
    """sym.contrib / sym.linalg / sym.random mirror mx.nd's layout; the
    port's random namespace holds its ``_random_*`` ops (none yet: the
    random op module is queue A14)."""
    for name in ("contrib", "linalg"):
        jn = {n for n in dir(getattr(jsym, name)) if not n.startswith("_")}
        tn = {n for n in dir(getattr(tsym, name)) if not n.startswith("_")}
        assert tn == {n for n in jn
                      if getattr(getattr(jsym, name), n).__name__ in TOPS}
    assert {n for n in dir(tsym.random) if not n.startswith("_")} == {
        n[len("_random_"):] for n in TOPS if n.startswith("_random_")}
    g = tsym.linalg.gemm2(tsym.Variable("a"), tsym.Variable("b"))
    a = np.float32([[1, 2], [3, 4]])
    np.testing.assert_allclose(
        g.eval(a=tnd.array(a), b=tnd.array(np.eye(2)))[0].asnumpy(), a)
    iou = tsym.contrib.box_iou(tsym.Variable("x"), tsym.Variable("y"))
    assert iou._node.op in ("_contrib_box_iou", "box_iou")


# ------------------------------------------------------------ dropout --
def test_dropout_respects_mode():
    o = tsym.Dropout(tsym.Variable("data"), p=0.5, name="drop")
    ex = o.bind(args={"data": tnd.array(np.ones((64, 64), np.float32))},
                grad_req="null")
    np.testing.assert_allclose(ex.forward(is_train=False)[0].asnumpy(), 1.0)
    tmx.random.seed(0)
    t1 = ex.forward(is_train=True)[0].asnumpy()
    t2 = ex.forward(is_train=True)[0].asnumpy()
    assert set(np.unique(t1.round(4))) == {0.0, 2.0}
    assert not np.array_equal(t1, t2)


def test_dropout_grads_match_jax_at_p0():
    def build(S):
        h = S.FullyConnected(S.Variable("x"), name="fc", num_hidden=6)
        return S.LinearRegressionOutput(S.Dropout(h, p=0.0), name="lro")
    jr, tr = both_run(build, {"x": (4, 5)})
    assert_runs_equal(jr, tr)


def test_dropout_gradient_uses_the_forward_mask():
    """The deliberate divergence: the gradient comes from the mask of
    the outputs the caller saw (the JAX executor draws a second one), so
    it is zero exactly where the output was dropped, 1/(1-p) elsewhere."""
    tmx.random.seed(3)
    o = tsym.make_loss(tsym.Dropout(tsym.Variable("x"), p=0.5))
    x = np.random.RandomState(0).rand(32, 32).astype(np.float32) + 0.5
    ex = o.bind(args={"x": tnd.array(x)},
                args_grad={"x": tnd.zeros(x.shape)})
    for _ in range(3):
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        g = ex.grad_dict["x"].asnumpy()
        kept = out != 0
        assert 0.3 < kept.mean() < 0.7
        np.testing.assert_array_equal(g, np.where(kept, 2.0, 0.0))
    # a backward with no training forward before it draws its own mask
    ex.forward(is_train=False)
    ex.backward()
    g = ex.grad_dict["x"].asnumpy()
    assert set(np.unique(g)) == {0.0, 2.0}


# --------------------------------------------------------------- json --
JSON_CASES = {
    "mlp": _mlp,
    "conv_bn": _conv_bn,
    "scalar sugar": lambda S: S.make_loss(2 * S.Variable("a") + 1),
    "slice channel": lambda S: S.SliceChannel(S.Variable("data"),
                                              num_outputs=3, axis=1,
                                              name="sc"),
    "bn mean var": lambda S: S.BatchNorm(S.Variable("data"),
                                         output_mean_var=True, name="bn"),
    "one of several": lambda S: S.SliceChannel(S.Variable("data"),
                                               num_outputs=2, axis=1,
                                               name="pick")[1],
    "group": lambda S: S.Group([_mlp(S), S.Variable("z") * 3]),
    "attr meta": lambda S: S.FullyConnected(
        S.Variable("data", lr_mult="0.5"), name="fc", num_hidden=4,
        attr={"lr_mult": "0.1", "ctx_group": "dev1"}),
    "rnn": lambda S: S.RNN(S.Variable("x"), S.Variable("p"),
                           S.Variable("h"), S.Variable("c"), state_size=4,
                           num_layers=1, mode="lstm", name="rnn"),
}


@pytest.mark.parametrize("case", sorted(JSON_CASES))
def test_tojson_byte_identical_and_cross_loads(case):
    j, t = both(JSON_CASES[case])
    text = t.tojson()
    assert text == j.tojson()
    assert json.loads(text)["attrs"] == {"mxnet_tpu": "1"}
    t2, j2 = tsym.fromjson(j.tojson()), jsym.fromjson(text)
    for a, b in ((t2, t), (j2, j), (t2, j)):
        assert a.list_arguments() == b.list_arguments()
        assert a.list_outputs() == b.list_outputs()
        assert a.list_auxiliary_states() == b.list_auxiliary_states()
    assert t2.tojson() == text and j2.tojson() == text


def test_json_round_trip_numerics_cross_package():
    j, t = both(_conv_bn)
    shapes = {"data": (2, 3, 4, 4)}
    vals, aux = _values(j, shapes, ints={"softmax_label": 2})
    t_from_j = tsym.fromjson(j.tojson())
    assert t_from_j.infer_shape(**shapes) == j.infer_shape(**shapes)
    kw = dict(aux=aux, grad_req="null", is_train=False, backward=False)
    assert_runs_equal(run("jax", j, vals, **kw),
                      run("port", t_from_j, vals, **kw), CHAIN_TOL)


def test_save_load_file_cross_package(tmp_path):
    j, t = both(_mlp)
    t.save(str(tmp_path / "t-symbol.json"))
    j.save(str(tmp_path / "j-symbol.json"))
    assert jsym.load(str(tmp_path / "t-symbol.json")).list_arguments() \
        == tsym.load(str(tmp_path / "j-symbol.json")).list_arguments() \
        == t.list_arguments()


def test_multi_output_heads_json_roundtrip():
    x = tsym.Variable("data")
    s2 = tsym.fromjson(tsym.SliceChannel(x, num_outputs=3, axis=1,
                                         name="sc").tojson())
    assert s2.list_outputs() == [f"sc_output{i}" for i in range(3)]
    outs = s2.eval(data=tnd.array(np.arange(12, dtype=np.float32)
                                  .reshape(2, 6)))
    assert [o.shape for o in outs] == [(2, 2)] * 3
    np.testing.assert_allclose(outs[1].asnumpy(), [[2, 3], [8, 9]])


# -------------------------------------------------------- static arity --
def _n_inputs(fn):
    ps = inspect.signature(fn).parameters.values()
    if any(p.kind is p.VAR_POSITIONAL for p in ps):
        return 2
    return sum(1 for p in ps if p.default is p.empty and p.kind in (
        p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD))


@pytest.mark.parametrize("op", SHARED)
def test_static_arity_matches_jax(op):
    """``n_out`` of a node with no attrs and the op's required inputs:
    the port's rule or meta probe against the JAX package's rule or
    ``jax.eval_shape`` probe."""
    k = _n_inputs(JOPS[op])
    jn = jsym._Node(op, "x", {}, [jsym.Variable(f"v{i}") for i in range(k)])
    tn = tsym._Node(op, "x", {}, [tsym.Variable(f"v{i}") for i in range(k)])
    assert tn.n_out == jn.n_out


def _positional(fn):
    ps = inspect.signature(fn).parameters.values()
    return ([p.name for p in ps if p.kind in (p.POSITIONAL_ONLY,
                                                p.POSITIONAL_OR_KEYWORD)],
            any(p.kind is p.VAR_POSITIONAL for p in ps))


@pytest.mark.parametrize("op", SHARED)
def test_builder_signature_matches_jax(op):
    """The builders map non-Symbol positionals onto the op's positional
    parameters (and refuse them for ``*args`` ops): the same names, in
    the same order, in both packages."""
    assert _positional(TOPS[op]) == _positional(JOPS[op])
    assert tsym._signature_has_varargs(op) == jsym._signature_has_varargs(op)


def test_n_out_is_static_not_a_tracing_side_effect():
    t = tsym.topk(tsym.Variable("d"), k=2, ret_typ="both", name="tk")
    fresh = t.list_outputs()
    assert fresh == ["tk_output0", "tk_output1"]
    t.eval(d=tnd.array(np.random.RandomState(0).rand(3, 5)
                       .astype(np.float32)))
    assert t.list_outputs() == fresh
    n = tsym._Node("adam_update", "au", {},
                   [tsym.Variable(v) for v in "wgmv"])
    assert n.n_out == 3


def test_unruled_custom_multi_output_op_reconciles():
    """A custom op the meta probe cannot run (it needs rank 3) reports
    one output until its first walk, then the walked arity, cached for
    fresh nodes; a ruled op still fails loudly on a mismatch."""
    from mxnet_tpu_torch.ops.registry import register_op

    name = "_test_seq_stats_port"
    if name not in TOPS:
        @register_op(name)
        def _seq_stats(x):
            if x.dim() != 3:
                raise ValueError("rank 3 only")
            return x.mean(dim=1), x.amax(dim=1)
    node = tsym._Node(name, "ss", {}, [tsym.Variable("x3")])
    s = tsym.Symbol(node, whole=True)
    assert node.n_out == 1
    outs = s.eval(x3=tnd.array(np.ones((2, 3, 4), np.float32)))
    assert len(outs) == 2 and node.n_out == 2
    assert tsym._Node(name, "ss2", {}, [tsym.Variable("y3")]).n_out == 2
    with pytest.raises(RuntimeError, match="_N_OUT_RULES"):
        tsym.observe_n_out(tsym._Node("SliceChannel", "sc",
                                      {"num_outputs": 2},
                                      [tsym.Variable("z")]), 5)


# ---------------------------------------------------------- attributes --
def test_attr_scope():
    def build(S):
        mx = jmx if S is jsym else tmx
        d = S.Variable("data")
        with mx.AttrScope(lr_mult="0.1", ctx_group="dev1"):
            fc = S.FullyConnected(d, name="fc", num_hidden=4)
            with mx.AttrScope(lr_mult="0.5"):
                fc2 = S.FullyConnected(fc, name="fc2", num_hidden=4)
        fc3 = S.FullyConnected(d, name="fc3", num_hidden=4)
        with mx.AttrScope(lr_mult="0.1"):
            fc4 = S.FullyConnected(d, name="fc4", num_hidden=4,
                                   attr={"lr_mult": "2.0"})
        with mx.AttrScope(lr_mult="0.25"):
            w = S.Variable("embed_weight")
        wvar = [s for s in fc4._node.inputs
                if s._node.name == "fc4_weight"][0]
        return ([fc.attr("lr_mult"), fc.attr("ctx_group"),
                 fc2.attr("lr_mult"), fc2.attr("ctx_group"),
                 fc3.attr("lr_mult"), fc4.attr("lr_mult"),
                 w.attr("lr_mult"), wvar.attr("lr_mult")],
                mx.mod.Module._attr_mults(fc2),
                mx.mod.Module._attr_mults(S.make_loss(w * 2)),
                mx.mod.Module._attr_mults(fc4))
    j, t = both(build)
    assert t == j
    assert t[0] == ["0.1", "dev1", "0.5", "dev1", None, "2.0", "0.25",
                    "2.0"]
    with pytest.raises(ValueError, match="string"):
        tmx.AttrScope(lr_mult=0.1)


def test_attr_metadata_not_forwarded_to_op():
    fc = tsym.FullyConnected(tsym.Variable("data"), num_hidden=4, name="fc",
                             attr={"lr_mult": "0.5", "ctx_group": "dev1"})
    assert fc.attr("lr_mult") == "0.5"
    assert fc.list_attr()["ctx_group"] == "dev1"
    assert fc.simple_bind(data=(2, 3)).forward()[0].shape == (2, 4)


# --------------------------------------------------------- SymbolBlock --
def _fc_net(S):
    data = S.Variable("data")
    s = S.FullyConnected(data, name="fc1", num_hidden=8)
    s = S.Activation(s, act_type="relu", name="r")
    return data, S.FullyConnected(s, name="fc2", num_hidden=2)


def test_symbolblock_from_symbol():
    rng = np.random.RandomState(0)
    arg = {"fc1_weight": (rng.randn(8, 6) * 0.3).astype(np.float32),
           "fc1_bias": np.zeros(8, np.float32),
           "fc2_weight": (rng.randn(2, 8) * 0.3).astype(np.float32),
           "fc2_bias": np.zeros(2, np.float32)}
    x = rng.randn(4, 6).astype(np.float32)
    y = rng.randn(4, 2).astype(np.float32)
    losses = {}
    for pkg, (mx, S, nd) in PKGS.items():
        data, s = _fc_net(S)
        blk = mx.gluon.SymbolBlock(s, [data], params={
            k: nd.array(v) for k, v in arg.items()})
        out = blk(nd.array(x))
        ex = s.bind(args={**{k: nd.array(v) for k, v in arg.items()},
                          "data": nd.array(x)}, grad_req="null")
        np.testing.assert_allclose(out.asnumpy(),
                                   ex.forward()[0].asnumpy(), **TOL)
        tr = mx.gluon.Trainer(blk.collect_params(), "sgd",
                              {"learning_rate": 0.3})
        l2 = mx.gluon.loss.L2Loss()
        losses[pkg] = []
        for _ in range(5):
            with mx.autograd.record():
                loss = l2(blk(nd.array(x)), nd.array(y)).mean()
            loss.backward()
            tr.step(4)
            losses[pkg].append(float(loss.asnumpy()))
        losses[pkg + " params"] = {k: p.data().asnumpy() for k, p in
                                   blk.collect_params().items()}
    np.testing.assert_allclose(losses["port"], losses["jax"], **TOL)
    for k in arg:
        np.testing.assert_allclose(losses["port params"][k],
                                   losses["jax params"][k], **TOL)


def test_symbolblock_deferred_init_hybridize_and_errors():
    data, s = _fc_net(tsym)
    x = tnd.array(np.random.RandomState(0).randn(4, 6).astype(np.float32))
    blk = tmx.gluon.SymbolBlock(s, [data])
    blk.initialize()
    eager = blk(x).asnumpy()
    assert eager.shape == (4, 2)
    assert blk.collect_params()["fc1_weight"].shape == (8, 6)
    blk.hybridize()
    np.testing.assert_allclose(blk(x).asnumpy(), eager, **TOL)
    # a hybridized block reads the live weights, not frozen copies
    blk.collect_params()["fc2_bias"].set_data(np.ones(2, np.float32))
    np.testing.assert_allclose(blk(x).asnumpy(), eager + 1.0, **TOL)
    with pytest.raises(ValueError, match="not variables of the symbol"):
        tmx.gluon.SymbolBlock(s, ["dtaa"])
    with pytest.raises(ValueError, match="match no argument"):
        tmx.gluon.SymbolBlock(s, [data], params={
            "dense0_weight": tnd.zeros((8, 6))})
    with pytest.raises(ValueError, match="graph cutting"):
        tmx.gluon.SymbolBlock(s, [tsym.FullyConnected(data, num_hidden=2)])


def test_symbolblock_hybridized_trains_like_eager():
    """A hybridized SymbolBlock under autograd and gluon.Trainer: its
    captured unit's body (run eagerly on the CPU) reads the parameters
    through ``functional_call``'s aliases, and trains as the eager
    block does."""
    rng = np.random.RandomState(1)
    x = rng.randn(4, 6).astype(np.float32)
    y = rng.randn(4, 2).astype(np.float32)
    start = None
    finals = []
    for hyb in (False, True):
        with tmx.name.NameManager():
            data, s = _fc_net(tsym)
        blk = tmx.gluon.SymbolBlock(s, [data])
        blk.initialize()
        blk(tnd.array(x))
        if start is None:
            start = {k: p.data().asnumpy() for k, p in
                     blk.collect_params().items()}
        for k, p in blk.collect_params().items():
            p.set_data(start[k])
        if hyb:
            blk.hybridize()
        tr = tmx.gluon.Trainer(blk.collect_params(), "sgd",
                               {"learning_rate": 0.3})
        for _ in range(4):
            with tmx.autograd.record():
                loss = tmx.gluon.loss.L2Loss()(blk(tnd.array(x)),
                                               tnd.array(y)).mean()
            loss.backward()
            tr.step(4)
        finals.append({k: p.data().asnumpy() for k, p in
                       blk.collect_params().items()})
    for k in finals[0]:
        np.testing.assert_allclose(finals[1][k], finals[0][k], **TOL)
        assert not np.allclose(finals[1][k], start[k])


def test_symbolblock_batchnorm_aux():
    def build(S):
        d = S.Variable("data")
        return d, S.BatchNorm(S.FullyConnected(d, name="fc", num_hidden=4),
                              name="bn")
    x = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    w = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    stats = {}
    for pkg, (mx, S, nd) in PKGS.items():
        d, g = build(S)
        blk = mx.gluon.SymbolBlock(g, [d])
        blk.initialize()
        blk(nd.array(x))
        blk.collect_params()["fc_weight"].set_data(nd.array(w))
        with mx.autograd.record():
            blk(nd.array(x))
        mm = blk.collect_params()["bn_moving_mean"].data().asnumpy()
        before = mm.copy()
        blk(nd.array(x))              # predict mode: stats untouched
        np.testing.assert_array_equal(
            blk.collect_params()["bn_moving_mean"].data().asnumpy(), before)
        stats[pkg] = mm
    assert not np.allclose(stats["port"], 0.0)
    np.testing.assert_allclose(stats["port"], stats["jax"], **TOL)


# ------------------------------------------------------- visualization --
@pytest.mark.parametrize("kw", [{}, {"hide_weights": False},
                                {"shape": (2, 5)}, {"title": "mlp"}],
                         ids=["default", "weights", "shape", "title"])
def test_plot_network_dot_equals_jax(kw):
    from mxnet_tpu import visualization as jviz
    from mxnet_tpu_torch import visualization as tviz

    j, t = both(_mlp)
    src = tviz.plot_network(t, **kw).source
    assert src == jviz.plot_network(j, **kw).source
    assert "fc1\\nFullyConnected" in src


def test_plot_network_escapes_and_renders(tmp_path):
    from mxnet_tpu_torch import visualization as tviz

    g = tviz.plot_network(_mlp(tsym), title="mlp")
    path = g.render(str(tmp_path / "m"))
    assert path.endswith(".dot") and 'digraph "mlp"' in open(path).read()
    src = tviz.plot_network(tsym.make_loss(tsym.Variable('we"ird') * 2)
                            ).source
    assert 'we\\"ird' in src and '"we"' not in src


def test_print_summary_symbol_forms():
    from mxnet_tpu import visualization as jviz
    from mxnet_tpu_torch import visualization as tviz

    j, t = both(_mlp)
    expect = 8 * 5 + 8 + 3 * 8 + 3
    for shape in ((2, 5), [(2, 5)], {"data": (2, 5)}, None):
        texts = []
        for viz, s in ((jviz, j), (tviz, t)):
            buf = _io.StringIO()
            with contextlib.redirect_stdout(buf):
                total = viz.print_summary(s, shape=shape)
            assert total == (expect if shape is not None else 0)
            texts.append(buf.getvalue())
        assert texts[0] == texts[1]


# ----------------------------------------------------------- kernels --
def _fused_sym(S):
    names = ("data", "weight", "gamma", "beta", "moving_mean", "moving_var")
    v = [S.Variable(n) for n in names]
    return S.FusedNormReluConv(*v, stride=1, name="nrc")[0]


def test_fused_norm_relu_conv_symbol_matches_jax():
    """The fused-conv symbol (NHWC, 3x3, stride 1) against the JAX op
    through the Pallas kernels in interpret mode: output and the
    gradients of data, weight, gamma and beta under an out_grad."""
    rng = np.random.RandomState(0)
    n, h, ci, co = 2, 6, 8, 8
    vals = {"data": rng.randn(n, h, h, ci).astype(np.float32),
            "weight": (rng.randn(3, 3, ci, co) * 0.2).astype(np.float32),
            "gamma": (rng.rand(ci) + 0.5).astype(np.float32),
            "beta": (rng.randn(ci) * 0.1).astype(np.float32),
            "moving_mean": np.zeros(ci, np.float32),
            "moving_var": np.ones(ci, np.float32)}
    og = [rng.randn(n, h, h, co).astype(np.float32)]
    req = {k: "write" for k in ("data", "weight", "gamma", "beta")}
    j, t = both(_fused_sym)
    assert t.list_outputs() == j.list_outputs() == ["nrc_output0"]
    assert t.infer_shape(**{k: v.shape for k, v in vals.items()}) \
        == j.infer_shape(**{k: v.shape for k, v in vals.items()})
    assert_runs_equal(run("jax", j, vals, req, out_grads=og),
                      run("port", t, vals, req, out_grads=og), CHAIN_TOL)


def _flash_sym(S):
    q, k, v = (S.Variable(n) for n in "qkv")
    return S.flash_attention(q, k, v, heads=2, block_q=16, block_k=16,
                             name="fa")


def test_flash_attention_symbol_matches_jax():
    rng = np.random.RandomState(1)
    vals = {n: (rng.randn(2, 16, 16) * 0.5).astype(np.float32)
            for n in "qkv"}
    og = [rng.randn(2, 16, 16).astype(np.float32)]
    j, t = both(_flash_sym)
    assert t.infer_shape(q=(2, 16, 16), k=(2, 16, 16), v=(2, 16, 16)) \
        == j.infer_shape(q=(2, 16, 16), k=(2, 16, 16), v=(2, 16, 16))
    assert_runs_equal(run("jax", j, vals, out_grads=og),
                      run("port", t, vals, out_grads=og), CHAIN_TOL)


def test_kernel_wrappers_meta_and_device_rules(monkeypatch):
    """``meta`` tensors give the plain bodies' shapes (shape inference);
    a mix of devices raises; a CUDA tensor is routed to the kernel,
    never to a plain body."""
    import importlib

    tfa = importlib.import_module("mxnet_tpu_torch.ops.flash_attention")
    tfc = importlib.import_module("mxnet_tpu_torch.ops.fused_conv")
    tpa = importlib.import_module("mxnet_tpu_torch.ops.paged_attention")

    m = lambda *s: torch.empty(*s, device="meta")
    assert tfc.norm_relu_conv(m(2, 8, 8, 16), m(16), m(16), m(3, 3, 16, 32),
                              stride=2).shape == (2, 4, 4, 32)
    assert tfa.flash_attention(m(4, 32, 8), m(4, 32, 8), m(4, 32, 8)
                               ).shape == (4, 32, 8)
    i32 = lambda *s: torch.empty(*s, dtype=torch.int32, device="meta")
    assert tpa.paged_decode_attention(m(4, 2, 8), m(16, 8, 2, 8),
                                      m(16, 8, 2, 8), i32(4, 4),
                                      i32(4)).shape == (4, 2, 8)
    for use_plain in (tfc._use_plain, tfa._use_plain):
        with pytest.raises(ValueError, match="all lie on the CPU"):
            use_plain([m(2), torch.ones(2)])
        cuda = types.SimpleNamespace(device=torch.device("cuda", 0))
        assert use_plain([cuda, cuda]) is False
        with pytest.raises(ValueError, match="all lie on the CPU"):
            use_plain([cuda, m(2)])
    with pytest.raises(ValueError, match="all lie on the CPU"):
        tpa.paged_decode_attention(m(4, 2, 8), torch.ones(16, 8, 2, 8),
                                   m(16, 8, 2, 8), i32(4, 4), i32(4))
    routed = []
    monkeypatch.setattr(tpa, "_paged_decode_attention_cuda",
                        lambda *a: routed.append("kernel"))
    monkeypatch.setattr(tpa, "paged_decode_attention_reference",
                        lambda *a: routed.append("plain"))
    fake = types.SimpleNamespace(is_cuda=True,
                                 device=torch.device("cuda", 0))
    tpa.paged_decode_attention(*[fake] * 5)
    assert routed == ["kernel"]


def test_executor_frees_each_steps_values_without_the_cycle_collector(
        monkeypatch):
    """The walk's memo sits in a reference cycle (a recursive closure):
    it is emptied when the walk ends, so a step's intermediate values
    (on the card its activations and autograd graph) die with the step,
    not at the next run of the cycle collector."""
    import gc
    import weakref

    from mxnet_tpu_torch import executor

    walked = []
    trace = executor._trace

    def traced(*a, **kw):
        outs, updates = trace(*a, **kw)
        walked.append(weakref.ref(outs[0]))
        return outs, updates
    monkeypatch.setattr(executor, "_trace", traced)
    x = tsym.Variable("x")
    o = tsym.make_loss(tsym.FullyConnected(x, num_hidden=4, name="fc") * 2)
    ex = o.simple_bind(x=(2, 3), capture=False)
    gc.disable()
    try:
        for _ in range(3):
            ex.forward(is_train=True)
            ex.backward()
        assert len(walked) == 3
        assert all(r() is None for r in walked)
    finally:
        gc.enable()


def test_symbolblock_callable_form():
    """``SymbolBlock(callable, params)``: a function of ``nd`` arrays as
    a block, its Parameters collected, as in the JAX package."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 4).astype(np.float32)
    w = rng.randn(4, 4).astype(np.float32)
    outs = []
    for mx, S, nd in PKGS.values():
        p = mx.gluon.Parameter("w", shape=(4, 4))
        p.initialize()
        p.set_data(nd.array(w))
        blk = mx.gluon.SymbolBlock(
            lambda a, p=p: nd.relu(nd.dot(a, p.data())) * 2, params=[p])
        assert list(blk.collect_params().keys()) == ["w"]
        outs.append(blk(nd.array(x)).asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


# ----------------------------------------------------- export / imports --
def _small_fused_net():
    """A conv, a fused norm-relu-conv, BatchNorm and Dense, NHWC."""
    from mxnet_tpu_torch.gluon import nn

    with tmx.name.NameManager():
        net = nn.HybridSequential()
        net.add(nn.Conv2D(8, 3, padding=1, layout="NHWC", in_channels=3),
                nn.NormReluConv2D(8, 3, in_channels=8),
                nn.BatchNorm(axis=-1), nn.Flatten(), nn.Dense(5))
    net.initialize()
    return net


def test_export_symbolblock_imports_roundtrip(tmp_path):
    """HybridBlock.export -> SymbolBlock.imports serves the block without
    its class: the same outputs in process and in a fresh process that
    imports only the port; the fused kernels are recorded as the
    ``mxnet_tpu_torch::norm_relu_conv`` custom op."""
    import subprocess
    import sys

    net = _small_fused_net()
    with pytest.raises(RuntimeError, match="hybridized forward"):
        net.export(str(tmp_path / "early"))
    net.hybridize()
    x = np.random.RandomState(0).randn(2, 8, 8, 3).astype(np.float32)
    ref = net(tnd.array(x)).asnumpy()
    sym_file, params_file = net.export(str(tmp_path / "model"))
    program = torch.export.load(str(tmp_path / "model-graph.pt2"))
    assert "mxnet_tpu_torch.norm_relu_conv" in program.graph_module.code
    blk = tmx.gluon.SymbolBlock.imports(sym_file)
    np.testing.assert_allclose(blk(tnd.array(x)).asnumpy(), ref, **TOL)
    assert len(blk.collect_params()) == len(net.collect_params())
    np.save(str(tmp_path / "x.npy"), x)
    code = (f"import numpy as np, mxnet_tpu_torch as mx\n"
            f"with mx.cpu():\n"
            f"    blk = mx.gluon.SymbolBlock.imports({sym_file!r})\n"
            f"    x = mx.nd.array(np.load({str(tmp_path / 'x.npy')!r}))\n"
            f"    np.save({str(tmp_path / 'out.npy')!r}, blk(x).asnumpy())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    np.testing.assert_allclose(np.load(str(tmp_path / "out.npy")), ref,
                               **TOL)


def test_export_records_the_attention_kernels_as_custom_ops(tmp_path):
    """flash and paged attention in an exported program: each a custom op
    whose run gives the wrapper's result."""
    import importlib

    tpa = importlib.import_module("mxnet_tpu_torch.ops.paged_attention")

    class Attend(tmx.gluon.HybridBlock):
        def hybrid_forward(self, F, q, k, v):
            return F.flash_attention(q, k, v, heads=2)

    rng = np.random.RandomState(3)
    q, k, v = (tnd.array(rng.randn(2, 16, 16).astype(np.float32))
               for _ in range(3))
    blk = Attend()
    blk.hybridize()
    ref = blk(q, k, v).asnumpy()
    sym_file, _ = blk.export(str(tmp_path / "attend"))
    program = torch.export.load(str(tmp_path / "attend-graph.pt2"))
    assert "mxnet_tpu_torch.flash_attention" in program.graph_module.code
    served = tmx.gluon.SymbolBlock.imports(sym_file)
    np.testing.assert_allclose(served(q, k, v).asnumpy(), ref, **TOL)

    class Paged(torch.nn.Module):
        def forward(self, *ts):
            return tpa.paged_decode_attention(*ts)

    ins = (torch.randn(3, 2, 8), torch.randn(12, 4, 2, 8),
           torch.randn(12, 4, 2, 8),
           torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]],
                        dtype=torch.int32),
           torch.tensor([5, 16, 0], dtype=torch.int32))
    ep = torch.export.export(Paged(), ins)
    assert "mxnet_tpu_torch.paged_decode_attention" in ep.graph_module.code
    torch.testing.assert_close(ep.module()(*ins),
                               tpa.paged_decode_attention(*ins))


def test_imports_across_the_packages_raise(tmp_path):
    """The JAX package's artifact (a StableHLO program) raises in the
    port's imports, naming that package; the port's artifact raises in
    the JAX package's; an artifact without a graph asks for an export."""
    jnet = jmx.gluon.nn.Dense(3, in_units=4)
    jnet.initialize()
    jnet.hybridize()
    jnet(jnd.array(np.ones((2, 4), np.float32)))
    jsym_file, _ = jnet.export(str(tmp_path / "jax"))
    with pytest.raises(ValueError, match=r"JAX package \(mxnet_tpu\)"):
        tmx.gluon.SymbolBlock.imports(jsym_file)
    tnet = tmx.gluon.nn.Dense(3, in_units=4)
    tnet.initialize()
    tnet.hybridize()
    tnet(tnd.array(np.ones((2, 4), np.float32)))
    tsym_file, _ = tnet.export(str(tmp_path / "port"))
    with pytest.raises(Exception):
        jmx.gluon.SymbolBlock.imports(tsym_file)
    old = tmp_path / "old-symbol.json"
    old.write_text(json.dumps({"framework": "mxnet_tpu_torch", "block": "X",
                               "params": "old-0000.params"}))
    with pytest.raises(ValueError, match="re-export"):
        tmx.gluon.SymbolBlock.imports(str(old))
