"""The graph engine's vision, neuron and glue layer types (CONVOLUTION on K2's
Net entry, POOLING, LRN, IM2COL, SIGMOID, TANH, BNLL, ABSVAL, POWER,
THRESHOLD, SOFTMAX, SPLIT, FLATTEN, FLATTEN_BATCH, SILENCE) and the
extraction net (projects/videovec_embedding/generate_extraction_net.py)
through the port's Net, against the JAX package's Net on the CPU.

Each case feeds the same numpy inputs and params to both Nets and compares
every output blob and the gradients of sum(output * cotangent) with respect
to every param and the input. Tolerances, relative to max|ref|: 1e-5 for
f32 values and 1e-4 for f32 gradients (convolutions and products sum in
other orders; the extraction net's gradients pass 8 layers of them); bf16
`compute_dtype` values 2e-2 (one bf16 rounding step, 2**-8, can flip where
the two f32 sums straddle a bf16 boundary, and the chain carries it). JAX's
bf16 CONVOLUTION has no gradient (lax.conv_general_dilated refuses the
f32 cotangent against the bf16 weight, pinned below), so the port's bf16
conv gradients are held against JAX's f32 VJP of the same bf16-valued
operands, rounded to bf16 as the cotangents of JAX's casts are: within 8e-3
(one bf16 step either side). The bf16 conv's single rounding of the
forward is pinned exactly on integer operands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videovector_tpu.config import parse as jparse
from videovector_tpu.graph import Net as JNet
from videovector_tpu.ops import conv as jconv
from videovector_tpu_torch import convert
from videovector_tpu_torch.config import parse as tparse
from videovector_tpu_torch.graph import Net as TNet
from videovector_tpu_torch.graph import layers as tlayers
from videovector_tpu_torch.ops.hopper import conv_gemm as k2
from torch_extraction_net import BATCH, CROP, extraction_net

torch.set_num_threads(1)
NEW_TYPES = ("CONVOLUTION", "POOLING", "LRN", "IM2COL", "SIGMOID", "TANH",
             "BNLL", "ABSVAL", "POWER", "THRESHOLD", "SOFTMAX", "SPLIT",
             "FLATTEN", "FLATTEN_BATCH", "SILENCE")


def _random_params(jn, batch, seed=3):
    """Params of the JAX Net's shapes, drawn with numpy (the extraction net
    has no fillers: its init is all zeros), scaled by 1/sqrt(fan_in)."""
    jp, _ = jn.init(jax.random.PRNGKey(0), {
        k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()})
    rs = np.random.RandomState(seed)
    out = {}
    for lname, lp in jp.items():
        out[lname] = {}
        for pname, arr in lp.items():
            shape = np.shape(arr)
            fan_in = int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]
            scale = 1.0 / np.sqrt(max(fan_in, 1)) if pname == "w" else 0.1
            out[lname][pname] = (rs.randn(*shape) * scale).astype(np.float32)
    return out


def _cotangents(outs, seed=11):
    rs = np.random.RandomState(seed)
    return {k: rs.randn(*np.shape(v)).astype(np.float32)
            for k, v in sorted(outs.items())}


def _jax_run(jn, params, batch, cots=None, **kw):
    """(blobs, grads wrt params, grad wrt the batch) of the JAX Net."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, outs = jn.apply(params, jb, **kw)
    outs = jax.tree.map(np.asarray, outs)
    if cots is None:
        cots = _cotangents({k: v for k, v in outs.items()
                            if k not in batch})

    def scalar(p, b):
        _, o = jn.apply(p, b, **kw)
        return sum(jnp.sum(o[k].astype(jnp.float32) * c)
                   for k, c in cots.items())

    gp, gb = jax.grad(scalar, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jb)
    return (outs, jax.tree.map(np.asarray, gp),
            {k: np.asarray(v) for k, v in gb.items()}, cots)


def _port_run(tn, params, batch, cots, **kw):
    p = convert.map_params(
        lambda a: torch.tensor(np.asarray(a), requires_grad=True), params)
    tb = {k: torch.tensor(v, requires_grad=True) for k, v in batch.items()}
    _, outs = tn.apply(p, tb, **kw)
    scalar = sum((outs[k].float() * torch.as_tensor(c)).sum()
                 for k, c in cots.items())
    if scalar.requires_grad:
        scalar.backward()
    grad = lambda t: (t.grad.numpy() if t.grad is not None
                      else np.zeros(tuple(t.shape), np.float32))
    return ({k: v.detach().float().numpy() for k, v in outs.items()},
            convert.map_params(grad, p), {k: grad(v) for k, v in tb.items()})


def _close(got, ref, rtol, what):
    ref = np.asarray(ref, np.float32)
    assert np.shape(got) == ref.shape, (what, np.shape(got), ref.shape)
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale + 1e-30,
                               err_msg=what)


def _compare(txt, batch):
    """The f32 TEST Nets of `txt` on `batch`: the port's init gives JAX's
    param shapes; outputs within 1e-5, gradients within 1e-4."""
    jn = JNet(jparse(txt), "TEST", fuse_scoring=False)
    tn = TNet(tparse(txt), "TEST")
    params = _random_params(jn, batch)
    tp, _ = tn.init(torch.Generator().manual_seed(0), batch)
    assert {k: sorted(v) for k, v in tp.items()} == \
        {k: sorted(v) for k, v in params.items()}
    for lname, lp in tp.items():
        for pname, t in lp.items():
            assert tuple(t.shape) == params[lname][pname].shape
    jouts, jgp, jgb, cots = _jax_run(jn, params, batch)
    touts, tgp, tgb = _port_run(tn, params, batch, cots)
    assert sorted(touts) == sorted(jouts)
    for k in jouts:
        _close(touts[k], jouts[k], 1e-5, k)
    for path, leaf in convert.leaves_with_paths(tgp):
        _close(leaf, jgp[path[0]][path[1]], 1e-4, path)
    for k in batch:
        _close(tgb[k], jgb[k], 1e-4, f"d{k}")
    return touts


def _net(body, shape=(2, 6, 9, 8)):
    dims = " ".join(f"input_dim: {d}" for d in shape)
    return f'name: "t" input: "x" {dims}\n{body}'


def _x(shape=(2, 6, 9, 8), seed=1):
    return {"x": np.random.RandomState(seed).randn(*shape).astype(np.float32)}


# -- one layer type at a time ---------------------------------------------------

CONV = """layers { name: "c" type: CONVOLUTION bottom: "x" top: "y"
  convolution_param { num_output: 8 %s } }"""
CONV_CASES = {
    "square": "kernel_size: 3",
    "group2_pad": "kernel_size: 3 pad: 1 group: 2",
    "nonsquare": "kernel_h: 3 kernel_w: 2 stride_h: 2 stride_w: 1 "
                 "pad_h: 1 pad_w: 0 group: 2",
    "stride_no_bias": "kernel_size: 5 stride: 2 pad: 2 bias_term: false",
    "conv1_like": "kernel_size: 4 stride: 4",
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_layer_matches_jax(case):
    _compare(_net(CONV % CONV_CASES[case]), _x())


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("case", ["group2_pad", "nonsquare"])
def test_convolution_layer_bf16_matches_jax(case):
    """Values against JAX's bf16 Net; gradients against JAX's f32 VJP of
    the conv over the bf16-rounded operands, rounded to bf16 (dx, dw) or
    kept f32 (db), as the port's backward defines them."""
    txt = _net(CONV % CONV_CASES[case])
    batch = _x()
    jn = JNet(jparse(txt), "TEST", fuse_scoring=False,
              compute_dtype="bfloat16")
    params = _random_params(jn, batch)
    _, jouts = jn.apply(params, {"x": jnp.asarray(batch["x"])})
    cots = _cotangents({"y": np.asarray(jouts["y"])})
    tn = TNet(tparse(txt), "TEST", compute_dtype="bfloat16")
    touts, tgp, tgb = _port_run(tn, params, batch, cots)
    _close(touts["y"], np.asarray(jouts["y"]).astype(np.float32), 2e-2, "y")
    p = tparse(txt).get_list("layers")[0].get_msg("convolution_param")
    _, stride, pad = tlayers._kernel_geometry(p)
    groups = int(p.get("group", 1))
    fwd = lambda x, w, b: jconv.conv2d(x, w, b, stride=stride, pad=pad,
                                       groups=groups)
    _, vjp = jax.vjp(fwd, jnp.asarray(_bf16(batch["x"])),
                     jnp.asarray(_bf16(params["c"]["w"])),
                     jnp.asarray(params["c"]["b"]))
    # the cotangent reaches the conv through the bf16 output: rounded
    dx, dw, db = vjp(jnp.asarray(_bf16(cots["y"])))
    _close(tgb["x"], _bf16(dx), 8e-3, "dx")
    _close(tgp["c"]["w"], _bf16(dw), 8e-3, "dw")
    _close(tgp["c"]["b"], db, 1e-5, "db")


def test_jax_bf16_convolution_has_no_gradient():
    """Why the bf16 gradients above have no JAX Net to compare with."""
    txt = _net(CONV % CONV_CASES["square"])
    batch = _x()
    jn = JNet(jparse(txt), "TEST", compute_dtype="bfloat16")
    params = _random_params(jn, batch)
    with pytest.raises(TypeError, match="same dtypes"):
        _jax_run(jn, params, batch)


LAYER_CASES = {
    "pool_max": 'type: POOLING pooling_param { pool: MAX kernel_size: 3 '
                'stride: 2 }',
    "pool_max_pad": 'type: POOLING pooling_param { kernel_size: 3 stride: 2 '
                    'pad: 1 }',
    "pool_ave": 'type: POOLING pooling_param { pool: AVE kernel_h: 3 '
                'kernel_w: 2 stride: 2 pad_h: 1 pad_w: 1 }',
    "pool_stochastic": 'type: POOLING pooling_param { pool: STOCHASTIC '
                       'kernel_size: 2 stride: 2 }',
    "lrn_across": 'type: LRN lrn_param { local_size: 5 alpha: 0.01 '
                  'beta: 0.75 }',
    "lrn_within": 'type: LRN lrn_param { local_size: 3 alpha: 0.5 beta: 0.6 '
                  'norm_region: WITHIN_CHANNEL }',
    "lrn_default": 'type: LRN',
    "im2col": 'type: IM2COL convolution_param { kernel_size: 3 stride: 2 '
              'pad: 1 }',
    "sigmoid": 'type: SIGMOID',
    "tanh": 'type: TANH',
    "bnll": 'type: BNLL',
    "absval": 'type: ABSVAL',
    "power": 'type: POWER power_param { power: 2 scale: 0.5 shift: 1 }',
    "power_default": 'type: POWER',
    "threshold": 'type: THRESHOLD threshold_param { threshold: 0.3 }',
    "softmax": 'type: SOFTMAX',
    "flatten": 'type: FLATTEN',
    "flatten_batch": 'type: FLATTEN_BATCH',
    "flatten_batch_bs": 'type: FLATTEN_BATCH flatten_batch_param '
                        '{ batch_size: 4 }',
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_type_matches_jax(case):
    body = f'layers {{ name: "l" {LAYER_CASES[case]} bottom: "x" top: "y" }}'
    x = _x()
    if case == "pool_stochastic":
        x["x"] = np.abs(x["x"])
    _compare(_net(body), x)


def test_split_silence_and_flatten_in_one_net():
    """SPLIT's tops feed two consumers; SILENCE swallows a blob; FLATTEN
    keeps c*h*w order for the INNER_PRODUCT after it."""
    body = """
    layers { name: "s" type: SPLIT bottom: "x" top: "a" top: "b" }
    layers { name: "t" type: TANH bottom: "a" top: "ta" }
    layers { name: "f" type: FLATTEN bottom: "b" top: "fb" }
    layers { name: "ip" type: INNER_PRODUCT bottom: "fb" top: "y"
      inner_product_param { num_output: 5 } }
    layers { name: "q" type: SIGMOID bottom: "ta" top: "z" }
    layers { name: "mute" type: SILENCE bottom: "z" }
    """
    out = _compare(_net(body), _x())
    assert sorted(out) == ["y"]


def test_every_new_type_is_registered_and_not_pending():
    for t in NEW_TYPES:
        assert t in tlayers.LAYERS and t not in tlayers.PENDING_TYPES
    assert tlayers.LAYERS["CONVOLUTION"].has_params
    assert not tlayers.LAYERS["POOLING"].has_params


@pytest.mark.parametrize("geometry,match", [
    ("kernel_h: 3", "BOTH kernel_h and kernel_w"),
    ("kernel_size: 3 kernel_h: 3 kernel_w: 3", "cannot be combined"),
    ("kernel_size: 3 stride_w: 2", "BOTH stride_h and stride_w"),
    ("kernel_size: 0", "must be positive"),
    ("num_output: 1", "must be positive"),
])
def test_kernel_geometry_errors_match_jax(geometry, match):
    body = (f'layers {{ name: "c" type: CONVOLUTION bottom: "x" top: "y" '
            f'convolution_param {{ num_output: 4 {geometry} }} }}')
    batch = _x()
    with pytest.raises(ValueError, match=match):
        JNet(jparse(_net(body)), "TEST").init(jax.random.PRNGKey(0), {
            "x": jax.ShapeDtypeStruct(batch["x"].shape, np.float32)})
    with pytest.raises(ValueError, match=match):
        TNet(tparse(_net(body)), "TEST").init(torch.Generator(), batch)


def test_convolution_quant_is_not_ported():
    """Once refused, a CONVOLUTION in the quant side table now runs its
    mode: weight_only gives JAX's bf16 conv over the dequantized weights
    (within 2e-2 of max|ref|), int8 JAX's exact int32 conv (1e-6)."""
    text = _net(CONV % "kernel_size: 3")
    batch = _x()
    jnet = JNet(jparse(text), "TEST")
    jp, _ = jnet.init(jax.random.PRNGKey(0), {
        "x": jax.ShapeDtypeStruct(batch["x"].shape, jnp.float32)})
    net = TNet(tparse(text), "TEST")
    net.init(torch.Generator(), batch)
    w = np.random.RandomState(2).randn(*jp["c"]["w"].shape).astype(np.float32)
    jp = {"c": {**jp["c"], "w": jnp.asarray(w)}}
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    s_w = (np.abs(w.reshape(w.shape[0], -1)).max(1) / 127.0).astype(np.float32)
    w_q = np.clip(np.rint(w / s_w[:, None, None, None]), -127, 127) \
        .astype(np.int8)
    s_x = np.float32(np.abs(batch["x"]).max() / 127.0)
    for mode, tol in (("weight_only", 2e-2), ("int8", 1e-6)):
        q = {"w_q": w_q, "s_w": s_w, "s_x": s_x, "mode": mode}
        jnet.quant = {"c": q}
        want = np.asarray(jnet.apply(jp, {"x": jnp.asarray(batch["x"])})[1]
                          ["y"], np.float32)
        net.quant = {"c": {k: (torch.as_tensor(v) if k != "mode" else v)
                           for k, v in q.items()}}
        with torch.no_grad():
            got = net.apply(params, {"x": torch.as_tensor(batch["x"])})[1]["y"]
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max(), err_msg=mode)


def test_bf16_conv_rounds_once_as_jaxs_net():
    """JAX's Net sums in f32, adds the f32 bias and rounds once; K2's
    MedNet epilogue would round the sum, add the rounded bias and round
    again. With integer operands (exact sums) the two differ where it
    matters: 128 + 129 + 0.9 rounds to 258 once, 256 twice."""
    x = np.array([128.0, 129.0], np.float32).reshape(1, 2, 1, 1)
    w = np.ones((1, 2, 1, 1), np.float32)
    b = np.array([0.9], np.float32)
    ref = np.asarray(jconv.conv2d(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(w, jnp.bfloat16),
                                  jnp.asarray(b))).astype(np.float32)
    got = k2.conv2d_nchw(torch.as_tensor(x), torch.as_tensor(w),
                         torch.as_tensor(b), compute_dtype=torch.bfloat16)
    twice = k2.conv_epilogue_plain(torch.tensor([257.0]), torch.as_tensor(b),
                                   False, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert float(got) == float(ref.item()) == 258.0
    assert float(twice) == 256.0
    # and over a random conv with integer operands, element for element
    rs = np.random.RandomState(2)
    x = rs.randint(-8, 9, (2, 4, 7, 6)).astype(np.float32)
    w = rs.randint(-8, 9, (6, 2, 3, 3)).astype(np.float32)
    b = rs.randn(6).astype(np.float32) * 3
    ref = np.asarray(jconv.conv2d(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(w, jnp.bfloat16), jnp.asarray(b),
                                  pad=(1, 1), groups=2)).astype(np.float32)
    got = k2.conv2d_nchw(torch.as_tensor(x), torch.as_tensor(w),
                         torch.as_tensor(b), pad=(1, 1), groups=2,
                         compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), ref)


# -- the extraction net, narrowed -------------------------------------------------

def _extraction_batch(seed=5):
    rs = np.random.RandomState(seed)
    return {"data": (rs.randn(BATCH, 3, CROP, CROP) * 40).astype(np.float32),
            "label": np.zeros(BATCH, np.float32)}


def test_narrowed_extraction_net_keeps_caffenets_geometry():
    txt = extraction_net()
    assert "num_output: 4096" not in txt and "num_output: 32" in txt
    tn = TNet(tparse(txt), "TEST")
    params, _ = tn.init(torch.Generator(), _extraction_batch())
    assert {k: tuple(v["w"].shape) for k, v in params.items()} == {
        "conv1": (8, 3, 11, 11), "conv2": (16, 4, 5, 5),
        "conv3": (24, 16, 3, 3), "conv4": (24, 12, 3, 3),
        "conv5": (16, 12, 3, 3), "fc6": (64, 32), "fc7": (32, 32)}
    _, blobs = tn.apply(params, {k: torch.as_tensor(v) for k, v in
                                 _extraction_batch().items()},
                        return_blobs=True)
    assert tuple(blobs["conv1"].shape) == (BATCH, 8, 23, 23)
    assert tuple(blobs["pool2"].shape) == (BATCH, 16, 5, 5)
    assert tuple(blobs["pool5"].shape) == (BATCH, 16, 2, 2)
    assert tuple(blobs["ip2"].shape) == (BATCH, 32)


def test_narrowed_extraction_net_blobs_and_grads_match_jax():
    """Every blob, and the gradients of a scalar of ip2 with respect to
    every param and the input, f32."""
    jn = JNet(jparse(extraction_net()), "TEST")
    batch = _extraction_batch()
    params = _random_params(jn, batch)
    jouts, jgp, jgb, _ = _jax_run(jn, params, batch, return_blobs=True)
    cots = _cotangents({"ip2": jouts["ip2"]})
    jouts, jgp, jgb, _ = _jax_run(jn, params, batch, cots, return_blobs=True)
    tn = TNet(tparse(extraction_net()), "TEST")
    touts, tgp, tgb = _port_run(tn, params, batch, cots, return_blobs=True)
    assert sorted(touts) == sorted(jouts)
    for k in jouts:
        _close(touts[k], jouts[k], 1e-5, k)
    assert sorted(tgp) == sorted(jgp) == ["conv1", "conv2", "conv3", "conv4",
                                          "conv5", "fc6", "fc7"]
    for path, leaf in convert.leaves_with_paths(tgp):
        _close(leaf, jgp[path[0]][path[1]], 1e-4, path)
    _close(tgb["data"], jgb["data"], 1e-4, "ddata")


def test_narrowed_extraction_net_bf16_matches_jax():
    """Every blob of the bf16 Net against JAX's bf16 Net (which has no
    gradient); the port's bf16 gradients are finite, f32 and shaped as the
    params."""
    jn = JNet(jparse(extraction_net()), "TEST", compute_dtype="bfloat16")
    batch = _extraction_batch()
    params = _random_params(jn, batch)
    _, jouts = jn.apply(params, {k: jnp.asarray(v) for k, v in batch.items()},
                        return_blobs=True)
    tn = TNet(tparse(extraction_net()), "TEST", compute_dtype="bfloat16")
    cots = _cotangents({"ip2": np.asarray(jouts["ip2"])})
    touts, tgp, _ = _port_run(tn, params, batch, cots, return_blobs=True)
    assert sorted(touts) == sorted(jouts)
    for k in jouts:
        _close(touts[k], np.asarray(jouts[k]).astype(np.float32), 2e-2, k)
    for path, leaf in convert.leaves_with_paths(tgp):
        assert leaf.dtype == np.float32 and np.isfinite(leaf).all(), path
        assert leaf.shape == params[path[0]][path[1]].shape
        assert np.abs(leaf).max() > 0, path
