"""int8 post-training quantization in the port (tools/quantize.py, the
quant branches of INNER_PRODUCT and CONVOLUTION, ops/quant.py) against the
JAX package's on the CPU.

Same params and batches in both: the calibrated input scales within 1e-6
relative, w_q and s_w bit for bit; the int8 INNER_PRODUCT forward within
1e-6 relative of JAX's (an exact int32 sum, one f32 multiply, one add);
the weight_only conv (bf16 operands: one bf16 rounding either way) within
2e-2 of max|ref|, the int8 conv (exact sums) within 1e-6; and JAX's
accuracy contract, retrieval mAP / hit@1 / hit@5 of int8 features within
0.02 of f32's on a class-structured batch (tests/test_quantize.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videovector_tpu.config import parse as jparse
from videovector_tpu.graph import Net as JNet
from videovector_tpu.tools import quantize as jquant
from videovector_tpu_torch import convert
from videovector_tpu_torch.config import parse as tparse
from videovector_tpu_torch.graph import Net as TNet
from videovector_tpu_torch.metrics.retrieval import retrieval_stats
from videovector_tpu_torch.ops import quant as tq
from videovector_tpu_torch.tools import quantize as tquant

IP_NET = """
layers { name: "d" type: MEMORY_DATA top: "x" }
layers { name: "fc" type: INNER_PRODUCT bottom: "x" top: "h"
  inner_product_param { num_output: 32 weight_filler { type: "gaussian" std: 0.2 }
    bias_filler { type: "constant" value: 0.05 } } }
layers { name: "r" type: RELU bottom: "h" top: "h" }
layers { name: "fc2" type: INNER_PRODUCT bottom: "h" top: "emb"
  inner_product_param { num_output: 16 weight_filler { type: "xavier" } } }
layers { name: "n" type: NORMALIZATION bottom: "emb" top: "out" }
"""

CONV_NET = """
layers { name: "d" type: MEMORY_DATA top: "x" }
layers { name: "c1" type: CONVOLUTION bottom: "x" top: "h"
  convolution_param { num_output: 8 kernel_size: 3 stride: 1
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "r" type: RELU bottom: "h" top: "h" }
layers { name: "c2" type: CONVOLUTION bottom: "h" top: "out"
  convolution_param { num_output: 4 kernel_size: 3 stride: 2 group: 2 pad: 1
    weight_filler { type: "xavier" } } }
"""


def _nets(text, batch, seed=0):
    jnet = JNet(jparse(text), phase="TEST")
    jp, _ = jnet.init(jax.random.PRNGKey(seed), {
        k: jax.ShapeDtypeStruct(v.shape, jnp.float32)
        for k, v in batch.items()})
    tnet = TNet(tparse(text), "TEST")
    tnet.init(torch.Generator(), batch)
    return jnet, jp, tnet, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _quantized(text, batch, seed=0):
    """(JAX net, params, port net, params), each with its quant table from
    its own calibrate + quantize_weights on `batch`."""
    jnet, jp, tnet, tp = _nets(text, batch, seed)
    jnet.quant = jquant.quantize_weights(
        jp, jnet, jquant.calibrate(jnet, jp, [batch]))
    tnet.quant = tquant.quantize_weights(
        tp, tnet, tquant.calibrate(tnet, tp, [batch]))
    return jnet, jp, tnet, tp


def _blobs(net, params, batch, jax_side: bool):
    if jax_side:
        _, b = net.apply(params, {k: jnp.asarray(v) for k, v in batch.items()},
                         return_blobs=True)
        return {k: np.asarray(v, np.float32) for k, v in b.items()}
    with torch.no_grad():
        _, b = net.apply(params, {k: torch.as_tensor(v)
                                  for k, v in batch.items()}, return_blobs=True)
    return {k: v.float().numpy() for k, v in b.items()}


@pytest.mark.parametrize("text,shape", [(IP_NET, (16, 24)),
                                        (CONV_NET, (4, 3, 12, 12))])
def test_scales_and_int8_weights_match_jax(text, shape):
    batch = {"x": np.random.RandomState(3).randn(*shape).astype(np.float32)}
    jnet, jp, tnet, tp = _nets(text, batch)
    js = jquant.calibrate(jnet, jp, [batch])
    ts = tquant.calibrate(tnet, tp, [batch])
    assert js.keys() == ts.keys() and len(ts) == 2
    for k in js:
        assert abs(ts[k] - js[k]) <= 1e-6 * abs(js[k])
    jq = jquant.quantize_weights(jp, jnet, js)
    tq_ = tquant.quantize_weights(tp, tnet, js)
    assert jq.keys() == tq_.keys()
    for k in jq:
        assert tq_[k]["mode"] == jq[k]["mode"]
        assert tq_[k]["w_q"].dtype == torch.int8
        np.testing.assert_array_equal(tq_[k]["w_q"].numpy(), jq[k]["w_q"])
        np.testing.assert_array_equal(tq_[k]["s_w"].numpy(), jq[k]["s_w"])
        assert float(tq_[k]["s_x"]) == float(jq[k]["s_x"])


def test_int8_inner_product_matches_jax():
    batch = {"x": np.random.RandomState(4).randn(16, 24).astype(np.float32)}
    jnet, jp, tnet, tp = _quantized(IP_NET, batch)
    assert {m["mode"] for m in tnet.quant.values()} == {"int8"}
    jb = _blobs(jnet, jp, batch, True)
    tb = _blobs(tnet, tp, batch, False)
    for name in ("h", "emb", "out"):
        scale = np.abs(jb[name]).max()
        np.testing.assert_allclose(tb[name], jb[name], rtol=0,
                                   atol=1e-6 * scale, err_msg=name)


def test_weight_only_conv_matches_jax():
    batch = {"x": np.random.RandomState(5).rand(4, 3, 12, 12)
             .astype(np.float32)}
    jnet, jp, tnet, tp = _quantized(CONV_NET, batch)
    assert {m["mode"] for m in tnet.quant.values()} == {"weight_only"}
    jb = _blobs(jnet, jp, batch, True)
    tb = _blobs(tnet, tp, batch, False)
    for name in ("h", "out"):
        np.testing.assert_allclose(tb[name], jb[name], rtol=0,
                                   atol=2e-2 * np.abs(jb[name]).max())


def test_int8_conv_matches_jax():
    """The int8 conv mode, reachable only by a hand-built table: exact int32
    sums dequantized per channel, within 1e-6 of JAX's."""
    batch = {"x": np.random.RandomState(6).randn(3, 3, 11, 11)
             .astype(np.float32)}
    jnet, jp, tnet, tp = _quantized(CONV_NET, batch)
    for table in (jnet.quant, tnet.quant):
        for entry in table.values():
            entry["mode"] = "int8"
    jb = _blobs(jnet, jp, batch, True)
    tb = _blobs(tnet, tp, batch, False)
    for name in ("h", "out"):
        np.testing.assert_allclose(tb[name], jb[name], rtol=0,
                                   atol=1e-6 * np.abs(jb[name]).max())


def test_retrieval_metric_parity_bound():
    """JAX's accuracy contract: mAP / hit@k of int8 features within 0.02 of
    f32's on a class-structured batch."""
    rng = np.random.RandomState(0)
    n, d, n_cls = 128, 24, 8
    centers = rng.randn(n_cls, d).astype(np.float32) * 2
    cls = rng.randint(0, n_cls, n)
    x = (centers[cls] + 0.6 * rng.randn(n, d)).astype(np.float32)
    batch = {"x": x}
    _, _, tnet, tp = _nets(IP_NET, batch)
    f32 = _blobs(tnet, tp, batch, False)["out"]
    tnet.quant = tquant.quantize_weights(
        tp, tnet, tquant.calibrate(tnet, tp, [batch]))
    q = _blobs(tnet, tp, batch, False)["out"]
    vids = torch.as_tensor(np.arange(n) % 50)
    c = torch.as_tensor(cls)
    s_f = retrieval_stats(torch.as_tensor(f32), vids, c)
    s_q = retrieval_stats(torch.as_tensor(q), vids, c)
    for k in ("mean_ap", "hit_at_1", "hit_at_5"):
        assert abs(float(s_f[k]) - float(s_q[k])) <= 0.02, k


@pytest.mark.parametrize("m,k,n", [(1, 9, 5), (16, 24, 7), (50, 40, 33)])
def test_int8_product_and_its_card_padding_are_exact(m, k, n):
    """int8_matmul equals an int64 product; the zero padding the card's
    _int_mm needs (more than 16 rows, K and N multiples of 8) leaves the
    product exact (run here through _int_mm on the CPU)."""
    g = torch.Generator().manual_seed(m * k * n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    want = a.long() @ b.long()
    assert torch.equal(tq.int8_matmul(a, b).long(), want)
    up = lambda v: -(-v // tq.INT_MM_ALIGN) * tq.INT_MM_ALIGN  # noqa: E731
    mp = max(m, tq.INT_MM_MIN_ROWS)
    padded = torch._int_mm(tq._pad_to(a, mp, up(k)), tq._pad_to(b, up(k), up(n)))
    assert torch.equal(padded[:m, :n].long(), want)
    assert padded.shape == (mp, up(n))


def test_quantize_input_rounds_half_to_even_and_clips():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0])
    assert tq.quantize_input(x, 1.0).tolist() == [0, 2, 2, 0, -2, 127, -127]
    # a bf16 input is widened before the division, as JAX promotes it
    xb = torch.tensor([3.0], dtype=torch.bfloat16)
    assert tq.quantize_input(xb, 0.75).tolist() == [4]
