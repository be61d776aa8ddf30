"""The kernels' entry points (K1's `matmul`, with and without GELU, K2's
`conv2d_gemm_nhwc`, `conv2d_nchw` and `space_to_depth`, the NHWC
`max_pool`, `attention`) choose between
kernel and plain version in one rule, `device.runs_kernel`: CPU tensors
give the plain version's bits and count no launch, "meta" tensors give the
output's shape, any other device raises, and CUDA tensors reach the custom
op except inside `device.plain_versions()`, which nests and is restored
after an exception. CUDA and other devices are FakeTensors here: the
custom ops' fake implementations give the shapes, and check the operands
as the real ones do.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from videovector_tpu_torch import device
from videovector_tpu_torch.ops import attention as ta
from videovector_tpu_torch.ops import pooling
from videovector_tpu_torch.ops.hopper import conv_gemm as k2
from videovector_tpu_torch.ops.hopper import matmul as k1
from videovector_tpu_torch.utils import timer


def _operands(*shapes):
    g = torch.Generator().manual_seed(sum(map(sum, shapes)))
    return [torch.randn(s, generator=g) for s in shapes]


ATTN_SEQS = ta.Sequences.spatial(2, 3, 2)
# name -> (operand shapes, the entry point, its plain version, the op)
ENTRIES = {
    "matmul": (
        ((6, 8), (8, 5), (5,)),
        lambda x, w, b: k1.matmul(x, w, b, fuse_relu=True),
        lambda x, w, b: k1.matmul_plain(x, w, b, fuse_relu=True),
        "vvtpu.k1_matmul"),
    "conv2d_gemm_nhwc": (
        ((2, 7, 7, 4), (3, 3, 2, 8), (8,)),
        lambda x, w, b: k2.conv2d_gemm_nhwc(x, w, b, stride=(2, 2),
                                            pad=(1, 1), groups=2,
                                            fuse_relu=True),
        lambda x, w, b: k2.conv2d_gemm_nhwc_plain(x, w, b, stride=(2, 2),
                                                  pad=(1, 1), groups=2,
                                                  fuse_relu=True),
        "vvtpu.k2_conv2d_nhwc"),
    # NCHW and OIHW views of NHWC and HWIO storage, the layouts K2 reads
    # (a CUDA FakeTensor cannot be copied into them here)
    "conv2d_nchw": (
        ((2, 7, 7, 4), (3, 3, 2, 8), (8,)),
        lambda x, w, b: k2.conv2d_nchw(
            x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, stride=(2, 2),
            pad=(1, 1), groups=2),
        lambda x, w, b: k2._conv_plain(
            x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, (2, 2), (1, 1),
            2, False, torch.float32),
        "vvtpu.k2_conv2d_nhwc"),
    "space_to_depth": (
        ((2, 11, 11, 3), (5, 5, 3, 8)),
        lambda x, w: k2.space_to_depth(x, w, 2, 1),
        lambda x, w: k2.space_to_depth_plain(x, w, 2, 1),
        None),
    "max_pool_nhwc": (
        ((2, 9, 9, 5),),
        lambda x: pooling.max_pool(x, kernel=(3, 3), stride=(2, 2),
                                   pad=(1, 1), layout="NHWC"),
        lambda x: pooling.max_pool_nhwc_plain(x, (3, 3), (2, 2), (1, 1)),
        "vvtpu.max_pool_nhwc"),
    "matmul_gelu": (
        ((6, 8), (8, 5), (5,)),
        lambda x, w, b: k1.matmul(x, w, b, fuse_gelu=True),
        lambda x, w, b: k1.matmul_plain(x, w, b, fuse_gelu=True),
        "vvtpu.k1_matmul"),
    # two clips of 3 patches x 2 frames, their class rows, two heads of 4
    "attention": (
        ((14, 24),),
        lambda qkv: ta.attention(qkv, 2, ATTN_SEQS),
        lambda qkv: ta.attention_plain(qkv, 2, ATTN_SEQS, 0.5),
        "vvtpu.attention"),
}
# what each entry point counts on the CPU: the calls it counts on any
# device, and the attention's plain version's gather of its 4 sequences of
# 4 rows of q, k and v and scatter of their 12 token rows (8 f32 a row)
CALLS = {"max_pool_nhwc": {"vvtpu.max_pool.calls": 1},
         "attention": {"vvtpu.attn.calls": 1,
                       "vvtpu.attn.layout_bytes": (48 + 12) * 8 * 4}}
NAMES = list(ENTRIES)


def _tensors(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", NAMES)
def test_cpu_tensors_give_the_plain_versions_bits_and_no_launch(name):
    shapes, entry, plain, _ = ENTRIES[name]
    ops = _operands(*shapes)
    with timer.tally() as counts:
        got = entry(*ops)
    for g, w in zip(_tensors(got), _tensors(plain(*ops))):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert not [k for k in counts if k.endswith("launches")], counts
    assert counts == CALLS.get(name, {})


@pytest.mark.parametrize("name", NAMES)
def test_meta_tensors_give_the_outputs_shape(name):
    shapes, entry, plain, _ = ENTRIES[name]
    want = _tensors(plain(*_operands(*shapes)))
    got = _tensors(entry(*[torch.empty(s, device="meta") for s in shapes]))
    assert [(t.shape, t.device.type) for t in got] == \
        [(t.shape, "meta") for t in want]


@pytest.mark.parametrize("name", NAMES)
def test_another_device_raises(name):
    shapes, entry, _, _ = ENTRIES[name]
    with FakeTensorMode():
        ops = [torch.empty(s, device="mps") for s in shapes]
        with pytest.raises(ValueError, match="not on mps"):
            entry(*ops)


class _OpLog(TorchDispatchMode):
    """The names of the ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


# the plain function each entry point's plain branch calls
PLAIN = {"matmul": (k1, "matmul_plain"),
         "matmul_gelu": (k1, "matmul_plain"),
         "attention": (ta, "attention_plain"),
         "conv2d_gemm_nhwc": (k2, "conv2d_gemm_nhwc_plain"),
         "conv2d_nchw": (k2, "_conv_plain"),
         "space_to_depth": (k2, "space_to_depth_plain"),
         "max_pool_nhwc": (pooling, "max_pool_nhwc_plain")}


class _Took(Exception):
    """Raised by a stand-in to say which path an entry point took."""


def _path(name, monkeypatch) -> str:
    """Runs the entry point on CUDA FakeTensors: "kernel" where it reached
    the kernel's path (its custom op; for the repack, `_space_to_depth`),
    "plain" where it called its plain version."""
    shapes, entry, _, op = ENTRIES[name]

    def took(path):
        def stand_in(*args, **kwargs):
            raise _Took(path)
        return stand_in
    monkeypatch.setattr(*PLAIN[name], took("plain"))
    monkeypatch.setattr(k2, "_space_to_depth", took("kernel"))
    with FakeTensorMode():
        ops = [torch.empty(s, device="cuda") for s in shapes]
        with _OpLog() as log:
            try:
                entry(*ops)
            except _Took as e:
                return str(e)
    assert any(op in n for n in log.names), log.names
    return "kernel"


@pytest.mark.parametrize("name", NAMES)
def test_plain_versions_nests_and_is_restored_after_an_exception(
        name, monkeypatch):
    assert _path(name, monkeypatch) == "kernel"
    with device.plain_versions():
        assert _path(name, monkeypatch) == "plain"
        with device.plain_versions():
            assert _path(name, monkeypatch) == "plain"
        assert _path(name, monkeypatch) == "plain"
    with pytest.raises(RuntimeError, match="planted"):
        with device.plain_versions():
            raise RuntimeError("planted")
    assert _path(name, monkeypatch) == "kernel"


@pytest.mark.parametrize("entry, bad, error", [
    (lambda x, w: k1.matmul(x, w), (8, 4), None),
    (lambda x, w: k1.matmul(x, w), (7, 4), ValueError),
    (lambda x, w: k1.matmul(x, w.bfloat16()), (8, 4), TypeError),
    (lambda x, w: k2.conv2d_gemm_nhwc(x.reshape(1, 2, 2, 8),
                                      w.reshape(1, 1, 8, 4)), (8, 4), None),
    (lambda x, w: k2.conv2d_gemm_nhwc(x.reshape(1, 2, 2, 8),
                                      w.reshape(1, 1, 4, 6)), (4, 6),
     ValueError),
    (lambda x, w: k2.conv2d_gemm_nhwc(x.reshape(1, 2, 2, 8),
                                      w.reshape(1, 1, 8, 4).bfloat16()),
     (8, 4), TypeError),
])
def test_the_ops_fake_implementations_check_the_operands(entry, bad, error):
    """On CUDA FakeTensors (as torch.export traces a card's program) the
    custom ops' fake implementations refuse what their real ones refuse."""
    with FakeTensorMode():
        x = torch.empty((4, 8), device="cuda")
        w = torch.empty(bad, device="cuda")
        if error is None:
            entry(x, w)
        else:
            with pytest.raises(error):
                entry(x, w)
