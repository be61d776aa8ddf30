"""The golden fixtures through the port's Net, shared by the CPU test
(tests/test_torch_golden.py) and the card test
(tests/test_torch_cuda_kernels.py). Imports no JAX, so that the card's
machine, which has none, can run it.

- tests/golden/: a narrow CaffeNet (net.prototxt, weights.caffemodel,
  input.blob) and every activation dumped by torch (acts/*.blob), held at
  1e-5 as tests/test_golden_parity.py holds JAX.
- tests/golden_fullscale.npz: the CaffeNet extraction tower at full width
  (227 x 227, batch 2) against torch-computed activations, the weights made
  again from their seed by scripts/gen_golden_fullscale.py, held at
  nrm_err 2e-5 and rel_big 1e-3 per blob as tests/test_golden_fullscale.py
  holds JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from videovector_tpu_torch.config import parse, parse_file
from videovector_tpu_torch.data.weights import (
    LayerBlobs, NetWeights, load_into_params,
)
from videovector_tpu_torch.data.wire import BlobProto
from videovector_tpu_torch.graph import Net

HERE = Path(__file__).resolve().parent
GOLDEN = HERE / "golden"
FIXTURE = HERE / "golden_fullscale.npz"
sys.path.insert(0, str(HERE.parent / "scripts"))

# tests/test_golden_fullscale.py's net, blobs and bounds (a test asserts
# that this copy equals it)
BLOBS = ("conv1", "pool1", "norm1", "conv2", "pool2", "norm2",
         "conv3", "conv4", "conv5", "pool5", "fc6", "ip1_nonorm", "ip2")
NRM_BOUND = 2e-5
REL_BOUND = 1e-3

EXTRACTION_NET = """\
name: "med_c5_fullscale"
layers { name: "data" type: MEMORY_DATA top: "data" }
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  convolution_param { num_output: 96 kernel_size: 11 stride: 4 } }
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers { name: "pool1" type: POOLING bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layers { name: "norm1" type: LRN bottom: "pool1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layers { name: "conv2" type: CONVOLUTION bottom: "norm1" top: "conv2"
  convolution_param { num_output: 256 pad: 2 kernel_size: 5 group: 2 } }
layers { name: "relu2" type: RELU bottom: "conv2" top: "conv2" }
layers { name: "pool2" type: POOLING bottom: "conv2" top: "pool2"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layers { name: "norm2" type: LRN bottom: "pool2" top: "norm2"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layers { name: "conv3" type: CONVOLUTION bottom: "norm2" top: "conv3"
  convolution_param { num_output: 384 pad: 1 kernel_size: 3 } }
layers { name: "relu3" type: RELU bottom: "conv3" top: "conv3" }
layers { name: "conv4" type: CONVOLUTION bottom: "conv3" top: "conv4"
  convolution_param { num_output: 384 pad: 1 kernel_size: 3 group: 2 } }
layers { name: "relu4" type: RELU bottom: "conv4" top: "conv4" }
layers { name: "conv5" type: CONVOLUTION bottom: "conv4" top: "conv5"
  convolution_param { num_output: 256 pad: 1 kernel_size: 3 group: 2 } }
layers { name: "relu5" type: RELU bottom: "conv5" top: "conv5" }
layers { name: "pool5" type: POOLING bottom: "conv5" top: "pool5"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layers { name: "fc6" type: INNER_PRODUCT bottom: "pool5" top: "fc6"
  inner_product_param { num_output: 4096 } }
layers { name: "relu6" type: RELU bottom: "fc6" top: "fc6" }
layers { name: "fc7" type: INNER_PRODUCT bottom: "fc6" top: "ip1_nonorm"
  inner_product_param { num_output: 4096 } }
layers { name: "fc7_relu" type: RELU bottom: "ip1_nonorm" top: "ip2" }
"""


def _read_blob(path) -> np.ndarray:
    return BlobProto.decode(Path(path).read_bytes()).to_array()


def _forward(net: Net, params: dict, x: np.ndarray, dev) -> dict:
    with torch.no_grad():
        _, blobs = net.apply(params, {"data": torch.as_tensor(x, device=dev)},
                             return_blobs=True)
    return {k: v.cpu().numpy() for k, v in blobs.items()}


def mini_golden(dev="cpu") -> tuple[dict, dict]:
    """(the Net's blobs, Caffe-shaped (N, C, 1, 1) where 2-D; the dumped
    activations) on tests/golden/."""
    net = Net(parse_file(str(GOLDEN / "net.prototxt")), "TEST")
    x = _read_blob(GOLDEN / "input.blob")
    params, _ = net.init(torch.Generator(device=dev).manual_seed(0),
                         {"data": x})
    params = load_into_params(
        NetWeights.load(str(GOLDEN / "weights.caffemodel")), params)
    blobs = _forward(net, params, x, dev)
    golden = {p.stem: _read_blob(p) for p in (GOLDEN / "acts").glob("*.blob")}
    return ({k: v[:, :, None, None] if v.ndim == 2 else v
             for k, v in blobs.items() if k in golden}, golden)


def fullscale_blobs(dev="cpu") -> dict:
    """The extraction tower's blobs at full width on `dev`, with the
    fixture's weights (seed-derived; their checksums are checked against
    the fixture's)."""
    from gen_golden_fullscale import make_weights
    fixture = np.load(FIXTURE)
    w = {k: v.numpy() for k, v in make_weights().items()}
    for name, arr in w.items():
        got, want = float(arr.astype(np.float64).sum()), float(
            fixture[f"wsum:{name}"])
        assert abs(got - want) < 1e-6 * max(1.0, abs(want)), name
    x = fixture["input"]
    net = Net(parse(EXTRACTION_NET), "TEST")
    params, _ = net.init(torch.Generator(device=dev).manual_seed(0),
                         {"data": x})
    layers = [LayerBlobs(name=n, blobs=[BlobProto.from_array(w[f"{n}.w"]),
                                        BlobProto.from_array(w[f"{n}.b"])])
              for n in ("conv1", "conv2", "conv3", "conv4", "conv5", "fc6",
                        "fc7")]
    params = load_into_params(NetWeights(name="fullscale", layers=layers),
                              params)
    return _forward(net, params, x, dev)


def fullscale_errors(blobs: dict) -> dict:
    """{blob: (nrm_err, rel_big)}: max|a - g| / rms(g), and max|a - g| / |g|
    over |g| >= 1% rms, on the fixture's full or sampled values."""
    from gen_golden_fullscale import FULL_BLOBS, sample_indices
    fixture = np.load(FIXTURE)
    out = {}
    for name in BLOBS:
        shape = tuple(int(s) for s in fixture[f"shape:{name}"])
        flat = np.asarray(blobs[name], np.float32).reshape(-1)
        assert flat.size == int(np.prod(shape)), name
        if name in FULL_BLOBS:
            golden, mine = fixture[f"full:{name}"].reshape(-1), flat
        else:
            golden, mine = fixture[f"samp:{name}"], flat[sample_indices(shape)]
        rms = float(np.sqrt(fixture[f"sumsq:{name}"] / np.prod(shape)))
        d = np.abs(mine - golden)
        big = np.abs(golden) >= 0.01 * rms
        out[name] = (float(d.max()) / max(rms, 1e-12),
                     float((d[big] / np.abs(golden[big])).max())
                     if big.any() else 0.0)
    return out


def assert_fullscale_within_bounds(errors: dict) -> None:
    bad = {k: v for k, v in errors.items()
           if v[0] > NRM_BOUND or v[1] > REL_BOUND}
    assert not bad, bad
