"""Parameter initializers ("fillers"); counterpart of
videovector_tpu/core/fillers.py.

Caffe-equivalent semantics (ref:include/caffe/filler.hpp:20-188):

- constant(value)
- uniform(min, max)
- gaussian(mean, std[, sparse]) — `sparse >= 0` keeps each weight with
  probability sparse/fan_out via a Bernoulli mask (non-zero expected count per
  output = sparse).
- positive_unitball — uniform [0,1), then each row (leading axis) scaled to
  sum to 1.
- xavier — uniform(-s, s) with s = sqrt(3 / fan_in), fan_in = count / shape[0]
  (Caffe's definition).

A filler is `fill(generator, shape, dtype=torch.float32) -> tensor` on the
generator's device, drawing from that explicit torch.Generator. Its numbers
differ from jax.random's for the same seed, so parity tests carry weights
across from JAX (convert.params_from_jax) instead of re-drawing them.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import numpy as np
import torch


def constant_fill(generator, shape, dtype=torch.float32, *, value=0.0):
    return torch.full(shape, float(value), dtype=dtype,
                      device=generator.device)


def uniform_fill(generator, shape, dtype=torch.float32, *, min=0.0, max=1.0):
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=dtype)
    return u * (max - min) + min


def gaussian_fill(generator, shape, dtype=torch.float32, *, mean=0.0, std=1.0,
                  sparse=-1):
    out = torch.randn(shape, generator=generator, device=generator.device,
                      dtype=dtype) * std + mean
    if sparse >= 0:
        # ref:include/caffe/filler.hpp gaussian sparsity: non-zero probability
        # = sparse / fan_out, fan_out = shape[0] for a (num_output, fan_in) blob.
        fan_out = shape[0] if len(shape) else 1
        p = min(1.0, float(sparse) / float(max(fan_out, 1)))
        mask = torch.rand(shape, generator=generator,
                          device=generator.device) < p
        out = out * mask.to(dtype)
    return out


def positive_unitball_fill(generator, shape, dtype=torch.float32):
    x = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=dtype)
    num = shape[0] if len(shape) else 1
    flat = x.reshape(num, -1)
    flat = flat / torch.sum(flat, dim=1, keepdim=True)
    return flat.reshape(shape)


def xavier_fill(generator, shape, dtype=torch.float32):
    count = int(np.prod(shape)) if len(shape) else 1
    num = shape[0] if len(shape) else 1
    fan_in = count // max(num, 1)
    scale = float(np.sqrt(3.0 / max(fan_in, 1)))
    return uniform_fill(generator, shape, dtype, min=-scale, max=scale)


_FILLERS = {
    "constant": constant_fill,
    "uniform": uniform_fill,
    "gaussian": gaussian_fill,
    "positive_unitball": positive_unitball_fill,
    "xavier": xavier_fill,
}


def get_filler(cfg: Any = None):
    """Build `fill(generator, shape, dtype)` from a FillerParameter-like
    config.

    `cfg` may be None (constant 0, Caffe's default), a `config.textformat.Message`,
    or a dict. ref:include/caffe/filler.hpp:175-188 (GetFiller factory).
    """
    kwargs: dict[str, Any] = {}
    if cfg is not None:
        for field in ("type", "value", "min", "max", "mean", "std", "sparse"):
            v = cfg.get(field, None)  # Message and dict share .get
            if v is not None:
                kwargs[field] = v
    ftype = kwargs.pop("type", "constant")
    if ftype not in _FILLERS:
        raise ValueError(f"Unknown filler type: {ftype!r}")
    fn = _FILLERS[ftype]
    if ftype in ("positive_unitball", "xavier"):
        kwargs = {}
    return partial(fn, **kwargs)
