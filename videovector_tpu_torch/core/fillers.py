"""Parameter initializers; counterpart of videovector_tpu/core/fillers.py
(gaussian only, what the serving slice initializes with).

Random numbers come from an explicit torch.Generator. They differ from
jax.random's for the same seed, so parity tests carry weights across from
JAX (convert.params_from_jax) instead of re-drawing them.
"""

from __future__ import annotations

import torch


def gaussian_fill(generator: torch.Generator, shape, *, mean=0.0, std=1.0):
    """mean + std * N(0, 1) in f32, on the generator's device (the JAX
    filler's `sparse` option is not used by the serving slice)."""
    return torch.randn(shape, generator=generator,
                       device=generator.device) * std + mean
