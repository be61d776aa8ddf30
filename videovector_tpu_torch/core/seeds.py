"""Seed derivation shared by the training loop and the layers that draw."""

from __future__ import annotations

_MASK64 = (1 << 64) - 1


def iteration_seed(seed: int, it: int) -> int:
    """The dropout generator's seed for iteration `it`: SplitMix64 of
    seed << 32 | it (both as 32-bit words). Each iteration's masks then
    depend on (seed, it) alone, as JAX's fold_in(PRNGKey(seed), it) does,
    so a run resumed at iteration N draws iteration N's masks."""
    z = (((seed & 0xFFFFFFFF) << 32) | (it & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)
