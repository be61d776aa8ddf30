"""Seed derivation shared by the training loop and the layers that draw."""

from __future__ import annotations

_MASK64 = (1 << 64) - 1


# the stream tag of the on-device negative sampler's draws
# (solver/driver.py)
SAMPLER_STREAM = 0x5A4D504C


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def derived_seed(seed: int, stream: int) -> int:
    """The seed of another stream drawn beside the one seeded by `seed` (a
    64-bit generator seed): SplitMix64 of seed XOR (stream << 32). The two
    streams' draws are then unrelated, and the derived one depends on
    `seed` alone."""
    return _splitmix64((seed ^ ((stream & 0xFFFFFFFF) << 32)) & _MASK64)


def iteration_seed(seed: int, it: int) -> int:
    """The dropout generator's seed for iteration `it`: SplitMix64 of
    seed << 32 | it (both as 32-bit words). Each iteration's masks then
    depend on (seed, it) alone, as JAX's fold_in(PRNGKey(seed), it) does,
    so a run resumed at iteration N draws iteration N's masks."""
    return _splitmix64(((seed & 0xFFFFFFFF) << 32) | (it & 0xFFFFFFFF))
