"""videovector_tpu_torch: the PyTorch + CUDA (H100) port of videovector_tpu.

Module paths mirror the JAX package's, so each counterpart is easy to find.
The JAX package is the reference; this package imports torch and never jax.
Hand-written Hopper kernels live in csrc/ and are bound in ops/hopper/.
"""
