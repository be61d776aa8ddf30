"""Tensor ops of the port. Plain PyTorch here; the hand-written Hopper
kernels are under ops/hopper/."""
