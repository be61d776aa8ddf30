"""Hand-written Hopper kernels (CUDA C++ in ../../csrc), with their plain
PyTorch versions beside them."""
