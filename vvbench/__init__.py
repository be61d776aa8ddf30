"""The benchmark of videovector_tpu_torch (see vvbench/README.md)."""
