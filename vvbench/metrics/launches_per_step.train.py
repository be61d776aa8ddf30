"""Kernels the device runs a training step, over the traced window's steps
(the test evals in it included), from the profiler's trace."""

SOURCE = "device_trace"
LAYER = "graph engine"
MOVES = "train_triplets_per_s"


def read(reading):
    t = reading.trace
    if t is None or not t.device_ops:
        return None
    return t.kernels() / t.counts["steps"]
