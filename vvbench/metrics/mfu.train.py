"""The training window's model FLOPs at the f32 peak (the prototxt's type):
each step's tower forward and weight gradient, 4 (R B) D E, and each test
eval's TEST tower and distance product, over the window's wall time."""

from vvbench import flops

SOURCE = "host_clock"
LAYER = "whole step"
MOVES = "train_triplets_per_s"


def read(reading):
    w, cfg = reading.window, reading.config
    if not w.get("wall_s"):
        return None
    ops = (w["steps"] * flops.train_step_ops(cfg)
           + w["evals"] * flops.test_eval_ops(cfg))
    return 100.0 * ops / (flops.PEAK_F32 * w["wall_s"])
