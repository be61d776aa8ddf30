"""K1's share of its roofline in training: the least time of the K1 work
in the traced window (the tower forward a step, the TEST tower an eval,
f32 operands at the f32 peak) over the device time of K1's launches
there, by kernel name (the f32 route's GEMM and its split-K reduce)."""

from vvbench import flops

SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "train_triplets_per_s"
KERNELS = ("vv::f32sm90::gemm_f32", "vv::sm90::splitk_reduce")


def read(reading):
    t = reading.trace
    if t is None:
        return None
    busy, n = t.kernel_seconds(KERNELS)
    if n == 0 or busy <= 0:
        return None
    least = flops.k1_train_least_s(reading.config, t.counts["steps"],
                                   t.counts["evals"])
    return 100.0 * least / busy
