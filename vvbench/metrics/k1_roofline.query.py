"""K1's share of its roofline in serving: fc6, fc7 and the tower at the
query's rows (bytes-bound: the bf16 weights) over the device time of K1's
sm90 route and its split-K reduce, by kernel name."""

from vvbench import flops

SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "query_frames_per_s"
KERNELS = ("vv::sm90::gemm_tma_wgmma", "vv::sm90::splitk_reduce")


def read(reading):
    t = reading.trace
    if t is None:
        return None
    busy, n = t.kernel_seconds(KERNELS)
    if n == 0 or busy <= 0:
        return None
    least = flops.k1_query_least_s(reading.layer["frames_per_query"],
                                   reading.config)
    return 100.0 * t.counts["queries"] * least / busy
