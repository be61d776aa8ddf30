"""K1's share of its roofline in the TimeSformer query: the 86 GEMMs'
least time at the query's clips (the patch embedding, 7 a block, the
tower; per GEMM the larger of operations at the bf16 peak and bytes at HBM
bandwidth, each input, weight, bias and output counted once:
vvbench/flops_timesformer.py, 4.61 ms a 96-frame clip) over the device
time of K1's sm90 kernels (`vv::sm90::gemm_tma_wgmma`, its GELU twin, and
`vv::sm90::splitk_reduce`), by kernel name. None with no trace, or where
no such kernel ran."""

from vvbench import flops_timesformer

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
    least = flops_timesformer.k1_least_s(reading.layer["clips_per_query"],
                                         reading.config)
    return 100.0 * t.counts["queries"] * least / busy
