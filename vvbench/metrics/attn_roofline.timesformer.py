"""The attention kernel's share of its roofline in the TimeSformer query:
the 24 attention calls' least time at the query's clips (per call the
larger of operations at the bf16 peak and bytes at HBM bandwidth, q, k and
v read once and the output written once: vvbench/flops_timesformer.py,
0.83 ms a 96-frame clip, bound by bytes) over the device time of the
port's attention kernel (`vv::attn::`, both kinds), by kernel name. None
with no trace, or where no such kernel ran."""

from vvbench import flops_timesformer

SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "query_frames_per_s"
KERNELS = ("vv::attn::",)


def read(reading):
    t = reading.trace
    if t is None:
        return None
    busy, n = t.kernel_seconds(KERNELS)
    if n == 0 or busy <= 0:
        return None
    least = flops_timesformer.attn_least_s(reading.layer["clips_per_query"],
                                           reading.config)
    return 100.0 * t.counts["queries"] * least / busy
