"""The max pools' share of their roofline in the I3D query: the 13 pools'
least time at the query's clips (each input read once and each output
written once, in the compute dtype, at HBM bandwidth: vvbench/flops_i3d.py)
over the device time of the port's pool kernels (`vv::pool::`, the NHWC
and the NDHWC ones), by kernel name."""

from vvbench import flops_i3d

SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "query_frames_per_s"
KERNELS = ("vv::pool::",)


def read(reading):
    t = reading.trace
    if t is None:
        return None
    busy, n = t.kernel_seconds(KERNELS)
    if n == 0 or busy <= 0:
        return None
    least = flops_i3d.pool_least_s(reading.layer["clips_per_query"],
                                   reading.config)
    return 100.0 * t.counts["queries"] * least / busy
