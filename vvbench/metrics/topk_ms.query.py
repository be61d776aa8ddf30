"""Device time a query of the top-k selection: the port's per-row top-k
kernels (`vv::topk::`, csrc/top_k_rows.cu's two stages), by kernel name,
over the traced queries. None with no trace, or where no such kernel ran
(the CPU, or a program whose top-k is a sort, which `gallery_ms.query`
reads)."""

SOURCE = "device_trace"
LAYER = "gallery scoring"
MOVES = "query_p95_ms"
KERNELS = ("vv::topk::",)


def read(reading):
    t = reading.trace
    if t is None:
        return None
    total, n = t.kernel_seconds(KERNELS)
    if n == 0:
        return None
    return 1e3 * total / t.counts["queries"]
