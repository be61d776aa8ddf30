"""Device time a query of the gallery scoring: the f32 score product
against the gallery (the only library GEMM on the query's path; cuBLAS
names it sm80_xmma_gemm_f32f32_...) and the stable sort behind the top-k
(cub's radix sort and torch's sort kernels around it), by kernel name, over
the traced queries. The port's own kernels (vv::) are left out."""

SOURCE = "device_trace"
LAYER = "gallery scoring"
MOVES = "query_p95_ms"
KERNELS = ("gemm", "RadixSort", "sort_postprocess", "fill_index_and_segment",
           "fill_reverse_indices")


def read(reading):
    t = reading.trace
    if t is None:
        return None
    total, n = 0.0, 0
    for name, sec in t.device_ops:
        if any(k in name for k in KERNELS) and "vv::" not in name:
            total += sec
            n += 1
    if n == 0:
        return None
    return 1e3 * total / t.counts["queries"]
