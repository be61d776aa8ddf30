"""Host time a query inside the port's kernel wrappers: the program's spans
`vvtpu.k1`, `vvtpu.k2` and `vvtpu.s2d` (each custom op's real
implementation, its planning and its ctypes call), over the traced
queries. A span inside another of the three (conv1's repack runs inside
its K2 call) counts once."""

SOURCE = "program_span"
LAYER = "kernels"
MOVES = "query_frames_per_s"
SPANS = ("vvtpu.k1", "vvtpu.k2", "vvtpu.s2d")


def read(reading):
    from videovector_tpu_torch.utils import timer
    recorded = getattr(timer, "recorded", None)
    if recorded is None or reading.trace is None:
        return None
    spans = recorded().spans
    total, n = 0, 0
    for s in spans:
        if s.name not in SPANS or s.end_ns is None:
            continue
        up = s.parent
        while up is not None and spans[up].name not in SPANS:
            up = spans[up].parent
        if up is None:
            total += s.end_ns - s.start_ns
            n += 1
    if n == 0:
        return None
    return total / 1e6 / reading.trace.counts["queries"]
