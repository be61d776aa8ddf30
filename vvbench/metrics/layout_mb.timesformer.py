"""Megabytes a query that TimeSformer's divided blocks copy to lay out the
tokens of their attention's sequences apart from the qkv projection's
rows and back, per-frame class rows among them: the program's counter
`vvtpu.attn.layout_bytes` (ops/attention.py) over the traced queries, in
10^6 bytes (a replayed query adds what its capture counted). 0 where both
kinds read and write their tokens in place. None with no trace, or where
the program keeps no such counter."""

SOURCE = "program_counter"
LAYER = "divided attention"
MOVES = "query_frames_per_s"


def read(reading):
    from videovector_tpu_torch.utils import timer
    recorded = getattr(timer, "recorded", None)
    if recorded is None or reading.trace is None:
        return None
    counters = recorded().counters
    if "vvtpu.attn.layout_bytes" not in counters:
        return None
    return (counters["vvtpu.attn.layout_bytes"] / 1e6
            / reading.trace.counts["queries"])
