"""Host time a training step inside the program's span `vvtpu.train.step`
(the forward, the backward and the solver's update: what a captured step
would replace), over the traced steps."""

SOURCE = "program_span"
LAYER = "graph engine"
MOVES = "train_triplets_per_s"


def read(reading):
    from videovector_tpu_torch.utils import timer
    recorded = getattr(timer, "recorded", None)
    if recorded is None or reading.trace is None:
        return None
    steps = [s for s in recorded().spans
             if s.name == "vvtpu.train.step" and s.end_ns is not None]
    if not steps:
        return None
    return (sum(s.end_ns - s.start_ns for s in steps) / 1e6
            / reading.trace.counts["steps"])
