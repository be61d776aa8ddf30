"""The test evals' share of the traced training window: the host time
inside the program's spans `vvtpu.train.test` over the window's wall."""

SOURCE = "program_span"
LAYER = "test eval"
MOVES = "train_triplets_per_s"


def read(reading):
    from videovector_tpu_torch.utils import timer
    recorded = getattr(timer, "recorded", None)
    t = reading.trace
    if recorded is None or t is None or t.window_s <= 0:
        return None
    spans = recorded().spans
    if not spans:
        return None
    test_ns = sum(s.end_ns - s.start_ns for s in spans
                  if s.name == "vvtpu.train.test" and s.end_ns is not None)
    return 100.0 * test_ns / 1e9 / t.window_s
