"""The port's prefetcher (videovector_tpu_torch/data/prefetch.py) and timer
(videovector_tpu_torch/utils/timer.py) on the CPU: the cases of the JAX
package's prefetch tests (tests/test_data.py, tests/test_trainer.py) and
SolverDriver's re-feed of its build batch. The card's path (pinned staging,
the side stream, the event wait) is in tests/test_torch_cuda_kernels.py.
"""

import itertools
import time

import numpy as np
import pytest
import torch

from videovector_tpu_torch.data.prefetch import DevicePrefetcher
from videovector_tpu_torch.solver.driver import SolverDriver
from videovector_tpu_torch.utils import timer


def _counting(n=None):
    for i in itertools.count() if n is None else range(n):
        yield {"x": np.full((2, 3), i, np.float32),
               "id": np.asarray([i], np.int64)}


def test_order_is_kept_and_batches_are_tensors():
    pf = DevicePrefetcher(_counting(7), depth=2, device="cpu")
    seen = []
    for b in pf:
        assert isinstance(b["x"], torch.Tensor) and b["x"].dtype == torch.float32
        assert b["id"].dtype == torch.int64
        seen.append(int(b["x"][0, 0]))
    assert seen == list(range(7))


def test_stop_iteration_repeats_and_close_ends_an_infinite_source():
    pf = DevicePrefetcher(iter([{"x": np.ones(2, np.float32)}]), depth=2,
                          device="cpu")
    assert float(next(pf)["x"].sum()) == 2.0
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(pf)    # must not block
    pf2 = DevicePrefetcher(_counting(), depth=2, device="cpu")
    assert int(next(pf2)["x"][0, 0]) == 0
    t0 = time.time()
    pf2.close()
    pf2._thread.join(timeout=5.0)
    assert not pf2._thread.is_alive(), "the worker did not end on close"
    assert time.time() - t0 < 5.0
    assert pf2._q.empty()
    with pytest.raises(StopIteration):
        next(pf2)
    pf2.close()     # idempotent


def test_source_errors_reach_the_consumer():
    def gen():
        yield {"x": np.zeros(2, np.float32)}
        raise RuntimeError("boom")
    pf = DevicePrefetcher(gen(), depth=2, device="cpu")
    next(pf)
    with pytest.raises(RuntimeError, match="boom"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)


def test_transform_runs_in_the_worker():
    import threading
    threads = []

    def tf(b):
        threads.append(threading.current_thread().name)
        return {"x": b["x"] * 2}
    pf = DevicePrefetcher(_counting(3), depth=1, device="cpu", transform=tf)
    assert [float(b["x"][0, 0]) for b in pf] == [0.0, 2.0, 4.0]
    assert set(threads) == {"vvtpu-torch-prefetch"}


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        DevicePrefetcher(_counting(1))


class _Source:
    def __init__(self):
        self.gen = _counting()

    def next_batch(self):
        return next(self.gen)

    def __iter__(self):
        while True:
            yield self.next_batch()


def _driver_stub():
    d = SolverDriver.__new__(SolverDriver)
    d.device = torch.device("cpu")
    d._prefetchers = []
    return d


def test_data_iter_refeeds_the_first_batch_once():
    """_data_iter(first=): the batch build() drew for shapes comes first,
    then the source's next ones: no batch skipped, none repeated (a drift
    of one batch against JAX's sampling stream otherwise)."""
    d = _driver_stub()
    src = _Source()
    first = src.next_batch()
    it = d._data_iter(src, first=first)
    assert [int(next(it)["x"][0, 0]) for _ in range(5)] == [0, 1, 2, 3, 4]
    for pf in d._prefetchers:
        pf.close()


def test_data_iter_validates_before_the_transform():
    d = _driver_stub()
    order = []

    def check(b):
        order.append(("check", int(b["x"][0, 0])))
        if int(b["x"][0, 0]) == 2:
            raise ValueError("bad batch 2")

    def tf(b):
        order.append(("transform", int(b["x"][0, 0])))
        return b
    it = d._data_iter(_Source(), validators=[check], transform=tf)
    next(it), next(it)
    with pytest.raises(ValueError, match="bad batch 2"):
        next(it)
    assert order[:4] == [("check", 0), ("transform", 0), ("check", 1),
                         ("transform", 1)]
    for pf in d._prefetchers:
        pf.close()


def test_timer_and_step_timer_on_the_cpu():
    t = timer.Timer()
    assert t.stop() == 0.0 and t.calls == 0       # stop without start
    t.start()
    time.sleep(0.01)
    dt = t.stop(fence={"a": torch.ones(2), "b": [torch.zeros(1)]})
    assert 5.0 < dt < 1000.0 and t.calls == 1
    t.start()
    t.stop()
    assert t.calls == 2 and t.average_ms == pytest.approx(t.total_ms / 2)
    st = timer.StepTimer(window=3)
    assert st.steps_per_sec == 0.0
    for _ in range(5):
        st.tick()
        time.sleep(0.005)
    assert len(st._marks) == 3 and 0 < st.steps_per_sec < 1000


def test_device_fence_and_trace_on_the_cpu(tmp_path):
    timer.device_fence({"a": [torch.ones(3)], "b": (torch.zeros(1),)})
    with timer.trace(str(tmp_path)):
        torch.ones(8).sum()
    assert any(p.name.endswith(".json") for p in tmp_path.iterdir())
