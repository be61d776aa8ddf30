"""Runs the port's parallel cases as gloo ranks on the CPU, for the
tests/test_torch_parallel_*.py files. It imports no JAX: the test files
compute JAX's side in the pytest process and hand the ranks numpy inputs.

`run(world, cases, tmp)` starts `world` processes of this module (one rank
each, a file:// rendezvous in `tmp`), each running every (function name,
kwargs) case of `cases` in order, and returns [rank 0's results, rank 1's,
...], one list of case results each. Every rank's case must reach the same
collectives. A rank that fails, or a launch that outlives `timeout`, kills
every rank and raises with the ranks' output.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def run(world: int, cases: list, tmp, *, timeout: float = 120) -> list:
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    case_file = os.path.join(tmp, f"cases_{world}.pkl")
    with open(case_file, "wb") as f:
        pickle.dump(cases, f)
    rdzv = os.path.join(tmp, f"rdzv_{world}")
    if os.path.exists(rdzv):
        os.remove(rdzv)
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, HERE] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    procs, outs, logs = [], [], []
    try:
        for rank in range(world):
            out = os.path.join(tmp, f"out_{world}_{rank}.pkl")
            log = os.path.join(tmp, f"log_{world}_{rank}.txt")
            outs.append(out)
            logs.append(log)
            with open(log, "w") as lf:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "torch_parallel_cases", str(rank),
                     str(world), rdzv, case_file, out, str(timeout)],
                    env=env, cwd=tmp, stdout=lf, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break   # a rank failed: the others may wait forever
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.poll() != 0]
        if bad:
            text = "\n".join(f"--- rank {r} ---\n" + open(logs[r]).read()[-6000:]
                             for r in range(world))
            raise AssertionError(f"ranks {bad} failed or timed out "
                                 f"({timeout} s):\n{text}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for out in outs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


def _main(argv) -> int:
    rank, world = int(argv[0]), int(argv[1])
    rdzv, case_file, out = argv[2], argv[3], argv[4]
    timeout = float(argv[5])
    import datetime
    import faulthandler

    # a rank stuck in a collective prints its stack before run() kills it
    faulthandler.dump_traceback_later(max(timeout - 5, 1), exit=True)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + rdzv, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    import torch_parallel_impl as impl
    with open(case_file, "rb") as f:
        cases = pickle.load(f)
    results = []
    try:
        for name, kwargs in cases:
            results.append(getattr(impl, name)(**kwargs))
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)   # no teardown: the other ranks are killed by run()
    with open(out, "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
