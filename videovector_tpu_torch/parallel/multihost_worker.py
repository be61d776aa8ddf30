"""Multi-process training worker: one rank of a multi-process launch;
counterpart of videovector_tpu/parallel/multihost_worker.py.

Each process joins the default process group (one process a device: NCCL
on cards, gloo on the CPU), builds the solver's net, feeds its slice of
the global batch through parallel.multihost.HostShardedSource, and runs
the sharded train step (parallel.train.make_train_step): the gradient
all_reduce crosses the process boundary.

Run one worker a device:

  python -m videovector_tpu_torch.parallel.multihost_worker \\
      --solver solver.prototxt --coordinator file:///tmp/rdzv \\
      --num_processes 2 --process_id $I --iters 3 --out losses_$I.json

(`--coordinator` is init_process_group's init_method: a file:// path all
ranks see, or tcp://host:port.) With --simulate (the test rig), every
process runs the identical data stream and cuts its host_shard_range rows,
so the multi-process trajectory must equal a --num_processes 1 run.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys

import torch
import torch.distributed as dist

from videovector_tpu_torch.core.seeds import iteration_seed
from videovector_tpu_torch.device import DEFAULT
from videovector_tpu_torch.parallel.mesh import make_mesh
from videovector_tpu_torch.parallel.multihost import (
    HostShardedSource, replicate_global,
)
from videovector_tpu_torch.parallel.train import make_train_step
from videovector_tpu_torch.solver.driver import SolverDriver
from videovector_tpu_torch.solver.solvers import init_solver_state


def run_worker(solver_path: str, *, process_id: int, num_processes: int,
               coordinator: str, iters: int = 3, simulate: bool = True,
               device=DEFAULT, timeout: float = 900) -> list[float]:
    """Train the solver's net `iters` steps over all processes' devices
    (device "cuda", the default, or "cpu"); returns the per-iteration loss
    list (the same on every process: the metrics are replicated)."""
    if num_processes > 1 or coordinator:
        dist.init_process_group(
            "nccl" if torch.device(device).type == "cuda" else "gloo",
            init_method=coordinator or None, rank=process_id,
            world_size=num_processes,
            timeout=datetime.timedelta(seconds=timeout))
    try:
        driver = SolverDriver.from_prototxt(solver_path,
                                            device=device).build()
        return worker_losses(driver, driver.params, iters,
                             simulate=simulate)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def worker_losses(driver, params, iters: int, *,
                  simulate: bool = True) -> list[float]:
    """run_worker's steps on a built SolverDriver from `params`, over every
    rank of the default process group (started here for one rank): `iters`
    sharded train steps on the driver's train stream, each rank its
    host_shard_range rows; the loss list."""
    mesh = make_mesh(devices=driver.device)
    net = driver.train_net
    cfg = driver.cfg

    def loss_fn(p, batch, generator):
        loss, outputs = net.apply(p, batch, generator=generator)
        return loss, {k: v.reshape(-1) for k, v in outputs.items()}

    params = replicate_global(params, mesh)
    state = init_solver_state(cfg, params)
    # every process runs the same deterministic sampler stream; with
    # simulate=True the wrapper cuts this rank's rows
    src = HostShardedSource(driver.train_source, mesh, simulate=simulate)
    it_src = iter(src)
    step = make_train_step(loss_fn, cfg, mesh, lr_mults=driver.lr_mults,
                           decay_mults=driver.decay_mults, donate=False,
                           batch_axes=src.batch_axes() or None)
    seed = cfg.random_seed if cfg.random_seed >= 0 else 0
    generator = torch.Generator(device=driver.device)
    losses = []
    for it in range(iters):
        batch = next(it_src)
        generator.manual_seed(iteration_seed(seed, it))
        params, state, metrics = step(params, state, batch, generator)
        losses.append(float(metrics["loss"].reshape(-1)[0]))
    return losses


def launch_workers(solver_path: str, out_dir: str, num_processes: int,
                   devices_per_proc: int, *, iters: int = 3, cwd=None,
                   timeout: int = 900,
                   device=DEFAULT) -> list[list[float]]:
    """Launch `num_processes` workers as subprocesses (one device each: the
    card, the default, or the CPU for device "cpu") and return their JSON
    loss lists in process order.

    The ranks meet through a file:// rendezvous in `out_dir` (no port is
    taken, so concurrent launches cannot collide); each worker's output
    goes to `worker_p{N}_{i}.log` there. On a timeout, or when a worker
    fails, every sibling is killed: no orphan waits in a collective."""
    if devices_per_proc != 1:
        raise ValueError(
            f"devices_per_proc={devices_per_proc}: the port runs one process "
            "a device (ranks are processes), so devices_per_proc must be 1; "
            "ask for more processes instead")
    rdzv = os.path.abspath(os.path.join(out_dir, f"rdzv_p{num_processes}"))
    if os.path.exists(rdzv):
        os.remove(rdzv)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, outs, logs = [], [], []
    try:
        for pid in range(num_processes):
            out = os.path.join(out_dir, f"losses_p{num_processes}_{pid}.json")
            outs.append(out)
            log_path = os.path.join(out_dir,
                                    f"worker_p{num_processes}_{pid}.log")
            logs.append(log_path)
            cmd = [sys.executable, "-m",
                   "videovector_tpu_torch.parallel.multihost_worker",
                   "--solver", solver_path, "--iters", str(iters),
                   "--simulate", "--num_processes", str(num_processes),
                   "--process_id", str(pid), "--out", out,
                   "--timeout", str(timeout)]
            if num_processes > 1:
                cmd += ["--coordinator", "file://" + rdzv]
            if torch.device(device).type == "cpu":
                cmd.append("--cpu")
            with open(log_path, "w") as lf:
                procs.append(subprocess.Popen(
                    cmd, env=env, cwd=cwd or os.getcwd(), stdout=lf,
                    stderr=subprocess.STDOUT))
        for p, log_path in zip(procs, logs):
            p.wait(timeout=timeout)
            if p.returncode != 0:
                with open(log_path) as f:
                    raise AssertionError(
                        f"multihost worker failed:\n{f.read()[-4000:]}")
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    results = []
    for o in outs:
        with open(o) as f:
            results.append(json.load(f))
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--solver", required=True)
    p.add_argument("--coordinator", default="",
                   help="init_process_group's init_method (file://... or "
                        "tcp://host:port)")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--simulate", action="store_true",
                   help="identical stream on every process, cut by "
                        "host_shard_range (the test rig)")
    p.add_argument("--out", default="",
                   help="write the loss list as JSON to this path")
    p.add_argument("--timeout", type=float, default=900,
                   help="seconds a collective may wait for the other ranks")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU over gloo (default: the card, NCCL)")
    args = p.parse_args(argv)
    losses = run_worker(args.solver, process_id=args.process_id,
                        num_processes=args.num_processes,
                        coordinator=args.coordinator, iters=args.iters,
                        simulate=args.simulate,
                        device="cpu" if args.cpu else DEFAULT,
                        timeout=args.timeout)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(losses, f)
    print(json.dumps({"process": args.process_id, "losses": losses}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
