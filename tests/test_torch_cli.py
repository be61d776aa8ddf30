"""The port's CLI (videovector_tpu_torch/tools/cli.py) on the CPU, against
the JAX package's `vvtpu` where both run.

The mini project of tests/test_torch_driver.py (feature 24, embed 16, B = 8
windows of 1 + 4 + 3 roles, 12-window test batches). `test`'s means agree
with JAX's CLI on the same .vvmodel within 1e-5 relative; every other case
checks the port's own behaviour: the subcommands and their lines, the
deprecated shims, the reference's refusals, crash-restart and auto-resume,
the device flags (no --cpu and no card raises).
"""

import io
import logging
import subprocess
import sys
import textwrap
import unittest.mock as mock
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_driver import Lines, write_mini_project
from videovector_tpu_torch.config.textformat import parse
from videovector_tpu_torch.graph.layers import DATA_LAYER_TYPES
from videovector_tpu_torch.solver.driver import SolverDriver
from videovector_tpu_torch.tools import cli
from videovector_tpu_torch.tools.cli import main

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def mini(tmp_path):
    return write_mini_project(tmp_path)


def _solver_file(mini, name="solver2.prototxt", **fields) -> str:
    """The mini solver with `fields` replaced (a line each)."""
    lines = [l for l in Path(mini["solver"]).read_text().splitlines()
             if l.split(":")[0].strip() not in fields]
    for k, v in fields.items():
        lines.append(f'{k}: {v}')
    path = mini["tmp"] / name
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_train_test_time_device_query(mini):
    with Lines() as out:
        assert main(["train", "--solver", mini["solver"], "--cpu"]) == 0
    assert out.lines[-1] == "Optimization Done."
    assert "Solving" in out.lines
    # snapshot_after_train wrote the final model
    snap = str(mini["tmp"] / "snap_iter_10.vvmodel")
    assert Path(snap).exists()
    with Lines() as out:
        assert main(["test", "--model", mini["net"], "--weights", snap,
                     "--iterations", "2", "--cpu"]) == 0
    assert sum(l.startswith("Batch 1, map = ") for l in out.lines) == 1
    assert any(l.startswith("Loss: ") for l in out.lines)
    assert any(l.startswith("map = ") for l in out.lines)
    with Lines() as out:
        assert main(["time", "--model", mini["net"], "--iterations", "2",
                     "--cpu"]) == 0
    assert out.lines[-1] == "*** Benchmark ends ***"
    with Lines() as out:
        assert main(["device_query", "--cpu"]) == 0
    assert out.lines[:2] == ["Device: cpu", "  platform: cpu"]


def _record_args(lines, fmt):
    return {r.args[0]: float(r.args[1]) for r in lines.records
            if r.msg == fmt}


def test_test_means_equal_jax_cli(mini):
    """`test` on the same .vvmodel and test store: the per-output means
    within 1e-5 relative of JAX's `vvtpu test` (the unrounded values the
    two log), the loss too."""
    from videovector_tpu.tools.cli import main as jmain
    assert main(["train", "--solver", mini["solver"], "--cpu"]) == 0
    snap = str(mini["tmp"] / "snap_iter_10.vvmodel")
    argv = ["test", "--model", mini["net"], "--weights", snap,
            "--iterations", "3"]
    with Lines() as tout:
        assert main(argv + ["--cpu"]) == 0
    with Lines("videovector_tpu") as jout:
        assert jmain(argv + ["--cpu"]) == 0
    tmeans = _record_args(tout, "%s = %g%s")
    jmeans = _record_args(jout, "%s = %g%s")
    assert sorted(tmeans) == sorted(jmeans) == ["hit1", "hit5", "map"]
    for k in tmeans:
        np.testing.assert_allclose(tmeans[k], jmeans[k], rtol=1e-5,
                                   err_msg=k)
    tb = [r.args for r in tout.records if r.msg == "Batch %d, %s = %g"]
    jb = [r.args for r in jout.records if r.msg == "Batch %d, %s = %g"]
    assert [a[:2] for a in tb] == [a[:2] for a in jb] and len(tb) == 9
    np.testing.assert_allclose([a[2] for a in tb], [a[2] for a in jb],
                               rtol=1e-5)


def test_train_trajectory_equals_jax_cli(mini):
    """`train --weights` from one .vvmodel (JAX's initial params) through
    both CLIs: the 10 displayed losses within 1e-5 relative, the test
    outputs within 2e-5."""
    import jax

    from videovector_tpu.solver.driver import SolverDriver as JDriver
    from videovector_tpu.tools.cli import main as jmain
    from videovector_tpu_torch.solver.checkpoint import snapshot
    init = snapshot(str(mini["tmp"] / "init"), 0, jax.tree.map(
        np.asarray, JDriver.from_prototxt(mini["solver"]).build().params))[0]
    argv = ["train", "--solver", mini["solver"], "--weights", init, "--cpu"]
    with Lines() as tout:
        assert main(argv) == 0
    with Lines("videovector_tpu") as jout:
        assert jmain(argv) == 0

    def numbers(out, fmt):
        return [(r.args[0], float(r.args[1]))
                for r in out.records if r.msg == fmt]
    tl = numbers(tout, "Iteration %d, loss = %g")
    jl = numbers(jout, "Iteration %d, loss = %g")
    assert [i for i, _ in tl] == [i for i, _ in jl] == list(range(11))
    np.testing.assert_allclose([v for _, v in tl], [v for _, v in jl],
                               rtol=1e-5)
    fmt = "    Test net output #%d: %s = %g%s"
    tt = [r.args[1:3] for r in tout.records if r.msg == fmt]
    jt = [r.args[1:3] for r in jout.records if r.msg == fmt]
    assert [k for k, _ in tt] == [k for k, _ in jt] and len(tt) == 9
    np.testing.assert_allclose([float(v) for _, v in tt],
                               [float(v) for _, v in jt], atol=2e-5)


def test_segmented_time_lines_cover_every_layer(mini):
    """One marginal line per compute layer of the TRAIN net, in net order,
    then the prefix sum and the whole forward-backward."""
    with Lines() as out:
        assert main(["time", "--model", mini["net"], "--iterations", "1",
                     "--cpu"]) == 0
    from videovector_tpu_torch.graph.net import Net
    net = Net(parse(Path(mini["net"]).read_text()), "TRAIN")
    names = [l.get("name") for l in net.layers
             if l.get("type") not in DATA_LAYER_TYPES]
    marg = [r.args[0] for r in out.records
            if r.msg == "%-24s %s (marginal): %.3f ms"]
    assert marg == names and len(names) == 21
    assert any(l.startswith("Total forward (prefix sum): ")
               for l in out.lines)
    assert any(l.startswith("Fused forward-backward: ") for l in out.lines)


@pytest.mark.parametrize("flags,want", [
    (["--backward"], "Total forward-backward (prefix sum): "),
    (["--per_layer", "isolated"], "Total per-layer forward: "),
    (["--per_layer", "isolated", "--backward"], "Total per-layer forward: "),
    (["--fused_only", "--memory"], "Memory (forward only): not reported"),
    (["--per_layer", "off"], "Fused forward-backward: "),
])
def test_time_modes(mini, flags, want):
    with Lines() as out:
        assert main(["time", "--model", mini["net"], "--iterations", "1",
                     "--cpu"] + flags) == 0
    assert any(l.startswith(want) for l in out.lines), out.lines
    if "--backward" in flags and "isolated" in flags:
        assert any("fc7" in l and "backward: " in l for l in out.lines)


def test_time_deploy_style_prototxt(tmp_path):
    """`time` on a deploy prototxt (input/input_dim, no data layers): the
    reference tool's canonical use; a loss-less net times the sum of its
    outputs."""
    net = tmp_path / "deploy.prototxt"
    net.write_text("""
name: "deploy"
input: "data"
input_dim: 4 input_dim: 1 input_dim: 8 input_dim: 8
layers { name: "ip" type: INNER_PRODUCT bottom: "data" top: "out"
  inner_product_param { num_output: 6 weight_filler { type: "xavier" } } }
layers { name: "relu" type: RELU bottom: "out" top: "out" }
""")
    with Lines() as out:
        assert main(["time", "--model", str(net), "--iterations", "2",
                     "--cpu", "--per_layer", "off", "--memory"]) == 0
    assert any("no loss layer" in l for l in out.lines)
    assert any(l.startswith("Memory (fused forward-backward): ")
               for l in out.lines)
    with Lines() as out:
        assert main(["net_speed_benchmark", str(net), "1", "--cpu"]) == 0
    assert any(l.startswith("ip ") and "forward (marginal)" in l
               for l in out.lines)


def test_deprecated_shims(mini):
    short = _solver_file(mini, max_iter=2, test_interval=2)
    assert main(["train_net", short, "--cpu"]) == 0
    snap = str(mini["tmp"] / "snap_iter_2.vvmodel")
    assert Path(snap).exists()
    with Lines() as out:
        assert main(["finetune_net", short, snap, "--cpu"]) == 0
    assert "Optimization Done." in out.lines
    with Lines() as out:
        assert main(["test_net", mini["net"], snap, "2", "--cpu"]) == 0
    assert any(l.startswith("Batch 1, hit1 = ") for l in out.lines)
    assert main(["train_net", short, str(mini["tmp"] /
                                         "snap_iter_2.vvstate"),
                 "--cpu"]) == 0


def test_refusals(mini, tmp_path):
    """The reference CLI's CHECKs: `test` without --weights (caffe.cpp:129)
    and `train` with both --snapshot and --weights (caffe.cpp:82-84)."""
    with pytest.raises(SystemExit, match="Need model weights"):
        main(["test", "--model", mini["net"], "--iterations", "1", "--cpu"])
    with pytest.raises(SystemExit, match="not both"):
        main(["train", "--solver", mini["solver"], "--cpu",
              "--snapshot", str(tmp_path / "x.vvstate"),
              "--weights", str(tmp_path / "y.vvmodel")])
    with Lines() as out:
        assert main(["test", "--model", mini["net"], "--iterations", "1",
                     "--cpu", "--allow_random_weights"]) == 0
    assert any(l.startswith("Batch 0, map = ") for l in out.lines)


@pytest.mark.parametrize("argv,item", [
    (["train", "--mesh", "4x1"], "item 11"),
    (["train", "--shard_gallery"], "item 11"),
    (["test", "--mesh", "2", "--allow_random_weights"], "item 11"),
])
def test_later_slices_raise_not_implemented(mini, argv, item):
    """Item 11 has come: --mesh runs over the process group's ranks
    (tests/test_torch_parallel_driver.py), so a mesh of more than one rank
    without a group says how to launch them, and --shard_gallery without
    --mesh is the driver's ValueError."""
    extra = (["--solver", mini["solver"]] if argv[0] == "train"
             else ["--model", mini["net"]])
    err, match = ((ValueError, "requires mesh") if "--shard_gallery" in argv
                  else (RuntimeError, "torch.distributed.run"))
    with pytest.raises(err, match=match):
        main(argv[:1] + extra + argv[1:] + ["--cpu"])


def test_train_over_a_one_rank_mesh_logs_the_losses_of_no_mesh(mini):
    """`train --mesh 1` starts its one-rank group itself (no launcher) and
    logs the run without --mesh's losses, line for line."""
    import torch.distributed as dist
    with Lines() as plain:
        assert main(["train", "--solver", _solver_file(
            mini, "plain.prototxt", snapshot_prefix=f'"{mini["tmp"]}/p"'),
            "--cpu"]) == 0
    try:
        with Lines() as meshed:
            assert main(["train", "--solver", _solver_file(
                mini, "mesh.prototxt",
                snapshot_prefix=f'"{mini["tmp"]}/m"'), "--mesh", "1",
                "--cpu"]) == 0
    finally:
        dist.destroy_process_group()
    assert "Training over mesh data=1 model=1" in meshed.lines
    assert _losses_from(meshed) == _losses_from(plain)


def _losses_from(out) -> list:
    return [(r.args[0], float(r.args[1])) for r in out.records
            if r.msg == "Iteration %d, loss = %g"]


@pytest.mark.parametrize("resume", ["solverstate"])
def test_train_resumes_from_a_solverstate(mini, resume):
    """`train --snapshot=<...>.solverstate` (once refused): a run with
    snapshot_format: "caffe" writes both pairs at iteration 4, and resuming
    from the .solverstate gives the .vvstate resume's losses bit for bit;
    the .caffemodel also serves `test --weights`."""
    solver = _solver_file(mini, max_iter=8, snapshot=4, test_interval=4,
                          display=1, snapshot_format='"caffe"')
    assert main(["train", "--solver", solver, "--cpu"]) == 0
    prefix = mini["tmp"] / "snap_iter_4"
    for ext in ("vvmodel", "vvstate", "caffemodel", resume):
        assert Path(f"{prefix}.{ext}").exists(), ext
    runs = {}
    for ext in ("vvstate", resume):
        with Lines() as out:
            assert main(["train", "--solver", solver, "--cpu",
                         "--snapshot", f"{prefix}.{ext}"]) == 0
        runs[ext] = _losses_from(out)
    assert [i for i, _ in runs[resume]] == [4, 5, 6, 7, 8]
    assert runs[resume] == runs["vvstate"]
    with Lines() as out:
        assert main(["test", "--model", mini["net"], "--weights",
                     f"{prefix}.caffemodel", "--iterations", "1",
                     "--cpu"]) == 0
    assert any(l.startswith("Batch 0, map = ") for l in out.lines)


def test_max_restarts_resumes_from_the_newest_snapshot(mini):
    """A fault mid-training reloads the newest snapshot and goes on to
    max_iter; an exhausted budget re-raises."""
    solver = _solver_file(mini, max_iter=12, snapshot=4, test_interval=0,
                          display=1)
    Path(solver).write_text("\n".join(
        l for l in Path(solver).read_text().splitlines()
        if not l.startswith("test_iter")) + "\n")
    calls = {"n": 0, "resumed": []}
    orig = SolverDriver.train

    def flaky(self, **kw):
        calls["n"] += 1
        calls["resumed"].append(kw.get("resume_state_path"))
        if calls["n"] == 1:
            orig(self, max_iter=10, **{k: v for k, v in kw.items()
                                       if k != "max_iter"})
            raise RuntimeError("injected device fault")
        return orig(self, **kw)

    with mock.patch.object(SolverDriver, "train", flaky), Lines() as out:
        assert main(["train", "--solver", solver, "--cpu",
                     "--max_restarts", "2"]) == 0
    assert calls["n"] == 2
    assert calls["resumed"][1].endswith("snap_iter_10.vvstate")
    assert any("restart 1/2 from" in l for l in out.lines)
    assert any(l.startswith("Restoring previous solver status from ")
               and "(iter 10)" in l for l in out.lines)
    assert (mini["tmp"] / "snap_iter_12.vvmodel").exists()

    calls["n"] = 0

    def always_fail(self, **kw):
        calls["n"] += 1
        raise RuntimeError("still broken")

    with mock.patch.object(SolverDriver, "train", always_fail):
        with pytest.raises(RuntimeError, match="still broken"):
            main(["train", "--solver", solver, "--cpu", "--max_restarts",
                  "2"])
    assert calls["n"] == 3  # the first try and 2 restarts


def test_auto_resume(mini):
    first = _solver_file(mini, max_iter=4, snapshot=2, test_interval=2)
    assert main(["train", "--solver", first, "--cpu", "--auto_resume"]) == 0
    assert (mini["tmp"] / "snap_iter_4.vvstate").exists()
    longer = _solver_file(mini, "solver3.prototxt", max_iter=6, snapshot=2,
                          test_interval=2)
    with Lines() as out:
        assert main(["train", "--solver", longer, "--cpu",
                     "--auto_resume"]) == 0
    assert any(l.startswith("Auto-resuming from ") and
               l.endswith("snap_iter_4.vvstate") for l in out.lines)
    its = [int(l.split(",")[0].split()[1]) for l in out.lines
           if l.startswith("Iteration ") and ", loss = " in l]
    assert its[0] == 4 and its[-1] == 6


def test_device_selection(mini, monkeypatch):
    """--cpu, --gpu=-1 and solver_mode: CPU pick the CPU; otherwise the card,
    and without one every command raises (never falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    short = _solver_file(mini, max_iter=1, test_interval=1)
    for argv in (["train", "--solver", short],
                 ["train", "--solver", short, "--gpu", "0"],
                 ["test", "--model", mini["net"], "--allow_random_weights"],
                 ["time", "--model", mini["net"]],
                 ["device_query"],
                 ["train_net", short]):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            main(argv)
    assert main(["train", "--solver", short, "--gpu", "-1"]) == 0
    cpu_mode = _solver_file(mini, "solver_cpu.prototxt", max_iter=1,
                            test_interval=1, solver_mode="CPU")
    with Lines() as out:
        assert main(["train", "--solver", cpu_mode]) == 0
    assert any("CPU-only mode" in l for l in out.lines)


def test_device_watch_table():
    """The gpustat-style table: a header and one row per card per tick,
    from the caching allocator's numbers."""
    stats = {0: {"bytes_in_use": 512 << 20, "peak_bytes_in_use": 1 << 30,
                 "bytes_limit": 16 << 30, "num_allocs": 42}, 1: {}}
    buf = io.StringIO()
    with mock.patch.object(cli, "_memory_stats", lambda i: stats[i]):
        assert cli._device_watch(interval=0.01, count=2, out=buf,
                                 devices=[0, 1]) == 0
    lines = buf.getvalue().strip().split("\n")
    assert "used MB" in lines[0] and "allocs" in lines[0]
    assert len(lines) == 1 + 2 * 2  # the header, 2 cards x 2 ticks
    assert "cuda:0" in lines[1] and "512.0" in lines[1]
    assert "1024.0" in lines[1] and "42" in lines[1] and " 3.1" in lines[1]
    assert "n/a" in lines[2]


def test_module_runs_with_jax_blocked(mini):
    """`python -m videovector_tpu_torch.tools.cli` with jax and the JAX
    package blocked: it imports neither."""
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None
        sys.modules["videovector_tpu"] = None
        sys.argv = ["cli", "train", "--solver", {_solver_file(
            mini, max_iter=1, test_interval=1)!r}, "--cpu"]
        try:
            runpy.run_module("videovector_tpu_torch.tools.cli",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert "Optimization Done." in out.stderr
