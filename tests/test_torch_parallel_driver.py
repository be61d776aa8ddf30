"""SolverDriver.train(mesh=) and the Net over a mesh, the CLI's and the
extraction tool's --mesh, against one rank and against the JAX package's
mesh driver on the CPU.

Ranks are gloo processes (tests/torch_parallel_cases.py), rank r on JAX's
device (r // model, r % model). The nets: tests/test_driver_mesh.py's
flagship mini solver (generate_net.emit: feature 32, embed 16, B = 8 of
1 + 4 + 4 roles, dropout 0.9) at 2 x 2, with dropout 0 against JAX's mesh
driver (JAX's params carried in) and with dropout 0.9 against the port's
one-rank run; its stateful LSTM net at 4 x 1; a classifier head whose
ranks hold unequal class counts (SOFTMAX_LOSS, ACCURACY,
CLASSIFICATION_STATS); the device_negatives reservoir over 2 ranks;
tests/test_torch_driver.py's mini project through `train`/`test --mesh 2`
and `extract_features --mesh 2`, and `train --mesh 2` under
`python -m torch.distributed.run`; multihost_worker over 1 and 2
processes, and its steps from JAX's init against JAX's worker. Losses within 2e-5 relative (1e-5 against
JAX), params 1e-4 relative + 1e-6, the reservoir bit for bit, the files
byte for byte, and rank 0 alone logs.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from test_torch_driver import write_mini_project
from videovector_tpu.config.textformat import parse_file as jparse_file
from videovector_tpu.parallel import make_mesh as jmake_mesh
from videovector_tpu.parallel import multihost_worker as jworker
from videovector_tpu.solver import driver as jdriver

from videovector_tpu_torch import convert
from videovector_tpu_torch.config.textformat import parse as tparse
from videovector_tpu_torch.data.shots import ShotDataset, ShotVideo
from videovector_tpu_torch.graph.net import Net
from videovector_tpu_torch.parallel.multihost_worker import launch_workers
from videovector_tpu_torch.solver.driver import SolverDriver, _spec_from_batch
from videovector_tpu_torch.solver.solvers import (
    SolverConfig, init_solver_state, solver_update,
)
from videovector_tpu_torch.solver.train import value_and_grad
from videovector_tpu_torch.tools import cli, extract_features

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "projects" / "videovec_embedding"))
from generate_net import emit  # noqa: E402

torch.set_num_threads(1)

CLS_NET = """
name: "cls"
input: "data" input_dim: 8 input_dim: 6 input_dim: 1 input_dim: 1
input: "label" input_dim: 8 input_dim: 1 input_dim: 1 input_dim: 1
layers { name: "ip" type: INNER_PRODUCT bottom: "data" top: "ip"
  inner_product_param { num_output: 4
    weight_filler { type: "gaussian" std: 0.5 } } }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "ip" bottom: "label"
  top: "loss" }
layers { name: "acc" type: ACCURACY bottom: "ip" bottom: "label" top: "acc" }
layers { name: "cs" type: CLASSIFICATION_STATS bottom: "ip" bottom: "label"
  top: "pca" top: "pcap" top: "accs"
  classification_stats_param { num_classes: 4 } }
"""


def _emit_project(tmp, dropout, **solver_fields):
    rs = np.random.RandomState(1701)
    videos = []
    for v in range(10):
        center = rs.randn(32).astype(np.float32)
        feats = np.abs(center + 0.3 * rs.randn(8, 32).astype(np.float32))
        videos.append(ShotVideo(v + 1, np.arange(8, dtype=np.int32), feats))
    train = str(tmp / "train.vvr")
    ShotDataset(videos).to_records(train)
    net = tmp / "net.prototxt"
    net.write_text(emit(train, train, batch=8, test_batch=8, negatives=4,
                        embed=16, buffer_size=16, same_video_negs=1,
                        dropout=dropout))
    fields = dict(base_lr=0.02, momentum=0.9, max_iter=6, display=1,
                  random_seed=7, **solver_fields)
    solver = tmp / "solver.prototxt"
    solver.write_text(f'net: "{net}"\n' + "".join(
        f"{k}: {v}\n" for k, v in fields.items()))
    return str(solver)


def _lstm_project(tmp):
    from videovector_tpu_torch.data.records import RecordWriter
    from videovector_tpu_torch.data.wire import TrackingWindow, TrackPositions
    rs = np.random.RandomState(3)
    t_obs, t_pred, b = 6, 3, 16
    path = str(tmp / "tracks.vvr")
    with RecordWriter(path) as w:
        tid = 0
        for s in range(60):
            tracks = []
            for _ in range(4):
                vel = rs.randn(2) * 0.4
                ts = np.arange(t_obs + t_pred)
                xy = vel[None, :] * ts[:, None]
                tracks.append(TrackPositions(
                    id=tid, x=list(map(float, xy[:, 0])),
                    y=list(map(float, xy[:, 1])), cl=0))
                tid += 1
            w.append(f"{s:06d}", TrackingWindow(
                observed_time=list(range(t_obs)),
                prediction_time=list(range(t_obs, t_obs + t_pred)),
                scene_id=s, track_positions=tracks).encode())
    net = f"""
    name: "lstm_mesh"
    layers {{ name: "d" type: TRACKING_WINDOWS_DATA
      top: "observed" top: "cont_obs" top: "predicted" top: "cont_pred" top: "gt"
      tracking_windows_data_param {{ source: "{path}" batch_size: {b}
        temporal_observed_size: {t_obs} temporal_predicted_size: {t_pred} }} }}
    layers {{ name: "enc" type: LSTM bottom: "observed" bottom: "cont_obs"
      top: "h" inner_product_param {{ num_output: 16
        weight_filler {{ type: "gaussian" std: 0.2 }} }} }}
    layers {{ name: "fb" type: FLATTEN_BATCH bottom: "h" top: "hf" }}
    layers {{ name: "ro" type: INNER_PRODUCT bottom: "hf" top: "pred"
      inner_product_param {{ num_output: 2 weight_filler {{ type: "xavier" }} }} }}
    layers {{ name: "gtf" type: FLATTEN_BATCH bottom: "observed" top: "obs_f" }}
    layers {{ name: "sl" type: SLICE bottom: "obs_f" top: "xy" top: "rest"
      slice_param {{ slice_dim: 1 slice_point: 2 }} }}
    layers {{ name: "sil" type: SILENCE bottom: "rest" }}
    layers {{ name: "loss" type: EUCLIDEAN_LOSS bottom: "pred" bottom: "xy"
      top: "l" }}
    """
    solver = tmp / "lstm_solver.prototxt"
    solver.write_text(f"net_param {{ {net} }}\nbase_lr: 0.05 momentum: 0.9 "
                      'lr_policy: "fixed"\nmax_iter: 8 display: 1 '
                      f'snapshot: 0 snapshot_prefix: "{tmp / "s"}"\n')
    return str(solver)


def _cls_batches():
    """Rank 0 of a 2-way data split holds class 0 alone; the other rank
    all four classes: unequal per-class counts across ranks."""
    rs = np.random.RandomState(5)
    out = []
    for _ in range(3):
        label = np.array([0, 0, 0, 0, 0, 1, 2, 3], np.float32)
        out.append({"data": rs.randn(8, 6, 1, 1).astype(np.float32),
                    "label": label.reshape(8, 1, 1, 1)})
    return out


def _one_rank(solver, params=None):
    d = SolverDriver.from_prototxt(solver, device="cpu").build()
    if params is not None:
        d.params = convert.params_from_jax(params)
    return d.train()


def _jax_mesh(solver, data, model):
    jd = jdriver.SolverDriver(jparse_file(solver)).build()
    params = jax.tree.map(np.asarray, jd.params)
    res = jd.train(mesh=jmake_mesh(data=data, model=model,
                                   devices=jax.devices()[:data * model]))
    return params, res


def _losses(history):
    return [m["loss"] for _, m in history]


def _close_params(got, want):
    for ln in want:
        for pn in want[ln]:
            np.testing.assert_allclose(got[ln][pn], np.asarray(want[ln][pn]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{ln}/{pn}")


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("driver4")
    (tmp / "d9").mkdir()
    (tmp / "d0").mkdir()
    drop = _emit_project(tmp / "d9", 0.9)
    nodrop = _emit_project(tmp / "d0", 0.0)
    lstm = _lstm_project(tmp)
    jparams, jres = _jax_mesh(nodrop, 2, 2)
    lparams, ljres = _jax_mesh(lstm, 4, 1)
    run = [("driver_train", dict(solver_path=drop, data_n=2, model_n=2)),
           ("driver_train", dict(solver_path=nodrop, data_n=2, model_n=2,
                                 params=jparams)),
           ("driver_train", dict(solver_path=lstm, data_n=4, model_n=1,
                                 params=lparams)),
           ("net_steps", dict(net_text=CLS_NET, batches=_cls_batches(),
                              data_n=2, model_n=2))]
    out = cases.run(4, run, tmp, timeout=150)
    return dict(drop=drop, nodrop=nodrop, lstm=lstm, jres=jres,
                jparams=jparams, lparams=lparams, ljres=ljres, out=out)


def test_driver_trains_over_a_2x2_mesh_as_one_rank(four):
    """Dropout 0.9 on the role-major concat of the tower input: each rank's
    masks are the one-rank run's rows, so the trajectory is the same."""
    ref = _one_rank(four["drop"])
    for hist, _, params, _ in (r[0] for r in four["out"]):
        np.testing.assert_allclose(_losses(hist), _losses(ref.metrics_history),
                                   rtol=2e-5)
        # the violation counts too: the whole batch's on every rank
        assert [m["train_violations"] for _, m in hist] == \
            [m["train_violations"] for _, m in ref.metrics_history]
        _close_params(params, convert.params_to_numpy(ref.params))


def test_driver_over_a_2x2_mesh_matches_jax(four):
    for hist, _, params, _ in (r[1] for r in four["out"]):
        np.testing.assert_allclose(_losses(hist),
                                   _losses(four["jres"].metrics_history),
                                   rtol=1e-5)
        _close_params(params, jax.tree.map(np.asarray, four["jres"].params))


def test_stateful_lstm_net_over_4_data_ranks(four):
    ref = _one_rank(four["lstm"], four["lparams"])
    jl = _losses(four["ljres"].metrics_history)
    carries = []
    for hist, _, params, carry in (r[2] for r in four["out"]):
        np.testing.assert_allclose(_losses(hist), _losses(ref.metrics_history),
                                   rtol=2e-5)
        np.testing.assert_allclose(_losses(hist), jl, rtol=1e-5)
        _close_params(params, convert.params_to_numpy(ref.params))
        carries.append(carry["enc"][0])
    # each rank carries its own 4 rows of the 16: the one-rank carry's
    np.testing.assert_allclose(np.concatenate(carries),
                               ref.final_carry["enc"].c.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_batch_coupled_outputs_are_the_whole_batch(four):
    """SOFTMAX_LOSS, ACCURACY and CLASSIFICATION_STATS over a 2 x 2 mesh
    whose data ranks hold unequal class counts: outputs, loss and params
    equal the one-device run's."""
    batches = _cls_batches()
    net = Net(tparse(CLS_NET), phase="TRAIN")
    params, _ = net.init(torch.Generator().manual_seed(0),
                         _spec_from_batch(batches[0]))
    s = SolverConfig(base_lr=0.1, momentum=0.9)
    st = init_solver_state(s, params)
    vg = value_and_grad(lambda pp, b, g: (lambda r: (
        r[0], {k: v.reshape(-1) for k, v in r[1].items()}))(
            net.apply(pp, b, generator=g)))
    want = []
    for b in batches:
        (loss, aux), g = vg(params, {k: torch.as_tensor(v)
                                     for k, v in b.items()}, None)
        params, st = solver_update(s, params, g, st)
        want.append({"loss": float(loss),
                     **{k: v.numpy() for k, v in aux.items()}})
    for hist, p in (r[3] for r in four["out"]):
        for got, ref in zip(hist, want):
            for k, v in ref.items():
                np.testing.assert_allclose(got[k], v, rtol=2e-5, atol=1e-7,
                                           err_msg=k)
        _close_params(p, convert.params_to_numpy(params))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("driver2")
    dn_dir = tmp / "dn"
    dn_dir.mkdir()
    mini_dn = write_mini_project(dn_dir)
    Path(mini_dn["net"]).write_text(Path(mini_dn["net"]).read_text().replace(
        "context_size: 5", "context_size: 5\n    device_negatives: true")
        .replace("max_same_video_negs: 1", "max_same_video_negs: 0"))
    cli_dir = tmp / "cli"
    cli_dir.mkdir()
    mini = write_mini_project(cli_dir)
    # the one-rank runs: train (its snapshot scores `test` and feeds the
    # extraction), test, extract
    text = Path(mini["solver"]).read_text()
    one = cli_dir / "one_solver.prototxt"
    one.write_text(text.replace(str(cli_dir / "snap"),
                                str(cli_dir / "one")))
    two_ = cli_dir / "two_solver.prototxt"
    two_.write_text(text.replace(str(cli_dir / "snap"),
                                 str(cli_dir / "two")))
    assert cli.main(["train", "--solver", str(one), "--cpu"]) == 0
    weights = str(cli_dir / "one_iter_10.vvmodel")
    # multihost_worker's steps from JAX's init, against JAX's one-process
    # worker (dropout 0: the two packages' mask streams differ, their
    # samplers do not)
    (tmp / "mw").mkdir()
    worker_solver = _emit_project(tmp / "mw", 0.0)
    jd = jdriver.SolverDriver.from_prototxt(worker_solver).build()
    jparams = jax.tree.map(np.asarray, jd.params)
    jlosses = jworker.run_worker(worker_solver, process_id=0,
                                 num_processes=1, coordinator="", iters=3)
    run = [("driver_train", dict(solver_path=mini_dn["solver"], data_n=2,
                                 model_n=1)),
           ("cli_runs", dict(solver=str(two_), model=mini["net"],
                             weights=weights,
                             out_prefix=str(cli_dir / "mesh"),
                             blobs="ctxn")),
           ("worker_steps", dict(solver_path=worker_solver,
                                 params=jparams))]
    out = cases.run(2, run, tmp, timeout=150)
    return dict(dn=mini_dn, mini=mini, cli_dir=cli_dir, weights=weights,
                one=str(one), two=str(two_), out=out, worker_solver=worker_solver,
                jlosses=jlosses)


def test_device_negatives_reservoir_is_the_same_on_every_rank(two):
    ref = _one_rank(two["dn"]["solver"])
    res = [r[0] for r in two["out"]]
    np.testing.assert_array_equal(res[0][3], res[1][3])
    np.testing.assert_array_equal(res[0][3], ref.final_carry.numpy())
    for hist, _, params, _ in res:
        np.testing.assert_allclose(_losses(hist), _losses(ref.metrics_history),
                                   rtol=2e-5)
        _close_params(params, convert.params_to_numpy(ref.params))


def _floats(lines, part):
    return [float(l.rsplit("=", 1)[1].split()[0]) for l in lines
            if part in l]


def test_cli_train_test_and_extract_over_2_ranks(two):
    from test_torch_driver import Lines
    logs = [r[1] for r in two["out"]]
    # rank 0 alone logs (and writes)
    assert logs[1] == {"train": [], "test": [], "extract": []}
    tl = logs[0]["train"]
    assert "Training over mesh data=2 model=1" in tl
    assert tl[-1] == "Optimization Done."
    with Lines() as one:
        assert cli.main(["train", "--solver", two["one"], "--cpu"]) == 0
    for part in (", loss = ", "Test net output"):
        np.testing.assert_allclose(_floats(tl, part),
                                   _floats(one.lines, part), rtol=1e-5)
    got = np.load(str(two["cli_dir"] / "two_iter_10.vvmodel"))
    want = np.load(two["weights"])
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6)
    # test: the one-rank lines, string for string
    with Lines() as t1:
        assert cli.main(["test", "--model", two["mini"]["net"], "--weights",
                         two["weights"], "--iterations", "2",
                         "--cpu"]) == 0
    assert logs[0]["test"] == t1.lines
    # extraction: the stores and text files byte for byte
    prefix = str(two["cli_dir"] / "single")
    assert extract_features.main([
        "--model", two["mini"]["net"], "--weights", two["weights"],
        "--blobs", "ctxn", "--out", prefix, "--num_batches", "2",
        "--cpu"]) == 0
    for suffix in ("_ctxn.vvr", "_ctxn.txt"):
        assert Path(prefix + suffix).read_bytes() == Path(
            str(two["cli_dir"] / "mesh") + suffix).read_bytes()


def test_cli_train_under_torchrun_is_the_2_rank_run(two, tmp_path):
    """`python -m torch.distributed.run --nproc_per_node 2 ... train --mesh
    2`: make_mesh starts the group from torchrun's environment; the loss
    lines are the fixture's 2-rank run's, logged once (rank 0 alone)."""
    solver = tmp_path / "solver.prototxt"
    solver.write_text(Path(two["two"]).read_text().replace(
        str(two["cli_dir"] / "two"), str(tmp_path / "snap")))
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "videovector_tpu_torch.tools.cli",
         "train", "--solver", str(solver), "--mesh", "2", "--cpu"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    lines = (run.stdout + run.stderr).splitlines()
    want = [l for l in two["out"][0][1]["train"] if ", loss = " in l]
    got = [l for l in lines if ", loss = " in l]
    assert len(got) == len(want)
    assert _floats(got, ", loss = ") == _floats(want, ", loss = ")


def test_launch_workers_two_processes_equal_one_and_jax(two, tmp_path):
    """multihost_worker over 2 gloo processes against 1 process (the port's
    init); its steps from JAX's init over the fixture's 2 ranks against the
    JAX package's one-process worker."""
    solver = two["worker_solver"]
    (single,) = launch_workers(solver, str(tmp_path), 1, 1, timeout=120,
                               device="cpu")
    two_ = launch_workers(solver, str(tmp_path), 2, 1, timeout=120,
                          device="cpu")
    assert two_[0] == two_[1]
    np.testing.assert_allclose(two_[0], single, rtol=1e-5)
    ranks = [r[2] for r in two["out"]]
    assert ranks[0] == ranks[1]
    np.testing.assert_allclose(ranks[0], two["jlosses"], rtol=1e-5)
    with pytest.raises(ValueError, match="devices_per_proc"):
        launch_workers(solver, str(tmp_path), 2, 4, device="cpu")
