"""The port's SolverDriver (videovector_tpu_torch/solver/driver.py) against the
JAX package's on the CPU.

The mini project of tests/test_e2e.py: feature 24, embed 16, B = 8 windows
of 1 target + 4 context + 3 negatives from a 10-video x 8-shot VVR store,
test batches of 12 windows; the stores are written by the port. JAX's
params are carried across with `convert.params_from_jax` after both
builds, the net has no dropout, and both drivers draw the same batches
from the same seeded sources. Tolerances: the 10-iteration loss
trajectory within 1e-5 relative, the test outputs within 2e-5.
"""

import logging
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from videovector_tpu.config.textformat import parse_file as jparse_file
from videovector_tpu.solver import driver as jdriver
from videovector_tpu_torch import convert
from videovector_tpu_torch.config.textformat import Message
from videovector_tpu_torch.config.textformat import parse_file as tparse_file
from videovector_tpu_torch.data.records import RecordWriter
from videovector_tpu_torch.data.shots import ShotDataset, ShotVideo
from videovector_tpu_torch.data.wire import (
    Datum, TestVideoShotWindows, TrackingWindow, TrackPositions,
)
from videovector_tpu_torch.solver import driver as tdriver
from videovector_tpu_torch.solver.checkpoint import snapshot

torch.set_num_threads(1)

FEAT = 24

MINI_NET = """
name: "mini_embedding"
layers {{
  name: "shot_windows"
  type: VIDEO_SAMPLED_SHOTS_DATA
  top: "data"
  video_sampled_shots_data_param {{
    source: "{train_src}"
    batch_size: 8
    num_negative_samples: 3
    max_buffer_size: 20
    negative_swap_percentage: 50
    max_same_video_negs: 1
    context_type: WINDOW
    context_size: 5
  }}
  include: {{ phase: TRAIN }}
}}
layers {{
  name: "shot_windows"
  type: VIDEO_SHOT_WINDOW_TEST_DATA
  top: "data"
  top: "video_ids"
  video_shot_window_test_data_param {{
    source: "{test_src}"
    batch_size: 12
  }}
  include: {{ phase: TEST }}
}}
layers {{
  name: "slice_input" type: SLICE bottom: "data"
  top: "t" top: "c1" top: "c2" top: "c3" top: "c4"
  top: "n1" top: "n2" top: "n3"
  slice_param {{ slice_dim: 1 }}
  include: {{ phase: TRAIN }}
}}
layers {{
  name: "slice_input" type: SLICE bottom: "data"
  top: "c1" top: "c2" top: "c3" top: "c4"
  slice_param {{ slice_dim: 1 }}
  include: {{ phase: TEST }}
}}
layers {{
  name: "concat_all" type: CONCAT
  bottom: "t" bottom: "c1" bottom: "c2" bottom: "c3" bottom: "c4"
  bottom: "n1" bottom: "n2" bottom: "n3"
  top: "tower_in" concat_param {{ concat_dim: 0 }}
  include: {{ phase: TRAIN }}
}}
layers {{
  name: "concat_all" type: CONCAT
  bottom: "c1" bottom: "c2" bottom: "c3" bottom: "c4"
  top: "tower_in" concat_param {{ concat_dim: 0 }}
  include: {{ phase: TEST }}
}}
layers {{
  name: "fc7" type: INNER_PRODUCT bottom: "tower_in" top: "emb"
  inner_product_param {{
    num_output: 16
    weight_filler {{ type: "gaussian" std: 0.05 }}
  }}
}}
layers {{ name: "relu7" type: RELU bottom: "emb" top: "emb" }}
layers {{
  name: "slice_emb" type: SLICE bottom: "emb"
  top: "et" top: "ec1" top: "ec2" top: "ec3" top: "ec4"
  top: "en1" top: "en2" top: "en3"
  slice_param {{ slice_dim: 0 }}
  include: {{ phase: TRAIN }}
}}
layers {{
  name: "slice_emb" type: SLICE bottom: "emb"
  top: "ec1" top: "ec2" top: "ec3" top: "ec4"
  slice_param {{ slice_dim: 0 }}
  include: {{ phase: TEST }}
}}
layers {{
  name: "ctx_avg" type: ELTWISE
  bottom: "ec1" bottom: "ec2" bottom: "ec3" bottom: "ec4" top: "ctx"
  eltwise_param {{ operation: SUM coeff: 0.25 coeff: 0.25 coeff: 0.25 coeff: 0.25 }}
}}
layers {{ name: "ctx_norm" type: NORMALIZATION bottom: "ctx" top: "ctxn" }}
layers {{
  name: "tgt_norm" type: NORMALIZATION bottom: "et" top: "etn"
  include: {{ phase: TRAIN }}
}}
layers {{
  name: "true_prod" type: ELTWISE bottom: "ctxn" bottom: "etn" top: "tp"
  eltwise_param {{ operation: PROD }}
  include: {{ phase: TRAIN }}
}}
layers {{
  name: "true_score" type: SUM bottom: "tp" top: "ts"
  sum_param {{ num_output: 3 }}
  include: {{ phase: TRAIN }}
}}
layers {{
  name: "n1_norm" type: NORMALIZATION bottom: "en1" top: "en1n"
  include: {{ phase: TRAIN }} }}
layers {{
  name: "n2_norm" type: NORMALIZATION bottom: "en2" top: "en2n"
  include: {{ phase: TRAIN }} }}
layers {{
  name: "n3_norm" type: NORMALIZATION bottom: "en3" top: "en3n"
  include: {{ phase: TRAIN }} }}
layers {{ name: "np1" type: ELTWISE bottom: "ctxn" bottom: "en1n" top: "np1"
  eltwise_param {{ operation: PROD }} include: {{ phase: TRAIN }} }}
layers {{ name: "ns1" type: SUM bottom: "np1" top: "ns1"
  include: {{ phase: TRAIN }} }}
layers {{ name: "np2" type: ELTWISE bottom: "ctxn" bottom: "en2n" top: "np2"
  eltwise_param {{ operation: PROD }} include: {{ phase: TRAIN }} }}
layers {{ name: "ns2" type: SUM bottom: "np2" top: "ns2"
  include: {{ phase: TRAIN }} }}
layers {{ name: "np3" type: ELTWISE bottom: "ctxn" bottom: "en3n" top: "np3"
  eltwise_param {{ operation: PROD }} include: {{ phase: TRAIN }} }}
layers {{ name: "ns3" type: SUM bottom: "np3" top: "ns3"
  include: {{ phase: TRAIN }} }}
layers {{ name: "neg_concat" type: CONCAT
  bottom: "ns1" bottom: "ns2" bottom: "ns3" top: "negs"
  concat_param {{ concat_dim: 1 }} include: {{ phase: TRAIN }} }}
layers {{
  name: "max_margin_loss" type: MAX_MARGIN_LOSS
  bottom: "ts" bottom: "negs" top: "loss" top: "violations"
  loss_weight: 1.0 loss_weight: 0.0
  max_margin_loss_param {{ margin: 1.0 norm: L2 }}
  include: {{ phase: TRAIN }}
}}
layers {{
  name: "retrieval" type: RETRIEVAL_STATS
  bottom: "ctxn" bottom: "video_ids"
  top: "map" top: "hit1" top: "hit5"
  retrieval_stats_param {{ exclude_same_video_shots: false }}
  include: {{ phase: TEST }}
}}
"""

MINI_SOLVER = """
net: "{net_path}"
base_lr: 0.05
momentum: 0.9
weight_decay: 0.0001
lr_policy: "inv"
gamma: 0.001
power: 0.75
display: 1
max_iter: 10
test_interval: 5
test_iter: 1
snapshot: 0
snapshot_prefix: "{snap_prefix}"
"""


def write_mini_project(tmp_path: Path, seed: int = 1701) -> dict:
    """The mini project's stores, net and solver in tmp_path."""
    rng = np.random.RandomState(seed)
    videos = []
    for v in range(10):
        center = rng.randn(FEAT).astype(np.float32) * 2
        feats = center + 0.3 * rng.randn(8, FEAT).astype(np.float32)
        videos.append(ShotVideo(v + 1, np.arange(8, dtype=np.int32), feats))
    train_src = str(tmp_path / "train.vvr")
    ShotDataset(videos).to_records(train_src)
    test_src = str(tmp_path / "test.vvr")
    with RecordWriter(test_src) as w:
        for i in range(12):
            center = rng.randn(FEAT).astype(np.float32)
            ctx = [Datum(float_data=(center + 0.1 * rng.randn(FEAT))
                         .astype(np.float32)) for _ in range(4)]
            w.append(str(i), TestVideoShotWindows(
                video_id=i % 4 + 1, context_shot_words=ctx).encode())
    net_path = tmp_path / "net.prototxt"
    net_path.write_text(MINI_NET.format(train_src=train_src,
                                        test_src=test_src))
    solver_path = tmp_path / "solver.prototxt"
    solver_path.write_text(MINI_SOLVER.format(
        net_path=str(net_path), snap_prefix=str(tmp_path / "snap")))
    return {"net": str(net_path), "solver": str(solver_path),
            "tmp": tmp_path}


@pytest.fixture
def mini(tmp_path):
    return write_mini_project(tmp_path)


class Lines(logging.Handler):
    """Collects the messages of a logger (the port's root propagates
    nothing, so caplog does not see them)."""

    def __init__(self, name="videovector_tpu_torch"):
        super().__init__()
        self.logger = logging.getLogger(name)
        self.lines, self.records = [], []

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)

    def emit(self, record):
        self.records.append(record)
        self.lines.append(record.getMessage())


def _solver(mini, **fields):
    """Both packages' parse of the mini solver, with `fields` replaced."""
    msgs = []
    for parse in (jparse_file, tparse_file):
        msg = parse(mini["solver"])
        for k, v in fields.items():
            if v is None:
                msg.fields.pop(k, None)
            else:
                msg.fields[k] = v if isinstance(v, list) else [v]
        msgs.append(msg)
    return msgs


def _pair(mini, **fields):
    """JAX's built driver and the port's, the port holding JAX's params."""
    jmsg, tmsg = _solver(mini, **fields)
    jd = jdriver.SolverDriver(jmsg).build()
    td = tdriver.SolverDriver(tmsg, device="cpu").build()
    td.params = convert.params_from_jax(jax.tree.map(np.asarray, jd.params))
    return jd, td


def _losses(res):
    return [m["loss"] for _, m in res.metrics_history]


def test_ten_iteration_trajectory_and_tests_match_jax(mini):
    jd, td = _pair(mini)
    jres, tres = jd.train(), td.train()
    assert [it for it, _ in tres.metrics_history] == list(range(10))
    np.testing.assert_allclose(_losses(tres), _losses(jres), rtol=1e-5)
    for (ti, tm), (ji, jm) in zip(tres.metrics_history, jres.metrics_history):
        assert ti == ji and sorted(tm) == sorted(jm) == ["loss", "violations"]
    assert [it for it, _ in tres.test_history] == [0, 5, 10]
    for (ti, tm), (ji, jm) in zip(tres.test_history, jres.test_history):
        assert ti == ji and sorted(tm) == sorted(jm) == ["hit1", "hit5", "map"]
        for k in tm:
            assert abs(tm[k] - jm[k]) <= 2e-5, (ti, k, tm[k], jm[k])
    np.testing.assert_allclose(tres.params["fc7"]["w"].numpy(),
                               np.asarray(jres.params["fc7"]["w"]),
                               rtol=1e-5, atol=1e-6)


def test_the_build_batch_is_iteration_zero(mini):
    """The batch build() drew for shapes is re-fed as iteration 0: the
    first step's loss is the loss of the source's first batch."""
    (_, tmsg) = _solver(mini, max_iter=1, test_interval=0, test_iter=None)
    td = tdriver.SolverDriver(tmsg, device="cpu").build()
    first = {k: torch.as_tensor(v) for k, v in td._first_batch.items()}
    fresh = tdriver.SolverDriver(tmsg, device="cpu").build()
    np.testing.assert_array_equal(first["data"].numpy(),
                                  fresh._first_batch["data"])
    with torch.no_grad():
        want = td.train_net.loss_fn(td.params, first).item()
    assert _losses(td.train()) == [pytest.approx(want, rel=1e-6)]


def test_multi_test_nets_and_compute_loss(mini):
    """Repeated test_net, per-net test_iter and test_compute_loss (ref
    caffe.proto:86-116): history keys net{i}/..., as JAX's."""
    jd, td = _pair(mini, max_iter=4, test_interval=2, test_iter=[1, 1],
                   test_net=[mini["net"], mini["net"]],
                   test_compute_loss=True)
    assert len(td.test_nets) == 2
    tres, jres = td.train(), jd.train()
    metrics = tres.test_history[0][1]
    assert "net0/map" in metrics and "net1/map" in metrics
    assert "net0/loss" in metrics and "net1/loss" in metrics
    for (_, tm), (_, jm) in zip(tres.test_history, jres.test_history):
        assert sorted(tm) == sorted(jm)
        for k in tm:
            assert abs(tm[k] - jm[k]) <= 2e-5, k


def test_test_initialization_flag(mini):
    (_, tmsg) = _solver(mini, max_iter=4, test_interval=2,
                        test_initialization=False)
    res = tdriver.SolverDriver(tmsg, device="cpu").build().train()
    its = [t[0] for t in res.test_history]
    assert 0 not in its and 2 in its and 4 in its


def test_two_builds_train_alike(mini):
    """The same solver and seeds give the same params and trajectory."""
    (_, tmsg) = _solver(mini, max_iter=6, test_interval=0, test_iter=None)
    runs = [tdriver.SolverDriver(tmsg, device="cpu").build() for _ in "ab"]
    for a, b in zip(convert.leaves_with_paths(runs[0].params),
                    convert.leaves_with_paths(runs[1].params)):
        assert torch.equal(a[1], b[1])
    assert _losses(runs[0].train()) == _losses(runs[1].train())


def test_random_seed_reaches_fillers_and_sources(mini):
    """SolverParameter.random_seed seeds the fillers and the sampler (ref
    Caffe::set_random_seed, solver.cpp:37-39); the test net's source gets
    seed + 1 + i; no random_seed means 1234."""
    def build(seed):
        (_, tmsg) = _solver(mini, random_seed=seed)
        return tdriver.SolverDriver(tmsg, device="cpu").build()
    a, b, c = build(7), build(7), build(8)
    assert torch.equal(a.params["fc7"]["w"], b.params["fc7"]["w"])
    assert not torch.equal(a.params["fc7"]["w"], c.params["fc7"]["w"])
    np.testing.assert_array_equal(a._first_batch["data"],
                                  b._first_batch["data"])
    assert not np.array_equal(a._first_batch["data"], c._first_batch["data"])
    # the sources get JAX's seeds: the same first batches as JAX's driver
    jmsg, tmsg = _solver(mini, random_seed=7)
    jd = jdriver.SolverDriver(jmsg).build()
    np.testing.assert_array_equal(a._first_batch["data"],
                                  jd._first_batch["data"])
    np.testing.assert_array_equal(a._test_first_batches[0]["data"],
                                  jd._test_first_batches[0]["data"])
    (_, tmsg) = _solver(mini, random_seed=None)
    d = tdriver.SolverDriver(tmsg, device="cpu").build()
    e = build(1234)
    assert torch.equal(d.params["fc7"]["w"], e.params["fc7"]["w"])


def test_finetune_from_vvmodel(mini, tmp_path):
    """--weights: a .vvmodel's layers land in the train net (ref
    tools/caffe.cpp:110-117), on a copy; a wrong shape or a param the net
    lacks is refused with JAX's message."""
    (_, tmsg) = _solver(mini, max_iter=0, test_interval=0, test_iter=None,
                        display=0)
    td = tdriver.SolverDriver(tmsg, device="cpu").build()
    orig = td.params["fc7"]["w"].clone()
    good = snapshot(str(tmp_path / "pre"), 0, {"fc7": {
        "w": np.full((FEAT, 16), 0.123, np.float32),
        "b": np.zeros(16, np.float32)}, "absent_layer": {
        "w": np.zeros(3, np.float32)}})[0]
    res = td.train(weights_path=good)
    np.testing.assert_allclose(res.params["fc7"]["w"].numpy(), 0.123)
    assert torch.equal(td.params["fc7"]["w"], orig)   # copy, not mutate
    bad_shape = snapshot(str(tmp_path / "shape"), 0, {"fc7": {
        "w": np.zeros((FEAT + 1, 16), np.float32)}})[0]
    with pytest.raises(ValueError, match=r"param 'w' has shape \(25, 16\), "
                                         r"net expects \(24, 16\)"):
        td.train(weights_path=bad_shape)
    unknown = snapshot(str(tmp_path / "unknown"), 0, {"fc7": {
        "w2": np.zeros((FEAT, 16), np.float32)}})[0]
    with pytest.raises(ValueError, match="has param 'w2' the net does not"):
        td.train(weights_path=unknown)


def _jax_and_port_error(jmsg, tmsg):
    with pytest.raises(ValueError) as jerr:
        jdriver.SolverDriver(jmsg)
    with pytest.raises(ValueError) as terr:
        tdriver.SolverDriver(tmsg, device="cpu")
    assert str(terr.value) == str(jerr.value)
    return str(terr.value)


@pytest.mark.parametrize("case", ["two_train_nets", "no_train_net",
                                  "test_net_without_test_iter",
                                  "test_state_count", "no_test_interval"])
def test_constructor_errors_carry_jax_messages(mini, case):
    """ref Solver::Init CHECKs (solver.cpp:47-113)."""
    jmsg, tmsg = _solver(mini)
    for msg in (jmsg, tmsg):
        if case == "two_train_nets":
            msg.add("train_net", mini["net"])
        elif case == "no_train_net":
            msg.fields.pop("net")
        elif case == "test_net_without_test_iter":
            msg.add("test_net", mini["net"])
            msg.fields.pop("test_iter")
        elif case == "test_state_count":
            st = type(msg)()
            msg.add("test_state", st)
            msg.add("test_state", st)
        else:
            msg.fields["test_interval"] = [0]
    text = _jax_and_port_error(jmsg, tmsg)
    want = {"two_train_nets": "more than", "no_train_net":
            "must specify a train net", "test_net_without_test_iter":
            "test_iter must be specified", "test_state_count": "test_state",
            "no_test_interval": "test_interval"}[case]
    assert want in text


def _state(phase=None, level=None, stages=()):
    m = Message()
    if phase is not None:
        m.add("phase", phase)
    if level is not None:
        m.add("level", level)
    for s in stages:
        m.add("stage", s)
    return m


@pytest.mark.parametrize("states", [
    (None, None),
    (_state(level=2, stages=("a",)), _state(stages=("b",))),
    (_state(phase="TEST"), _state(level=1)),
    (_state(phase="1", level=3), None),
    (None, _state(phase="0", stages=("x", "y"))),
])
def test_net_state_merging_equals_jax(states):
    """Proto MergeFrom semantics: present scalars overwrite, stages
    concatenate (ref solver.cpp:72-81, :141-152)."""
    for default in ("TRAIN", "TEST"):
        got = tdriver._merge_net_state(default, *states)
        assert got == jdriver._merge_net_state(default, *states)


STAGED_PROBES = """
layers { name: "tr_probe" type: RELU bottom: "loss" top: "tr_probe"
  include: { phase: TRAIN stage: "trs" } }
layers { name: "te_probe" type: RELU bottom: "map" top: "te_probe"
  include: { phase: TEST stage: "deep" } }
"""


def test_solver_net_states_and_generic_test_instances(mini):
    """train_state / test_state merge into the nets' states, and extra
    test_iter entries make extra generic-net test instances: two test_iter
    and two test_state over one `net:` build two differently staged nets
    (ref Solver::InitTrainNet/InitTestNets)."""
    with open(mini["net"], "a") as f:
        f.write(STAGED_PROBES)
    jmsg, tmsg = _solver(mini, max_iter=3, display=1, test_interval=3,
                         test_iter=[1, 1])
    st1 = Message()
    st1.add("stage", "deep")
    ts = Message()
    ts.add("stage", "trs")
    tmsg.add("test_state", Message())
    tmsg.add("test_state", st1)
    tmsg.add("train_state", ts)
    td = tdriver.SolverDriver(tmsg, device="cpu").build()
    assert len(td.test_nets) == 2
    assert td.train_state == ("TRAIN", 0, ("trs",))
    assert [s[2] for s in td.test_net_states] == [(), ("deep",)]
    res = td.train()
    assert any("tr_probe" in k for k in res.metrics_history[0][1])
    merged = res.test_history[-1][1]
    assert "net0/map" in merged and "net1/te_probe" in merged
    assert "net1/map" not in merged      # consumed by net1's probe
    assert not any(k.startswith("net0/te_probe") for k in merged)


def test_role_major_data_trains_as_the_plain_feed(mini):
    """solver `role_major_data: true`: the data blob fed (R, B, D), its
    SLICE/CONCAT absorbed into a reshape; the same losses bit for bit."""
    (_, plain) = _solver(mini, max_iter=4, test_interval=0, test_iter=None)
    (_, rm) = _solver(mini, max_iter=4, test_interval=0, test_iter=None,
                      role_major_data=True)
    a = tdriver.SolverDriver(plain, device="cpu").build()
    b = tdriver.SolverDriver(rm, device="cpu").build()
    assert b.role_major_keys == ("data",)
    assert b.train_net.role_major_inputs == ("data",)
    assert b._first_batch["data"].shape == (8, 8, FEAT)   # (R, B, D)
    assert _losses(a.train()) == _losses(b.train())


def test_test_sink_writes_the_stats_csv(mini, tmp_path):
    """A RETRIEVAL_STATS stats_output_file in the TEST net is written at
    every test (the sink_fn path), one row per window."""
    csv = tmp_path / "stats.csv"
    text = Path(mini["net"]).read_text().replace(
        "exclude_same_video_shots: false }",
        f'exclude_same_video_shots: false stats_output_file: "{csv}" }}')
    Path(mini["net"]).write_text(text)
    (_, tmsg) = _solver(mini, max_iter=2, test_interval=2)
    tdriver.SolverDriver(tmsg, device="cpu").build().train()
    lines = csv.read_text().strip().split("\n")
    assert lines[0].startswith("#video_id,class_id,ap,acc@1,acc@5")
    assert len(lines) == 1 + 12


def test_loss_weighted_outputs_carry_the_suffix(mini):
    """Train and test lines of a loss-weighted output end in
    " (* w = x loss)" (ref solver.cpp:204-214, :306-314)."""
    # an output blob named "loss" is shadowed by the step's loss line, in
    # JAX's loop too; rename it
    Path(mini["net"]).write_text(Path(mini["net"]).read_text().replace(
        'top: "loss" top: "violations"', 'top: "mm_loss" top: "violations"'))
    (_, tmsg) = _solver(mini, max_iter=1, display=1, test_interval=1,
                        test_compute_loss=True)
    with Lines() as out:
        tdriver.SolverDriver(tmsg, device="cpu").build().train()
    loss_lines = [l for l in out.lines if "Train net output" in l
                  and ": mm_loss = " in l]
    assert loss_lines and all("(* 1 = " in l and l.endswith(" loss)")
                              for l in loss_lines)
    assert not any("violations = " in l and "(*" in l for l in out.lines)
    assert any(l.startswith("Test loss: ") for l in out.lines)


STATEFUL_NET = """
name: "lstm"
layers {{ name: "d" type: TRACKING_WINDOWS_DATA
  top: "x" top: "cont" top: "pred_in" top: "cont_pred" top: "y"
  tracking_windows_data_param {{ source: "{src}" batch_size: 3
    temporal_observed_size: 4 temporal_predicted_size: 4 }} }}
layers {{ name: "rnn" type: LSTM bottom: "x" bottom: "cont" top: "h"
  inner_product_param {{ num_output: 8 }} }}
layers {{ name: "fb" type: FLATTEN_BATCH bottom: "h" top: "hf" }}
layers {{ name: "ip" type: INNER_PRODUCT bottom: "hf" top: "p"
  inner_product_param {{ num_output: 2 weight_filler {{ type: "xavier" }} }} }}
layers {{ name: "yf" type: FLATTEN_BATCH bottom: "y" top: "yf" }}
layers {{ name: "loss" type: EUCLIDEAN_LOSS bottom: "p" bottom: "yf"
  top: "l" }}
layers {{ name: "s" type: SILENCE bottom: "pred_in" bottom: "cont_pred" }}
"""


def test_stateful_net_trains_with_its_carry(mini, tmp_path):
    """A net with an LSTM (a cross-batch carry) trains 2 iterations through
    the driver on the CPU: the carry threads from step to step, detached,
    in the host-loop schedule that stateful nets take, and equals JAX's
    driver's run on the same params and store."""
    from videovector_tpu.solver import driver as jdrv
    src = str(tmp_path / "tracks.vvr")
    rng = np.random.RandomState(4)
    with RecordWriter(src) as w:
        for i in range(5):
            w.append(f"{i:08d}", TrackingWindow(scene_id=i, track_positions=[
                TrackPositions(id=2 * i + k, x=list(rng.randn(8)),
                               y=list(rng.randn(8))) for k in range(2)]
            ).encode())
    (tmp_path / "lstm.prototxt").write_text(STATEFUL_NET.format(src=src))
    (jmsg, tmsg) = _solver(mini, max_iter=2, test_interval=0, test_iter=None,
                           display=1, net=str(tmp_path / "lstm.prototxt"))
    jd = jdrv.SolverDriver(jmsg).build()
    td = tdriver.SolverDriver(tmsg, device="cpu").build()
    assert td.train_net.stateful_layer_names == ["rnn"]
    td.params = convert.params_from_jax(jax.tree.map(np.asarray, jd.params))
    tres, jres = td.train(), jd.train()
    np.testing.assert_allclose(
        [m["loss"] for _, m in tres.metrics_history],
        [m["loss"] for _, m in jres.metrics_history], rtol=1e-5)
    assert len(tres.metrics_history) == 2
    carry = tres.final_carry["rnn"]
    assert carry.h.shape == (3, 8) and not carry.h.requires_grad
    for got, want in zip(carry, jres.final_carry["rnn"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("case,item", [
    ("snapshot_vis", "item 10"), ("debug_info", "item 10"),
    ("device_negatives", "item 7"),
    ("orbax_format", "do not port"), ("mesh", "item 11"),
    ("shard_gallery", "item 11")])
def test_later_slices_raise_not_implemented(mini, tmp_path, case, item):
    """Whatever later slices bring raises NotImplementedError naming its
    ROADMAP item; nothing quietly does something else. Items 7, 10 and 11
    have come: snapshot_vis writes its JSON, debug_info logs its stats every
    `display` iterations, device_negatives trains with the reservoir
    carried on the device, a one-rank mesh trains as no mesh does (more
    ranks: tests/test_torch_parallel_driver.py), and shard_gallery without
    a mesh is JAX's ValueError."""
    fields = dict(max_iter=1, test_interval=0, test_iter=None)
    if case == "snapshot_vis":
        fields["snapshot_vis"] = 5
        fields["snapshot_vis_dir"] = str(tmp_path / "vis")
    elif case == "debug_info":
        fields["debug_info"] = True
        fields["display"] = 1
    elif case == "orbax_format":
        fields["snapshot_format"] = "orbax"
    elif case == "device_negatives":
        Path(mini["net"]).write_text(Path(mini["net"]).read_text().replace(
            "context_size: 5", "context_size: 5\n    device_negatives: true")
            .replace("max_same_video_negs: 1", "max_same_video_negs: 0"))
    (_, tmsg) = _solver(mini, **fields)
    if item == "item 11":
        import torch.distributed as dist

        from videovector_tpu_torch.parallel import make_mesh
        d = tdriver.SolverDriver(tmsg, device="cpu").build()
        if case == "shard_gallery":
            with pytest.raises(ValueError, match="requires mesh"):
                d.train(shard_gallery=True)
            return
        plain = tdriver.SolverDriver(tmsg, device="cpu").build().train()
        try:
            res = d.train(mesh=make_mesh(1, 1, devices="cpu"))
        finally:
            dist.destroy_process_group()
        assert _losses(res) == _losses(plain)
        return
    if item in ("item 7", "item 10"):
        calls = []
        real = tdriver.Net.debug_info
        tdriver.Net.debug_info = lambda self, *a, **k: calls.append(
            real(self, *a, **k))
        try:
            res = tdriver.SolverDriver(tmsg, device="cpu").build().train()
        finally:
            tdriver.Net.debug_info = real
        if case == "snapshot_vis":
            assert (tmp_path / "vis" / "vis_iter_0.json").is_file()
        elif case == "debug_info":
            assert len(calls) == 1 and calls[0]
        else:
            assert isinstance(res.final_carry, torch.Tensor)
        return
    with pytest.raises(NotImplementedError, match=item):
        d = tdriver.SolverDriver(tmsg, device="cpu").build()
        if case == "mesh":
            d.train(mesh=object())
        elif case == "shard_gallery":
            d.train(shard_gallery=True)
        else:
            d.train()


@pytest.mark.parametrize("case", ["caffe_format", "solverstate"])
def test_caffe_snapshot_pair_and_solverstate_resume(mini, case):
    """snapshot_format: "caffe" and the .solverstate resume (once refused).
    caffe_format: the driver writes the npz pair and the reference's pair,
    the latter byte-equal to JAX's export_caffe_snapshot of the same arrays,
    and JAX's restore_solverstate reads back the port's arrays bit for bit.
    solverstate: resuming from the .solverstate gives the .vvstate resume's
    losses bit for bit, and JAX's driver resumed from the same file follows
    the same trajectory within 1e-5."""
    from videovector_tpu.solver import checkpoint as jckpt
    fields = dict(max_iter=4, snapshot=2, test_interval=0, test_iter=None,
                  snapshot_format="caffe")
    jd, td = _pair(mini, **fields)
    res = td.train()
    prefix = str(mini["tmp"] / "snap")
    layer_order = [l.get("name") for l in td.train_net.layers
                   if l.get("name") in td.params]
    assert layer_order == [l.get("name") for l in jd.train_net.layers
                           if l.get("name") in jd.params]
    if case == "caffe_format":
        for it in (2, 4):
            for ext in ("vvmodel", "vvstate", "caffemodel", "solverstate"):
                assert os.path.exists(f"{prefix}_iter_{it}.{ext}"), (it, ext)
        p_np = convert.params_to_numpy(res.params)
        s_np = {"iter": 4, "history": convert.params_to_numpy(
            res.state["history"])}
        ours = {ext: Path(f"{prefix}_iter_4.{ext}").read_bytes()
                for ext in ("caffemodel", "solverstate")}
        # JAX's export to the same prefix (the solverstate names its
        # .caffemodel's path)
        jpaths = jckpt.export_caffe_snapshot(prefix, 4, p_np, s_np,
                                             jd.net_msg, layer_order)
        for jpath, ext in zip(jpaths, ("caffemodel", "solverstate")):
            assert Path(jpath).read_bytes() == ours[ext], ext
        jp, js = jckpt.restore_solverstate(
            f"{prefix}_iter_4.solverstate",
            jax.tree.map(np.zeros_like, p_np), layer_order)
        assert int(js["iter"]) == 4
        for tree, ref in ((jp, p_np), (js["history"], s_np["history"])):
            for ln, lp in ref.items():
                for pn, a in lp.items():
                    assert np.asarray(tree[ln][pn]).tobytes() == a.tobytes()
        return
    runs = {}
    for ext in ("vvstate", "solverstate"):
        (_, tmsg) = _solver(mini, **dict(fields, max_iter=6, snapshot=0))
        d = tdriver.SolverDriver(tmsg, device="cpu").build()
        runs[ext] = d.train(resume_state_path=f"{prefix}_iter_2.{ext}")
    assert [i for i, _ in runs["solverstate"].metrics_history] == [2, 3, 4, 5]
    assert _losses(runs["solverstate"]) == _losses(runs["vvstate"])
    (jmsg, _) = _solver(mini, **dict(fields, max_iter=6, snapshot=0))
    jres = jdriver.SolverDriver(jmsg).build().train(
        resume_state_path=f"{prefix}_iter_2.solverstate")
    np.testing.assert_allclose(_losses(runs["solverstate"]), _losses(jres),
                               rtol=1e-5)


def test_driver_without_a_card_raises(mini, monkeypatch):
    """An entry point: the card unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (_, tmsg) = _solver(mini)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tdriver.SolverDriver(tmsg)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tdriver.SolverDriver.from_prototxt(mini["solver"])


def test_prefetchers_are_closed_after_train(mini):
    (_, tmsg) = _solver(mini, max_iter=2, test_interval=1)
    td = tdriver.SolverDriver(tmsg, device="cpu").build()
    seen = []
    orig = td._data_iter

    def spy(*a, **kw):
        it = orig(*a, **kw)
        seen.append(td._prefetchers[-1])
        return it
    td._data_iter = spy
    td.train()
    assert len(seen) == 2 and td._prefetchers == []
    for pf in seen:
        pf._thread.join(timeout=5.0)
        assert not pf._thread.is_alive()
    assert os.path.exists(str(mini["tmp"] / "snap_iter_2.vvmodel"))


def test_compute_dtype_reaches_the_train_net_only(mini):
    """Solver `compute_dtype: "bfloat16"`: the TRAIN net's INNER_PRODUCT
    operands in bf16, the TEST nets' in f32 (the reference's numerics for
    the eval), as in JAX's driver; the TRAIN net still trains."""
    (_, tmsg) = _solver(mini, max_iter=2, test_interval=2,
                        compute_dtype="bfloat16")
    td = tdriver.SolverDriver(tmsg, device="cpu").build()
    assert td.train_net.compute_dtype == torch.bfloat16
    assert [n.compute_dtype for n in td.test_nets] == [None]
    res = td.train()
    assert all(np.isfinite(_losses(res)))
    assert td.rebuild().train_net.compute_dtype == torch.bfloat16
