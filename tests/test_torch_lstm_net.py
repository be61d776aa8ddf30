"""Item 9 through the port's graph engine, solver loop, driver and CLI,
against the JAX package's on the CPU.

- The six LSTM-family types (LSTM, LSTM_LINEAR, LSTM_ENC_DEC,
  LSTM_CONDITIONAL, LSTM_SINGLE_STEP, SOCIAL_POOLING) in one prototxt
  through each package's own Net, on JAX's params: every top within rtol
  1e-5 / atol 1e-6, the gradient of every param within rtol 1e-4 /
  atol 1e-5.
- `Net.apply(state=, return_state=True)` on tests/test_lstm_workload.py's
  CARRY_NET: the outputs and the carry against JAX's within rtol 1e-5 /
  atol 1e-6, a JAX carry handed to the port through
  `convert.lstm_state_from_jax`.
- `train` with the carry over 4 batches against JAX's `train`: the params
  within rtol 1e-5 / atol 1e-6.
- projects/trajectory_forecast at its widths (hidden 32, batch 16, T 8 + 4)
  through both CLIs from one .vvmodel of JAX's initial params: the losses
  at every display within 1e-4 relative, the TEST outputs too; `test` on
  the port's .vvmodel snapshot through both CLIs within 1e-4 relative.
- `time` on a stateful net.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_lstm_workload import CARRY_NET
from test_torch_driver import Lines
from videovector_tpu.config.textformat import parse as jparse
from videovector_tpu.graph.net import Net as JNet
from videovector_tpu.ops.recurrent import LstmState as JState
from videovector_tpu.solver import SolverConfig as JSolverConfig
from videovector_tpu.solver.train import train as jtrain
from videovector_tpu_torch import convert
from videovector_tpu_torch.config.textformat import parse as tparse
from videovector_tpu_torch.graph.net import Net as TNet
from videovector_tpu_torch.ops.recurrent import LstmState
from videovector_tpu_torch.solver import SolverConfig
from videovector_tpu_torch.solver.checkpoint import snapshot
from videovector_tpu_torch.solver.train import train as ttrain
from videovector_tpu_torch.tools import make_tracking_data
from videovector_tpu_torch.tools.cli import main as tmain
from videovector_tpu_torch.tools.make_tracking_data import write_windows

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
G_RTOL, G_ATOL = 1e-4, 1e-5
ROOT = Path(__file__).resolve().parent.parent
PROJECT = ROOT / "projects" / "trajectory_forecast"


def _project(name):
    # loaded by path: the embedding project has modules of the same names
    spec = importlib.util.spec_from_file_location(
        f"trajproj_{name}", PROJECT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LSTM_ZOO = """
name: "lstm_zoo"
layers { name: "d" type: MEMORY_DATA top: "x" top: "cont" top: "x2"
  top: "cont2" top: "first" top: "xs" top: "c0" top: "h0" top: "feats"
  top: "rel" top: "mean" }
layers { name: "rnn" type: LSTM bottom: "x" bottom: "cont" top: "h1"
  inner_product_param { num_output: 6
    weight_filler { type: "gaussian" std: 0.3 } } }
layers { name: "rnn_lin" type: LSTM_LINEAR bottom: "x" bottom: "cont"
  top: "h2" inner_product_param { num_output: 5 }
  lstm_param { clipping_threshold: 0.05 } }
layers { name: "encdec" type: LSTM_ENC_DEC bottom: "x" bottom: "cont"
  bottom: "x2" bottom: "cont2" top: "enc_h" top: "dec_h"
  inner_product_param { num_output: 4 weight_filler { type: "gaussian" } } }
layers { name: "cond" type: LSTM_CONDITIONAL bottom: "x" bottom: "cont"
  bottom: "first" top: "cout"
  inner_product_param { num_output: 4
    weight_filler { type: "gaussian" std: 0.2 } }
  lstm_param { final_output_size: 3 clipping_threshold: 2.0 } }
layers { name: "single" type: LSTM_SINGLE_STEP bottom: "xs" bottom: "c0"
  bottom: "h0" top: "hs" top: "cs"
  inner_product_param { num_output: 7
    weight_filler { type: "gaussian" std: 0.3 } } }
layers { name: "social" type: SOCIAL_POOLING bottom: "feats" bottom: "rel"
  bottom: "mean" top: "pooled" social_pooling_param { pool_feat_size: 8 } }
"""
ZOO_TOPS = ("h1", "h2", "enc_h", "dec_h", "cout", "hs", "cs", "pooled")


def _write_tracks(path, rng, n, tracks_per=4, t_obs=8, t_pred=4):
    """The project's synthetic windows, written by the port
    (tools/make_tracking_data.py)."""
    return write_windows(str(path), rng, n, tracks_per, t_obs, t_pred)


def test_port_writes_the_projects_synthetic_stores(tmp_path):
    """tools/make_tracking_data.py writes the bytes the project's
    make_synthetic_data.py writes from the same seed (its windows through
    the JAX package's writer), with the same defaults."""
    from videovector_tpu.data.records import RecordWriter as JWriter
    proj = _project("make_synthetic_data")
    rng = np.random.RandomState(0)
    want = tmp_path / "jax.vvr"
    with JWriter(str(want)) as w:
        for i, win in enumerate(proj.make_windows(rng, 30, 4, 8, 4)):
            w.append(f"{i:08d}", win.encode())
    assert make_tracking_data.main(
        ["--out_train", str(tmp_path / "train.vvr"), "--out_test",
         str(tmp_path / "test.vvr"), "--train_windows", "30"]) == 0
    assert (tmp_path / "train.vvr").read_bytes() == want.read_bytes()
    assert (tmp_path / "test.vvr").stat().st_size > 0


def _zoo_batch(rng, tmp_path):
    """The zoo's inputs; the social ones from a TRACKING_WINDOWS_SOCIAL_DATA
    batch of the project's windows (the last observed offsets, the scene
    blocks, the mean positions)."""
    from videovector_tpu_torch.data.tracking import (
        TrackingConfig, TrackingWindowDataset, TrackingWindowsSocialSource,
    )
    store = _write_tracks(tmp_path / "social.vvr", rng, 6, tracks_per=3)
    social = TrackingWindowsSocialSource(
        TrackingWindowDataset.from_records(store),
        TrackingConfig(batch_size=8, temporal_observed_size=8,
                       temporal_predicted_size=4)).next_batch()
    t, b, i = 5, 8, 3
    cont = np.ones((t, b), np.float32)
    cont[0] = 0.0
    cont[2, :3] = 0.0
    f = np.float32
    return {"x": rng.randn(t, b, i).astype(f), "cont": cont,
            "x2": rng.randn(3, b, i).astype(f),
            "cont2": np.ones((3, b), f),
            "first": rng.randn(b, 3).astype(f),
            "xs": rng.randn(b, 4).astype(f), "c0": rng.randn(b, 7).astype(f),
            "h0": rng.randn(b, 7).astype(f),
            "feats": social["observed"][-1][None],
            "rel": social["relations"][None],
            "mean": social["mean_pos"][None]}


def _jax_net(text, phase="TRAIN"):
    return JNet(jparse(text), phase=phase)


def _spec(batch):
    return {k: jax.ShapeDtypeStruct(np.shape(v), jnp.float32)
            for k, v in batch.items()}


def _tree_close(got, want, rtol, atol):
    for ln in want:
        for pn in want[ln]:
            np.testing.assert_allclose(
                np.asarray(got[ln][pn]), np.asarray(want[ln][pn]), rtol=rtol,
                atol=atol, err_msg=f"{ln}/{pn}")


def test_six_types_through_both_nets(rng, tmp_path):
    """Values and gradients of the six types, on the same params and batch,
    with a carried state for the two stateful ones."""
    batch = _zoo_batch(rng, tmp_path)
    jnet, tnet = _jax_net(LSTM_ZOO), TNet(tparse(LSTM_ZOO), "TRAIN")
    assert sorted(tnet.stateful_layer_names) == sorted(
        jnet.stateful_layer_names) == ["rnn", "rnn_lin"]
    jp, _ = jnet.init(jax.random.PRNGKey(0), _spec(batch))
    jp = jax.tree.map(np.asarray, jp)
    tp0, _ = tnet.init(torch.Generator().manual_seed(0),
                       {k: torch.as_tensor(v) for k, v in batch.items()})
    assert jax.tree.map(np.shape, convert.params_to_numpy(tp0)) == \
        jax.tree.map(np.shape, jp)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    _, _, jstate = jnet.apply(jp, jb, return_state=True)   # a carry to feed
    tstate = convert.lstm_state_from_jax(jax.tree.map(np.asarray, jstate))
    cr = np.random.RandomState(9)
    cots = {}

    def jscalar(p):
        _, blobs, st = jnet.apply(p, jb, state=jstate, return_blobs=True,
                                  return_state=True)
        for k in ZOO_TOPS:
            cots.setdefault(k, cr.randn(*blobs[k].shape).astype(np.float32))
        return sum(jnp.sum(blobs[k] * cots[k]) for k in ZOO_TOPS), (blobs, st)
    (_, (jblobs, jst)), jg = jax.value_and_grad(jscalar, has_aux=True)(
        jax.tree.map(jnp.asarray, jp))

    tp = convert.map_params(lambda t: t.requires_grad_(True),
                            convert.params_from_jax(jp))
    _, tblobs, tst = tnet.apply(tp, tb, state=tstate, return_blobs=True,
                                return_state=True)
    for k in ZOO_TOPS:
        assert tuple(tblobs[k].shape) == tuple(jblobs[k].shape), k
        np.testing.assert_allclose(tblobs[k].detach().numpy(),
                                   np.asarray(jblobs[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert sorted(tst) == sorted(jst) == ["rnn", "rnn_lin"]
    for name in tst:
        for got, want in zip(tst[name], jst[name]):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)
    sum((tblobs[k] * torch.as_tensor(cots[k])).sum() for k in ZOO_TOPS
        ).backward()
    _tree_close(convert.map_params(lambda t: t.grad.numpy(), tp), jg,
                G_RTOL, G_ATOL)


@pytest.mark.parametrize("ltype", ["LSTM", "LSTM_LINEAR", "LSTM_ENC_DEC",
                                   "LSTM_CONDITIONAL", "LSTM_SINGLE_STEP",
                                   "SOCIAL_POOLING"])
def test_each_item9_type_builds_and_runs_in_a_net(rng, ltype):
    """Each type alone in a Net: built (no NotImplementedError), its params
    initialized by the port with the proto defaults (a weight_filler
    without std gives std 1, no filler 0.1, the forget bias 5,
    final_output_size 1, SOCIAL_POOLING's gaussian 0.1 and zero bias), its
    forward run and differentiable."""
    t, b, i, h = 4, 64, 32, 64
    f = np.float32
    inputs = {"x": rng.randn(t, b, i).astype(f), "cont": np.ones((t, b), f),
              "first": rng.randn(b, 1).astype(f),
              "xs": rng.randn(b, i).astype(f),
              "feats": rng.randn(1, b, 3).astype(f),
              "rel": np.ones((1, b, b), f)}
    bottoms = {"LSTM": ["x", "cont"], "LSTM_LINEAR": ["x", "cont"],
               "LSTM_ENC_DEC": ["x", "cont", "x", "cont"],
               "LSTM_CONDITIONAL": ["x", "cont", "first"],
               "LSTM_SINGLE_STEP": ["xs"],
               "SOCIAL_POOLING": ["feats", "rel"]}[ltype]
    tops = {"LSTM_ENC_DEC": ["e", "d"], "LSTM_SINGLE_STEP": ["hs", "cs"]
            }.get(ltype, ["y"])
    filler = {"LSTM": 'weight_filler { type: "gaussian" }',
              "LSTM_ENC_DEC": 'weight_filler { type: "gaussian" std: 0.5 }'
              }.get(ltype, "")
    text = (f'layers {{ name: "d" type: MEMORY_DATA '
            + " ".join(f'top: "{k}"' for k in dict.fromkeys(bottoms))
            + f' }}\nlayers {{ name: "l" type: {ltype} '
            + " ".join(f'bottom: "{k}"' for k in bottoms) + " "
            + " ".join(f'top: "{k}"' for k in tops)
            + f" inner_product_param {{ num_output: {h} {filler} }} }}")
    net = TNet(tparse(text), "TRAIN")
    batch = {k: torch.as_tensor(inputs[k]) for k in dict.fromkeys(bottoms)}
    params, _ = net.init(torch.Generator().manual_seed(3), batch)
    p = params["l"]
    std = {"LSTM": 1.0, "LSTM_ENC_DEC": 0.5}.get(ltype, 0.1)
    if ltype == "SOCIAL_POOLING":
        assert p["w"].shape == (2, 32) and not p["b"].any()
        assert abs(p["w"].std().item() / 0.1 - 1) < 0.3
    else:
        pre = "enc_" if ltype == "LSTM_ENC_DEC" else ""
        w = p[pre + "w_h"]
        assert w.shape == (h, 4 * h)
        assert abs(w.std().item() / std - 1) < 0.05
        assert torch.all(p[pre + "b"][h:2 * h] == 5.0)
        if ltype == "LSTM_CONDITIONAL":
            assert p["w_h2o"].shape == (h, 1)   # final_output_size 1
    tp = convert.map_params(lambda x: x.requires_grad_(True), params)
    _, outs = net.apply(tp, batch)
    assert outs and all(torch.isfinite(v).all() for v in outs.values())
    sum(v.sum() for v in outs.values()).backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all()
               for x in tp["l"].values())


def _carry_batches(rng, n, t=4, b=3, i=5, h=8):
    out = []
    for j in range(n):
        cont = np.ones((t, b), np.float32)
        if j == 0:
            cont[0] = 0
        out.append({"x": rng.randn(t, b, i).astype(np.float32), "cont": cont,
                    "y": rng.randn(t, b, h).astype(np.float32)})
    return out


def test_apply_threads_the_carry_as_jax_does(rng):
    """CARRY_NET over two batches: the second forward from the first's
    carry equals JAX's (the port's own carry and JAX's converted one); a
    cont of 0 at the second batch's start makes the carry inert."""
    b1, b2 = _carry_batches(rng, 2)
    jnet, tnet = _jax_net(CARRY_NET), TNet(tparse(CARRY_NET), "TRAIN")
    jp, _ = jnet.init(jax.random.PRNGKey(3), _spec(b1))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    tnet.init(torch.Generator().manual_seed(0),
              {k: torch.as_tensor(v) for k, v in b1.items()})

    def jrun(b, st):
        return jnet.apply(jp, {k: jnp.asarray(v) for k, v in b.items()},
                          state=st, return_blobs=True, return_state=True)

    def trun(b, st):
        with torch.no_grad():
            return tnet.apply(tp, {k: torch.as_tensor(v) for k, v in b.items()},
                              state=st, return_blobs=True, return_state=True)
    jl1, jbl1, jst1 = jrun(b1, None)
    tl1, tbl1, tst1 = trun(b1, None)
    jl2, jbl2, jst2 = jrun(b2, jst1)
    for carry in (tst1, convert.lstm_state_from_jax(
            jax.tree.map(np.asarray, jst1))):
        tl2, tbl2, tst2 = trun(b2, carry)
        np.testing.assert_allclose(tbl2["h"].numpy(), np.asarray(jbl2["h"]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tl2.item(), float(jl2), rtol=RTOL)
        for got, want in zip(convert.lstm_state_to_numpy(tst2)["rnn"],
                             JState(*jst2["rnn"])):
            np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                       atol=ATOL)
    np.testing.assert_allclose(tbl1["h"].numpy(), np.asarray(jbl1["h"]),
                               rtol=RTOL, atol=ATOL)
    assert isinstance(tst1["rnn"], LstmState)
    # without the carry the second batch differs; with cont 0 at its start
    # the carry changes nothing
    _, reset, _ = trun(b2, None)
    assert not np.allclose(reset["h"].numpy(), tbl2["h"].numpy(), atol=1e-4)
    restart = dict(b2, cont=b2["cont"].copy())
    restart["cont"][0] = 0
    _, a, _ = trun(restart, None)
    _, b, _ = trun(restart, tst1)
    np.testing.assert_allclose(a["h"].numpy(), b["h"].numpy(), rtol=1e-6)


def test_train_threads_the_carry_as_jax_does(rng):
    """train over CARRY_NET's 4 batches, the carry riding "__carry__"
    (truncated BPTT: it enters each batch as a constant), against JAX's
    train: the params within rtol 1e-5, the final carries too, and the
    carry handed back through initial_carry."""
    batches = _carry_batches(rng, 4)
    jnet, tnet = _jax_net(CARRY_NET), TNet(tparse(CARRY_NET), "TRAIN")
    jp, _ = jnet.init(jax.random.PRNGKey(5), _spec(batches[0]))
    tnet.init(torch.Generator().manual_seed(0),
              {k: torch.as_tensor(v) for k, v in batches[0].items()})

    def jloss(p, batch, key):
        feed = {k: v for k, v in batch.items() if k != "__carry__"}
        loss, _, carry = jnet.apply(p, feed, rng=key,
                                    state=batch.get("__carry__"),
                                    return_state=True)
        return loss, {"__carry__": carry}

    def tloss(p, batch, generator):
        feed = {k: v for k, v in batch.items() if k != "__carry__"}
        loss, _, carry = tnet.apply(p, feed, generator=generator,
                                    state=batch.get("__carry__"),
                                    return_state=True)
        return loss, {"__carry__": carry}

    kw = dict(base_lr=0.05, momentum=0.9, max_iter=4)
    jres = jtrain(jloss, jp, iter([{k: jnp.asarray(v) for k, v in b.items()}
                                   for b in batches]), JSolverConfig(**kw))
    tres = ttrain(tloss, convert.params_from_jax(
        jax.tree.map(np.asarray, jp)), iter(batches), SolverConfig(**kw),
        device="cpu")
    _tree_close(convert.params_to_numpy(tres.params),
                jax.tree.map(np.asarray, jres.params), RTOL, ATOL)
    for got, want in zip(convert.lstm_state_to_numpy(tres.final_carry)["rnn"],
                         jres.final_carry["rnn"]):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    assert not tres.final_carry["rnn"].c.requires_grad
    # continuing from the final carry (initial_carry) equals running on:
    # plain SGD keeps no history, so 4 + 1 steps are 5 steps
    five = batches + _carry_batches(rng, 1)
    sgd = dict(base_lr=0.05, momentum=0.0)
    start = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    whole = ttrain(tloss, start, iter(five), SolverConfig(**sgd, max_iter=5),
                   device="cpu")
    first = ttrain(tloss, start, iter(five[:4]),
                   SolverConfig(**sgd, max_iter=4), device="cpu")
    rest = ttrain(tloss, first.params, iter(five[4:]),
                  SolverConfig(**sgd, max_iter=1), device="cpu",
                  initial_carry=first.final_carry)
    _tree_close(convert.params_to_numpy(rest.params),
                convert.params_to_numpy(whole.params), 1e-6, 1e-7)
    assert torch.equal(rest.final_carry["rnn"].h, whole.final_carry["rnn"].h)


def test_fused_accumulation_refuses_a_carry(rng):
    """The fused microbatch step cannot thread the carry: JAX's message."""
    batches = _carry_batches(rng, 4, b=4)
    tnet = TNet(tparse(CARRY_NET), "TRAIN")
    params, _ = tnet.init(torch.Generator().manual_seed(0), {
        k: torch.as_tensor(v) for k, v in batches[0].items()})

    def tloss(p, batch, generator):
        loss, _, carry = tnet.apply(p, batch, return_state=True)
        return loss, {"__carry__": carry}
    with pytest.raises(ValueError, match="fused_accum=False"):
        ttrain(tloss, params, iter(batches), SolverConfig(
            base_lr=0.05, max_iter=2, iter_size=2), device="cpu")
    res = ttrain(tloss, params, iter(batches), SolverConfig(
        base_lr=0.05, max_iter=2, iter_size=2), device="cpu",
        fused_accum=False)
    assert res.final_carry is not None


def _trajectory_project(tmp_path, rng):
    """The project's prototxt (generate_net.emit at its defaults) over
    stores the port writes, and a copy of its solver (the net's path,
    max_iter 60, a display every 20, a test every 30 over 5 batches, a
    snapshot every 30 into tmp_path)."""
    train = _write_tracks(tmp_path / "tracks_train.vvr", rng, 60)
    test = _write_tracks(tmp_path / "tracks_test.vvr", rng, 20)
    net = tmp_path / "trajectory_train.prototxt"
    net.write_text(_project("generate_net").emit(train, test))
    fields = {"net": f'"{net}"', "max_iter": "60", "display": "20",
              "test_interval": "30", "test_iter": "5", "snapshot": "30",
              "snapshot_prefix": f'"{tmp_path / "traj"}"'}
    lines = []
    for line in (PROJECT / "trajectory_solver.prototxt").read_text().splitlines():
        key = line.split(":")[0].strip()
        lines.append(f"{key}: {fields.pop(key)}" if key in fields else line)
    solver = tmp_path / "trajectory_solver.prototxt"
    solver.write_text("\n".join(lines + [f"{k}: {v}" for k, v in
                                         fields.items()]) + "\n")
    return str(net), str(solver)


def test_trajectory_project_through_both_clis(rng, tmp_path):
    from videovector_tpu.solver.driver import SolverDriver as JDriver
    from videovector_tpu.tools.cli import main as jmain
    net, solver = _trajectory_project(tmp_path, rng)
    init = snapshot(str(tmp_path / "init"), 0, jax.tree.map(
        np.asarray, JDriver.from_prototxt(solver).build().params))[0]
    argv = ["train", "--solver", solver, "--weights", init, "--cpu"]
    with Lines() as tout:
        assert tmain(argv) == 0
    snap = tmp_path / "traj_iter_60.vvmodel"
    assert snap.is_file() and (tmp_path / "traj_iter_30.vvstate").is_file()
    (tmp_path / "traj_iter_60.vvmodel").rename(tmp_path / "port.vvmodel")
    with Lines("videovector_tpu") as jout:
        assert jmain(argv) == 0

    def numbers(out, fmt, n=2):
        return [tuple(r.args[:n]) for r in out.records if r.msg == fmt]
    tl = numbers(tout, "Iteration %d, loss = %g")
    jl = numbers(jout, "Iteration %d, loss = %g")
    assert [i for i, _ in tl] == [i for i, _ in jl] == [0, 20, 40, 60]
    np.testing.assert_allclose([float(v) for _, v in tl],
                               [float(v) for _, v in jl], rtol=1e-4)
    assert float(tl[-1][1]) < 0.5 * float(tl[0][1])   # it learns
    fmt = "    Test net output #%d: %s = %g%s"
    tt = [r.args[1:3] for r in tout.records if r.msg == fmt]
    jt = [r.args[1:3] for r in jout.records if r.msg == fmt]
    assert [k for k, _ in tt] == [k for k, _ in jt] == ["displacement_loss"] * 3
    np.testing.assert_allclose([float(v) for _, v in tt],
                               [float(v) for _, v in jt], rtol=1e-4)

    argv = ["test", "--model", net, "--weights", str(tmp_path / "port.vvmodel"),
            "--iterations", "5", "--cpu"]
    with Lines() as tout:
        assert tmain(argv) == 0
    with Lines("videovector_tpu") as jout:
        assert jmain(argv) == 0
    tm = numbers(tout, "%s = %g%s")
    jm = numbers(jout, "%s = %g%s")
    assert [k for k, _ in tm] == [k for k, _ in jm] == ["displacement_loss"]
    np.testing.assert_allclose(float(tm[0][1]), float(jm[0][1]), rtol=1e-4)


STATEFUL_DEPLOY = """
name: "lstm_deploy"
input: "x" input_dim: 4 input_dim: 3 input_dim: 5 input_dim: 1
input: "cont" input_dim: 4 input_dim: 3 input_dim: 1 input_dim: 1
layers { name: "rnn" type: LSTM bottom: "x" bottom: "cont" top: "h"
  inner_product_param { num_output: 8 } }
layers { name: "lin" type: LSTM_LINEAR bottom: "h" bottom: "cont" top: "h2"
  inner_product_param { num_output: 4 } }
"""


@pytest.mark.parametrize("flags", [[], ["--backward"], ["--per_layer",
                                                          "isolated"]])
def test_time_on_a_stateful_net(tmp_path, flags):
    """`time` on a deploy-style stateful net (no carry across the timed
    forwards: each starts from the zero state): a marginal or per-layer
    line for both LSTM layers and the fused line."""
    path = tmp_path / "deploy.prototxt"
    path.write_text(STATEFUL_DEPLOY)
    with Lines() as out:
        assert tmain(["time", "--model", str(path), "--iterations", "2",
                      "--cpu"] + flags) == 0
    lines = out.lines
    assert sum(l.startswith(("rnn ", "lin ")) for l in lines) >= 2
    assert any(l.startswith("Fused forward-backward") for l in lines)
