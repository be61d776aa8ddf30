"""The port's prototxt parser (videovector_tpu_torch.config) and
SolverConfig.from_message against the JAX package's, on the CPU: the same
text parses to the same Message tree (same keys, order, value types and
values), prints the same text, and fails with the same error; the V0
upgrade gives the same V1 net."""

import glob
import math
import os
import sys

import pytest

from videovector_tpu.config import textformat as jtf
from videovector_tpu.config import upgrade as jup
from videovector_tpu.solver import solvers as jsol
from videovector_tpu_torch.config import textformat as ttf
from videovector_tpu_torch.config import upgrade as tup
from videovector_tpu_torch.solver import solvers as tsol

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLVER = os.path.join(ROOT, "projects", "videovec_embedding",
                      "mednet_embedding_train_solver.prototxt")


def _same(tm, jm):
    """Two Message trees equal field by field: names in order, value types
    and values (NaN equal to NaN, -0.0 told from 0.0)."""
    assert type(tm).__name__ == type(jm).__name__ == "Message"
    assert list(tm.fields) == list(jm.fields)
    for k in tm.fields:
        tv, jv = tm.fields[k], jm.fields[k]
        assert len(tv) == len(jv), k
        for a, b in zip(tv, jv):
            if type(b).__name__ == "Message":
                _same(a, b)
                continue
            assert type(a) is type(b), (k, a, b)
            if isinstance(b, float):
                assert (math.isnan(a) and math.isnan(b)) or (
                    a == b and math.copysign(1, a) == math.copysign(1, b)), (k, a, b)
            else:
                assert a == b, (k, a, b)


def _flagship_net_texts():
    sys.path.insert(0, os.path.join(ROOT, "projects", "videovec_embedding"))
    try:
        from generate_net import emit
    finally:
        sys.path.pop(0)
    return [emit("train.vvr", "test.vvr"),
            emit("train.vvr", "test.vvr", device_negatives=True,
                 id_to_class_file="ids.csv", buffer_size=100)]


# the inputs of tests/test_textformat.py, and a few more of each token kind
TEXTS = [
    """
    name: "net"   # comment
    base_lr: 0.001
    max_iter: 200000
    lr_policy: "inv"
    momentum: 0.9
    snapshot_after_train: true
    solver_mode: GPU
    """,
    """
    layers { name: "a" type: SLICE bottom: "x" top: "t1" top: "t2" }
    layers { name: "b" type: CONCAT include: { phase: TRAIN } }
    """,
    'layers { include: { phase: TEST } }',
    r'''path: "a\"b" multi: "one" "two"''',
    'name: "n"\nlayers {\n  type: SLICE\n  coeff: 0.25\n}',
    'source: "café"',
    r'source: "\303\251"',
    r'source: "q\x41\n"',
    "rand_skip: 0x10",
    "rand_skip: 0XFF",
    'source: "true"', 'source: "false"', 'source: "inf"', 'source: "nan"',
    "a: -0 b: -0.0 c: +3 d: .5e1 e: 1e-3 f: inf g: nan h: -0x1F; i: 7, j: 8",
    "s: 'single \\' quoted' t: \"tab\\there\" // c++ comment\n u: \"\\a\\b\\f\\v\\?\\0\"",
    "dotted.ident: some.enum.Value x { y { z: 1 } } x { }",
]
BAD_TEXTS = ["a: @", "a { b: 1", "}", "a: {", "a", "a b", 'a: "\\q"',
             'a: "\\x"', "a: ;", "1: 2", 'a: "x\\'] + ["a { } }"]


@pytest.mark.parametrize("text", TEXTS + _flagship_net_texts())
def test_parse_and_dumps_equal_jax(text):
    tm, jm = ttf.parse(text), jtf.parse(text)
    _same(tm, jm)
    assert tm.to_dict().keys() == jm.to_dict().keys()
    assert tm.dumps() == jm.dumps()
    _same(ttf.parse(tm.dumps()), jtf.parse(jm.dumps()))


@pytest.mark.parametrize("text", BAD_TEXTS)
def test_parse_errors_equal_jax(text):
    with pytest.raises(ValueError) as je:
        jtf.parse(text)
    with pytest.raises(ValueError) as te:
        ttf.parse(text)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("path", sorted(
    p for d in ("projects", "tests")
    for p in glob.glob(os.path.join(ROOT, d, "**", "*.prototxt"),
                       recursive=True)))
def test_every_prototxt_in_the_repo_parses_as_in_jax(path):
    tm, jm = ttf.parse_file(path), jtf.parse_file(path)
    assert tm.fields
    _same(tm, jm)
    assert tm.dumps() == jm.dumps()


def test_message_accessors_equal_jax():
    text = _flagship_net_texts()[0]
    tm, jm = ttf.parse(text), jtf.parse(text)
    for t, j in zip(tm.get_list("layers"), jm.get_list("layers")):
        assert t.get("name") == j.get("name") and ("include" in t) == (
            "include" in j)
        assert t.get_msg("include").get("phase") == \
            j.get_msg("include").get("phase")
        assert t.get_msg("absent").fields == {} and not t.has("absent")
        assert list(t) == list(j) and repr(t) == repr(j)
    p = next(l for l in tm.get_list("layers")
             if l.get("type") == "VIDEO_SAMPLED_SHOTS_DATA") \
        .get_msg("video_sampled_shots_data_param")
    assert (p.get("batch_size"), p.get("num_negative_samples"),
            p.get("max_buffer_size"), p.get("context_type"),
            p.get("context_size")) == (128, 10, 5000, "WINDOW", 5)


# -- V0 upgrade: the nets of tests/test_upgrade_v0.py ------------------------

V0_NETS = [
    """
    layers { layer { name: "d" type: "data" source: "/db" batchsize: 32
                     scale: 0.00390625 cropsize: 227 mirror: true
                     meanfile: "/mean.bp" rand_skip: 7 } top: "data" top: "label" }
    """,
    """
    layers { layer { name: "im" type: "images" source: "/list.txt"
                     batchsize: 8 shuffle_images: true new_height: 256
                     new_width: 256 rand_skip: 3 } top: "data" top: "label" }
    layers { layer { name: "w" type: "window_data" source: "/win.txt"
                     batchsize: 4 det_fg_threshold: 0.5
                     det_bg_threshold: 0.3 det_fg_fraction: 0.25
                     det_context_pad: 16 det_crop_mode: "warp" }
             top: "wdata" top: "wlabel" }
    """,
    """
    input: "x" input_dim: 1 input_dim: 1 input_dim: 8 input_dim: 8
    layers { layer { name: "p" type: "pool" pool: "ave" kernelsize: 2
                     stride: 2 } bottom: "x" top: "p" }
    layers { layer { name: "c" type: "concat" concat_dim: 1 }
             bottom: "p" bottom: "p" top: "c" }
    """,
    """
    input: "x" input_dim: 1 input_dim: 1 input_dim: 8 input_dim: 8
    layers { layer { name: "padder" type: "padding" pad: 2 }
             bottom: "x" top: "xp" }
    layers { layer { name: "p" type: "pool" pool: "max" kernelsize: 3 }
             bottom: "xp" top: "y" }
    """,
    """
    input: "x" input_dim: 1 input_dim: 1 input_dim: 8 input_dim: 8
    layers { layer { name: "c1" type: "conv" num_output: 2 kernelsize: 3 }
             bottom: "x" top: "h" }
    layers { layer { name: "padder" type: "padding" pad: 1 }
             bottom: "h" top: "h" }
    layers { layer { name: "c2" type: "conv" num_output: 2 kernelsize: 3 }
             bottom: "h" top: "y" }
    """,
    """
    layers { layer { name: "mem" type: "data" } top: "x" top: "t" }
    layers { layer { name: "padder" type: "padding" pad: 1 }
             bottom: "x" top: "xp" }
    layers { layer { name: "c1" type: "conv" num_output: 4 kernelsize: 3
                     weight_filler { type: "gaussian" std: 0.1 } }
             bottom: "xp" top: "h" }
    layers { layer { name: "p1" type: "pool" pool: "max" kernelsize: 2
                     stride: 2 } bottom: "h" top: "hp" }
    layers { layer { name: "ip" type: "innerproduct" num_output: 3
                     weight_filler { type: "xavier" } }
             bottom: "hp" top: "pred" }
    layers { layer { name: "l" type: "euclidean_loss" }
             bottom: "pred" bottom: "t" top: "loss" }
    """,
    """
    name: "v0"
    input: "data"
    layers { layer { name: "p" type: "padding" pad: 2 }
             bottom: "data" top: "pd" }
    layers { layer { name: "c" type: "conv" num_output: 4 kernelsize: 3
                     new_num: 7 new_channels: 3 group: 2 blobs_lr: 1
                     weight_decay: 0 dropout_ratio_extra: 1 }
             bottom: "pd" top: "co" }
    layers { layer { name: "l" type: "lrn" local_size: 5 alpha: 0.1 beta: 0.75 } }
    layers { layer { name: "dr" type: "dropout" dropout_ratio: 0.5 } }
    layers { layer { name: "h" type: "hdf5_output"
                     hdf5_output_param { file_name: "o.h5" } } }
    """,
]
V0_BAD = [
    ("""input: "x" input_dim: 1
        layers { layer { name: "padder" type: "padding" pad: 1 }
                 bottom: "x" top: "xp" }
        layers { layer { name: "r" type: "relu" } bottom: "xp" top: "y" }""",
     "non-conv/pool"),
    ("""input: "x" input_dim: 1
        layers { layer { name: "r" type: "relu" num_output: 4 }
                 bottom: "x" top: "y" }""", "unknown parameter"),
    ("""layers { layer { name: "r" type: "relu" } bottom: "ghost" top: "y" }""",
     "unknown blob input"),
    ("""layers { layer { name: "r" type: "mystery" } }""", "unknown layer type"),
    ("""input: "x"
        layers { layer { name: "p" type: "padding" pad: 1 }
                 bottom: "x" top: "xp" }
        layers { layer { name: "c" type: "conv" } bottom: "xp" bottom: "x"
                 top: "y" }""", "single-input"),
]


@pytest.mark.parametrize("text", V0_NETS)
def test_upgrade_net_equals_jax(text):
    tm, jm = ttf.parse(text), jtf.parse(text)
    assert tup.net_needs_upgrade(tm) and jup.net_needs_upgrade(jm)
    before = tm.dumps()
    tu, ju = tup.upgrade_net(tm), jup.upgrade_net(jm)
    _same(tu, ju)
    assert tu.dumps() == ju.dumps()
    assert tm.dumps() == before                     # input untouched
    for tl, jl in zip(tm.get_list("layers"), jm.get_list("layers")):
        if tl.get_msg("layer").get("type") != "padding":
            _same(tup.upgrade_layer(tl), jup.upgrade_layer(jl))


@pytest.mark.parametrize("text,match", V0_BAD)
def test_upgrade_errors_equal_jax(text, match):
    with pytest.raises(ValueError, match=match) as je:
        jup.upgrade_net(jtf.parse(text))
    with pytest.raises(ValueError) as te:
        tup.upgrade_net(ttf.parse(text))
    assert str(te.value) == str(je.value)


def test_a_v1_net_is_not_upgraded():
    text = _flagship_net_texts()[0]
    tm = ttf.parse(text)
    assert not tup.net_needs_upgrade(tm) and tup.upgrade_net(tm) is tm


# -- SolverConfig.from_message ----------------------------------------------

SOLVER_TEXTS = [
    open(SOLVER).read(),
    """net: "n.prototxt" train_net: "t" test_net: "a" test_net: "b"
       solver_type: NESTEROV solver_mode: CPU device_id: 2 test_iter: 3
       test_iter: 4 iter_size: 2 grad_microbatch: 4 snapshot_diff: true
       test_compute_loss: true snapshot_format: "caffe" random_seed: 7
       regularization_type: "L1" lr_policy: "step" stepsize: 10
       snapshot_after_train: false test_initialization: false""",
    "solver_type: 2 delta: 1e-6 base_lr: 0.1",
]


@pytest.mark.parametrize("text", SOLVER_TEXTS)
def test_solver_config_from_message_equals_jax(text):
    t = tsol.SolverConfig.from_message(ttf.parse(text))
    j = jsol.SolverConfig.from_message(jtf.parse(text))
    names = [f for f in tsol.SolverConfig.__dataclass_fields__]
    assert names == [f for f in jsol.SolverConfig.__dataclass_fields__]
    for f in names:
        assert getattr(t, f) == getattr(j, f), f
        assert type(getattr(t, f)) is type(getattr(j, f)), f
    assert t.extras == j.extras


def test_the_repo_solver_prototxt_field_by_field():
    """The flagship solver as the port reads it (its values are the
    reference's schedule; dropout_prng "rbg" is checked and kept, while the
    port draws its masks from Philox either way)."""
    cfg = tsol.SolverConfig.from_message(ttf.parse_file(SOLVER))
    assert (cfg.base_lr, cfg.lr_policy, cfg.gamma, cfg.power, cfg.momentum,
            cfg.weight_decay, cfg.max_iter, cfg.display, cfg.test_interval,
            cfg.test_iter, cfg.snapshot, cfg.dropout_prng, cfg.random_seed) \
        == (0.001, "inv", 0.001, 0.75, 0.9, 0.0005, 200000, 10, 50, (1,),
            2000, "rbg", -1)
    assert cfg.extras == {
        "net": "projects/videovec_embedding/mednet_embedding_train.prototxt"}
    with pytest.raises(ValueError, match="dropout_prng"):
        tsol.SolverConfig.from_message(ttf.parse('dropout_prng: "philox"'))
    with pytest.raises(ValueError, match="AdaGrad"):
        tsol.SolverConfig.from_message(ttf.parse(
            "solver_type: ADAGRAD momentum: 0.9"))
