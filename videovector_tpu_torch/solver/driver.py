"""SolverDriver: end-to-end orchestration from prototxt files; counterpart of
videovector_tpu/solver/driver.py.

The `caffe train --solver=...` path (ref:tools/caffe.cpp:80-123 ->
Solver::Init, src/caffe/solver.cpp:33-157): parse the solver prototxt, build
the TRAIN net and the TEST nets from the net prototxt it names, build the
host data sources from their data-layer configs, and run the training loop
with test-interval evaluation, snapshots and resume or finetune. Batches
reach the card through data/prefetch.py (pinned buffers, the copy on a side
stream, overlapping the step).

An entry point: it runs on the card unless asked for the CPU
(`device="cpu"`), and raises without a card. `train(mesh=)` trains over a
parallel.make_mesh mesh, one process a device: each rank feeds its rows of
every batch, the Net's 2-D params are column-sharded when the mesh has a
model axis, rank 0 writes the snapshots and logs; `shard_gallery=True`
shards the RETRIEVAL_STATS report's gallery rows. Orbax stays with the JAX
package. A data layer with `device_negatives: true` keeps its reservoir on
the card (data/device_sampler.py): the host ships (B, C, ...) rows, and the
loss function draws the negatives and updates the reservoir, which rides
the "__carry__" channel. `snapshot_vis` writes tools/vis_snapshot.py's JSON
and `debug_info` logs Net.debug_info every `display` iterations. Finetune
weights are a .vvmodel or the reference's .caffemodel; a run resumes from a
.vvstate or the reference's .solverstate, and `snapshot_format: "caffe"`
writes the reference's .caffemodel/.solverstate pair beside the npz pair.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import replace

import numpy as np
import torch

from videovector_tpu_torch.config.textformat import Message, parse_file
from videovector_tpu_torch.core.seeds import SAMPLER_STREAM, derived_seed
from videovector_tpu_torch.data.device_sampler import (
    DeviceReservoir, train_batch_with_device_negatives,
)
from videovector_tpu_torch.data.prefetch import DevicePrefetcher
from videovector_tpu_torch.data.weights import NetWeights, load_into_params
from videovector_tpu_torch.device import DEFAULT, resolve
from videovector_tpu_torch.graph.data_factory import MergedSource, make_data_source
from videovector_tpu_torch.graph.layers import DATA_LAYER_TYPES
from videovector_tpu_torch.graph.net import Net
from videovector_tpu_torch.ops import collectives
from videovector_tpu_torch.ops.sharding import MeshRun, rank_rows
from videovector_tpu_torch.solver.checkpoint import (
    export_caffe_snapshot, load_model,
)
from videovector_tpu_torch.solver.solvers import SolverConfig
from videovector_tpu_torch.solver.train import TrainResult, train
from videovector_tpu_torch.tools.vis_snapshot import vis_snapshot
from videovector_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _spec_from_batch(batch) -> dict:
    """f32 "meta" tensors of the batch's shapes (the JAX driver's f32
    ShapeDtypeStructs): shape inference without data."""
    return {k: torch.empty(tuple(np.shape(v)), dtype=torch.float32,
                           device="meta") for k, v in batch.items()}


_PHASE_NAMES = {"0": "TRAIN", "1": "TEST"}


def _merge_net_state(default_phase: str, *states):
    """(phase, level, stages) under proto MergeFrom semantics: each present
    scalar overwrites, repeated `stage` concatenates: the reference's
    NetState assembly (ref:src/caffe/solver.cpp:72-81, :141-152)."""
    phase, level, stages = default_phase, 0, []
    for st in states:
        if st is None:
            continue
        if st.has("phase"):
            p = str(st.get("phase"))
            phase = _PHASE_NAMES.get(p, p)
        if st.has("level"):
            level = int(st.get("level"))
        stages.extend(str(s) for s in st.get_list("stage"))
    return phase, level, tuple(stages)


class SolverDriver:
    def __init__(self, solver_msg: Message, *, net_dir: str = ".",
                 device=DEFAULT):
        self._solver_msg = solver_msg
        self._net_dir = net_dir
        self.device = resolve(device)
        self._prefetchers: list = []  # live DevicePrefetchers (closed per train())
        self.cfg = SolverConfig.from_message(solver_msg)
        # the reference's visualization and debug knobs (ref
        # solver.cpp:183-193, :345-416)
        self.snapshot_vis = int(solver_msg.get("snapshot_vis", 0) or 0)
        self.snapshot_vis_dir = solver_msg.get("snapshot_vis_dir", ".")
        # csv blob selection and sample truncation (ref solver.cpp:352-353,
        # 401-405: an empty csv is every blob; truncate_len 0 the default)
        vis_blobs = solver_msg.get("snapshot_vis_blobs", "") or ""
        self.snapshot_vis_blobs = [b for b in vis_blobs.split(",") if b]
        self.snapshot_vis_truncate = int(
            solver_msg.get("snapshot_vis_truncate_len", 0) or 0)
        self.debug_info_every = (int(solver_msg.get("display", 0) or 0)
                                 if solver_msg.get("debug_info") else 0)

        def resolve_path(p):
            if p and not os.path.isabs(p):
                cand = os.path.join(net_dir, p)
                return cand if os.path.exists(cand) else p
            return p

        # exactly ONE of the four train-net fields (ref InitTrainNet
        # CHECK_GE/CHECK_LE, solver.cpp:47-55)
        fields = "net, net_param, train_net, train_net_param"
        n_train = sum(solver_msg.get(f) is not None
                      for f in ("net", "net_param", "train_net",
                                "train_net_param"))
        if n_train < 1:
            raise ValueError("SolverParameter must specify a train net "
                             f"using one of these fields: {fields}")
        if n_train > 1:
            raise ValueError("SolverParameter must not contain more than "
                             "one of these fields specifying a train_net: "
                             f"{fields}")
        inline = (solver_msg.get("net_param")
                  or solver_msg.get("train_net_param"))
        if inline is not None:
            self.net_msg = inline
        else:
            self.net_msg = parse_file(resolve_path(
                solver_msg.get("net") or solver_msg.get("train_net")))
        has_generic = (solver_msg.get("net") is not None
                       or solver_msg.get("net_param") is not None)
        # the train net's NetState: TRAIN, then the net's own `state`, then
        # the solver's `train_state` (highest precedence), merged as protos
        # merge (ref InitTrainNet, solver.cpp:72-81)
        self.train_state = _merge_net_state(
            "TRAIN", self.net_msg.get("state"),
            solver_msg.get("train_state"))

        # test-net instances (ref InitTestNets, solver.cpp:85-157):
        # dedicated test_net_param entries, then test_net files, then
        # (test_iter count - dedicated) instances of the GENERIC net; the
        # test_iter list must cover every instance
        inline_tests = list(solver_msg.get_list("test_net_param"))
        test_paths = [resolve_path(str(p))
                      for p in solver_msg.get_list("test_net")]
        n_dedicated = len(inline_tests) + len(test_paths)
        n_test_iter = len(solver_msg.get_list("test_iter"))
        if has_generic:
            if n_test_iter < n_dedicated:
                raise ValueError(
                    "test_iter must be specified for each test network.")
            n_instances = n_test_iter
        else:
            if n_test_iter != n_dedicated:
                raise ValueError(
                    "test_iter must be specified for each test network.")
            n_instances = n_dedicated
        self.test_net_msgs = (inline_tests
                              + [parse_file(p) for p in test_paths]
                              + [self.net_msg] * (n_instances - n_dedicated))
        test_states = list(solver_msg.get_list("test_state"))
        if test_states and len(test_states) != n_instances:
            raise ValueError("test_state must be unspecified or specified "
                             "once per test net.")
        self.test_net_states = [
            _merge_net_state("TEST", msg.get("state"),
                             test_states[i] if test_states else None)
            for i, msg in enumerate(self.test_net_msgs)]
        if n_instances and not solver_msg.get("test_interval"):
            # ref CHECK_GT(test_interval, 0) when test nets exist
            raise ValueError("test_interval must be > 0 when test nets "
                             "are specified")
        self.has_test = n_instances > 0

    @classmethod
    def from_prototxt(cls, solver_path: str, *,
                      device=DEFAULT) -> "SolverDriver":
        return cls(parse_file(solver_path), net_dir=os.getcwd(), device=device)

    def rebuild(self) -> "SolverDriver":
        """A fresh driver over the same solver config: fresh nets, data
        sources and params. Crash-restart recovery (`train
        --max_restarts`) uses it: the restored snapshot supplies iter,
        params and momentum, everything else starts as a process would."""
        return type(self)(self._solver_msg, net_dir=self._net_dir,
                          device=self.device).build()

    # ------------------------------------------------------------------
    def build(self, *, seed: int | None = None):
        if seed is None:
            # SolverParameter.random_seed >= 0 seeds everything: fillers
            # and data-layer sampling, not just the train loop's dropout
            # (ref:src/caffe/solver.cpp:37-39 Caffe::set_random_seed)
            rs = int(self.cfg.random_seed)
            seed = rs if rs >= 0 else 1234
        # extension: solver `compute_dtype: "bfloat16"` runs the TRAIN net's
        # INNER_PRODUCT on bf16 operands (f32 sums; K1's sm90 route). TEST
        # nets stay f32 so that eval metrics keep the reference's numerics.
        cd = self._solver_msg.get("compute_dtype") or None
        tr_phase, tr_level, tr_stages = self.train_state
        self.train_net = Net(self.net_msg, phase=tr_phase, level=tr_level,
                             stages=tr_stages, compute_dtype=cd)
        self.train_source = self._build_sources(self.train_net, tr_phase,
                                                seed)
        batch0 = self.train_source.next_batch()
        # the batch consumed here for shapes is RE-FED as training iteration
        # 0 (_data_iter first=). _first_batch_raw is not redundant: under
        # role_major_data, _first_batch is the transposed view while the
        # re-fed copy stays raw, and the data iterator's transform
        # transposes it like any other batch
        self._first_batch = batch0
        self._first_batch_raw = batch0
        # the on-device negative sampler (a data layer's `device_negatives:
        # true`, graph/data_factory.py): the host batch carries (B, C, D)
        # target+context rows; the net sees (B, C+N, D), assembled in the
        # loss function from the device reservoir, so its spec widens
        self.device_negatives = self.train_source.device_negatives
        spec0 = _spec_from_batch(batch0)
        if self.device_negatives:
            dn = self.device_negatives
            s = spec0[dn["top"]].shape
            spec0[dn["top"]] = torch.empty(
                (s[0], s[1] + dn["num_negatives"]) + tuple(s[2:]),
                dtype=torch.float32, device="meta")
            if self.snapshot_vis or self.debug_info_every:
                raise ValueError(
                    "device_negatives cannot combine with snapshot_vis/"
                    "debug_info (their hooks forward the raw host batch, "
                    "which has no negative channels)")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params, _ = self.train_net.init(gen, spec0)
        self.params = params

        # extension: solver `role_major_data: true` feeds eligible data
        # blobs role-major ((R, B, feat...) for (B, R, feat...)), so that the
        # leading SLICE/CONCAT absorb into a reshape instead of a copy a
        # step (graph/fuse.py drole symbols). The transpose runs in the
        # prefetch thread; loss and grads are bit-equal.
        self.role_major_keys: tuple = ()
        if self._solver_msg.get("role_major_data"):
            if self.device_negatives:
                raise ValueError(
                    "role_major_data cannot combine with device_negatives "
                    "(the device sampler assembles batch-major (B, C+N, D) "
                    "inside the step; role_major_data is a >=256-batch "
                    "relayout knob: drop one of the two)")
            cands = self.train_net.role_major_candidates(batch0)
            if cands:
                self.train_net.role_major_inputs = tuple(cands)
                self.role_major_keys = tuple(cands)
                self._first_batch = self._transpose_role_major(batch0)
            else:
                log.warning("role_major_data: no eligible SLICE(dim1) "
                            "data blob in the TRAIN net; feeding normally")

        self.test_nets = []
        self.test_sources = []
        self._test_first_batches: list = []
        if self.has_test:
            for i, msg in enumerate(self.test_net_msgs):
                te_phase, te_level, te_stages = self.test_net_states[i]
                test_net = Net(msg, phase=te_phase, level=te_level,
                               stages=te_stages)
                source = self._build_sources(test_net, te_phase,
                                             seed + 1 + i)
                if source.device_negatives:
                    raise ValueError(
                        "device_negatives is a TRAIN-net feature (the "
                        "reservoir rides the training carry channel); "
                        f"test net #{i} declares it: gate the layer with "
                        "include { phase: TRAIN } or drop the flag")
                # the test net reuses the train net's params (shared by
                # layer name, ref ShareTrainedLayersWith, net.cpp); its init
                # only sets its shapes and sharing
                tb = source.next_batch()
                test_net.init(torch.Generator(device=self.device).manual_seed(0),
                              _spec_from_batch(tb))
                self.test_nets.append(test_net)
                self.test_sources.append(source)
                self._test_first_batches.append(tb)

        self.lr_mults, self.decay_mults = self.train_net.param_multipliers()
        return self

    def _build_sources(self, net: Net, phase: str, seed: int):
        sources = [make_data_source(layer, phase=phase, seed=seed)
                   for layer in net.layers
                   if layer.get("type") in DATA_LAYER_TYPES]
        if not sources:
            raise ValueError(f"no data layers in {phase} net")
        return MergedSource(sources)

    # ------------------------------------------------------------------
    def _transpose_role_major(self, batch):
        return {k: (np.ascontiguousarray(np.moveaxis(v, 1, 0))
                    if k in self.role_major_keys else v)
                for k, v in batch.items()}

    def _data_iter(self, source, validators=None, transform=None, first=None):
        """Background host batching and the copy to the device, double
        buffered: the reference's prefetch-thread overlap. `first` (the
        batch build() consumed for shapes) is re-fed ahead of the source;
        `validators` (Net.batch_validators) check each host batch before
        it is used, and `transform` runs after them, in the prefetch
        thread."""
        it = iter(source)
        if first is not None:
            it = itertools.chain([first], it)
        if validators:
            def _checked(inner):
                for b in inner:
                    for v in validators:
                        v(b)
                    yield b
            it = _checked(it)
        pf = DevicePrefetcher(it, depth=2, device=self.device,
                              transform=transform)
        self._prefetchers.append(pf)
        return iter(pf)

    def _finetune_params(self, weights_path: str):
        """The build's params with a .vvmodel's layers copied in (ref
        tools/caffe.cpp:110-117 CopyTrainedLayersFrom): a copy (a second
        train() on this driver starts from the original init), each blob
        shape-checked, a param the net lacks refused. Any other file is read
        as the reference's .caffemodel (data/weights.py), as JAX's driver
        reads it."""
        if not weights_path.endswith(".vvmodel"):
            return load_into_params(NetWeights.load(weights_path), self.params)
        params = {ln: dict(lp) for ln, lp in self.params.items()}
        for lname, lp in load_model(weights_path).items():
            if lname not in params:
                continue
            for pname, arr in lp.items():
                tgt = params[lname].get(pname)
                if tgt is None:
                    # a param init never produced would desync the tree
                    # from lr_mults/decay_mults
                    raise ValueError(
                        f"finetune weights {weights_path!r}: layer "
                        f"{lname!r} has param {pname!r} the net does not "
                        f"(e.g. a bias for a bias_term:false layer)")
                if tuple(arr.shape) != tuple(tgt.shape):
                    raise ValueError(
                        f"finetune weights {weights_path!r}: layer "
                        f"{lname!r} param {pname!r} has shape "
                        f"{tuple(arr.shape)}, net expects {tuple(tgt.shape)}")
                params[lname][pname] = arr.to(tgt.device, tgt.dtype)
        return params

    def train(self, *, resume_state_path: str | None = None,
              weights_path: str | None = None, max_iter: int | None = None,
              mesh=None, shard_gallery: bool = False) -> TrainResult:
        """Train from the build's params (or a .vvmodel's, `weights_path`,
        or a .vvstate's, `resume_state_path`) up to the solver's max_iter
        (or `max_iter`).

        With `mesh` (parallel.make_mesh, run on every rank), every rank
        draws the same sampler stream and keeps its rows of each batch (the
        prefetcher cuts them on each key's batch axis and copies only
        them); the train loop shards the params (2-D columns over "model"
        when it spans more than one rank), averages the gradients over
        "data" and gathers the params whole for snapshots, which rank 0
        writes; every rank reads a resume. The device_negatives reservoir
        stays the same on every rank: the ranks' offers are gathered and
        one update applied everywhere. `shard_gallery` shards the
        RETRIEVAL_STATS report's gallery rows over "data" in place of its
        query chunks (metrics.retrieval)."""
        if shard_gallery and mesh is None:
            raise ValueError("shard_gallery=True requires mesh=")
        params = (self._finetune_params(weights_path) if weights_path
                  else self.params)
        cfg = self.cfg if max_iter is None else replace(self.cfg,
                                                        max_iter=max_iter)
        # param-carrying layers in NET order: the .solverstate history order
        # (ref net_->params(); src/caffe/solver.cpp:578-596)
        layer_order = [l.get("name") for l in self.train_net.layers
                       if l.get("name") in self.params]
        caffe_export = None
        fmt = str(cfg.snapshot_format).lower()
        if fmt == "caffe":
            # the reference's pair, written after the npz pair in the
            # snapshot thread
            net_msg = self.net_msg

            def caffe_export(it, p_np, s_np):
                export_caffe_snapshot(cfg.snapshot_prefix or "snapshot", it,
                                      p_np, s_np, net_msg, layer_order)
        elif fmt == "orbax":
            raise NotImplementedError(
                'snapshot_format: "orbax" stays with the JAX package '
                "(ROADMAP, do not port)")
        elif fmt not in ("vv", ""):
            raise ValueError(f"unknown snapshot_format {cfg.snapshot_format!r} "
                             "(expected vv, caffe, or orbax)")

        net = self.train_net
        # sink layers in a TRAIN net write their files on every training
        # Forward in the reference (write_to_file_layer.cpp:36-64)
        train_sinks = bool(net.host_sinks)
        # the batch-axis map for microbatch splits; the role-major feed
        # moves those keys' batch axis from 0 to 1
        src_axes = dict(self.train_source.batch_axes())
        for k in self.role_major_keys:
            src_axes[k] = 1
        on_mesh = MeshRun(mesh, src_axes)

        def sinks_of(n, whole_batch=False):
            if not n.host_sinks:
                return None

            def fn(blobs):
                if whole_batch:
                    # a train step's sink bottoms are the rank's rows
                    blobs = on_mesh.gather(blobs)
                n.process_host_sinks(blobs, mesh=mesh,
                                     shard_gallery=shard_gallery)
            return fn

        stateful = bool(net.stateful_layer_names)
        if stateful and self.device_negatives:
            raise ValueError(
                "device_negatives cannot combine with stateful (cross-batch "
                "LSTM carry) nets: both need the carry channel")

        def net_loss(p, batch, generator):
            # a stateful net's cross-batch LSTM carry (ref
            # lstm_layer.cpp:171-173) rides the aux channel under a
            # reserved key; train moves it, detached, from one step's
            # output into the next step's batch
            feed = {k: v for k, v in batch.items() if k != "__carry__"}
            loss, outputs, *tail = net.apply(
                p, feed, generator=generator, state=batch.get("__carry__"),
                return_state=stateful, return_sink_blobs=train_sinks)
            # ref solver.cpp:195-217: every element of every output blob
            aux = {k: v.reshape(-1) for k, v in outputs.items()}
            if stateful:
                aux["__carry__"] = tail.pop(0)
            if train_sinks:
                aux["__sinks__"] = tail[0]
            return loss, aux

        loss_fn, initial_carry = net_loss, None
        if self.device_negatives:
            loss_fn = self._device_negatives_loss(net_loss)
            initial_carry = torch.as_tensor(self.device_negatives["buffer"],
                                            device=self.device)
            if resume_state_path:
                # the reservoir is not in the snapshot: a resume restarts it
                # from the initial fill, as the reference's host reservoir,
                # which lives in data-layer memory, is rebuilt on every
                # restart (ref:src/caffe/layers/video_sampled_shots_data_
                # layer.cpp:268-361 refills at LayerSetUp; SolverState
                # carries iter/weights/history only, caffe.proto:176-180)
                log.warning(
                    "resume with device_negatives: the device reservoir "
                    "restarts from the initial fill (not snapshotted, as "
                    "the reference's host reservoir is rebuilt on every "
                    "restart); the negative distribution re-warms over the "
                    "next ~buffer_size/batch steps")

        eval_fns, test_iters = [], []
        if self.test_nets:
            include_loss = self.cfg.test_compute_loss

            def make_eval(test_net):
                sinks = bool(test_net.host_sinks)
                t_stateful = bool(test_net.stateful_layer_names)

                def eval_fn(p, batch):
                    feed = {k: v for k, v in batch.items()
                            if k != "__carry__"}
                    loss, outputs, *tail = test_net.apply(
                        p, feed, state=batch.get("__carry__"),
                        return_state=t_stateful, return_sink_blobs=sinks)
                    # every element of every output blob accumulates into
                    # the test report (ref Solver::Test solver.cpp:280-315)
                    out = {k: v.reshape(-1) for k, v in outputs.items()}
                    if include_loss:  # ref test_compute_loss, caffe.proto:116
                        out["loss"] = loss
                    if t_stateful:  # carried across the test batches
                        out["__carry__"] = tail.pop(0)
                    if sinks:  # sink-layer bottoms for process_host_sinks
                        out["__sinks__"] = tail[0]
                    return out
                return eval_fn

            eval_fns = [make_eval(n) for n in self.test_nets]
            test_iters = [self._data_iter(s, validators=n.batch_validators(),
                                          first=fb)
                          for n, s, fb in zip(self.test_nets,
                                              self.test_sources,
                                              self._test_first_batches)]

        hooks = []
        if self.snapshot_vis:
            def vis_hook(p, it):
                if not on_mesh.writer:
                    # the forward's collectives run on every rank, the
                    # file is rank 0's
                    gen = torch.Generator(device=self.device).manual_seed(it)
                    with torch.no_grad():
                        net.apply(p, self._first_batch_on_device(),
                                  generator=gen)
                    return
                os.makedirs(self.snapshot_vis_dir, exist_ok=True)
                # a TRAIN-phase forward: dropout draws from a generator
                # seeded by the iteration, so that a dump is reproducible
                gen = torch.Generator(device=self.device).manual_seed(it)
                with torch.no_grad():
                    _, blobs = net.apply(p, self._first_batch_on_device(),
                                         generator=gen, return_blobs=True)
                vis_snapshot(net, p, blobs, os.path.join(
                    self.snapshot_vis_dir, f"vis_iter_{it}.json"),
                    vis_blobs=self.snapshot_vis_blobs,
                    max_elements=self.snapshot_vis_truncate or 64)

            hooks.append((self.snapshot_vis, vis_hook))
        if self.debug_info_every:
            def debug_hook(p, it):
                with torch.no_grad():
                    net.debug_info(p, self._first_batch_on_device())

            hooks.append((self.debug_info_every, debug_hook))

        transform = (self._transpose_role_major
                     if self.role_major_keys else None)
        if mesh is not None:
            # the rank's rows of every key, cut in the prefetch thread
            # before the copy to the device
            transform = (on_mesh.rows if transform is None else
                         lambda b, t=transform: on_mesh.rows(t(b)))
        data_iter = self._data_iter(self.train_source, transform=transform,
                                    validators=net.batch_validators(),
                                    first=self._first_batch_raw)
        try:
            return train(
                loss_fn, params, data_iter, cfg,
                lr_mults=self.lr_mults, decay_mults=self.decay_mults,
                device=self.device, eval_fn=eval_fns, test_data=test_iters,
                sink_fn=[sinks_of(n) for n in self.test_nets],
                train_sink_fn=sinks_of(net, whole_batch=True),
                hooks=hooks,
                resume_state_path=resume_state_path,
                param_layer_order=layer_order,
                caffe_export=caffe_export,
                batch_axes=src_axes,
                train_output_weights=net.output_loss_weights(),
                test_output_weights=[n.output_loss_weights()
                                     for n in self.test_nets],
                initial_carry=initial_carry,
                # the carry (LSTM state, device reservoir) threads between
                # sub-batches on the host: the fused step cannot carry it
                # (build_fused_step refuses)
                fused_accum=not (stateful or self.device_negatives),
                mesh=mesh,
                time_major=any(a == 1 for a in
                               self.train_source.batch_axes().values()))
        finally:
            # stop the prefetch threads and drop their queued device
            # batches: over infinite sources they would otherwise live until
            # the process exits, one more per restart
            for pf in self._prefetchers:
                pf.close()
            self._prefetchers.clear()

    def _first_batch_on_device(self) -> dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in self._first_batch.items()}

    def _device_negatives_loss(self, net_loss):
        """net_loss wrapped for the on-device sampler: the full (B, C+N, D)
        batch (or (B, C+N, D, 1)) is assembled on the card from the host's
        (B, C, D) rows and the reservoir in "__carry__", negatives gathered
        and the reservoir updated with this batch's rows
        (data/device_sampler.py); the updated reservoir goes out as the
        aux's "__carry__". The draws come from a generator of their own,
        reseeded whenever the dropout generator is (once an iteration, by
        train), from that seed (`derived_seed`): dropout's stream is the
        one it would be without the sampler, and each iteration's draws
        depend on (solver seed, iteration) alone."""
        dn = self.device_negatives
        top, n_negs = dn["top"], int(dn["num_negatives"])
        swap = float(dn["swap_percentage"])
        sampler_gen = torch.Generator(device=self.device)
        seeded = [None]

        def loss_fn(p, batch, generator):
            seed = generator.initial_seed()
            if seed != seeded[0]:
                sampler_gen.manual_seed(derived_seed(seed, SAMPLER_STREAM))
                seeded[0] = seed
            host = batch[top]
            trailing1 = host.dim() == 4  # a (B, C, D, 1) feed
            ax = collectives.axis("data")
            if ax is not None:
                # on a batch shard: every rank's offers, the whole batch's
                # draws and one update, so that the reservoir stays the
                # same on every rank (and the one-device one); the rank
                # keeps its rows of the assembled batch
                host = collectives.data_gather(host, 0)
            full, res = train_batch_with_device_negatives(
                DeviceReservoir(batch["__carry__"], swap), sampler_gen,
                host[..., 0] if trailing1 else host, n_negs)
            if ax is not None:
                full = rank_rows(full, ax)
            feed = {k: v for k, v in batch.items() if k != "__carry__"}
            feed[top] = full[..., None] if trailing1 else full
            loss, aux = net_loss(p, feed, generator)
            aux["__carry__"] = res.buffer
            return loss, aux

        return loss_fn
