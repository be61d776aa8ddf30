"""The trajectory-forecasting model, the social-pooling workload;
counterpart of videovector_tpu/models/trajectory.py.

It composes what the reference wires by prototxt for the tracking project
(TRACKING_WINDOWS[_SOCIAL]_DATA -> LSTM encoder/decoder + SOCIAL_POOLING +
EUCLIDEAN_LOSS): an encoder LSTM consumes the observed track; a
social-pooling summary of the neighbours' offsets at the last observed step
is added to its final hidden state (when `use_social` and the batch has
relations); that state seeds a decoder LSTM over the prediction window, and
a linear readout gives (dx, dy) per future step, or the conditional decoder
feeds its own previous (dx, dy) back. The Euclidean loss against the true
future positions is masked by track validity. Every product is
ops.linear.dot's (f32, TF32 off); no Pallas kernel is on this path in the
JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from videovector_tpu_torch.ops.linear import dot
from videovector_tpu_torch.ops.recurrent import (
    LstmState, init_lstm_params, lstm, lstm_conditional,
)
from videovector_tpu_torch.ops.social import social_pooling


@dataclass(frozen=True)
class TrajectoryConfig:
    feature_size: int = 3            # dx, dy, encoder_bit
    hidden: int = 128
    pool_feat_size: int = 32
    use_social: bool = True
    clip_threshold: float = 0.0
    # conditional decoding (ref LSTM_CONDITIONAL): the decoder consumes its
    # own previous (dx, dy) prediction instead of a fixed zero/scene input
    conditional_decoder: bool = False


class TrajectoryModel:
    def __init__(self, cfg: TrajectoryConfig):
        self.cfg = cfg

    def init(self, generator: torch.Generator) -> dict:
        """Params on the generator's device, drawn from it: the encoder, the
        decoder, the readout, then the social blocks."""
        cfg = self.cfg
        dev = generator.device

        def normal(*shape):
            return 0.1 * torch.randn(shape, generator=generator, device=dev)

        params = {
            "encoder": init_lstm_params(generator, cfg.feature_size,
                                        cfg.hidden),
            "decoder": init_lstm_params(
                generator, cfg.feature_size, cfg.hidden, output_dim=2,
                conditional=cfg.conditional_decoder),
            "readout": {"w": normal(cfg.hidden, 2),
                        "b": torch.zeros((2,), device=dev)},
        }
        if cfg.use_social:
            params["social"] = {
                "w": normal(2, cfg.pool_feat_size),
                "b": torch.zeros((cfg.pool_feat_size,), device=dev)}
            params["social_proj"] = {"w": normal(cfg.pool_feat_size,
                                                 cfg.hidden)}
        return params

    def forward(self, params, batch):
        """batch: observed (T_obs, B, F), cont_observed (T_obs, B),
        predicted (T_pred, B, F), cont_predicted (T_pred, B)
        [+ mean_pos (B, 2), relations (B, B) when social].
        Returns predictions (T_pred, B, 2)."""
        cfg = self.cfg
        obs = batch["observed"]
        _, enc_state = lstm(params["encoder"], obs, batch["cont_observed"],
                            clip_threshold=cfg.clip_threshold)
        h = enc_state.h
        if cfg.use_social and "relations" in batch:
            # the social summary of the final observed offsets, added to
            # the decoder's initial hidden state
            pooled = social_pooling(obs[-1], batch["relations"],
                                    params["social"]["w"],
                                    params["social"]["b"],
                                    batch.get("mean_pos"))
            h = h + dot(pooled, params["social_proj"]["w"])
        dec_state = LstmState(enc_state.c, h)
        if cfg.conditional_decoder:
            # seeded with the last observed offset, (0, 0) after
            # recentering; each step's (dx, dy) feeds the next
            # (ref lstm_conditional_layer.cpp:169-345)
            out, _ = lstm_conditional(
                params["decoder"], batch["predicted"], obs[-1][:, :2] * 0.0,
                batch["cont_predicted"], state=dec_state,
                clip_threshold=cfg.clip_threshold)
            return out
        dec_h, _ = lstm(params["decoder"], batch["predicted"],
                        batch["cont_predicted"], state=dec_state,
                        clip_threshold=cfg.clip_threshold)
        t, b, _ = dec_h.shape
        out = dot(dec_h.reshape(t * b, -1), params["readout"]["w"]) \
            + params["readout"]["b"]
        return out.reshape(t, b, 2)

    def loss(self, params, batch, generator=None, train=True):
        """(loss, {"ade": ...}): the Euclidean loss, sum/(2 num) with num =
        T.B items (T times the valid tracks under an is_valid mask), and the
        average displacement error masked like it (padded slots carry
        predictions against zero labels)."""
        del generator, train
        pred = self.forward(params, batch)
        labels = batch["labels"]
        sq = (pred - labels) ** 2
        err = sq
        if "is_valid" in batch:
            mask = batch["is_valid"].reshape(1, -1, 1)
            err = err * mask
            denom = torch.clamp(batch["is_valid"].sum(), min=1.0) \
                * labels.shape[0]
        else:
            mask = None
            denom = labels.shape[0] * labels.shape[1]
        loss = err.sum() / denom / 2.0
        dist = torch.sqrt(sq.sum(dim=-1))  # (T, B)
        if mask is not None:
            m = mask.reshape(1, -1)
            ade = (dist * m).sum() / torch.clamp(m.sum() * dist.shape[0],
                                                 min=1.0)
        else:
            ade = dist.mean()
        return loss, {"ade": ade}
