"""On-device negative sampling; counterpart of
videovector_tpu/data/device_sampler.py.

The reference's negative reservoir lives on the host inside the data layer
(ref:src/caffe/layers/video_sampled_shots_data_layer.cpp:24-44, :885-905);
every batch then ships (B, C+N, D) floats host -> device, negatives being
about two thirds of that traffic. Here the reservoir is a tensor on the
card, sampled and updated inside the train step:

  * the host sends only (B, C, D) target+context features,
  * negatives are gathered from the device reservoir,
  * the reservoir is refreshed by offering every batch row (target AND
    context channels, as the host path offers all shots of each consumed
    video) with the reference's swap probability: a statistical twin of
    AddToBuffer without the key dedup (a measure-zero difference at corpus
    scale; shots the sampler never put in a batch never enter the
    reservoir, a second, small one).

H2D traffic at the flagship's shape drops from 128*15*4096*4 = 31.5 MB to
128*5*4096*4 = 10.5 MB a step.

Each step splits into a draw and an apply. The draw (`draw_step`) takes
every random number from one torch.Generator on the buffer's device: the
negatives' reservoir rows, distinct within an item (one `topk` over a
(B, max_size) uniform draw, no loop over the batch), and, for each offered
row, whether it is accepted and the slot it takes. The apply
(`apply_step`) is deterministic given those draws, so tests feed it the
JAX package's draws. Where accepted offers share a slot, the last offer
wins, resolved before the scatter (`winning_offers`), so the result does
not depend on the order in which the card's threads write.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DeviceReservoir(NamedTuple):
    buffer: torch.Tensor      # (max_size, D)
    swap_percentage: float    # 0..100


class StepDraws(NamedTuple):
    """The random numbers of one step: `ids` (B, n) int64, the reservoir
    rows of each item's negatives; `accept` (M,) bool and `slots` (M,)
    int64, each offered row's acceptance and target slot."""
    ids: torch.Tensor
    accept: torch.Tensor
    slots: torch.Tensor


def init_device_reservoir(features, max_size: int, swap_percentage: float,
                          *, device="cuda") -> DeviceReservoir:
    """Seed from any (>= max_size, D) feature matrix (e.g. one pass over
    the dataset's shots, as the reference's initial fill), as f32 on
    `device`."""
    if features.shape[0] < max_size:
        raise ValueError("not enough seed features for the reservoir")
    buf = torch.as_tensor(np.asarray(features[:max_size], np.float32)
                          if not isinstance(features, torch.Tensor)
                          else features[:max_size])
    return DeviceReservoir(buf.to(device, torch.float32),
                           float(swap_percentage))


def draw_negative_ids(generator: torch.Generator, max_size: int, batch: int,
                      n: int) -> torch.Tensor:
    """(batch, n) reservoir rows, uniform, distinct within each item (the
    reference's RandomShuffleTopids per item) and independent across
    items: the n largest of max_size uniforms per item."""
    if n > max_size:
        raise ValueError(f"{n} negatives from a reservoir of {max_size}")
    u = torch.rand((batch, max_size), generator=generator,
                   device=generator.device)
    return u.topk(n, dim=1).indices


def draw_swaps(generator: torch.Generator, m: int, max_size: int,
               swap_percentage: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(accept (m,) bool, slots (m,) int64): each of m offered rows is
    accepted with probability swap_percentage / 100 into a uniform slot."""
    dev = generator.device
    accept = (torch.rand((m,), generator=generator, device=dev)
              < swap_percentage / 100.0)
    slots = torch.randint(0, max_size, (m,), generator=generator, device=dev)
    return accept, slots


def draw_step(reservoir: DeviceReservoir, generator: torch.Generator,
              batch: int, num_negatives: int, offered: int) -> StepDraws:
    """One step's draws: the negatives' rows first, then the swaps."""
    max_size = reservoir.buffer.shape[0]
    ids = draw_negative_ids(generator, max_size, batch, num_negatives)
    accept, slots = draw_swaps(generator, offered, max_size,
                               reservoir.swap_percentage)
    return StepDraws(ids, accept, slots)


def gather_negatives(reservoir: DeviceReservoir,
                     ids: torch.Tensor) -> torch.Tensor:
    """(B, n, D) rows of the reservoir at `ids` (B, n)."""
    return reservoir.buffer[ids]


def winning_offers(accept: torch.Tensor, slots: torch.Tensor,
                   max_size: int) -> torch.Tensor:
    """The offers that write: accepted, and the last accepted offer of
    their slot. One deterministic scatter-max of offer indices, with no
    host sync."""
    m = accept.shape[0]
    order = torch.arange(m, device=accept.device)
    target = torch.where(accept, slots, max_size)
    last = torch.full((max_size + 1,), -1, dtype=torch.long,
                      device=accept.device)
    last.scatter_reduce_(0, target, order, reduce="amax")
    return accept & (last[slots] == order)


def apply_update(reservoir: DeviceReservoir, new_feats: torch.Tensor,
                 accept: torch.Tensor, slots: torch.Tensor) -> DeviceReservoir:
    """The reservoir with each winning offer's row (`winning_offers`) in
    its slot; a new buffer, the input's is untouched. The other offers go
    to a scratch row past the end (max_size), which is dropped: only they
    share it, so which of them lands there does not matter."""
    buf = reservoir.buffer
    max_size = buf.shape[0]
    keep = winning_offers(accept, slots, max_size)
    target = torch.where(keep, slots, max_size)
    padded = torch.empty((max_size + 1,) + tuple(buf.shape[1:]),
                         dtype=buf.dtype, device=buf.device)
    padded[:max_size].copy_(buf)
    padded.index_copy_(0, target, new_feats.to(buf.dtype))
    return reservoir._replace(buffer=padded[:max_size])


def sample_negatives(reservoir: DeviceReservoir, generator: torch.Generator,
                     batch: int, n: int) -> torch.Tensor:
    """(batch, n, D) rows drawn uniformly (with replacement across items,
    without within an item)."""
    return gather_negatives(reservoir, draw_negative_ids(
        generator, reservoir.buffer.shape[0], batch, n))


def update_reservoir(reservoir: DeviceReservoir, generator: torch.Generator,
                     new_feats: torch.Tensor) -> DeviceReservoir:
    """Offer (M, D) new features; each replaces a random slot with prob
    swap%/100 (ref AddToBuffer :24-37, without the key dedup)."""
    accept, slots = draw_swaps(generator, new_feats.shape[0],
                               reservoir.buffer.shape[0],
                               reservoir.swap_percentage)
    return apply_update(reservoir, new_feats, accept, slots)


def apply_step(reservoir: DeviceReservoir, host_part: torch.Tensor,
               draws: StepDraws) -> tuple[torch.Tensor, DeviceReservoir]:
    """host_part (B, C, D) and the step's draws -> ((B, C+N, D) batch, the
    updated reservoir). Every host channel is offered back (the host path
    offers all shots of each consumed video, ref :885-905; offering only
    channel 0 would bias the reservoir toward target-position shots)."""
    negs = gather_negatives(reservoir, draws.ids).to(host_part.dtype)
    batch = torch.cat([host_part, negs], dim=1)
    d = host_part.shape[-1]
    return batch, apply_update(reservoir, host_part.reshape(-1, d),
                               draws.accept, draws.slots)


def train_batch_with_device_negatives(reservoir: DeviceReservoir,
                                      generator: torch.Generator,
                                      host_part: torch.Tensor,
                                      num_negatives: int):
    """host_part: (B, C, D) target+contexts -> ((B, C+N, D) batch, updated
    reservoir), the draws taken from `generator` (on the buffer's
    device)."""
    b, c = host_part.shape[:2]
    draws = draw_step(reservoir, generator, b, num_negatives, b * c)
    return apply_step(reservoir, host_part, draws)
