"""Write a synthetic trajectory-forecasting dataset (TrackingWindow records)
with the port's own writer, so that projects/trajectory_forecast runs end
to end through vvtpu-torch without the original tracking databases and
without the JAX package; counterpart of
projects/trajectory_forecast/make_synthetic_data.py, whose flags, draws and
bytes it keeps (the same seed writes the same stores).

Scenes hold several agents moving with constant velocity and noise, the
statistics the reference's tracking_windows data layers were built for
(ref:src/caffe/layers/tracking_windows_data_layer.cpp,
ref:src/caffe/proto/tracking_windows.proto:7-21).

Usage, from projects/trajectory_forecast:
  python -m videovector_tpu_torch.tools.make_tracking_data
  python generate_net.py --train_source tracks_train.vvr \\
      --test_source tracks_test.vvr > trajectory_train.prototxt
  python -m videovector_tpu_torch.tools.cli train \\
      --solver=trajectory_solver.prototxt
"""

from __future__ import annotations

import argparse

import numpy as np

from videovector_tpu_torch.data.records import RecordWriter
from videovector_tpu_torch.data.wire import TrackingWindow, TrackPositions


def make_windows(rng: np.random.RandomState, num_windows: int,
                 tracks_per: int, t_obs: int, t_pred: int):
    """num_windows scenes of tracks_per tracks, t_obs + t_pred positions
    each, drawn from `rng`."""
    length = t_obs + t_pred
    tid = 0
    for s in range(num_windows):
        tracks = []
        for _ in range(tracks_per):
            start = rng.rand(2) * 10
            vel = rng.randn(2) * 0.5
            ts = np.arange(length)
            x = start[0] + vel[0] * ts + 0.02 * rng.randn(length)
            y = start[1] + vel[1] * ts + 0.02 * rng.randn(length)
            tracks.append(TrackPositions(id=tid, x=list(x.astype(float)),
                                         y=list(y.astype(float)), cl=0))
            tid += 1
        yield TrackingWindow(
            observed_time=list(range(t_obs)),
            prediction_time=list(range(t_obs, length)),
            scene_id=s, track_positions=tracks)


def write_windows(path: str, rng: np.random.RandomState, num_windows: int,
                  tracks_per: int = 4, t_obs: int = 8, t_pred: int = 4) -> str:
    """One VVR store of make_windows' scenes, keyed "%08d"."""
    with RecordWriter(path) as w:
        for i, win in enumerate(make_windows(rng, num_windows, tracks_per,
                                             t_obs, t_pred)):
            w.append(f"{i:08d}", win.encode())
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out_train", default="tracks_train.vvr")
    p.add_argument("--out_test", default="tracks_test.vvr")
    p.add_argument("--train_windows", type=int, default=400)
    p.add_argument("--test_windows", type=int, default=40)
    p.add_argument("--tracks_per_scene", type=int, default=4)
    p.add_argument("--t_obs", type=int, default=8)
    p.add_argument("--t_pred", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    rng = np.random.RandomState(args.seed)
    for out, n in ((args.out_train, args.train_windows),
                   (args.out_test, args.test_windows)):
        write_windows(out, rng, n, args.tracks_per_scene, args.t_obs,
                      args.t_pred)
        print(f"wrote {out}: {n} windows")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
