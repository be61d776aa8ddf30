"""Training-curve extraction from glog-format logs; counterpart of
videovector_tpu/tools/plot_training_stats.py.

ref:caffe_utils/plot_training_stats.py:10-60 - parse `Iteration N, loss = X`
and `Test net output #k: name = v` lines from training logs (the port's
utils/logging.py and solver/train.py write the same lines) and plot or
export the curves.

Also covers the reference's log-tooling extras:
- extract_seconds() - elapsed seconds per Iteration line since the
  "Solving" banner, from glog timestamps
  (ref:tools/extra/extract_seconds.py:6-37);
- --parse_log - write `<log>.train` (#Iters Seconds TrainingLoss
  LearningRate) and `<log>.test` (#Iters Seconds <test outputs>) tables
  (ref:tools/extra/parse_log.sh:2-36).
"""

from __future__ import annotations

import argparse
import datetime
import re
import sys

ITER_LOSS_RE = re.compile(
    r"Iteration (\d+), loss = ([-\d.eE+]+|-?nan|-?inf)")
ITER_LR_RE = re.compile(
    r"Iteration (\d+), lr = ([-\d.eE+]+|-?nan|-?inf)")
# nan/inf alternates: a DIVERGED run's lines are the ones a plot
# exists to show; the numeric char class alone dropped them
TEST_OUT_RE = re.compile(
    r"Test net output #\d+: (\S+) = ([-\d.eE+]+|-?nan|-?inf)")
TEST_ITER_RE = re.compile(r"Iteration (\d+), Testing net")
# glog line prefix: I0210 13:39:22.381027 25210 file.py:12] ...
GLOG_TS_RE = re.compile(r"^[IWEF](\d{2})(\d{2}) (\d{2}):(\d{2}):(\d{2})"
                        r"\.(\d+)\s")


def _line_datetime(line: str, year: int):
    """Timestamp of a glog line (ref:tools/extra/extract_seconds.py:6-19)."""
    m = GLOG_TS_RE.match(line)
    if not m:
        return None
    month, day, hh, mm, ss, frac = m.groups()
    return datetime.datetime(year, int(month), int(day), int(hh), int(mm),
                             int(ss), int(frac[:6].ljust(6, "0")))


def extract_seconds(path: str, year: int | None = None) -> dict[int, float]:
    """iteration -> seconds elapsed since the "Solving" banner
    (ref:tools/extra/extract_seconds.py:21-37). Iterations logged before
    Solving (or logs without it) anchor at the first Iteration line."""
    import os
    if year is None:
        try:
            year = datetime.datetime.fromtimestamp(
                os.path.getctime(path)).year
        except OSError:
            year = datetime.datetime.now().year
    start = None
    out: dict[int, float] = {}
    iter_re = re.compile(r"Iteration (\d+)")
    with open(path) as f:
        for line in f:
            if start is None and "Solving" in line:
                start = _line_datetime(line, year)
                continue
            m = iter_re.search(line)
            if m:
                dt = _line_datetime(line, year)
                if dt is None:
                    continue
                if start is None:
                    start = dt
                # year rollover (Dec->Jan logs): only a LARGE negative
                # step is a rollover - slightly out-of-order buffered log
                # lines (microseconds before the anchor) must not gain a
                # year
                if dt < start - datetime.timedelta(days=180):
                    dt = dt.replace(year=dt.year + 1)
                out.setdefault(int(m.group(1)),
                               (dt - start).total_seconds())
    return out


def write_parse_log_tables(path: str, stats: dict,
                           seconds: dict[int, float]) -> tuple[str, str]:
    """`<log>.train` / `<log>.test` tables (ref:tools/extra/parse_log.sh)."""
    lrs = dict(stats["lr"])
    train_path = path + ".train"
    with open(train_path, "w") as f:
        f.write("#Iters Seconds TrainingLoss LearningRate\n")
        for it, loss in stats["train_loss"]:
            f.write(f"{it} {seconds.get(it, 0.0):.6f} {loss:g} "
                    f"{lrs.get(it, 0.0):g}\n")
    test_path = path + ".test"
    names = sorted(stats["test"])
    with open(test_path, "w") as f:
        f.write("#Iters Seconds " + " ".join(names) + "\n")
        by_iter: dict[int, dict[str, float]] = {}
        for name in names:
            for it, v in stats["test"][name]:
                by_iter.setdefault(it, {})[name] = v
        for it in sorted(by_iter):
            row = " ".join(f"{by_iter[it].get(n, float('nan')):g}"
                           for n in names)
            f.write(f"{it} {seconds.get(it, 0.0):.6f} {row}\n")
    return train_path, test_path


def parse_log(path: str) -> dict:
    train = []      # (iter, loss)
    lrs = []        # (iter, lr)
    tests: dict[str, list] = {}
    current_test_iter = None
    with open(path) as f:
        for line in f:
            m = ITER_LOSS_RE.search(line)
            if m:
                train.append((int(m.group(1)), float(m.group(2))))
                continue
            m = ITER_LR_RE.search(line)
            if m:
                lrs.append((int(m.group(1)), float(m.group(2))))
                continue
            m = TEST_ITER_RE.search(line)
            if m:
                current_test_iter = int(m.group(1))
                continue
            m = TEST_OUT_RE.search(line)
            if m and current_test_iter is not None:
                tests.setdefault(m.group(1), []).append(
                    (current_test_iter, float(m.group(2))))
    return {"train_loss": train, "lr": lrs, "test": tests}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vvtpu-torch-plot-training-stats")
    parser.add_argument("log")
    parser.add_argument("--out", default="training_stats.png")
    parser.add_argument("--csv", default=None)
    parser.add_argument("--parse_log", action="store_true",
                        help="write <log>.train/<log>.test tables "
                             "(ref tools/extra/parse_log.sh) and skip "
                             "plotting")
    args = parser.parse_args(argv)
    stats = parse_log(args.log)

    if args.csv:
        with open(args.csv, "w") as f:
            f.write("iter,loss\n")
            for it, loss in stats["train_loss"]:
                f.write(f"{it},{loss}\n")

    if args.parse_log:
        tp, vp = write_parse_log_tables(args.log, stats,
                                        extract_seconds(args.log))
        print(f"wrote {tp}\nwrote {vp}")
        return 0

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 5))
    if stats["train_loss"]:
        xs, ys = zip(*stats["train_loss"])
        ax.plot(xs, ys, label="train loss")
    for name, pts in stats["test"].items():
        xs, ys = zip(*pts)
        ax.plot(xs, ys, marker="o", label=f"test {name}")
    ax.set_xlabel("iteration")
    ax.legend()
    fig.savefig(args.out, dpi=100)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
