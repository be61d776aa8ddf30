"""The benchmark's specification, found by name.

`BENCHMARK.json` at the root lists the configurations, the cells
(`workloads`) and the metrics. Everything that belongs to one of them sits
in files of its own, which are found from the names alone:

- a configuration: the JSON file its entry names (`file`);
- a traffic mix: `vvbench/mixes/<traffic>.json`, whose `driver` names the
  general generator in `vvbench/drivers/<driver>.py` that reads it;
- a per-layer metric: `vvbench/metrics/<metric>.py`, a reader with
  `SOURCE`, `LAYER`, `MOVES` and `read(reading) -> float | None`.

A later change adds a configuration, a mix or a metric by adding such
files and entries; no file that is there needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class SpecError(ValueError):
    pass


def _load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise SpecError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    root: Path
    bench: dict
    workload: dict
    config: dict
    mix: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"] if _covers(m, self.name)]

    def per_layer(self) -> list[dict]:
        return [m for m in self.bench["per_layer"] if _covers(m, self.name)]

    def driver(self) -> ModuleType:
        name = self.mix["driver"]
        if not NAME.match(name):
            raise SpecError(f"driver name {name!r}")
        return _load_module(self.root / "vvbench" / "drivers" / f"{name}.py",
                            f"vvbench_driver_{name}")

    def limits(self) -> dict:
        """The correctness limits: the configuration's, where the mix gives
        its own for a number, the mix's."""
        return {**self.config.get("limits", {}), **self.mix.get("limits", {})}


def _covers(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_bench(root: Path) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no BENCHMARK.json in {root}")
    return json.loads(path.read_text())


def cell(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = load_bench(root)
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if len(found) != 1:
        raise SpecError(f"workload {workload!r}: {len(found)} entries in "
                        "BENCHMARK.json")
    wl = found[0]
    conf = [c for c in bench["configs"] if c["name"] == wl["config"]]
    if len(conf) != 1:
        raise SpecError(f"config {wl['config']!r}: {len(conf)} entries")
    config = json.loads((root / conf[0]["file"]).read_text())
    traffic = wl["traffic"]
    if not NAME.match(traffic):
        raise SpecError(f"traffic name {traffic!r}")
    mix_path = root / "vvbench" / "mixes" / f"{traffic}.json"
    if not mix_path.is_file():
        raise SpecError(f"traffic {traffic!r}: no {mix_path}")
    return Cell(root, bench, wl, config, json.loads(mix_path.read_text()))


def metric_reader(root: Path, name: str) -> ModuleType:
    if not NAME.match(name):
        raise SpecError(f"metric name {name!r}")
    return _load_module(Path(root) / "vvbench" / "metrics" / f"{name}.py",
                        "vvbench_metric_" + name.replace(".", "_")
                        .replace("-", "_"))


def problems(root: Path) -> list[str]:
    """What in BENCHMARK.json and its files breaks the benchmark's rules
    that can be checked without a run."""
    root = Path(root)
    bench = load_bench(root)
    out = []
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(bench) != keys:
        out.append(f"top-level keys {sorted(bench)}")
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["traffic"] for w in bench["workloads"]]
    for name in names:
        if not NAME.match(name):
            out.append(f"name {name!r}")
    for group in ("configs", "workloads"):
        seen = [x["name"] for x in bench[group]]
        if len(seen) != len(set(seen)):
            out.append(f"duplicate names in {group}")
    metrics = bench["end_to_end"] + bench["per_layer"]
    if len({m["name"] for m in metrics}) != len(metrics):
        out.append("duplicate metric names")
    for m in metrics:
        if not UNIT.match(m["unit"]) or m["better"] not in ("lower", "higher"):
            out.append(f"metric {m['name']}: unit or better")
    e2e = {m["name"] for m in bench["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in bench["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']} moves {m['moves']!r}")
        try:
            reader = metric_reader(root, m["name"])
        except SpecError as err:
            out.append(str(err))
            continue
        for key in ("source", "layer", "moves"):
            if getattr(reader, key.upper(), None) != m[key]:
                out.append(f"{m['name']}: {key} differs from its reader")
    for wl in bench["workloads"]:
        try:
            c = cell(root, wl["name"])
            c.driver()
        except SpecError as err:
            out.append(str(err))
            continue
        reported = {m["name"] for m in c.end_to_end()}
        if "setup_s" not in reported or len(reported) < 2:
            out.append(f"{wl['name']}: end-to-end metrics {sorted(reported)}")
        if not c.per_layer():
            out.append(f"{wl['name']}: no per-layer metric")
        for m in c.per_layer():
            if "workloads" in m and m["moves"] not in reported:
                out.append(f"{m['name']} in {wl['name']}, which does not "
                           f"report {m['moves']}")
    return out
