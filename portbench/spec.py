"""Where the harness finds a cell's pieces, by the names in BENCHMARK.json.

- `BENCHMARK.json` at the root of the checkout: cells, configurations, metrics.
- `portbench/workloads/<cell>.json`: the traffic mix (templates and weights,
  clients, order, sample size, the limits of the comparison).
- `portbench/configs/<config>.json` (the configuration as run, with its
  `shards`, the cards of its deployment, 1 where it states none) and
  `portbench/configs/<config>.py` (its generator: `make(cfg, seed, scale, device)`).
- `portbench/templates/<config>/<template>.py`: SQL, parameters, the columns
  read and the plain reference.
- `portbench/metrics/<metric>.py`: `read(ctx)` of one per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_module(path: str, name: str) -> ModuleType:
    """Import the file `path` as a module named `name` (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of BENCHMARK.json's `workloads` with its traffic mix,
    configuration and templates."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench if bench is not None else benchmark()
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entry
        self.chips = int(entry["chips"])
        self.mix = load_json(os.path.join(PKG, "workloads", f"{entry['traffic']}.json"))
        self.config_name = entry["config"]
        centry = next(c for c in bench["configs"] if c["name"] == self.config_name)
        self.config = load_json(os.path.join(ROOT, centry["file"]))
        # the deployment's layout: the port runs Config(num_shards=shards),
        # one shard a card, so a cell takes as many cards as its
        # configuration has shards, no idle card and none short
        self.shards = int(self.config.get("shards", 1))
        if self.chips != self.shards:
            raise ValueError(f"{name}: {self.chips} chips for the {self.shards} shard(s) of "
                             f"{self.config_name}")
        self.generator = load_module(os.path.join(PKG, "configs", f"{self.config_name}.py"),
                                     f"portbench_config_{self.config_name}")
        self.templates = {
            t: load_module(os.path.join(PKG, "templates", self.config_name, f"{t}.py"),
                           f"portbench_tpl_{self.config_name}_{t}")
            for t in self.mix["templates"]}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def metric_reader(self, metric: str) -> ModuleType:
        return load_module(os.path.join(PKG, "metrics", f"{metric}.py"),
                           f"portbench_metric_{metric}")
