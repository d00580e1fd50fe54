"""The benchmark's cells, found by name: ``BENCHMARK.json`` at the root of the
checkout names each cell's configuration and traffic mix, and each metric;
everything of one configuration, traffic mix or metric lies in a file of
its own, which this module loads by that name:

- a configuration: the ``file`` its entry names (``benchmark/configs/``);
- a traffic mix: ``benchmark/traffic/<traffic>.json``;
- a metric: ``benchmark/metrics/<name>.py``, whose ``read(run)`` returns
  its value from a finished run, or None where the run has nothing for it to
  read (the metric is then left out of the result). A quantity read in
  cells that move different end-to-end metrics has one name for each
  (``serve.mfu``, ``serve.mfu.tail``) and one reader: where
  ``<name>.py`` is not there, the name less its last dotted part is tried,
  down to the first part;
- a driver: ``benchmark/drivers/<driver>.py``, named by the configuration,
  whose ``run(ctx)`` makes one run of a cell.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, with its
    configuration, traffic mix and metrics."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json")) as f:
        mix = json.load(f)
    return Cell(name, int(w["chips"]), cfg, mix,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def driver(cfg: dict):
    return importlib.import_module(f"benchmark.drivers.{cfg['driver']}")


def reader(metric: str):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``, or of the
    longest dotted prefix of ``metric`` that has a file there."""
    parts = metric.split(".")
    for n in range(len(parts), 0, -1):
        path = os.path.join(BENCH_DIR, "metrics", ".".join(parts[:n]) + ".py")
        if os.path.exists(path):
            break
    else:
        raise FileNotFoundError(f"no reader for metric {metric!r} in benchmark/metrics/")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, run: dict) -> dict:
    """{name: {"value", "unit"}} of the entries whose reader finds a value."""
    out = {}
    for m in entries:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
