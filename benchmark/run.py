#!/usr/bin/env python3
"""Run one cell of the benchmark of ``spatialvla_tpu_torch`` and print its
result as the last line of standard output.

    python benchmark/run.py --workload serve-int8-fleet28 --seed 7 --seconds 45 --trace 0

The cell (``BENCHMARK.json`` at the root of the checkout) names a
configuration, whose driver makes the run (``benchmark/drivers/``), and a
traffic mix. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics from a traced window, with the device's busy and
window seconds and a breakdown. Every run checks what the timed path
produced against the reference (``benchmark/reference/``) and prints each
number compared beside its limit, last on standard error and last in the
result line. Without enough cards the run prints no result and exits
non-zero; so does a run in whose process JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

T_IMPORT = time.monotonic()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")


def process_age_s() -> float:
    """Seconds since this process started (from /proc), or since this module
    was imported where /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - T_IMPORT


def set_env():
    """Build and kernel caches at fixed paths inside the checkout, and no
    JAX or Flax through libraries that would load them on their own."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def execute(cell, seed: int, seconds: float, trace: bool, device, setup_clock=process_age_s):
    """One run of ``cell`` on ``device``: (the result line as a dict, its
    checks last; the driver's record of the run)."""
    import torch

    from benchmark.harness import cells, roofline

    ctx = SimpleNamespace(cfg=cell.cfg, mix=cell.mix, seed=seed, seconds=seconds, trace=trace,
                          device=device, setup_clock=setup_clock)
    run = cells.driver(cell.cfg).run(ctx)
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    run.update(cfg=cell.cfg, mix=cell.mix, device_kind=kind,
               peaks=roofline.peaks(kind) if cuda else None)
    metrics = cells.read_metrics(cell.per_layer if trace else cell.end_to_end, run)
    checks = run["checks"]
    correct = run["failed"] == 0 and all(
        c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": run["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": run["attempted"], "failed": run["failed"],
            "metrics": metrics, "device": dev}
    if trace and run["trace"] is not None:
        dev.update(busy_s=run["trace"]["busy_s"], window_s=run["trace"]["window_s"])
        line["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                             "idle_gaps": run["trace"]["idle_gaps"]}
    line["checks"] = checks
    return line, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_env()
    sys.path.insert(0, ROOT)
    from benchmark.harness import cells, guard

    cell = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 2
    line, run = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = guard.loaded()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark runs the port without JAX",
              file=sys.stderr)
        return 3
    for msg in run.get("failures", []):
        print(f"failed request {msg}", file=sys.stderr)
    for key in ("engine", "sender_late_ms", "made_in_window"):
        if key in run:
            print(f"{key} {json.dumps(run[key])}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
