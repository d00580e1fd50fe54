#!/usr/bin/env python3
"""Offered rate against what a serving cell's program sustains: the cell's
traffic at each of ``--rates`` requests a second (its period shortened or
lengthened, everything else as the cell states), one short window each, in
one process. One JSON line a rate: the rate offered and completed, the
latency's median and 95th percentile, the requests still unanswered at the
close, the engine's mean batch rows. The highest rate whose backlog does
not grow is the knee the cells' rates are set from.

    python benchmark/sweep.py --workload serve-int8-fleet28 --rates 20 30 40 --seconds 15
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    from benchmark import run as bench_run

    bench_run.set_env()
    import torch

    from benchmark.harness import cells

    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for rate in args.rates:
        mix = dict(cell.mix, loop="open", period_s=cell.mix["robots"] / rate)
        t0 = time.monotonic()
        ctx = SimpleNamespace(cfg=cell.cfg, mix=mix, seed=args.seed, seconds=args.seconds,
                              trace=False, device=torch.device("cuda", 0),
                              setup_clock=lambda: time.monotonic() - t0)
        run = cells.driver(cell.cfg).run(ctx)
        lat = sorted(d.latency_ms for d in run["answered"])
        print(json.dumps({
            "offered_rps": rate, "completed_rps": len(run["in_window"]) / run["seconds"],
            "attempted": run["attempted"], "failed": run["failed"],
            "unanswered_at_close": run["attempted"] - len(run["in_window"]),
            "p50_ms": lat[len(lat) // 2] if lat else None,
            "p95_ms": lat[math.ceil(0.95 * len(lat)) - 1] if lat else None,
            "batch_rows": run["engine"]["mean_batch_occupancy"],
            "sender_late_ms": run["sender_late_ms"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
