#!/usr/bin/env python3
"""Readings that a cell's check limits are set from, on the chip at the
cell's own size: for each seed, one run of the cell with a short window at
its own load, the number its check compares (the lower reading, from sound
runs of the program) and, for the first ``--control`` seeds, the control's
reading (the reference in the next precision below the configuration's, in
the program's place: the upper reading). ``--serving KEY=VALUE`` runs the
program with a serving knob of the configuration changed: with its own
lower-precision path switched on (``vision_bits=8`` for the bf16 front,
``lm_bits=4`` for the int8 LM) the numbers compared are a control's. One
process for all seeds; one JSON line a seed, then a summary line. The
cell's limit is not applied.

    python benchmark/calibrate.py --workload serve-int8-fleet28 --seeds 101 102 103 \\
        --control 3 --seconds 10
    python benchmark/calibrate.py --workload serve-int8-fleet28 --seeds 201 202 203 \\
        --control 0 --serving vision_bits=8
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--serving", action="append", default=[], metavar="KEY=VALUE",
                   help="a serving knob of the configuration, as JSON (e.g. vision_bits=8)")
    args = p.parse_args(argv)
    from benchmark import run as bench_run

    bench_run.set_env()
    import torch

    from benchmark.harness import cells

    cell = cells.load(args.workload)
    for kv in args.serving:
        k, v = kv.split("=", 1)
        if k not in cell.cfg["serving"]:
            raise SystemExit(f"no serving knob {k!r} in the configuration")
        cell.cfg["serving"][k] = json.loads(v)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    lows, highs = [], []
    for i, seed in enumerate(args.seeds):
        t0 = time.monotonic()
        ctx = SimpleNamespace(cfg=cell.cfg, mix=cell.mix, seed=seed, seconds=args.seconds,
                              trace=False, device=device, setup_clock=lambda: time.monotonic() - t0,
                              control=i < args.control)
        run = cells.driver(cell.cfg).run(ctx)
        detail = run["check_detail"]
        row = {"seed": seed, "failed": run["failed"], "finished": len(run["in_window"]),
               "setup_s": run["setup_s"], "checks": {k: c["value"] for k, c in run["checks"].items()},
               "control": detail.get("control_gap_max"), "requests": detail["requests"],
               "tokens": detail["tokens"], "gaps": detail["gaps"],
               "control_gaps": detail.get("control_gaps"), "wall_s": time.monotonic() - t0}
        lows.append(row["checks"])
        if row["control"] is not None:
            highs.append(row["control"])
        print(json.dumps(row), flush=True)
    names = lows[0].keys()
    print(json.dumps({"lower": {n: max(r[n] for r in lows) for n in names},
                      "upper": min(highs) if highs else None, "seeds": len(lows),
                      "control_seeds": len(highs), "serving": args.serving,
                      "card": torch.cuda.get_device_name(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
