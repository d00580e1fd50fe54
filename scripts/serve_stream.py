#!/usr/bin/env python3
"""Warm int8 `predict` latency over a stream of instructions of many lengths,
on an NVIDIA GPU, for comparing checkouts of the port.

    python3 scripts/serve_stream.py [--root DIR] [--label NAME]

Builds full-width spatialvla_4b (random weights, seed 0) after
quantize(bits=8), warms it up with three requests through the eager decode
loop, then sends 24 requests whose instructions have 24 lengths (prefixes of
264 to 379 tokens; more than the 8 decode graphs a policy keeps), one after
another, each timed by the host clock around a synchronized
``SpatialVLAPolicy.predict``. Prints each request's ms, the mean and median,
the decode graphs captured (where the checkout has them) and the card.
``--root`` imports ``spatialvla_tpu_torch`` from another checkout (a parent
commit unpacked with ``git archive``), so that versions can be timed in turn
in one call; the host's speed moves these times between calls.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

WORDS = ("please pick up the small green block on the left side of the table and then "
         "place it carefully inside the open top drawer").split()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from spatialvla_tpu_torch import SpatialVLAPolicy, spatialvla_4b

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    cfg = spatialvla_4b()
    policy = SpatialVLAPolicy.init_random(cfg, "cuda:0", seed=0).quantize(bits=8)
    rng = np.random.RandomState(7)
    size = cfg.vision.image_size
    images = [(rng.rand(size, size, 3) * 255).astype(np.uint8) for _ in range(3)]
    graphs = getattr(policy, "decode_graphs", None)
    if graphs is not None:
        policy.use_cuda_graph = False
    for img in images:  # kernels built, allocator warm; no decode graph yet
        policy.predict(img, "pick up the red cup")
    if graphs is not None:
        policy.use_cuda_graph = None
    instrs = [" ".join(WORDS[:k]) for k in range(1, len(WORDS) + 1)]
    times, lengths = [], []
    for i, instr in enumerate(instrs):
        img = images[i % len(images)]
        lengths.append(int(policy.processor(img, instr)["input_ids"].shape[1]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        policy.predict(img, instr)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    captured = "no decode graphs" if graphs is None else f"{len(graphs)} decode graphs kept"
    print(f"stream {args.label} ({args.root}): {len(instrs)} requests, prefixes "
          f"{min(lengths)}..{max(lengths)} ({len(set(lengths))} lengths); predict mean "
          f"{statistics.mean(times):.2f} ms, median {statistics.median(times):.2f} ms; "
          f"{captured} | {card}", flush=True)
    print(f"    per request ms {[round(t, 2) for t in times]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
