#!/usr/bin/env python3
"""Where one full-width training step's device time goes, on an NVIDIA GPU.

    python3 scripts/profile_train_step.py [--root DIR] [--steps 5] [--tag NAME]

Builds the training step of chip_smoke.py's train_path: spatialvla_4b with
random fp32 masters from a seed, the pretrain CLI's AdamW, bf16 compute,
remat, flash attention, 256-token loss chunks, batches of 2 x 320 from the
port's processor. Runs ``--steps`` steps, each between two synchronizes on
the host clock (median after 2 warm-up steps), then one more step under
``torch.profiler``: the device time of every kernel of that step, summed by
kernel name from the chrome trace (operator rows are not counted), the
flash kernels among them (forward, dq, dk/dv, by the names of the FMA and
the tensor-core kernels), the busy time, the span from the first kernel's
start to the last one's end, and the idle share 1 - busy / span.
``--root`` imports ``spatialvla_tpu_torch`` and ``chip_smoke`` from another
checkout (a parent commit unpacked with ``git archive``), so that two
versions can be traced in one call; ``--tag`` names the run in the printed
lines, the summary and the 15 kernels of most device time.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import statistics
import sys
import tempfile
import time
from pathlib import Path


def flash_kind(name: str):
    """"fwd", "dq", "dkv" or None for a kernel's name in the trace (the FMA
    kernels flash_bwd_dq_kernel / flash_bwd_dkv_kernel, the tensor-core
    flash_bwd_mma_kernel<DMAX, dk/dv>)."""
    if "flash_fwd" in name:
        return "fwd"
    mma = re.search(r"flash_bwd_mma_kernel<\d+, (true|false)>", name)
    if mma:
        return "dkv" if mma.group(1) == "true" else "dq"
    if "flash_bwd_dq" in name:
        return "dq"
    if "flash_bwd" in name:
        return "dkv"
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import chip_smoke as cs
    from spatialvla_tpu_torch import spatialvla_4b
    from spatialvla_tpu_torch.inference import default_processor
    from spatialvla_tpu_torch.models import spatialvla as sv
    from spatialvla_tpu_torch.ops import _lib
    from spatialvla_tpu_torch.train import (OptimizerConfig, TrainStepConfig, build_decode_luts,
                                            init_train_state, make_optimizer, make_train_step,
                                            trainable_mask)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"[{args.tag}] card: {card}; package from {sv.__file__}", flush=True)
    _lib.build()
    cfg = spatialvla_4b()
    processor = default_processor(cfg)
    batches = cs.training_batches(processor, cfg, args.steps + 1)
    params = sv.init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                            device="cuda", dtype=torch.float32)
    mask = trainable_mask(params, freeze_llm_embed=cfg.use_spatial_token, freeze_zoe=True)
    tx = make_optimizer(OptimizerConfig(), params, mask)
    luts = {k: torch.as_tensor(v, device="cuda")
            for k, v in build_decode_luts(processor.action_tokenizer).items()}
    step = make_train_step(cfg, tx, TrainStepConfig(use_remat=True, compute_dtype=torch.bfloat16,
                                                    attn_backend="flash", loss_chunk_size=256),
                           luts=luts)
    state = init_train_state(params, tx)
    times = []
    for batch in batches[:args.steps]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(times[2:])

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batches[args.steps])
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    flash = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"] / 1e3
        kind = flash_kind(e["name"])
        if kind:
            flash[kind][0] += 1
            flash[kind][1] += e["dur"] / 1e3
    busy = sum(ms for _, ms in by_name.values())
    span = (max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)) / 1e3
    print(f"[{args.tag}] steps {[round(t, 2) for t in times]} ms, median after 2 warm-up steps "
          f"{median:.2f} ms; traced step {traced_ms:.2f} ms: {len(kernels)} kernels, busy "
          f"{busy:.3f} ms of a {span:.3f} ms span (idle share {1 - busy / span:.3f}); "
          "flash " + ", ".join(f"{k} {n} launches {ms:.3f} ms" for k, (n, ms) in
                               sorted(flash.items()))
          + f"; flash backward {flash['dq'][1] + flash['dkv'][1]:.3f} ms; loss "
          f"{float(metrics['loss']):.4f} | {card}", flush=True)
    top = sorted(((ms, c, n) for n, (c, ms) in by_name.items()), reverse=True)[:15]
    for ms, count, name in top:
        print(f"[{args.tag}]   {ms:9.3f} ms {count:6d} x {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
