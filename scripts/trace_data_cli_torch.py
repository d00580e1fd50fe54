#!/usr/bin/env python3
"""Trace the pretrain CLI's steps beside background checkpoint writes on the
card: chip_smoke.py's data_cli_path phase (the committed RLDS fixture,
pretrain.main at full width with the LM cut, a step checkpoint every 2
steps, then the LoRA fine-tune from its export), each run in a process of
its own, one after the other: "plain" untraced, "traced" with three of the
pretrain run's steps under ``torch.profiler`` (the second, alone; the
third, the first beside a write, into host buffers the save just made; the
fifth, beside the next write, into the same buffers).

    python scripts/trace_data_cli_torch.py --out DIR [--modes plain,traced]
        [--write_chunk_mib N]

``--modes`` runs the listed modes in that order (one may repeat);
``--write_chunk_mib`` sets ``convert/safetensors_io.WRITE_CHUNK_BYTES`` in
them (0: a whole tensor a write() call; default: the library's). The
pretrain run takes 6 steps (saves at 2, 4 and 6). While each runs, a
sampler process reads the stepping thread's state
(``/proc/<pid>/task/<tid>/stat``) every millisecond and every thread's CPU
ticks every 50 ms. Writes ``<out>/step<i>/trace.json`` (Chrome traces) and
``<out>/<mode>-<k>.json`` (each pretrain step: wall ms, whether a write was
in flight, the stepping thread's user / system CPU ms, page faults and
context switches and sampled states, each thread's CPU ms; the traced
steps' kernels and ops) and prints one JSON line of them all. The
runs' directories go where chip_smoke puts them
(``chip_smoke.data_cli_work_root``). Needs an NVIDIA GPU; imports nothing of
jax.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEPS = 6
THREADS_PERIOD_S, STEPPING_PERIOD_S = 0.05, 0.001


def _stat(path):
    """(state, user ticks, system ticks) of a task's stat file, or None."""
    try:
        with open(path) as f:
            stat = f.read()
    except OSError:
        return None
    fields = stat[stat.rfind(")") + 2:].split()
    return fields[0], int(fields[11]), int(fields[12])


def sample(pid: int, tid: int, out: str):
    """The sampler process: JSON lines until SIGTERM (perf_counter is
    CLOCK_MONOTONIC, the clock the stepping process's step times use)."""
    stop = []
    signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
    tasks = f"/proc/{pid}/task"
    next_threads = 0.0
    with open(out, "w") as f:
        while not stop:
            t = time.perf_counter()
            row = {"t": t, "state": (_stat(f"{tasks}/{tid}/stat") or "?")[0]}
            if t >= next_threads:
                row["threads"] = {t_id: st[1:] for t_id in os.listdir(tasks)
                                  for st in [_stat(f"{tasks}/{t_id}/stat")] if st}
                next_threads = t + THREADS_PERIOD_S
            f.write(json.dumps(row) + "\n")
            time.sleep(STEPPING_PERIOD_S)


def per_step(steps, samples):
    """Each step's samples: the stepping thread's states by count and, between
    the 50 ms samples around the step, each thread's user / system CPU ms."""
    tick_ms = 1e3 / os.sysconf("SC_CLK_TCK")
    every = [s for s in samples if "threads" in s]
    for st in steps:
        t0, t1 = st["t0"], st["t0"] + st["ms"] / 1e3
        st["states"] = dict(collections.Counter(s["state"] for s in samples
                                                if t0 <= s["t"] <= t1))
        before = [s for s in every if s["t"] <= t0]
        after = [s for s in every if s["t"] >= t1]
        if before and after:
            a, b = before[-1]["threads"], after[0]["threads"]
            st["thread_cpu_ms"] = {
                t_id: [(u1 - u0) * tick_ms, (s1 - s0) * tick_ms]
                for t_id, (u1, s1) in b.items() for u0, s0 in [a.get(t_id, (0, 0))]
                if u1 - u0 or s1 - s0}
    return steps


def run(mode: str, args) -> dict:
    """One phase in this process, sampled; its pretrain steps and writes."""
    import threading

    import torch

    import chip_smoke
    from spatialvla_tpu_torch.convert import safetensors_io
    from spatialvla_tpu_torch.ops import _lib
    from spatialvla_tpu_torch.ops import flash_attention as fa

    if args.write_chunk_mib is not None:
        safetensors_io.WRITE_CHUNK_BYTES = args.write_chunk_mib << 20
    _lib.build()
    flash = [fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv]
    log = os.path.join(args.out, f"{mode}.samples.jsonl")
    chunk = safetensors_io.WRITE_CHUNK_BYTES
    sampler = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--out", args.out,
                                "--sample", str(os.getpid()), str(threading.get_native_id()),
                                log])
    try:
        res = chip_smoke.data_cli_path(
            torch, flash, steps=STEPS, work_root=chip_smoke.data_cli_work_root(),
            trace_dir=args.out if mode == "traced" else None)
    finally:
        sampler.terminate()
        sampler.wait()
    samples = [json.loads(line) for line in open(log) if line.strip()]
    os.remove(log)
    return {"card": chip_smoke.card_line(), "mode": mode, "write_chunk_bytes": chunk,
            "steps": per_step(res["pretrain"]["steps"], samples),
            "writes": res["pretrain"]["writes"], "sampled": len(samples)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="the directory of the traces and summaries")
    p.add_argument("--modes", default="plain,traced")
    p.add_argument("--write_chunk_mib", type=int)
    p.add_argument("--run", choices=("plain", "traced"), help=argparse.SUPPRESS)
    p.add_argument("--tag", default="", help=argparse.SUPPRESS)
    p.add_argument("--sample", nargs=3, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.sample:
        return sample(int(args.sample[0]), int(args.sample[1]), args.sample[2])

    import torch

    if not torch.cuda.is_available():
        sys.exit("trace_data_cli_torch.py needs an NVIDIA GPU")
    os.makedirs(args.out, exist_ok=True)
    if args.run:
        result = run(args.run, args)
        with open(os.path.join(args.out, f"{args.tag}.json"), "w") as f:
            json.dump(result, f, indent=1)
        return result
    summary = {}
    for k, mode in enumerate(args.modes.split(",")):
        # a process each: the host memory one leaves is not the next's
        tag = f"{mode}-{k}"
        extra = [] if args.write_chunk_mib is None else ["--write_chunk_mib",
                                                          str(args.write_chunk_mib)]
        subprocess.run([sys.executable, os.path.abspath(__file__), "--run", mode, "--tag", tag,
                        "--out", args.out] + extra, check=True)
        with open(os.path.join(args.out, f"{tag}.json")) as f:
            summary[tag] = json.load(f)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
