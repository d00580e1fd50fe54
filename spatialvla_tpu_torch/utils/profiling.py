"""Profiling and timing helpers (port of spatialvla_tpu/utils/profiling.py):
a ``torch.profiler`` trace written as a Chrome trace, a sync of the CUDA
devices a tree's tensors live on, and a mean wall-clock time of a call; and
for the port's profiling scripts, a trace's kernels read back as the card's
busy time, and the card's name and power limit."""
from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import subprocess
import tempfile
import time

import torch

from .tree import iter_leaves


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (CPU, and CUDA when a card is
    present) and write ``<log_dir>/trace.json`` (chrome://tracing,
    Perfetto). Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sync(tree) -> None:
    """Wait until the work that made ``tree``'s tensors is done: synchronize
    each CUDA device that one of its tensors lives on (a tensor, or a nested
    dict / list of them; CPU tensors need no wait)."""
    if isinstance(tree, torch.Tensor):
        tree = [tree]
    devices = {t.device for _, t in iter_leaves(tree)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


def timeit(fn, *args, iters: int = 10, warmup: int = 1, **kwargs) -> float:
    """The mean wall-clock seconds of ``fn(*args, **kwargs)`` over ``iters``
    calls after ``warmup`` calls, synchronized once at the end of the timed
    calls (on their last output), as the JAX helper does."""
    for _ in range(warmup):
        sync(fn(*args, **kwargs))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args, **kwargs)
    sync(out)
    return (time.perf_counter() - t0) / iters


def trace_events(prof, path=None) -> list:
    """The complete events ("ph" "X") of a finished ``torch.profiler``
    profile, read back from its Chrome trace, which is written to ``path``
    (kept) or to a temporary file; a profile exports its trace once."""
    with tempfile.TemporaryDirectory() as tmp:
        path = str(path or os.path.join(tmp, "trace.json"))
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    return [e for e in events if e.get("ph") == "X"]


def short_kernel_name(name: str) -> str:
    """A kernel's name without "void ", anonymous namespaces and its
    argument list."""
    return re.sub(r"^void |\(anonymous namespace\)::", "", name).split("(")[0]


def _union_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def kernel_busy(events, window_tag=None, top: int = 8) -> dict:
    """The card's work in a trace's events (``trace_events``): over the
    window (the first ``record_function(window_tag)`` range, or without a
    tag the first kernel's start to the last one's end), the kernels inside
    it, their busy ms (the union of their device intervals, cut to the
    window), the window's ms and idle share, and the ``top`` kernels by
    device ms ({"name", "ms", "launches"}, names by ``short_kernel_name``;
    ``top=None`` lists all). Without kernels in the window (the CPU) the
    times are None."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if window_tag is not None:
        marks = [e for e in events
                 if e.get("cat") == "user_annotation" and e.get("name") == window_tag]
        if not marks:
            raise ValueError(f"the trace holds no {window_tag!r} range")
        w0, w1 = marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
        kernels = [e for e in kernels if e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    elif kernels:
        w0 = min(e["ts"] for e in kernels)
        w1 = max(e["ts"] + e["dur"] for e in kernels)
    out = {"kernels": len(kernels), "busy_ms": None, "window_ms": None, "idle_share": None,
           "top": []}
    if not kernels:
        return out
    busy = _union_us((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in kernels) / 1e3
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        row = by_name[short_kernel_name(e["name"])]
        row[0] += e["dur"] / 1e3
        row[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    window = (w1 - w0) / 1e3
    out.update(busy_ms=busy, window_ms=window, idle_share=1.0 - busy / window,
               top=[{"name": k, "ms": ms, "launches": n}
                    for k, (ms, n) in ranked[:top if top is not None else len(ranked)]])
    return out


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them for
    card 0 (or why nvidia-smi failed)."""
    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"
