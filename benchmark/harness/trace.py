"""The traced window: a ``torch.profiler`` trace of the card and the host,
read back as the device's busy time, the device operations that took the
most of it, and the idle gaps by what the host was doing.

The window is the benchmark's own ``record_function(WINDOW)`` range on the
thread that times the run, so idle time at either end of the window counts.
The interval union and the kernel-name shortening are the arithmetic of
``spatialvla_tpu_torch/utils/profiling.py`` (``_union_us``,
``short_kernel_name``), copied so that the yardstick stays with the
benchmark.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import re
import tempfile

WINDOW = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation", "python_function")
TOP = 10
LABELLED_GAPS = 5000  # the longest gaps are labelled by the host's activity


def short_name(name: str) -> str:
    """A kernel's name without "void ", anonymous namespaces, its template
    and its argument lists."""
    return re.sub(r"^void |\(anonymous namespace\)::", "", name).split("(")[0].split("<")[0]


def union_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


@contextlib.contextmanager
def profiled(enabled: bool):
    """A ``torch.profiler`` over the card and the host while ``enabled``;
    yields the profiler (None when off)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def events(prof) -> list:
    """The complete ("X") events of a finished profile, from its Chrome
    trace, written to a temporary file and read back."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    data = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in data if e.get("ph") == "X"]


class _HostIndex:
    """Host events by thread, to find the innermost one open at a time."""

    def __init__(self, evs):
        self.by_tid = collections.defaultdict(list)
        for e in evs:
            if e.get("cat") in HOST_CATS:
                self.by_tid[e.get("tid")].append((e["ts"], e["ts"] + e["dur"], e["name"]))
        for rows in self.by_tid.values():
            rows.sort()
        self.starts = {tid: [r[0] for r in rows] for tid, rows in self.by_tid.items()}

    def innermost(self, tid, t: float):
        rows, starts = self.by_tid.get(tid, []), self.starts.get(tid, [])
        best = None
        i = bisect.bisect_right(starts, t)
        for a, b, name in reversed(rows[max(0, i - 256):i]):  # nesting is shallow
            if b >= t and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else None


def summary(evs: list) -> dict:
    """Over the WINDOW range: busy_s (the union of the device operations'
    intervals, cut to the window), window_s, ops_s (device seconds by short
    name, all of them), device_ops (the TOP names by seconds) and idle_gaps
    (the gaps between device work, the longest LABELLED_GAPS labelled by what
    the thread that launched the work after the gap was doing when the gap
    opened: its innermost CUDA call or range; seconds summed by label, the
    TOP labels). None without the window range or without device work in it."""
    marks = [e for e in evs if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not marks:
        return None
    w0, w1 = marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    if not dev:
        return None
    cut = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev]
    busy = union_us(cut)
    ops = collections.defaultdict(float)
    for e, (a, b) in zip(dev, cut):
        ops[short_name(e["name"])] += (b - a) / 1e6
    # gaps, each with the device event that ends it
    dev_sorted = sorted(zip(cut, dev), key=lambda x: x[0])
    gaps, end = [], w0
    for (a, b), e in dev_sorted:
        if a > end:
            gaps.append((a - end, end, e))
        end = max(end, b)
    if w1 > end:
        gaps.append((w1 - end, end, None))
    launches = {}
    for e in evs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e.get("tid")
    host = _HostIndex(evs)
    labelled = collections.defaultdict(float)
    gaps.sort(key=lambda g: -g[0])
    for length, start, e in gaps[:LABELLED_GAPS]:
        label = "window end"
        if e is not None:
            tid = launches.get(e.get("args", {}).get("correlation"))
            label = (host.innermost(tid, start) if tid is not None else None) or "host: no range"
        labelled[label] += length / 1e6
    rest = sum(g[0] for g in gaps[LABELLED_GAPS:]) / 1e6
    if rest:
        labelled["shorter gaps"] += rest
    rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:TOP]  # noqa: E731
    return {"busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6, "ops_s": dict(ops),
            "device_ops": rank(ops), "idle_gaps": rank(labelled)}


def ops_seconds(trace: dict, prefixes) -> float:
    """Device seconds of the operations whose short names start with one
    of ``prefixes``."""
    return sum(s for name, s in trace["ops_s"].items() if name.startswith(tuple(prefixes)))
