"""Profiling and timing helpers (port of spatialvla_tpu/utils/profiling.py):
a ``torch.profiler`` trace written as a Chrome trace, a sync of the CUDA
devices a tree's tensors live on, and a mean wall-clock time of a call."""
from __future__ import annotations

import contextlib
import os
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
