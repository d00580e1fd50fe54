"""Process-sharded frame loading: N worker processes, per-worker shard
split, IPC frame batches.

The single-process pipeline scales its decode/augment stage over threads
(the C calls release the GIL) but keeps a GIL-bound serial stream
(sampling, shuffle buffer, chunk bookkeeping, ~150 us/frame). On hosts
where that serial ceiling binds — or where thread scaling saturates —
this loader runs ``num_workers`` full pipelines in separate processes,
each on a disjoint shard-file subset, and interleaves their output through
an IPC queue. It is the TPU-host equivalent of tf.data's multi-threaded
C++ runtime feeding per-rank readers (reference data/rlds.py:464-573 +
per-rank seeding data/dataset.py:82).

Sharding composition: with multi-host rank (r, W) and ``num_workers`` w
per host, worker i reads shard slot (r * w + i) of (W * w) — disjoint
across both hosts and workers, and per-worker seeds derive from the base
seed so streams differ (the reference's 3407*rank semantics, one level
deeper).

The data layer is jax-free, so workers are spawned cleanly without
inheriting any accelerator runtime state.
"""
from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
from typing import Dict, Iterator, Optional, Tuple

_STOP_TIMEOUT_S = 5.0


def compose_shard(base: Tuple[int, int], worker_idx: int, num_workers: int) -> Tuple[int, int]:
    """(rank, world) x (worker, num_workers) -> flat disjoint (slot, total)."""
    rank, world = base
    return rank * num_workers + worker_idx, world * num_workers


def _worker_main(dataset_kwargs: Dict, worker_idx: int, num_workers: int, out_q, stop):
    # built INSIDE the worker: the dataset object is not picklable and each
    # worker must own its native reader/thread pool
    from .pipeline import InterleavedRLDSDataset

    kwargs = dict(dataset_kwargs)
    base = kwargs.pop("shard_by_rank", (0, 1))
    kwargs["shard_by_rank"] = compose_shard(base, worker_idx, num_workers)
    kwargs["seed"] = int(kwargs.get("seed", 0)) + 1000003 * worker_idx
    try:
        ds = InterleavedRLDSDataset(**kwargs)
        for frame in ds.frames():
            while not stop.is_set():
                try:
                    out_q.put(frame, timeout=0.25)
                    break
                except queue_mod.Full:
                    continue
            if stop.is_set():
                return
    except Exception as e:  # noqa: BLE001 — surface worker death to the parent
        # keep retrying the error report: under backpressure the queue is
        # usually full, and a swallowed report would let training continue
        # with this worker's shard slice silently missing (the parent also
        # polls exit codes as a backstop — frames())
        msg = {"__worker_error__": f"{type(e).__name__}: {e}"}
        while not stop.is_set():
            try:
                out_q.put(msg, timeout=0.25)
                break
            except queue_mod.Full:
                continue
        raise


class ProcessShardedFrameLoader:
    """``frames()`` interleaves the workers' infinite frame streams.

    dataset_kwargs are the InterleavedRLDSDataset constructor kwargs
    (mixture, data_dir, configs, seed, shard_by_rank, ...). Statistics for
    the processor should come from a parent-built dataset (its on-disk
    cache also pre-warms the workers so they do not race the statistics
    pass); pass ``statistics_override`` through dataset_kwargs for that.
    """

    def __init__(
        self,
        dataset_kwargs: Dict,
        *,
        num_workers: int = 2,
        queue_depth: int = 512,
        start_method: str = "spawn",
    ):
        assert num_workers >= 1
        self.num_workers = num_workers
        ctx = mp.get_context(start_method)
        self._queue = ctx.Queue(maxsize=queue_depth)
        self._stop = ctx.Event()
        self._procs = [
            ctx.Process(
                target=_worker_main,
                args=(dataset_kwargs, i, num_workers, self._queue, self._stop),
                daemon=True,
            )
            for i in range(num_workers)
        ]
        for p in self._procs:
            p.start()

    def frames(self) -> Iterator[Dict]:
        n = 0
        while True:
            try:
                frame = self._queue.get(timeout=60.0)
            except queue_mod.Empty:
                self._check_workers()
                continue
            if "__worker_error__" in frame:
                self.close()
                raise RuntimeError(f"loader worker failed: {frame['__worker_error__']}")
            n += 1
            if n % 256 == 0:  # cheap liveness backstop: a worker killed
                # hard (OOM/SIGKILL) posts no error message, but its shard
                # slice must not silently vanish from the mixture
                self._check_workers()
            yield frame

    def _check_workers(self):
        """The streams are infinite — ANY worker exit is abnormal."""
        dead = [p for p in self._procs if not p.is_alive()]
        if dead and not self._stop.is_set():
            codes = [p.exitcode for p in dead]
            # the dying worker's detailed error report may sit behind
            # buffered frames — surface it instead of just the exit code
            detail = ""
            try:
                while True:
                    item = self._queue.get_nowait()
                    if isinstance(item, dict) and "__worker_error__" in item:
                        detail = f": {item['__worker_error__']}"
                        break
            except queue_mod.Empty:
                pass
            self.close()
            raise RuntimeError(
                f"{len(dead)}/{len(self._procs)} loader workers exited "
                f"(exit codes {codes}){detail}; their shard slices would "
                "be silently missing from the mixture"
            )

    def close(self):
        if getattr(self, "_closed", False):
            return
        self._closed = True
        self._stop.set()
        # drain so blocked puts observe the stop flag
        try:
            while True:
                self._queue.get_nowait()
        except queue_mod.Empty:
            pass
        for p in self._procs:
            p.join(timeout=_STOP_TIMEOUT_S)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=_STOP_TIMEOUT_S)
        self._queue.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
