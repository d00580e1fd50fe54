"""Dynamic-batching serving engine (port of spatialvla_tpu/serve/engine.py).

The reference serves one request at a time; this engine batches concurrent
requests onto one card.

- ONE dispatch thread owns the card: requests are submitted from any number
  of caller threads, host-side preprocessing (tokenize, image resize) runs
  on the caller's thread, and the dispatch thread only assembles batches
  and enqueues them.
- Shape buckets: prompt lengths are right-padded to a multiple of
  ``prompt_pad_multiple``, batch sizes to the next entry of
  ``batch_buckets`` (filler rows replicate request 0, their ids are
  dropped). A batch runs the policy's pad-aware ``_generate``; on the card
  its decode loop replays the CUDA graph of its (batch, cache-slot bucket)
  shape, kept by ``policy.decode_graphs``. ``warmup_buckets`` captures every
  such graph an instruction set can produce before the engine takes
  traffic, as JAX compiles every (T, B) program. Over a mesh-sharded
  policy (``SpatialVLAPolicy.shard``) a batch runs the policy's sharded
  path (rows over the data groups when they divide them, the unfused
  decode loop over the model shards), and no decode graph is captured.
- Pipelined dispatch (``pipeline_depth`` > 1, the default): kernel launches
  are asynchronous, so the dispatch thread enqueues batch N+1 while a
  completion thread waits for batch N's ids (copied to pinned host memory
  behind an event, so it waits for that copy and nothing enqueued after it)
  and resolves its futures. An in-flight semaphore (a permit taken before
  the enqueue, returned after the wait) caps the batches in flight at
  ``pipeline_depth``; depth 1 is synchronous dispatch.
- Per-request ``unnorm_key``: the statistics matter only when the ids are
  decoded on the host, so requests against different datasets share a
  batch and each result is unnormalized with its own.
"""
from __future__ import annotations

import queue
import sys
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16)


class EngineOverloaded(RuntimeError):
    """Raised by submit() when the admission queue is at max_queue: the
    caller should shed load (HTTP 503) rather than let wait latency grow
    without bound."""


class RequestExpired(TimeoutError):
    """A request outlived its deadline_ms before dispatch. For a robot
    control loop a stale action is worse than none: drop the frame and
    submit a fresh observation."""


@dataclass
class _Request:
    ids: np.ndarray  # (1, T_i) all-valid prompt ids
    pixel_values: np.ndarray  # (1, ...) preprocessed image(s)
    intrinsic: np.ndarray  # (1, 3, 3)
    unnorm_key: Optional[str]
    deadline_ms: Optional[float] = None  # drop if not dispatched in time
    px_dev: object = None  # the pixels on the policy's device, put there at
    # submit time on the client thread (split engine): uint8 when the f32
    # pixels sit exactly on the u8/255 grid, else f32
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.monotonic)

    def expired(self, now: float) -> bool:
        return (
            self.deadline_ms is not None
            and (now - self.t_submit) * 1e3 > self.deadline_ms
        )


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _safe_resolve(future: Future, *, result=None, exception=None):
    """Resolve a future, tolerating a caller cancelling it concurrently:
    a Future.cancel() between a done() check and set_result raises
    InvalidStateError, which must not escape and fail co-batched
    requests."""
    try:
        if exception is not None:
            future.set_exception(exception)
        else:
            future.set_result(result)
    except Exception:  # InvalidStateError: cancelled/resolved concurrently
        pass


def _pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


class _HostCopy:
    """A device tensor's values on their way to host memory, ordered on the
    current stream at construction. On the card: a pinned buffer filled
    without blocking the caller and an event after the copy, so ``numpy()``
    (on another thread) waits for this copy alone, not for what the caller
    enqueues next. On the CPU: a clone."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.clone()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def assemble_batch(
    requests: List[_Request],
    *,
    pad_id: int,
    prompt_pad_multiple: int,
    batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Right-pad mixed-length requests into one fixed-shape batch.

    Returns (input_ids (B, T), attention_mask, pixel_values, intrinsic)
    with B = the batch bucket (filler rows replicate request 0) and
    T = max prompt length rounded up to `prompt_pad_multiple`. Split out
    from the dispatch loop so tests can pin batch assembly against the
    processor's own max_length padding."""
    n = len(requests)
    B = _pick_bucket(n, batch_buckets)
    T = _round_up(max(r.ids.shape[1] for r in requests), prompt_pad_multiple)
    ids = np.full((B, T), pad_id, dtype=np.int32)
    attn = np.zeros((B, T), dtype=np.int32)
    for i, r in enumerate(requests):
        t = r.ids.shape[1]
        ids[i, :t] = r.ids[0]
        attn[i, :t] = 1
    if n < B:  # filler rows: replicate request 0 (decoded rows are dropped)
        ids[n:] = ids[0]
        attn[n:] = attn[0]
    px = np.concatenate(
        [r.pixel_values for r in requests]
        + [requests[0].pixel_values] * (B - n),
        axis=0,
    )
    intr = np.concatenate(
        [r.intrinsic for r in requests] + [requests[0].intrinsic] * (B - n),
        axis=0,
    )
    return ids, attn, px, intr


def _generate_batch(policy, ids, attn, px, intr) -> torch.Tensor:
    """The pad-aware greedy ids (B, 3 * chunk) of an assembled batch, on the
    policy's device (not waited for)."""
    inputs = {"input_ids": ids, "pixel_values": px, "intrinsic": intr}
    return policy._generate(inputs, attention_mask=torch.as_tensor(attn, device=policy.device))


def warmup_buckets(
    policy,
    *,
    sample_image,
    instructions: Sequence[str],
    prompt_pad_multiple: int = 16,
    batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
    unnorm_key: Optional[str] = None,
):
    """Run one batch of every (padded-T, B) shape the given instruction
    lengths can produce, so that on the card every decode-loop CUDA graph
    the engine will replay (one a batch size and cache-slot bucket,
    ``models/spatialvla.loop_slots``) is captured before a client request
    arrives. The graphs live on the policy's ``decode_graphs``, shared by
    every engine over that policy; its limit is raised to hold them all, so
    none is dropped and captured again while serving."""
    from ..models.spatialvla import loop_slots

    reps: Dict[int, _Request] = {}  # padded-T -> representative request
    for instr in instructions:
        inputs = policy.processor(sample_image, instr, unnorm_key=unnorm_key)
        req = _Request(
            ids=np.asarray(inputs["input_ids"]),
            pixel_values=np.asarray(inputs["pixel_values"]),
            intrinsic=np.asarray(inputs["intrinsic"]),
            unnorm_key=unnorm_key,
        )
        reps.setdefault(_round_up(req.ids.shape[1], prompt_pad_multiple), req)
    n = 3 * policy.processor.action_chunk_size
    shapes = {(B, loop_slots(T + n, policy.config)) for T in reps for B in batch_buckets}
    policy.decode_graphs.limit = max(policy.decode_graphs.limit, len(shapes))
    pad_id = policy.processor.text_tokenizer.pad_id
    for req in reps.values():
        for B in batch_buckets:
            batch = assemble_batch(
                [req], pad_id=pad_id,
                prompt_pad_multiple=prompt_pad_multiple, batch_buckets=(B,),
            )
            _generate_batch(policy, *batch).cpu()


class ServingEngine:
    """Dynamic batcher over a `SpatialVLAPolicy`, on the policy's device.

    Usage:
        engine = ServingEngine(policy, max_batch_size=16)
        fut = engine.submit(image, "pick up the cup", unnorm_key=...)
        fut.result()  # {"actions": (chunk, 7), "action_ids": (3*chunk,)}
    """

    def __init__(
        self,
        policy,
        *,
        max_batch_size: int = 16,
        max_wait_ms: float = 4.0,
        prompt_pad_multiple: int = 16,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        pipeline_depth: int = 3,
        max_queue: Optional[int] = None,
    ):
        if max_batch_size > max(batch_buckets):
            raise ValueError("max_batch_size exceeds the largest batch bucket")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self.policy = policy
        self.max_batch_size = max_batch_size
        self.max_wait_ms = max_wait_ms
        self.prompt_pad_multiple = prompt_pad_multiple
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.pipeline_depth = pipeline_depth
        self.max_queue = max_queue  # admission bound: submit() sheds above it
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._pending: List[_Request] = []  # shape-incompatible holdovers
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._stats = {
            "requests": 0,
            "batches": 0,
            "batched_rows": 0,  # real rows summed over batches
            "padded_rows": 0,  # filler rows summed over batches
            "shed": 0,  # rejected at admission (max_queue)
            "expired": 0,  # dropped at dispatch (deadline_ms)
            "latency_ms": [],  # submit -> result, per request
        }
        self._completion = None  # enqueued-but-unwaited batches (FIFO)
        self._completer: Optional[threading.Thread] = None
        self._inflight: Optional[threading.Semaphore] = None
        if pipeline_depth > 1:
            # the semaphore is the backpressure: a permit is taken BEFORE a
            # batch is enqueued and returned when its wait completes, so at
            # most `pipeline_depth` batches are ever in flight
            self._completion = queue.Queue()
            self._inflight = threading.Semaphore(pipeline_depth)
            self._completer = threading.Thread(
                target=self._completion_loop,
                name="spatialvla-serve-sync",
                daemon=True,
            )
            self._completer.start()
        self._worker = threading.Thread(
            target=self._dispatch_loop, name="spatialvla-serve", daemon=True
        )
        self._worker.start()

    # -- client side -----------------------------------------------------
    def submit(
        self,
        image,
        instruction: str,
        *,
        unnorm_key: Optional[str] = None,
        deadline_ms: Optional[float] = None,
    ) -> Future:
        """Preprocess on the caller's thread, enqueue for batched dispatch.

        deadline_ms: fail the request with RequestExpired if it is still
        waiting (not yet dispatched) that long after submit; a control
        loop should drop the stale frame and send a fresh observation.
        Raises EngineOverloaded when the admission queue is at max_queue."""
        if self._stop.is_set():
            raise RuntimeError("engine is shut down")
        if self.max_queue is not None and (
            self._queue.qsize() + len(self._pending) >= self.max_queue
        ):
            with self._lock:
                self._stats["shed"] += 1
            raise EngineOverloaded(
                f"admission queue at max_queue={self.max_queue}; shed load"
            )
        # fail THIS caller fast on a bad dataset key instead of poisoning
        # the whole batch at decode time (statistics are host-side)
        stats = self.policy.processor.statistics
        if unnorm_key is not None and stats and unnorm_key not in stats:
            raise KeyError(
                f"unknown unnorm_key {unnorm_key!r}; available: {sorted(stats)}"
            )
        inputs = self.policy.processor(image, instruction, unnorm_key=unnorm_key)
        req = _Request(
            ids=np.asarray(inputs["input_ids"]),
            pixel_values=np.asarray(inputs["pixel_values"]),
            intrinsic=np.asarray(inputs["intrinsic"]),
            unnorm_key=unnorm_key,
            deadline_ms=deadline_ms,
        )
        self._queue.put(req)
        if self._stop.is_set():
            # raced with shutdown across the preprocessing window: the worker
            # may exit without seeing this request, so fail it loudly (a no-op
            # if the worker did resolve it)
            _safe_resolve(
                req.future, exception=RuntimeError("engine is shut down")
            )
        return req.future

    def predict(
        self,
        image,
        instruction: str,
        *,
        unnorm_key: Optional[str] = None,
        deadline_ms: Optional[float] = None,
    ):
        """Blocking convenience wrapper around submit()."""
        return self.submit(
            image, instruction, unnorm_key=unnorm_key, deadline_ms=deadline_ms
        ).result()

    def stats(self) -> Dict:
        with self._lock:
            lat = sorted(self._stats["latency_ms"])
            served = self._stats["requests"]
            batches = self._stats["batches"]
            return {
                "requests": served,
                "batches": batches,
                "shed": self._stats["shed"],
                "expired": self._stats["expired"],
                "mean_batch_occupancy": (
                    self._stats["batched_rows"] / batches if batches else 0.0
                ),
                "pad_fraction": (
                    self._stats["padded_rows"]
                    / max(self._stats["batched_rows"] + self._stats["padded_rows"], 1)
                ),
                "latency_ms_p50": lat[len(lat) // 2] if lat else None,
                "latency_ms_p95": lat[min(len(lat) - 1, int(0.95 * len(lat)))]
                if lat
                else None,
            }

    def reset_stats(self):
        """Zero the counters so stats() reflects a measured window only
        (warmup and parity-probe requests otherwise pollute occupancy and
        latency percentiles)."""
        with self._lock:
            for k, v in self._stats.items():
                self._stats[k] = [] if isinstance(v, list) else 0

    def shutdown(self, *, wait: bool = True):
        self._stop.set()
        self._queue.put(None)  # wake the worker
        if wait:
            self._worker.join(timeout=60)
            if self._worker.is_alive():
                # still mid-batch (a wedged device): the worker serves the
                # queue itself if it ever finishes, so do not steal its
                # requests; tell the caller shutdown did NOT complete
                print(
                    "ServingEngine.shutdown: dispatch thread still running "
                    "after 60 s; queued futures resolve only if the in-flight "
                    "batch finishes",
                    file=sys.stderr, flush=True,
                )
                return
            # fail any request that raced past the stop check in submit()
            # after the worker exited: an unresolved Future would hang its
            # caller forever
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                if req is not None:
                    _safe_resolve(
                        req.future,
                        exception=RuntimeError("engine is shut down"),
                    )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- dispatch side ----------------------------------------------------
    def _fail_expired(self, r: _Request, now: float):
        with self._lock:
            self._stats["expired"] += 1
        _safe_resolve(
            r.future,
            exception=RequestExpired(
                f"request waited {(now - r.t_submit) * 1e3:.0f} ms > "
                f"deadline_ms={r.deadline_ms:.0f} before dispatch"
            ),
        )

    def _collect(self) -> List[_Request]:
        """Block for one request, then drain compatible ones for up to
        max_wait_ms (or until the batch is full). Requests past their
        deadline_ms are failed here (never dispatched)."""
        batch: List[_Request] = []
        while not batch:
            if self._pending:
                first = self._pending.pop(0)
            else:
                first = self._queue.get()
            if first is None:
                return batch
            if first.expired(time.monotonic()):
                self._fail_expired(first, time.monotonic())
                continue
            batch.append(first)
        deadline = time.monotonic() + self.max_wait_ms / 1e3
        while len(batch) < self.max_batch_size:
            timeout = deadline - time.monotonic()
            try:
                r = (
                    self._pending.pop(0)
                    if self._pending
                    else self._queue.get(timeout=max(timeout, 0.0))
                )
            except queue.Empty:
                break
            if r is None:
                break
            if r.expired(time.monotonic()):
                self._fail_expired(r, time.monotonic())
                continue
            # only identically-shaped observations batch together
            # (e.g. multi-view vs single-view requests)
            if r.pixel_values.shape[1:] != batch[0].pixel_values.shape[1:]:
                self._pending.append(r)
                break
            batch.append(r)
        return batch

    def _dispatch_loop(self):
        while not self._stop.is_set() or self._pending or not self._queue.empty():
            batch = self._collect()
            if not batch:
                continue
            try:
                self._run_batch(batch)
            except Exception as e:  # fail the batch loudly, keep serving
                for r in batch:
                    _safe_resolve(r.future, exception=e)
        if self._completion is not None:
            # drain the pipeline before the worker exits so shutdown()'s
            # join on the worker covers every enqueued batch
            self._completion.put(None)
            self._completer.join()

    def _completion_loop(self):
        while True:
            item = self._completion.get()
            if item is None:
                return
            batch, n_padded, out = item
            try:
                self._complete(batch, n_padded, out)
            except Exception as e:  # noqa: BLE001 - a dead completer would
                # wedge the pipeline (dispatch blocks on the permit), so
                # fail the batch and keep draining
                for r in batch:
                    _safe_resolve(r.future, exception=e)
            finally:
                self._inflight.release()

    def _run_batch(self, batch: List[_Request]):
        """Assemble and enqueue one batch. Kernel launches return before the
        card runs them; with pipeline_depth > 1 the wait happens on the
        completion thread while this thread collects the next batch."""
        ids, attn, px, intr = assemble_batch(
            batch,
            pad_id=self.policy.processor.text_tokenizer.pad_id,
            prompt_pad_multiple=self.prompt_pad_multiple,
            batch_buckets=self.batch_buckets,
        )
        n_padded = ids.shape[0] - len(batch)
        if self._completion is None:
            out = _HostCopy(_generate_batch(self.policy, ids, attn, px, intr))
            self._complete(batch, n_padded, out)
            return
        self._inflight.acquire()  # blocks while `pipeline_depth` in flight
        try:
            out = _HostCopy(_generate_batch(self.policy, ids, attn, px, intr))
        except BaseException:
            self._inflight.release()
            raise
        self._completion.put((batch, n_padded, out))

    def _complete(self, batch: List[_Request], n_padded: int, out: _HostCopy):
        """Wait for one enqueued batch, record stats, resolve its futures. A
        device-side failure surfacing at the wait fails only this batch."""
        try:
            generated = out.numpy()
        except Exception as e:  # noqa: BLE001 - device error at the wait
            for r in batch:
                _safe_resolve(r.future, exception=e)
            return
        now = time.monotonic()
        with self._lock:
            self._stats["batches"] += 1
            self._stats["requests"] += len(batch)
            self._stats["batched_rows"] += len(batch)
            self._stats["padded_rows"] += n_padded
            self._stats["latency_ms"] = self._stats["latency_ms"][-999:] + [
                (now - r.t_submit) * 1e3 for r in batch
            ]
        for i, r in enumerate(batch):
            if r.future.done():  # e.g. cancelled by the caller
                continue
            try:  # per-request decode: one row's bad statistics/decode
                # must not fail the co-batched requests
                dec = self.policy.processor.decode_actions(
                    generated[i : i + 1], unnorm_key=r.unnorm_key
                )
                _safe_resolve(
                    r.future,
                    result={
                        "actions": dec["actions"][0],
                        "action_ids": dec["action_ids"][0],
                    },
                )
            except Exception as e:  # noqa: BLE001
                _safe_resolve(r.future, exception=e)
