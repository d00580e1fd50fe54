"""Split-phase continuous-batching engine: persistent decode slots (port of
spatialvla_tpu/serve/split_engine.py).

The monolithic engine (engine.py) runs one whole request program a batch:
each batch pays the vision front and the prefill, then decodes at the
arrival group's size, and an arrival cannot join a running decode. This
engine decouples the phases:

- A PREFILL (models/spatialvla.py:prefill_for_serving) runs eagerly per
  arrival group: vision front, pad-aware prefix, first token, and the
  group's cache rows already in the decode state's layout.
- A persistent decode batch of ``n_slots`` rows advances ``decode_block``
  decode steps a dispatch (decode_steps_serving over the per-row-position
  decode step, ops/decode_step.py), replayed as ONE CUDA graph on the card
  (models/spatialvla.py:ServingLoop), captured once when the engine is
  built: the state's shape never changes. Prefilled rows are admitted into
  free slots between dispatches (admit_rows_serving: a scatter on the card,
  the rows never visit the host) and retire after exactly 3 * chunk tokens.

The decode step's weight stream is thus shared by up to ``n_slots`` rows
whatever the groups' sizes, and an arrival waits at most one dispatch to
join.

Host and card: the dispatch thread only enqueues (kernel launches and graph
replays return before the card runs them); right after the replay that
retires rows it copies the output buffer to pinned host memory behind an
event, and a completion thread waits for that event, decodes the ids and
resolves the futures. The copy matters because the buffer is written in
place: a retired slot may be readmitted on the next loop iteration, and its
admission rewrites the row before the completion thread reads it. Run-ahead
is bounded by an event a dispatch: once more than ``max_ahead`` dispatches
are in flight, the host waits for the oldest.

Clients copy their pixels to the card themselves (``_put_pixels``), as
uint8 where the processor's pixels sit on the u8/255 grid; the prefill
divides by 255 on the card.

Over a mesh-sharded policy (``SpatialVLAPolicy.shard``) the engine runs the
model shards of data group 0 (JAX's engine cuts its state over the model
axis only, the data groups computing the same rows): the prefill over the
shards, the persistent KV cut over the kv heads of the attention, and the
decode step ``xla_decode_step`` over each shard's heads (JAX's
``use_fused = mesh is None``), replayed eagerly rather than as a CUDA graph.
``kv_bits=8`` is the engine's knob there (the policy's is None), and the
tree may be bf16.
"""
from __future__ import annotations

import collections
import queue
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .engine import (
    EngineOverloaded,
    RequestExpired,
    _HostCopy,
    _Request,
    _round_up,
    _safe_resolve,
)

DEFAULT_PREFILL_BUCKETS = (1, 2, 4, 8, 16)


def _put_pixels(px: np.ndarray, u8: Optional[np.ndarray] = None, *, device) -> torch.Tensor:
    """The pixels on ``device``, copied on the CLIENT thread at submit time
    so that the dispatch thread never waits for image bytes: from pinned
    host memory without blocking, on the card. When the pixels sit exactly
    on the u8/255 grid (the processor's PIL path gives ``u8``, its
    ``pixel_values_u8``; otherwise the grid is checked here) the uint8 bytes
    go, a quarter of the f32's, and the prefill divides by 255 on the card,
    the host's own f32 division (tests hold it exact over all 256 values);
    other pixels (the PIL-free resize, custom callers) go as f32."""
    if u8 is None:
        grid = np.rint(px * 255.0).astype(np.uint8)
        if np.array_equal(grid.astype(np.float32) / 255.0, px):
            u8 = grid
    return _to_device(u8 if u8 is not None else px.astype(np.float32), device)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; to the card from pinned memory without
    blocking the caller (a copy from pageable memory waits for everything
    the stream holds, the decode dispatches in flight among it)."""
    host = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device, copy=True)


def _first_rows(rows, n: int):
    """The first n rows of ``prefill_for_serving``'s output (the real
    requests of a group; its K / V rows, of every shard, along dim 1)."""
    if isinstance(rows, list):
        return [_first_rows(r, n) for r in rows]
    return {k: (v[:n] if k in ("tok", "valid") else
                _first_rows(v, n) if k == "shards" else v[:, :n]) for k, v in rows.items()}


class _Programs:
    """The engine's three steps over one policy: the eager prefill of an
    arrival group, the admission scatter, and the persistent decode batch
    (``ServingLoop``), whose CUDA graph is captured here on the card,
    before the engine's threads start (under a mesh: over data group 0's
    model shards, on its home device, eagerly)."""

    def __init__(self, policy, *, n_slots, cache_len, n_tokens, decode_block, kv_bits):
        from ..models import spatialvla as model

        self.policy, self.model = policy, model
        self.cache_len, self.kv_bits = cache_len, kv_bits
        cfg = policy.config
        self.token_range = (cfg.action_token_begin_idx, cfg.spatial_token_num)
        meshed = getattr(policy, "mesh", None) is not None
        self.params = policy.params.groups[0] if meshed else policy.params
        self.device = self.params.home if meshed else policy.device
        with torch.inference_mode():
            self.loop = model.ServingLoop(
                self.params, cfg, n_slots=n_slots, cache_len=cache_len, n_tokens=n_tokens,
                decode_block=decode_block, kv_bits=kv_bits, token_range=self.token_range,
                compute_dtype=policy.compute_dtype, device=self.device,
            )
            if self.device.type == "cuda" and not meshed:
                self.loop.capture()

    def prefill(self, ids, px, intr, attn) -> Dict[str, torch.Tensor]:
        if px.dtype == torch.uint8:  # the client-side u8 transport
            px = px.float() / 255.0
        dev = self.device
        return self.model.prefill_for_serving(
            self.params, self.policy.config, _to_device(ids, dev).long(),
            pixel_values=px, intrinsic=_to_device(intr, dev),
            attention_mask=_to_device(attn, dev), cache_len=self.cache_len,
            compute_dtype=self.policy.compute_dtype, token_range=self.token_range,
            depth_image_size=self.policy.depth_image_size, kv_bits=self.kv_bits,
        )

    def admit(self, rows, slots: List[int]):
        self.model.admit_rows_serving(self.loop.state, rows, slots)

    def decode(self):
        self.loop.step()


class SplitServingEngine:
    """Continuous-batching engine with a persistent decode batch, on the
    policy's device.

    Single-device: needs a fused-quantized LM (policy.quantize(bits=8|4) or
    a serving checkpoint): the persistent decode program is the fused decode
    step. Mesh-sharded (policy.shard): the decode step is
    ``xla_decode_step`` over the model shards, and a bf16 tree serves too.
    ``kv_bits=8`` (or the policy's) decodes from an int8 cache in both.

    Usage mirrors ServingEngine:
        engine = SplitServingEngine(policy)
        engine.warmup(sample_image, instructions)
        fut = engine.submit(image, "pick up the cup", unnorm_key=...)
        fut.result()  # {"actions": (chunk, 7), "action_ids": (3*chunk,)}
    """

    def __init__(
        self,
        policy,
        *,
        n_slots: int = 16,
        max_prompt_len: int = 320,
        prompt_pad_multiple: int = 64,
        prefill_buckets: Sequence[int] = DEFAULT_PREFILL_BUCKETS,
        decode_block: int = 4,
        max_ahead: int = 8,
        max_queue: Optional[int] = None,
        prefill_min_free: int = 0,
        prefill_wait_ms: float = 0.0,
        prefill_quiet_ms: float = 0.0,
        kv_bits: Optional[int] = None,  # None = inherit policy.kv_bits
    ):
        mesh = getattr(policy, "mesh", None)
        if mesh is None and "qkv" not in policy.params["lm"]["layers"].get("attn", {}):
            raise ValueError(
                "SplitServingEngine requires a fused-quantized LM "
                "(policy.quantize(bits=8) or a serving checkpoint): the "
                "single-device persistent decode program is the fused decode "
                "step (mesh-sharded policies may also serve bf16: their decode "
                "is xla_decode_step)"
            )
        self.kv_bits = (
            getattr(policy, "kv_bits", None) if kv_bits is None else (kv_bits or None)
        )
        if self.kv_bits not in (None, 8):
            raise ValueError(f"kv_bits={self.kv_bits}: only 8 (or None)")
        if not 1 <= n_slots <= 16:
            raise ValueError("n_slots must be in [1, 16] (the decode step's few-row "
                             "kernels take at most 16 rows)")
        if max_prompt_len % prompt_pad_multiple:
            raise ValueError("max_prompt_len must be a multiple of "
                             "prompt_pad_multiple")
        self.policy = policy
        self.n_slots = n_slots
        self.max_prompt_len = max_prompt_len
        self.prompt_pad_multiple = prompt_pad_multiple
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        if self.prefill_buckets[-1] > n_slots:
            self.prefill_buckets = tuple(
                b for b in self.prefill_buckets if b <= n_slots
            ) or (n_slots,)
        self.decode_block = decode_block
        self.max_ahead = max_ahead
        self.max_queue = max_queue
        # batch-forming hysteresis: while decode work is in flight, defer
        # prefill until at least this many slots are free, so arrival
        # groups ride the larger prefill buckets. 0 disables; an idle engine
        # always admits at once.
        self.prefill_min_free = min(prefill_min_free, n_slots)
        # burst gather: a COVERED engine (idle, or with run-ahead dispatches
        # still enqueued for the card) holds its first arrival up to this
        # long so that a closed-loop client burst forms one large prefill
        # group instead of a ragged run of small ones. 0 disables.
        self.prefill_wait_ms = prefill_wait_ms
        # adaptive early close of the gather window: it closes once no
        # arrival lands for this long (prefill_wait_ms stays the cap)
        if prefill_quiet_ms > 0 and prefill_wait_ms <= 0:
            raise ValueError(
                "prefill_quiet_ms needs prefill_wait_ms > 0 (the hard cap "
                "that opens the gather window); quiet_ms alone is inert"
            )
        self.prefill_quiet_ms = prefill_quiet_ms
        self.n_tokens = 3 * policy.processor.action_chunk_size
        self.cache_len = max_prompt_len + self.n_tokens
        sw = policy.config.text.sliding_window
        if self.cache_len > sw:
            raise ValueError(
                f"cache_len {self.cache_len} exceeds the sliding window "
                f"({sw}); the fused decode step treats window and global "
                "layers identically only below it; lower max_prompt_len"
            )
        self._programs = _Programs(
            policy, n_slots=n_slots, cache_len=self.cache_len,
            n_tokens=self.n_tokens, decode_block=decode_block,
            kv_bits=self.kv_bits,
        )

        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._pending: List[_Request] = []  # shape-incompatible holdovers
        self._free: List[int] = list(range(n_slots))
        self._slot_req: Dict[int, _Request] = {}
        self._slot_steps: Dict[int, int] = {}
        self._ahead = collections.deque()  # an event a dispatch (card only)
        self._stop = threading.Event()
        self._dead: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._stats = {
            "requests": 0,
            "prefill_batches": 0,
            "prefill_rows": 0,
            "prefill_filler_rows": 0,
            "decode_dispatches": 0,
            "active_slot_dispatches": 0,  # sum of active slots per dispatch
            "shed": 0,
            "expired": 0,
            "latency_ms": [],
            # host wall seconds the dispatch thread spends in each phase
            # (launches return before the card runs them, so these are host
            # costs: input copies and enqueues, the eager prefill's Python;
            # t_ahead is the run-ahead bound waiting for the card)
            "t_collect": 0.0,
            "t_prefill": 0.0,
            "t_admit": 0.0,
            "t_decode": 0.0,
            "t_ahead": 0.0,
        }
        self._completion: "queue.Queue" = queue.Queue()
        self._completer = threading.Thread(
            target=self._completion_loop, name="spatialvla-split-sync",
            daemon=True,
        )
        self._completer.start()
        self._worker = threading.Thread(
            target=self._dispatch_loop, name="spatialvla-split", daemon=True
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
    ):
        if self._stop.is_set():
            raise RuntimeError("engine is shut down")
        if self._dead is not None:
            raise RuntimeError(f"engine failed: {self._dead!r}")
        if self.max_queue is not None and (
            self._queue.qsize() + len(self._pending) >= self.max_queue
        ):
            with self._lock:
                self._stats["shed"] += 1
            raise EngineOverloaded(
                f"admission queue at max_queue={self.max_queue}; shed load"
            )
        stats = self.policy.processor.statistics
        if unnorm_key is not None and stats and unnorm_key not in stats:
            raise KeyError(
                f"unknown unnorm_key {unnorm_key!r}; available: {sorted(stats)}"
            )
        inputs = self.policy.processor(image, instruction, unnorm_key=unnorm_key)
        ids = np.asarray(inputs["input_ids"])
        if _round_up(ids.shape[1], self.prompt_pad_multiple) > self.max_prompt_len:
            raise ValueError(
                f"prompt of {ids.shape[1]} tokens pads past max_prompt_len="
                f"{self.max_prompt_len}; raise it (engine construction) for "
                "longer instructions / multi-image observations"
            )
        px = np.asarray(inputs["pixel_values"])
        req = _Request(
            ids=ids,
            pixel_values=px,
            intrinsic=np.asarray(inputs["intrinsic"]),
            unnorm_key=unnorm_key,
            deadline_ms=deadline_ms,
            px_dev=_put_pixels(px, inputs.get("pixel_values_u8"), device=self._programs.device),
        )
        self._queue.put(req)
        if self._stop.is_set():
            _safe_resolve(
                req.future, exception=RuntimeError("engine is shut down")
            )
        return req.future

    def predict(self, image, instruction, *, unnorm_key=None, deadline_ms=None):
        return self.submit(
            image, instruction, unnorm_key=unnorm_key, deadline_ms=deadline_ms
        ).result()

    def stats(self) -> Dict:
        with self._lock:
            lat = sorted(self._stats["latency_ms"])
            dd = self._stats["decode_dispatches"]
            pb = self._stats["prefill_batches"]
            pr = self._stats["prefill_rows"] + self._stats["prefill_filler_rows"]
            return {
                "requests": self._stats["requests"],
                "prefill_batches": pb,
                "mean_prefill_rows": (
                    self._stats["prefill_rows"] / pb if pb else 0.0
                ),
                "prefill_pad_fraction": (
                    self._stats["prefill_filler_rows"] / pr if pr else 0.0
                ),
                "decode_dispatches": dd,
                "mean_slot_occupancy": (
                    self._stats["active_slot_dispatches"] / dd if dd else 0.0
                ),
                "shed": self._stats["shed"],
                "expired": self._stats["expired"],
                "latency_ms_p50": lat[len(lat) // 2] if lat else None,
                "latency_ms_p95": lat[min(len(lat) - 1, int(0.95 * len(lat)))]
                if lat
                else None,
                "dispatch_thread_s": {
                    k[2:]: round(self._stats[k], 3)
                    for k in ("t_collect", "t_prefill", "t_admit",
                              "t_decode", "t_ahead")
                },
            }

    def reset_stats(self):
        """Zero the counters so stats() reflects a measured window only:
        warmup and parity probes otherwise pollute the dispatch-thread
        timings (the idle dispatch loop accrues t_collect all its life)."""
        with self._lock:
            for k, v in self._stats.items():
                if isinstance(v, float):
                    self._stats[k] = 0.0
                elif isinstance(v, int):
                    self._stats[k] = 0
                elif isinstance(v, list):
                    self._stats[k] = []

    def warmup(self, sample_image, instructions: Sequence[str]):
        """Run a prefill of every (padded-T, Bp) bucket the instructions can
        produce and one decode dispatch, so that the first requests do not
        pay the card's first-use costs (cuBLAS plans, the kernels' first
        launches). The decode graph is captured already (construction).
        Call it before the engine takes traffic: it admits the last group
        into the state and deactivates it again."""
        proc = self.policy.processor
        reps: Dict[int, tuple] = {}
        for instr in instructions:
            inputs = proc(sample_image, instr)
            ids = np.asarray(inputs["input_ids"])
            T = _round_up(ids.shape[1], self.prompt_pad_multiple)
            if T > self.max_prompt_len:  # same guard as submit()
                raise ValueError(
                    f"warmup instruction {instr!r} pads to {T} tokens > "
                    f"max_prompt_len={self.max_prompt_len}; raise it or "
                    "trim the warmup set"
                )
            reps.setdefault(T, (ids, np.asarray(inputs["pixel_values"]),
                                np.asarray(inputs["intrinsic"])))
        pad_id = proc.text_tokenizer.pad_id
        state = self._programs.loop.state
        with torch.inference_mode():
            for T, (ids, px, intr) in reps.items():
                for Bp in self.prefill_buckets:
                    bids = np.full((Bp, T), pad_id, np.int32)
                    attn = np.zeros((Bp, T), np.int32)
                    bids[:, : ids.shape[1]] = ids[0]
                    attn[:, : ids.shape[1]] = 1
                    # transported as the runtime path does (u8 where exact)
                    px_dev = _put_pixels(px, device=self._programs.device)
                    rows = self._programs.prefill(bids, torch.cat([px_dev] * Bp),
                                                  np.concatenate([intr] * Bp), attn)
                    self._programs.admit(rows, list(range(Bp)))
            state["steps"].fill_(self.n_tokens)  # every slot inactive again
            self._programs.decode()
            state["out"].cpu()

    def shutdown(self, *, wait: bool = True):
        self._stop.set()
        self._queue.put(None)
        if wait:
            self._worker.join(timeout=120)
            if self._worker.is_alive():
                print(
                    "SplitServingEngine.shutdown: dispatch thread still "
                    "running after 120 s (wedged device)",
                    file=sys.stderr, flush=True,
                )
                return
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

    def _collect_group(self, max_n: int, block: bool) -> List[_Request]:
        """Drain up to max_n compatible queued requests without waiting
        (decode continues between dispatches: under load the queue fills
        during them). With block=True (engine idle), wait for the first
        arrival. When the wait is COVERED (engine idle, or run-ahead
        dispatches still enqueued for the card) and prefill_wait_ms is set,
        keep gathering the burst until the window closes or the group
        fills; with prefill_quiet_ms also set, the window closes early once
        arrivals stop for that long."""
        group: List[_Request] = []
        gather_until: Optional[float] = None
        cap_until: Optional[float] = None
        while len(group) < max_n:
            r = None
            if self._pending:
                r = self._pending.pop(0)
            else:
                if not group:
                    timeout = 0.05 if block else 0.0
                elif gather_until is not None:
                    timeout = gather_until - time.monotonic()
                    if timeout <= 0:
                        break
                else:
                    timeout = 0.0
                try:
                    r = self._queue.get(timeout=max(timeout, 0.0))
                except queue.Empty:
                    if gather_until is None or time.monotonic() >= gather_until:
                        break
                    continue
            if r is None:  # shutdown wakeup
                break
            if (block or self._ahead) and not group and self.prefill_wait_ms > 0:
                now = time.monotonic()
                if cap_until is None:
                    # anchored to the FIRST arrival only: an expired first
                    # request must not restart the hard cap
                    cap_until = now + self.prefill_wait_ms / 1e3
                gather_until = (
                    min(cap_until, now + self.prefill_quiet_ms / 1e3)
                    if self.prefill_quiet_ms > 0
                    else cap_until
                )
            elif gather_until is not None and self.prefill_quiet_ms > 0:
                # burst still arriving: extend the quiet-gap window
                gather_until = min(
                    cap_until, time.monotonic() + self.prefill_quiet_ms / 1e3
                )
            if r.expired(time.monotonic()):
                self._fail_expired(r, time.monotonic())
                continue
            if group and (
                r.pixel_values.shape[1:] != group[0].pixel_values.shape[1:]
                or r.px_dev.dtype != group[0].px_dev.dtype
            ):
                self._pending.append(r)  # only like-shaped (and like-
                # transported) images share a prefill
                break
            group.append(r)
        return group

    def _admit_group(self, group: List[_Request]):
        n = len(group)
        Bp = next(b for b in self.prefill_buckets if b >= n)
        T = _round_up(
            max(r.ids.shape[1] for r in group), self.prompt_pad_multiple
        )
        pad_id = self.policy.processor.text_tokenizer.pad_id
        ids = np.full((Bp, T), pad_id, np.int32)
        attn = np.zeros((Bp, T), np.int32)
        for i, r in enumerate(group):
            t = r.ids.shape[1]
            ids[i, :t] = r.ids[0]
            attn[i, :t] = 1
        if n < Bp:  # filler rows: copies of request 0, not admitted
            ids[n:] = ids[0]
            attn[n:] = attn[0]
        # the pixels are on the card already (copied by the client threads);
        # assembling them is one concatenation enqueued on the card
        px = torch.cat([r.px_dev for r in group] + [group[0].px_dev] * (Bp - n))
        intr = np.concatenate(
            [r.intrinsic for r in group] + [group[0].intrinsic] * (Bp - n)
        )
        t0 = time.monotonic()
        rows = self._programs.prefill(ids, px, intr, attn)
        t1 = time.monotonic()
        slots = [self._free.pop() for _ in range(n)]
        self._programs.admit(_first_rows(rows, n), slots)
        t2 = time.monotonic()
        for s, r in zip(slots, group):
            self._slot_req[s] = r
            self._slot_steps[s] = 1
        with self._lock:
            self._stats["prefill_batches"] += 1
            self._stats["prefill_rows"] += n
            self._stats["prefill_filler_rows"] += Bp - n
            self._stats["t_prefill"] += t1 - t0
            self._stats["t_admit"] += t2 - t1

    def _decode_dispatch(self):
        t0 = time.monotonic()
        self._programs.decode()
        t_decode = time.monotonic() - t0
        retiring = []
        for s in list(self._slot_req):
            self._slot_steps[s] += self.decode_block
            if self._slot_steps[s] >= self.n_tokens:
                retiring.append((s, self._slot_req.pop(s)))
                del self._slot_steps[s]
                self._free.append(s)
        with self._lock:
            self._stats["decode_dispatches"] += 1
            self._stats["active_slot_dispatches"] += (
                len(self._slot_req) + len(retiring)
            )
            self._stats["t_decode"] += t_decode
        if retiring:
            # this dispatch's output buffer, copied before any later
            # admission can rewrite a retired slot's row; the completion
            # thread waits for the copy and resolves the futures
            self._completion.put((_HostCopy(self._programs.loop.state["out"]), retiring))
        if self._programs.device.type != "cuda":
            return  # the CPU ran the dispatch already
        # bound run-ahead: wait for the oldest dispatch once more than
        # max_ahead are in flight (free when the card has caught up; blocks
        # the host exactly when it is outrunning the card)
        ev = torch.cuda.Event()
        ev.record()
        self._ahead.append(ev)
        if len(self._ahead) > self.max_ahead:
            t0 = time.monotonic()
            self._ahead.popleft().synchronize()
            with self._lock:
                self._stats["t_ahead"] += time.monotonic() - t0

    def _drain_ahead(self):
        t0 = time.monotonic()
        while self._ahead:
            self._ahead.popleft().synchronize()
        with self._lock:
            self._stats["t_ahead"] += time.monotonic() - t0

    def _dispatch_loop(self):
        try:
            # autograd's mode is per thread: this one enters its own
            with torch.inference_mode():
                self._serve()
        except BaseException as e:  # noqa: BLE001 - decode/admit touched the
            # persistent state, so the engine is dead; fail everything loudly
            self._dead = e
            for s, r in list(self._slot_req.items()):
                _safe_resolve(r.future, exception=e)
            self._slot_req.clear()
            for r in self._pending:
                _safe_resolve(r.future, exception=e)
            self._pending.clear()
            while True:
                try:
                    r = self._queue.get_nowait()
                except queue.Empty:
                    break
                if r is not None:
                    _safe_resolve(r.future, exception=e)
        finally:
            self._completion.put(None)
            self._completer.join()

    def _serve(self):
        while True:
            idle = not self._slot_req
            if self._stop.is_set() and idle and not self._pending and self._queue.empty():
                break
            if idle and self._ahead and self.prefill_wait_ms > 0:
                # drain the run-ahead backlog before gathering: the card may
                # still run up to max_ahead dispatches whose clients resubmit
                # only once the completer resolves them; gathering now would
                # catch only the earlier cohort's resubmissions
                self._drain_ahead()
            group: List[_Request] = []
            if idle or len(self._free) >= self.prefill_min_free:
                t0 = time.monotonic()
                group = self._collect_group(
                    min(len(self._free), self.prefill_buckets[-1]),
                    block=idle,
                )
                with self._lock:
                    self._stats["t_collect"] += time.monotonic() - t0
            # else: decode work is in flight and too few slots are free for
            # an efficient prefill bucket; retirements accumulate (active
            # slots always advance below, and an idle engine always admits)
            if group:
                try:
                    self._admit_group(group)
                except Exception as e:  # noqa: BLE001 - a bad prefill fails
                    # its group, not the persistent state
                    for r in group:
                        _safe_resolve(r.future, exception=e)
            if self._slot_req:
                self._decode_dispatch()

    def _completion_loop(self):
        while True:
            item = self._completion.get()
            if item is None:
                return
            out_copy, retiring = item
            try:
                out = out_copy.numpy()  # waits for that dispatch's copy
            except Exception as e:  # noqa: BLE001 - device error at the wait
                for _, r in retiring:
                    _safe_resolve(r.future, exception=e)
                continue
            now = time.monotonic()
            with self._lock:
                self._stats["requests"] += len(retiring)
                self._stats["latency_ms"] = self._stats["latency_ms"][-999:] + [
                    (now - r.t_submit) * 1e3 for _, r in retiring
                ]
            # one decode_actions per unnorm_key, not one per row: the
            # closed-loop clients wait on the first futures resolved
            groups: Dict = {}
            for s, r in retiring:
                if not r.future.done():
                    groups.setdefault(r.unnorm_key, []).append((s, r))
            for key, members in groups.items():
                try:
                    dec = self.policy.processor.decode_actions(
                        out[[s for s, _ in members]], unnorm_key=key
                    )
                except Exception as e:  # noqa: BLE001
                    for _, r in members:
                        _safe_resolve(r.future, exception=e)
                    continue
                for i, (_, r) in enumerate(members):
                    _safe_resolve(
                        r.future,
                        result={
                            "actions": dec["actions"][i],
                            "action_ids": dec["action_ids"][i],
                        },
                    )
