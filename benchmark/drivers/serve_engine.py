"""Serving driver: a robot fleet, in an open or a closed loop, on the port's
``ServingEngine``.

Set-up makes the seeded bf16 weights on the device, hands them to
``SpatialVLAPolicy``, quantizes as the configuration says, captures every
decode graph the traffic's shapes need (``warmup_buckets``), sends one
request from each robot through the engine, and makes the frames of every
request the window will send (a closed loop: as many as ``premade_rps``
asks for). In the window one sender thread submits each request: in an
open loop when it is due, in a closed loop when the robot's last answer
has come (``harness/traffic.py``); each answer is timed from when its
request was due, or sent. After the close every
answer is waited for (late is not failed; one that never comes is), the
program's state is freed, and the reference judges a sample of the answered
requests (``reference/serve_check.py``).
"""
from __future__ import annotations

import gc
import queue
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..harness import trace as trace_mod
from ..harness import traffic as traffic_mod
from ..harness import weights
from ..reference import serve_check

TRACE_WINDOW_S = 12  # a traced run's window: a longer trace takes too long to read back
WAIT_S = 120  # an answer that has not come this long after its submit never comes
WARM_INDEX = 1 << 40  # request streams at and above this index warm up, never timed


@dataclass
class Done:
    client: int
    index: int
    instruction: str
    t_due: float  # when the robot sent it: latency counts any lateness of the sender
    t_sent: float = 0.0
    t_done: float = None
    ids: np.ndarray = None
    error: str = None

    @property
    def latency_ms(self) -> float:
        return (self.t_done - self.t_due) * 1e3


def build(cfg: dict, seed: int, device):
    """The policy of ``cfg`` on ``device``: the benchmark's weights from
    ``seed`` in the serving form the configuration states."""
    from spatialvla_tpu_torch import SpatialVLAPolicy
    from spatialvla_tpu_torch.config import SpatialVLAConfig
    from spatialvla_tpu_torch.inference import default_processor

    serving = cfg["serving"]
    config = SpatialVLAConfig.from_dict(cfg["model"])
    processor = default_processor(config)
    if processor.action_chunk_size != serving["action_chunk_size"]:
        raise ValueError(f"the processor's action chunk is {processor.action_chunk_size}, "
                         f"the configuration's {serving['action_chunk_size']}")
    tree = weights.make_tree(cfg["model"], seed, device)
    policy = SpatialVLAPolicy(tree, config, processor, device=device)
    del tree
    policy.quantize(serving["lm_bits"], vision_bits=serving["vision_bits"],
                    kv_bits=serving["kv_bits"])
    return policy


def run(ctx) -> dict:
    """One run of a serving cell; ``ctx`` holds cfg, mix, seed, seconds,
    trace, device and setup_clock (seconds since the process started), and
    for ``benchmark/calibrate.py`` control: the check also reads the
    control."""
    from spatialvla_tpu_torch.serve import ServingEngine, warmup_buckets

    cfg, mix, seed, device = ctx.cfg, ctx.mix, ctx.seed, ctx.device
    serving = cfg["serving"]
    key = serving["unnorm_key"]
    gen = traffic_mod.make(mix, seed)
    policy = build(cfg, seed, device)
    buckets = tuple(serving["batch_buckets"])
    first = gen.request(0, WARM_INDEX)
    shortest = min(gen.vocabulary, key=len)
    warmup_buckets(policy, sample_image=first.frame, instructions=[shortest, gen.longest_instruction()],
                   prompt_pad_multiple=serving["prompt_pad_multiple"], batch_buckets=buckets,
                   unnorm_key=key)
    engine = ServingEngine(policy, max_batch_size=serving["max_batch_size"],
                           max_wait_ms=serving["max_wait_ms"],
                           prompt_pad_multiple=serving["prompt_pad_multiple"],
                           batch_buckets=buckets, pipeline_depth=serving["pipeline_depth"])
    try:
        warm = [engine.submit(r.frame, r.instruction, unnorm_key=key)
                for r in (gen.request(i, WARM_INDEX + 1) for i in range(gen.clients))]
        for f in warm:
            f.result(timeout=WAIT_S)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = min(ctx.seconds, TRACE_WINDOW_S) if ctx.trace else ctx.seconds
        due = gen.arrivals(seconds) if gen.loop == "open" else None
        frames = {(r, k): gen.request(r, k) for r, k in gen.premade(seconds)}  # before the window
        sent = []
        made_in_window = [0]
        ready = queue.Queue()  # a closed loop's robots whose last answer has come
        setup_s = ctx.setup_clock()

        def finish(rec, fut):
            rec.t_done = time.monotonic()
            try:
                rec.ids = np.asarray(fut.result()["action_ids"])
            except Exception as e:  # noqa: BLE001 - a failed request is counted, not fatal
                rec.error = repr(e)
            if gen.loop == "closed":
                ready.put(rec.client)

        def send(rec, req):
            rec.t_sent = time.monotonic()
            sent.append(rec)
            try:
                fut = engine.submit(req.frame, req.instruction, unnorm_key=key)
            except Exception as e:  # noqa: BLE001 - a refused request is counted, not fatal
                rec.t_done, rec.error = time.monotonic(), repr(e)
                if gen.loop == "closed":
                    ready.put(rec.client)
            else:
                fut.add_done_callback(lambda f, rec=rec: finish(rec, f))

        def request(r, k):
            if (r, k) in frames:
                return frames.pop((r, k))
            made_in_window[0] += 1
            return gen.request(r, k)

        def open_sender(t_open):
            for off, r, k in due:
                req = request(r, k)
                rec = Done(r, k, req.instruction, t_open + off)
                time.sleep(max(rec.t_due - time.monotonic(), 0.0))
                send(rec, req)

        def closed_sender(t_open):
            count = [0] * gen.clients
            for r in range(gen.clients):
                ready.put(r)
            while True:
                try:
                    r = ready.get(timeout=max(t_open + seconds - time.monotonic(), 0.0))
                except queue.Empty:
                    return
                if time.monotonic() >= t_open + seconds:
                    return
                req = request(r, count[r])
                send(Done(r, count[r], req.instruction, time.monotonic()), req)
                count[r] += 1

        sender = open_sender if gen.loop == "open" else closed_sender
        with trace_mod.profiled(ctx.trace) as prof:
            engine.reset_stats()
            with torch.profiler.record_function(trace_mod.WINDOW):
                t_open = time.monotonic()
                deadline = t_open + seconds
                thread = threading.Thread(target=sender, args=(t_open,), daemon=True)
                thread.start()
                time.sleep(max(deadline - time.monotonic(), 0.0))
                stats = engine.stats()
            thread.join(timeout=WAIT_S)
            while (any(r.t_done is None for r in list(sent))
                   and time.monotonic() < deadline + WAIT_S):
                time.sleep(0.01)
        if thread.is_alive():
            raise RuntimeError("the sender did not finish within its wait after the close")
    finally:
        engine.shutdown()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    trace = trace_mod.summary(trace_mod.events(prof)) if ctx.trace else None
    del engine, policy
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    answered = sorted((r for r in sent if r.ids is not None), key=lambda r: (r.t_done, r.client))
    in_window = [r for r in answered if r.t_done <= deadline]
    failed = [f"({r.client}, {r.index}): {r.error or 'no answer'}" for r in sent if r.ids is None]
    sample = gen.sample(answered, mix["check"]["requests"])
    verdict = serve_check.check(cfg, seed, [gen.request(d.client, d.index) for d in sample],
                                [d.ids for d in sample], device,
                                control=getattr(ctx, "control", False))
    limit = cfg["check"]["served_logit_gap"]["limit"]
    late = sorted(r.t_sent - r.t_due for r in sent)
    return {
        "seconds": seconds,
        "setup_s": setup_s,
        "attempted": len(sent),
        "failed": len(failed),
        "failures": failed[:5],
        "answered": answered,
        "in_window": in_window,
        "sender_late_ms": {"p50": 1e3 * late[len(late) // 2], "max": 1e3 * late[-1]} if late else None,
        "made_in_window": made_in_window[0],
        "prompt_lens": [len(serve_check.prompt_ids(cfg["model"], d.instruction)) for d in in_window],
        "new_tokens": 3 * serving["action_chunk_size"],
        "actions_per_request": serving["action_chunk_size"],
        "engine": stats,
        "trace": trace,
        "memory_peak_bytes": memory_peak,
        "checks": {"served_logit_gap": {"value": verdict["gap_max"], "limit": limit}},
        "check_detail": {"requests": len(sample), **verdict},
    }
