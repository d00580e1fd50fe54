"""The serving cells' metric arithmetic, which the readers in
``benchmark/metrics/`` apply: each reads a finished run's record
(``drivers/serve_engine.py``) and returns None where the run has nothing for
it to read."""
from __future__ import annotations

import json
import math
import os

from . import roofline, trace

KERNELS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "metrics", "kernels.json")


def actions_per_s(run):
    """Actions of the requests answered inside the window, per second of it."""
    return len(run["in_window"]) * run["actions_per_request"] / run["seconds"]


def latency_p95_ms(run):
    """The 95th percentile (nearest rank) of the latencies of all requests
    due in the window, each from when it was due to when its answer reached
    the client; answers that come after the close are waited for."""
    lat = sorted(d.latency_ms for d in run["answered"])
    return lat[math.ceil(0.95 * len(lat)) - 1] if lat else None


def batch_rows(run):
    """Mean real rows of the engine's batches over the window
    (``ServingEngine.stats()`` after ``reset_stats()`` at the opening)."""
    s = run["engine"]
    return s["mean_batch_occupancy"] if s["batches"] else None


def idle_share(run):
    """Percent of the traced window in which no operation ran on the device."""
    t = run["trace"]
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(run):
    """The model FLOPs of the requests answered inside the window (the
    front, the prefill of each request's own prompt, its greedy tokens:
    ``roofline.serve_request_flops``) over the window's seconds times the
    chip's bf16 peak, in percent."""
    if run["peaks"] is None or not run["in_window"]:
        return None
    model = run["cfg"]["model"]
    flops = sum(roofline.serve_request_flops(model, p, run["new_tokens"]) for p in run["prompt_lens"])
    return 100.0 * flops / (run["seconds"] * run["peaks"]["bf16_flops"])


def decode_roofline(run):
    """The port's int8 decode kernels (``metrics/kernels.json``
    "decode_step_int8") against their roofline, in percent: the bytes their
    work in the window must move over the chip's bandwidth, divided by
    their device seconds in the trace. For each batch the engine finished in
    the window, the first token's read of the head's action block, then each
    later token's decode step (``roofline.decode_step_bytes``): every
    layer's int8 matrices, scales and norms, the action block again, each
    row's keys and values up to its position and the new ones. Every row of
    a batch's bucket decodes, filler rows too; each row's prompt is taken as
    the mean prompt of the requests answered in the window."""
    t, pk, s = run["trace"], run["peaks"], run["engine"]
    if t is None or pk is None or not s["batches"] or not run["prompt_lens"]:
        return None
    with open(KERNELS) as f:
        seconds = trace.ops_seconds(t, json.load(f)["decode_step_int8"])
    if seconds <= 0:
        return None
    text = run["cfg"]["model"]["text"]
    block = run["cfg"]["model"]["spatial_token_num"]
    rows = s["mean_batch_occupancy"] * s["batches"] / (1.0 - s["pad_fraction"])
    prompt = sum(run["prompt_lens"]) / len(run["prompt_lens"])
    steps = run["new_tokens"] - 1
    per_batch = roofline.head_bytes(text, block) + steps * (
        roofline.layers_bytes(text) + roofline.head_bytes(text, block))
    slots = rows * sum(prompt + k + 1 for k in range(steps))  # read, and the new one written
    total = s["batches"] * per_batch + roofline.kv_bytes(text, slots)
    return 100.0 * total / pk["hbm_bytes_per_s"] / seconds
