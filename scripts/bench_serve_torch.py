"""Serving load benchmark for the PyTorch port's engines (the port's form of
scripts/bench_serve.py; imports no jax).

Drives ``spatialvla_tpu_torch.serve.ServingEngine`` (or, with ``--split``,
``SplitServingEngine``) with N concurrent closed-loop clients, each a robot
control loop: submit an observation, wait for the action chunk, repeat, on
``INSTRUCTION_POOL``'s mixed instruction lengths. Prints ONE JSON line:
actions/s, p50 / p95 latency (ms, host clock from submit to result), the
batching it got (monolithic: mean batch occupancy and pad fraction; split:
mean prefill rows, mean active slots a decode dispatch, prefill pad
fraction and the dispatch thread's host seconds t_collect, t_prefill,
t_admit, t_decode, t_ahead) and, on the card, its name and power limit.

Usage (the card; full-width spatialvla_4b() on random weights from --seed,
quantize(bits=8), nothing downloaded):
    python scripts/bench_serve_torch.py --clients 8 --requests 4 [--split]
        [--bits 8] [--mlp_bits 4] [--kv_bits 8] [--n_slots 16]
        [--decode_block 4] [--max_batch 16] [--parity_check] [--seed 0]
        [--mesh_model N] [--mesh_data N]
    # CPU smoke: spatialvla_tiny, its sliding window widened to hold the cache
    python scripts/bench_serve_torch.py --tiny --device cpu --clients 3 --requests 2

Every graph and bucket the run can hit is warmed before the clock starts
(``warmup_buckets``; ``SplitServingEngine.warmup``), and the engine's
counters are reset after the warm-up and the parity check.
``--trace`` records the timed window with torch.profiler and adds the card's
busy ms and idle share over the window, the kernels' ms by name and the
host's waits for the card (synchronize calls and copies, by name, summed
over every thread) to the line; tracing slows the host, so a traced run's
speeds are not the untraced run's.
``--parity_check`` first holds the engine's ids on each pool instruction to
``policy.predict`` on the same observation under the margin rule: the first
token equal, then equal up to the first step whose ``predict`` argmax margin
is below 0.5 (the engines batch and pad, so a near tie may round the other
way). Without a card the default ``--device cuda`` raises.
``--mesh_model`` / ``--mesh_data`` serve a sharded policy
(``SpatialVLAPolicy.shard``, every shard on the one card): under a mesh
``--kv_bits`` needs ``--split`` (the monolithic mesh decode has no int8-cache
layout; the split engine takes the knob), and ``--split`` also serves a bf16
LM (``--bits 0``).
"""
import argparse
import collections
import contextlib
import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# varied lengths, so that batches mix prompt lengths (pad-aware decoding)
INSTRUCTION_POOL = (
    "go",
    "pick up the cup",
    "push the green bowl to the left side",
    "open the top drawer and place the sponge inside of it",
)
MARGIN_BOUND = 0.5
WAIT_S = 600  # a request that takes longer than this fails the run


def bucket_ladder(max_batch: int):
    """Batch buckets up to and INCLUDING max_batch: the engine rounds full
    batches up to the next bucket."""
    return tuple(sorted({b for b in (1, 2, 4, 8, 16) if b < max_batch} | {max_batch}))


def build_policy(args):
    from spatialvla_tpu_torch import SpatialVLAPolicy, spatialvla_4b, spatialvla_tiny
    from spatialvla_tpu_torch.convert.params import target_device

    device = target_device(args.device)
    if args.tiny:
        cfg = spatialvla_tiny(use_vision_zoe=True)
        # the tiny config's window (8 slots) cannot hold a serving cache;
        # window and global layers are identical below the window
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, sliding_window=512))
    else:
        cfg = spatialvla_4b()
    policy = SpatialVLAPolicy.init_random(cfg, device, seed=args.seed)
    meshed = _meshed(args)
    if args.bits or args.kv_bits:
        # under a mesh the split ENGINE owns the kv_bits knob (make_engine)
        policy.quantize(args.bits or None, mlp_bits=args.mlp_bits or None,
                        kv_bits=None if meshed else (args.kv_bits or None))
    if meshed:
        policy.shard(n_model=args.mesh_model, n_data=args.mesh_data)
    return policy


def _meshed(args) -> bool:
    return args.mesh_model > 1 or args.mesh_data > 1


def make_engine(policy, args):
    from spatialvla_tpu_torch.serve import ServingEngine, SplitServingEngine

    if args.split:
        return SplitServingEngine(policy, n_slots=args.n_slots, max_prompt_len=args.max_prompt_len,
                                  prompt_pad_multiple=args.pad_multiple,
                                  decode_block=args.decode_block,
                                  kv_bits=(args.kv_bits or None) if _meshed(args) else None)
    return ServingEngine(policy, max_batch_size=args.max_batch,
                         prompt_pad_multiple=args.pad_multiple,
                         batch_buckets=bucket_ladder(args.max_batch))


def margin_rule_ok(ids, ref_ids, ref_margins) -> bool:
    """First token equal; ids equal up to the first step whose reference
    margin is below MARGIN_BOUND."""
    if ids[0] != ref_ids[0]:
        return False
    for t in range(1, len(ids)):
        if ref_margins[t] < MARGIN_BOUND:
            return True
        if ids[t] != ref_ids[t]:
            return False
    return True


def parity_check(policy, engine, images, unnorm_key):
    """Each pool instruction through the engine and through policy.predict
    on the same observation, held to the margin rule; raises otherwise."""
    full, flips, min_margin = 0, [], float("inf")
    for i, instr in enumerate(INSTRUCTION_POOL):
        img = images[i % len(images)]
        got = engine.submit(img, instr, unnorm_key=unnorm_key).result(timeout=WAIT_S)
        want = policy.predict(img, instr, unnorm_key=unnorm_key, return_margins=True)
        ids, ref = np.asarray(got["action_ids"]), np.asarray(want["action_ids"])
        margins = np.asarray(want["margins"], np.float32)
        min_margin = min(min_margin, float(margins.min()))
        if not margin_rule_ok(ids, ref, margins):
            raise AssertionError(f"engine vs predict on {instr!r}: {ids.tolist()} vs "
                                 f"{ref.tolist()}, predict margins {margins.round(3).tolist()}")
        if np.array_equal(ids, ref):
            full += 1
        else:
            t = int(np.argmax(ids != ref))
            flips.append({"instr": instr, "step": t, "margin": round(float(margins[t]), 6)})
    return {"ok": True, "prompts": len(INSTRUCTION_POOL), "full_matches": full,
            "min_margin": round(min_margin, 6), "flips": flips}


# CUDA runtime calls that block the calling host thread until the card
# reaches a point (or, for a copy from pageable memory, drains the stream)
HOST_WAITS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpy", "cudaMemcpyAsync")


def trace_summary(prof):
    """The card's busy time (the union of its kernels' intervals) and idle
    share over the traced window (first kernel start to last kernel end),
    the kernels' ms by name (the 8 largest; utils/profiling.kernel_busy),
    and the host's calls in HOST_WAITS (count, ms) over all threads.
    Without kernels in the trace (the CPU) the card's numbers are None."""
    from spatialvla_tpu_torch.utils.profiling import kernel_busy, trace_events

    events = trace_events(prof)
    waits = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("cat") == "cuda_runtime" and e["name"] in HOST_WAITS:
            waits[e["name"]][0] += 1
            waits[e["name"]][1] += e["dur"] / 1e3
    busy = kernel_busy(events, top=8)
    return {"kernels": busy["kernels"], "device_busy_ms": busy["busy_ms"],
            "window_ms": busy["window_ms"], "device_idle_share": busy["idle_share"],
            "kernel_ms_top": {k["name"]: k["ms"] for k in busy["top"]},
            "host_waits": {k: {"calls": n, "ms": ms} for k, (n, ms) in sorted(waits.items())}}


def run_clients(policy, args, images, unnorm_key):
    """args.clients closed-loop clients x args.requests each; returns (the
    run's latencies in ms, sorted; engine stats; wall seconds; parity;
    the trace's summary or None)."""
    from spatialvla_tpu_torch.serve import warmup_buckets

    if not args.split:
        warmup_buckets(policy, sample_image=images[0], instructions=INSTRUCTION_POOL,
                       prompt_pad_multiple=args.pad_multiple,
                       batch_buckets=bucket_ladder(args.max_batch), unnorm_key=unnorm_key)
    errors, parity = [], None
    latencies = [[] for _ in range(args.clients)]  # one list a client: no lock
    with make_engine(policy, args) as engine:
        if args.split:
            engine.warmup(images[0], INSTRUCTION_POOL)
        if args.parity_check:
            parity = parity_check(policy, engine, images, unnorm_key)
        engine.reset_stats()  # the measured window starts here

        def client(i):
            try:
                for j in range(args.requests):
                    instr = INSTRUCTION_POOL[(i + j) % len(INSTRUCTION_POOL)]
                    t0 = time.monotonic()
                    engine.submit(images[(i + j) % len(images)], instr,
                                  unnorm_key=unnorm_key).result(timeout=WAIT_S)
                    latencies[i].append((time.monotonic() - t0) * 1e3)
            except Exception as e:  # noqa: BLE001 - raised below, on the main thread
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(args.clients)]
        tracer = contextlib.nullcontext()
        if args.trace:
            from torch.profiler import ProfilerActivity, profile

            tracer = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if policy.device.type == "cuda" else []))
        with tracer:
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S * args.requests)
            wall = time.perf_counter() - t0
        stats = engine.stats()
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client thread did not finish")
    trace = trace_summary(tracer) if args.trace else None
    return sorted(x for ls in latencies for x in ls), stats, wall, parity, trace


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--requests", type=int, default=4, help="per client")
    p.add_argument("--bits", type=int, default=8, help="LM weight bits (8 or 4; 0 = bf16)")
    p.add_argument("--mlp_bits", type=int, default=0,
                   help="4 = int4 MLP under an int8 attention and head")
    p.add_argument("--kv_bits", type=int, default=0, help="8 = int8 KV cache")
    p.add_argument("--split", action="store_true",
                   help="the split-phase engine (persistent decode slots; needs --bits)")
    p.add_argument("--n_slots", type=int, default=16, help="split engine: decode slots")
    p.add_argument("--decode_block", type=int, default=4,
                   help="split engine: decode steps a dispatch")
    p.add_argument("--max_batch", type=int, default=16, help="monolithic engine: batch rows")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel serving over N model shards (policy.shard)")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="data groups a batch's rows split over (policy.shard)")
    p.add_argument("--parity_check", action="store_true",
                   help="hold the engine's ids to policy.predict first (margin rule)")
    p.add_argument("--seed", type=int, default=0, help="random weights and frames")
    p.add_argument("--device", default="cuda",
                   help="cuda (raises without a card) or cpu")
    p.add_argument("--tiny", action="store_true",
                   help="spatialvla_tiny on random weights (CPU smoke)")
    p.add_argument("--trace", action="store_true",
                   help="torch.profiler over the timed window: card busy / idle, kernels, "
                        "host waits")
    args = p.parse_args(argv)
    if args.split and not args.bits and not _meshed(args):
        p.error("--split on a single device needs a fused-quantized LM: pass --bits 8 or 4 "
                "(mesh-sharded split serving also takes bf16: its decode step is "
                "xla_decode_step)")
    if args.kv_bits and not args.split and _meshed(args):
        p.error("--kv_bits under a mesh needs --split: the monolithic mesh decode has no "
                "int8-cache layout (split serving runs xla_decode_step's code-domain "
                "attention)")
    args.pad_multiple = 64  # every pool prompt pads to one length bucket
    args.max_prompt_len = 320

    import torch

    policy = build_policy(args)
    unnorm_key = next(iter(policy.processor.statistics))
    s = policy.config.vision.image_size
    rng = np.random.RandomState(args.seed)
    images = [(rng.rand(s, s, 3) * 255).astype(np.uint8) for _ in range(4)]

    lat, stats, wall, parity, trace = run_clients(policy, args, images, unnorm_key)
    done = len(lat)
    chunk = policy.processor.action_chunk_size
    tag = f"int{args.bits} LM" if args.bits else "bf16 LM"
    if args.mlp_bits:
        tag += f", int{args.mlp_bits} mlp"
    if args.kv_bits:
        tag += f", int{args.kv_bits} kv"
    tag += ", split-phase" if args.split else ", monolithic"
    if _meshed(args):
        tag += f", mesh model={args.mesh_model} data={args.mesh_data}"
    from spatialvla_tpu_torch.utils.profiling import card_line

    cuda = policy.device.type == "cuda"
    result = {
        "metric": f"serving load, {args.clients} closed-loop clients ({tag})",
        "model": "spatialvla_tiny" if args.tiny else "spatialvla_4b",
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "card": card_line() if cuda else None,
        "requests": args.clients * args.requests,
        "wall_s": round(wall, 3),
        "throughput_rps": round(done / wall, 3),
        "actions_per_sec": round(done * chunk / wall, 3),
        "latency_ms_p50": round(lat[len(lat) // 2], 2) if lat else None,
        "latency_ms_p95": round(lat[min(len(lat) - 1, int(0.95 * len(lat)))], 2)
        if lat else None,
    }
    if args.split:
        result.update(
            mean_prefill_rows=round(stats["mean_prefill_rows"], 3),
            prefill_pad_fraction=round(stats["prefill_pad_fraction"], 3),
            mean_slot_occupancy=round(stats["mean_slot_occupancy"], 3),
            decode_dispatches=stats["decode_dispatches"],
            dispatch_thread_s=stats["dispatch_thread_s"])
    else:
        result.update(mean_batch_occupancy=round(stats["mean_batch_occupancy"], 3),
                      pad_fraction=round(stats["pad_fraction"], 3), batches=stats["batches"])
    if parity is not None:
        result["parity"] = parity
    if trace is not None:
        result["trace"] = trace
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
