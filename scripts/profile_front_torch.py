#!/usr/bin/env python3
"""Where one warm request's time goes, stage by stage, in the PyTorch port
(the port of scripts/profile_front.py).

    python3 scripts/profile_front_torch.py [--bits 8] [--vision_bits 0] [--depth_res 256]
        [--iters 20] [--batch 1] [--preset spatialvla_4b] [--device cuda]

Builds the serving tree of the preset (random bf16 weights from a seed:
quantize_lm_params(bits), precompute_rel_bias at --depth_res, and
quantize_vision_params(vision_bits) unless --vision_bits 0 keeps the front
bf16) and the example request of graft_entry_torch (its ids with 10 text
tokens, its pixels and intrinsic, replicated to --batch rows), then times
each stage of a request:

    full_predict    spatialvla.predict_action (4 action steps; on the card
                    through the decode loop's CUDA graph, as a policy runs it)
    zoe_depth       zoe.predict_depth
    siglip          siglip.forward on the normalized pixels
    image_features  spatialvla.get_image_features (ZoeDepth + SigLIP + Ego3D
                    + projector)
    prefill         merge_input_embeddings + gemma2.forward writing a fresh
                    cache of P + 12 slots under bidirectional_prefill_mask

and the decode remainder (full_predict less image_features and prefill).
The stages are timed round-robin: after two warm-up calls of each, --iters
rounds of one synchronized call of each stage (utils/profiling.timeit), so
that a drift of the host's speed falls on every stage alike; a stage's wall
ms is the median of its calls, and the remainder the median of the rounds'
remainders. A negative remainder (the stages do not add up to the request)
is flagged in its line and in the JSON. On the card each stage then takes
one warm call under torch.profiler, whose kernels' device time (the union
of their intervals) over the traced window (the call and its synchronize)
gives the busy ms and the idle share, with its top kernels by device ms.
The profiler stretches the host's side of the window, so the idle share is
also given against the stage's wall ms ("idle_share_of_call"). Prints one
line a stage, then one JSON line with all of it. On the CPU (--device cpu)
no device time is measured.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

STAGES = ("full_predict", "zoe_depth", "siglip", "image_features", "prefill")
CHUNK = 4  # action steps a request: 3 * CHUNK ids, the first from the prefill
TOP = 5  # kernels a stage lists by device ms


def preset(name: str):
    from spatialvla_tpu_torch.config import spatialvla_4b, spatialvla_tiny

    if name == "spatialvla_4b":
        return spatialvla_4b()
    if name == "spatialvla_tiny":
        return spatialvla_tiny(use_vision_zoe=True)
    raise ValueError(f"unknown preset {name!r}: spatialvla_4b or spatialvla_tiny")


def serving_params(params, cfg, *, bits: int, vision_bits: int, depth_res=None):
    """The serving tree of scripts/profile_front.py's build: the LM
    quantized to ``bits``, the ZoeDepth bias precomputed at ``depth_res``,
    the vision front quantized to ``vision_bits`` (0 keeps it as it is)."""
    from spatialvla_tpu_torch.models.zoe import precompute_rel_bias
    from spatialvla_tpu_torch.ops.quant import quantize_lm_params, quantize_vision_params

    with torch.inference_mode():
        params = dict(params)
        params["lm"] = quantize_lm_params(params["lm"], bits=bits)
        if "zoe" in params:
            params["zoe"] = precompute_rel_bias(params["zoe"], cfg.zoe, image_size=depth_res)
        if vision_bits:
            params = quantize_vision_params(params, bits=vision_bits)
    return params


def build_params(cfg, *, bits: int, vision_bits: int, depth_res, device, seed: int = 0):
    """bf16 random weights from torch.Generator(device).manual_seed(seed),
    made on ``device``, in their serving form."""
    from spatialvla_tpu_torch.models import spatialvla

    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.inference_mode():
        params = spatialvla.init_params(cfg, generator=gen, device=device, dtype=torch.bfloat16)
    return serving_params(params, cfg, bits=bits, vision_bits=vision_bits, depth_res=depth_res)


def request(cfg, *, batch: int, device):
    """graft_entry_torch's example request without action tokens, its rows
    replicated ``batch`` times: (ids, pixels, intrinsic)."""
    from graft_entry_torch import _example_batch

    ex = _example_batch(cfg, B=1, n_text=10, n_action=0, device=device,
                        image_size=cfg.vision.image_size)
    return tuple(torch.cat([ex[k]] * batch) for k in ("input_ids", "pixel_values", "intrinsic"))


def stage_fns(params, cfg, ids, px, intr, *, depth_res=None, compute_dtype=torch.bfloat16,
              decode_graphs=None):
    """name -> a no-argument callable for each of STAGES (the prefill returns
    (hidden, cache)); call them under torch.inference_mode()."""
    from spatialvla_tpu_torch.models import gemma2, siglip, spatialvla, zoe

    B, P = ids.shape
    S = P + 3 * CHUNK
    size = cfg.vision.image_size
    fns = {
        "full_predict": lambda: spatialvla.predict_action(
            params, cfg, ids, pixel_values=px, intrinsic=intr, action_chunk_size=CHUNK,
            compute_dtype=compute_dtype, depth_image_size=depth_res,
            decode_graphs=decode_graphs),
        "siglip": lambda: siglip.forward(params["vision"], cfg.vision,
                                         (px.to(compute_dtype) - 0.5) / 0.5),
        "image_features": lambda: spatialvla.get_image_features(
            params, cfg, px, intr, compute_dtype=compute_dtype, depth_image_size=depth_res),
    }
    if "zoe" in params:
        fns["zoe_depth"] = lambda: zoe.predict_depth(
            params["zoe"], cfg.zoe, px.to(compute_dtype), target_hw=(size, size),
            image_size=depth_res)
    feats = fns["image_features"]()

    def prefill():
        embeds = spatialvla.merge_input_embeddings(params, cfg, ids, feats, dtype=compute_dtype)
        cache = gemma2.init_cache(cfg.text, B, S, device=ids.device, dtype=compute_dtype)
        pos = torch.arange(1, P + 1, device=ids.device)[None].expand(B, P)
        mask = spatialvla.bidirectional_prefill_mask(P, S, B, device=ids.device)
        return gemma2.forward(params["lm"], cfg.text, embeds, pos, mask, cache=cache,
                              cache_position=0)

    fns["prefill"] = prefill
    return {name: fns[name] for name in STAGES if name in fns}


def device_busy(fn, name: str) -> dict:
    """One call of ``fn`` and a synchronize under torch.profiler (CPU and
    CUDA), in a range of its own: utils/profiling.kernel_busy of that
    range."""
    from spatialvla_tpu_torch.utils.profiling import kernel_busy, trace_events

    torch.cuda.synchronize()
    tag = f"profile_front:{name}"
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(tag):
            fn()
            torch.cuda.synchronize()
    busy = kernel_busy(trace_events(prof), tag, top=TOP)
    if not busy["kernels"]:
        raise RuntimeError(f"{name}: the traced call holds no kernel")
    return busy


def profile(params, cfg, ids, px, intr, *, depth_res=None, iters: int = 20,
            compute_dtype=torch.bfloat16) -> dict:
    """Each stage's wall ms, timed round-robin (and on the card its device
    busy ms, idle share and top kernels), and the decode remainder; prints
    a line a stage."""
    from spatialvla_tpu_torch.models import spatialvla
    from spatialvla_tpu_torch.utils.profiling import sync, timeit

    cuda = ids.device.type == "cuda"
    B = ids.shape[0]
    graphs = spatialvla.DecodeGraphs() if cuda else None
    with torch.inference_mode():
        fns = stage_fns(params, cfg, ids, px, intr, depth_res=depth_res,
                        compute_dtype=compute_dtype, decode_graphs=graphs)
        for fn in fns.values():
            for _ in range(2):
                sync(fn())
        calls = {name: [] for name in fns}
        resid = []
        for _ in range(iters):  # one synchronized call of each stage a round
            for name, fn in fns.items():
                calls[name].append(timeit(fn, iters=1, warmup=0) * 1e3)
            resid.append(calls["full_predict"][-1] - calls["image_features"][-1]
                         - calls["prefill"][-1])
        report = {}
        for name, fn in fns.items():
            wall = statistics.median(calls[name])
            row = {"wall_ms": wall, "wall_ms_per_row": wall / B, "wall_ms_min": min(calls[name]),
                   "wall_ms_max": max(calls[name])}
            row.update(device_busy(fn, name) if cuda else
                       {"window_ms": None, "busy_ms": None, "idle_share": None, "kernels": None,
                        "top": None})
            row["idle_share_of_call"] = 1 - row["busy_ms"] / wall if cuda else None
            report[name] = row
            per_row = f" ({wall / B:6.2f} ms/row)" if B > 1 else ""
            if cuda:
                top = ", ".join(f"{t['name'][:48]} {t['ms']:.2f} ms x{t['launches']}"
                                for t in row["top"][:3])
                dev = (f"device busy {row['busy_ms']:8.2f} of {row['window_ms']:8.2f} ms traced "
                       f"(idle share {row['idle_share']:.3f}, of a call "
                       f"{row['idle_share_of_call']:.3f}; {row['kernels']} kernels; {top})")
            else:
                dev = "device busy not measured (CPU)"
            print(f"{name:>18}: {wall:8.2f} ms wall{per_row} (median of {iters} rounds, "
                  f"{row['wall_ms_min']:.2f}-{row['wall_ms_max']:.2f}); {dev}", flush=True)
    steps = 3 * CHUNK - 1
    median = statistics.median(resid)
    negative = sum(r < 0 for r in resid)
    flag = (f"; NEGATIVE in {negative} of {iters} rounds: the stages do not add up to the "
            f"request" if negative else "")
    print(f"{'decode (resid)':>18}: {median:8.2f} ms wall (median of the rounds' remainders, "
          f"{min(resid):.2f}-{max(resid):.2f}; ~{median / steps:.2f} ms/step x {steps}){flag}",
          flush=True)
    return {"stages": report, "decode_resid_ms": median, "decode_resid_min_ms": min(resid),
            "decode_resid_negative_rounds": negative, "rounds": iters, "P": int(ids.shape[1]),
            "batch": B}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--vision_bits", type=int, default=8, help="0 keeps the vision front bf16")
    ap.add_argument("--depth_res", type=int, default=0,
                    help=">0 runs ZoeDepth at a reduced internal resolution")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=1,
                    help="replicate the observation to B rows (the prefill-bucket front cost "
                         "per row)")
    ap.add_argument("--preset", default="spatialvla_4b", help="spatialvla_4b or spatialvla_tiny")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("profile_front_torch: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    from spatialvla_tpu_torch.utils.profiling import card_line

    card = card_line() if device.type == "cuda" else None
    if card:
        print(f"card: {torch.cuda.get_device_name(device)} | nvidia-smi: {card}", flush=True)
    cfg = preset(args.preset)
    depth_res = args.depth_res or None
    params = build_params(cfg, bits=args.bits, vision_bits=args.vision_bits,
                          depth_res=depth_res, device=device)
    ids, px, intr = request(cfg, batch=args.batch, device=device)
    out = profile(params, cfg, ids, px, intr, depth_res=depth_res, iters=args.iters)
    out.update(preset=args.preset, bits=args.bits, vision_bits=args.vision_bits,
               depth_res=depth_res, iters=args.iters, device=str(device), card=card)
    print(json.dumps({"profile_front": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
