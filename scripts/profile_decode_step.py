#!/usr/bin/env python3
"""Where one decode step's device time goes, kernel by kernel, on an NVIDIA GPU.

    python3 scripts/profile_decode_step.py [--root DIR] [--rows M] [--formats int8,int4]
        [--residual-max-m R]

Builds the 26 Gemma2-2B layers of spatialvla_4b (random weights from a
seed, a 2048-row vocabulary) in each weight format, captures one
``fused_decode_step`` (M rows at position 277 of a 289-slot bf16 cache) into
a CUDA graph, and replays it under ``torch.profiler``: the device time of
every kernel of one replay, summed by kernel name from the chrome trace
(operator rows are not counted; utils/profiling.kernel_busy), with the
replay's span, the busy share (the union of the kernels' intervals over the
span) and the launches. ``--root`` imports ``spatialvla_tpu_torch`` from another
checkout (a parent commit unpacked with ``git archive``), so that two
versions can be traced in one call. Writes the traces under
``chiprun_out/profile_decode_step/``. ``--residual-max-m`` sets
``quant.RESIDUAL_MAX_M`` for the run (0: no residual kernel, every
residual update by ``norm_residual`` with the next norm's x' and the plain
matvec), to trace the step's two routes side by side.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

FORMATS = {"int8": dict(bits=8), "int4": dict(bits=4), "int4-g128": dict(bits=4, group_size=128),
           "int8+mlp4": dict(bits=8, mlp_bits=4)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--formats", default="int8")
    ap.add_argument("--tag", default="")
    ap.add_argument("--residual-max-m", type=int, default=None)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from spatialvla_tpu_torch import spatialvla_4b
    from spatialvla_tpu_torch.models import gemma2
    from spatialvla_tpu_torch.ops import decode_step as ds
    from spatialvla_tpu_torch.ops import quant
    from spatialvla_tpu_torch.utils.profiling import card_line, kernel_busy, trace_events

    if args.residual_max_m is not None:
        quant.RESIDUAL_MAX_M = args.residual_max_m

    card = card_line()
    out_dir = Path("chiprun_out/profile_decode_step")
    out_dir.mkdir(parents=True, exist_ok=True)
    tcfg = dataclasses.replace(spatialvla_4b().text, vocab_size=2048)
    L, H, Nkv, D = tcfg.num_layers, tcfg.hidden_size, tcfg.num_kv_heads, tcfg.head_dim
    M, S, P = args.rows, 289, 277
    g = torch.Generator(device="cuda").manual_seed(11)
    with torch.inference_mode():
        base = gemma2.init_params(tcfg, generator=g, device="cuda", dtype=torch.bfloat16)
        for k in ("input_norm", "post_attn_norm", "pre_ffn_norm", "post_ffn_norm"):
            base["layers"][k] = (torch.randn(L, H, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
        ck, cv = ((torch.randn(L, M, Nkv, S, D, generator=g, device="cuda") * 0.3)
                  .to(torch.bfloat16) for _ in range(2))
        x = (torch.randn(M, H, generator=g, device="cuda") * 0.3 * H ** 0.5).to(torch.bfloat16)
        pos = torch.full((M,), P, dtype=torch.int32, device="cuda")
        for name in args.formats.split(","):
            lm = quant.quantize_lm_params(base, **FORMATS[name])
            step = lambda: ds.fused_decode_step(lm, tcfg, x, ck, cv, pos, pos + 1)  # noqa: E731
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(3):
                    step()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step()
            for _ in range(5):
                graph.replay()
            torch.cuda.synchronize()
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                graph.replay()
                torch.cuda.synchronize()
            path = out_dir / f"{name}{args.tag}_M{M}.json"
            trace = kernel_busy(trace_events(prof, path), top=None)
            if not trace["kernels"]:
                print(f"{name}: the trace holds no kernel events", flush=True)
                continue
            busy, span = trace["busy_ms"], trace["window_ms"]
            print(f"{name}{args.tag} M={M} S={S} ({args.root}): one graph replay, "
                  f"{trace['kernels']} kernels, busy {busy:.4f} ms of a {span:.4f} ms span (busy "
                  f"share {busy / span:.3f}) | {card}", flush=True)
            for k in trace["top"]:
                print(f"    {k['name'][:72]:72s} {k['launches']:4d} launches {k['ms']:8.4f} ms "
                      f"({k['ms'] / busy:6.1%})", flush=True)
            del lm, graph
    return 0


if __name__ == "__main__":
    sys.exit(main())
