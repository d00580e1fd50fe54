#!/usr/bin/env python3
"""Where one decode step's device time goes, kernel by kernel, on an NVIDIA GPU.

    python3 scripts/profile_decode_step.py [--root DIR] [--rows M] [--formats int8,int4]
        [--residual-max-m R]

Builds the 26 Gemma2-2B layers of spatialvla_4b (random weights from a
seed, a 2048-row vocabulary) in each weight format, captures one
``fused_decode_step`` (M rows at position 277 of a 289-slot bf16 cache) into
a CUDA graph, and replays it under ``torch.profiler``: the device time of
every kernel of one replay, summed by kernel name from the chrome trace
(operator rows are not counted), with the replay's span, the busy share and
the launches. ``--root`` imports ``spatialvla_tpu_torch`` from another
checkout (a parent commit unpacked with ``git archive``), so that two
versions can be traced in one call. Writes the traces under
``chiprun_out/profile_decode_step/``. ``--residual-max-m`` sets
``quant.RESIDUAL_MAX_M`` for the run (0: no residual kernel, every
residual update by ``norm_residual`` with the next norm's x' and the plain
matvec), to trace the step's two routes side by side.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import subprocess
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

    if args.residual_max_m is not None:
        quant.RESIDUAL_MAX_M = args.residual_max_m

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
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
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
            if not kernels:
                print(f"{name}: the trace holds no kernel events", flush=True)
                continue
            by = collections.defaultdict(lambda: [0.0, 0])
            for e in kernels:
                short = (e["name"].replace("(anonymous namespace)::", "")
                         .replace("void ", "").split("(")[0])
                by[short][0] += e["dur"] / 1e3
                by[short][1] += 1
            busy = sum(v[0] for v in by.values())
            span = (max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)) / 1e3
            print(f"{name}{args.tag} M={M} S={S} ({args.root}): one graph replay, {len(kernels)} "
                  f"kernels, busy {busy:.4f} ms of a {span:.4f} ms span (busy share "
                  f"{busy / span:.3f}) | {card}", flush=True)
            for k, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0]):
                print(f"    {k[:72]:72s} {n:4d} launches {ms:8.4f} ms ({ms / busy:6.1%})",
                      flush=True)
            del lm, graph
    return 0


if __name__ == "__main__":
    sys.exit(main())
