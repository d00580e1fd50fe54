#!/usr/bin/env python
"""Quantization quality gate for the PyTorch port (the jax-free twin of
scripts/eval_quant.py): compare bf16 / int8 / int4 serving on the same
observations and report action-token agreement + continuous-action drift.
Run this on YOUR checkpoint + representative images before serving with
``policy.quantize(bits=4)`` (per-channel symmetric int4 is a real accuracy
trade; int8 is typically indistinguishable).

    python scripts/eval_quant_torch.py --checkpoint_dir ckpt [--hf] \\
        [--images img1.png img2.png ...] [--n_synthetic 16] \\
        [--instruction "pick up the object"] [--unnorm_key bridge_orig/1.0.0] \\
        [--gate_out gate.json] [--device cuda]

With no --images, synthetic observations are used — fine for a smoke
signal, but gate on real task images (--images reads them with PIL).
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--hf", action="store_true", help="reference-format dir")
    p.add_argument("--images", nargs="*", default=None)
    p.add_argument("--n_synthetic", type=int, default=16)
    p.add_argument("--instruction", default="pick up the object")
    p.add_argument("--unnorm_key", default=None)
    p.add_argument("--bits", type=int, nargs="*", default=[8, 4])
    p.add_argument("--mixed", action="store_true",
                   help="also gate the mixed config (int8 attention/head + int4 MLP — "
                        "policy.quantize(8, mlp_bits=4))")
    p.add_argument("--depth_res", type=int, nargs="*", default=[],
                   help="also gate reduced-resolution ZoeDepth (e.g. 256 192): everything "
                        "else stays bf16 so the drift isolates the depth-resolution trade")
    p.add_argument("--kv8", action="store_true",
                   help="also gate the int8 KV cache (bits=8, kv_bits=8) — rides the fused "
                        "decode path, so run this on the card (the CPU path rejects kv_bits)")
    p.add_argument("--gate_out", default=None, metavar="PATH",
                   help="write a machine-readable quality-gate artifact (serve_torch.py "
                        "refuses ungated quality-trade knobs; bake it into a serving "
                        "checkpoint via quantize_checkpoint_torch.py --gate)")
    p.add_argument("--device", default="cuda",
                   help="where the policies run (cuda raises without a card; cpu)")
    args = p.parse_args(argv)

    from spatialvla_tpu_torch.inference import SpatialVLAPolicy
    from spatialvla_tpu_torch.serve.gating import policy_quality_knobs, write_gate

    load = SpatialVLAPolicy.from_hf_checkpoint if args.hf else SpatialVLAPolicy.load

    def loader(directory):
        return load(directory, device=args.device)

    if args.images:
        from PIL import Image

        obs = [np.asarray(Image.open(f).convert("RGB")) for f in args.images]
    else:
        rng = np.random.RandomState(0)
        obs = [(rng.rand(224, 224, 3) * 255).astype(np.uint8) for _ in range(args.n_synthetic)]
        print(f"(no --images: {len(obs)} synthetic observations — smoke signal only)")

    def run(policy):
        ids, acts = [], []
        for im in obs:
            out = policy.predict(im, args.instruction, unnorm_key=args.unnorm_key)
            ids.append(np.asarray(out["action_ids"]))
            acts.append(np.asarray(out["actions"]))
        return np.stack(ids), np.stack(acts)

    base_ids, base_acts = run(loader(args.checkpoint_dir))
    print(f"baseline (bf16): {base_ids.shape[0]} obs x chunk {base_acts.shape[1]}")

    # every row gates the config exactly as policy.quantize() would serve it
    # (the --bits/--mixed rows include the default int8 vision front so they
    # are mutually comparable); the depth rows deliberately isolate the
    # depth-resolution trade (everything else bf16)
    configs = [(f"int{b}", dict(bits=b)) for b in args.bits]
    if args.mixed:
        configs.append(("int8+mlp4", dict(bits=8, mlp_bits=4)))
    if args.kv8:
        configs.append(("int8+kv8", dict(bits=8, kv_bits=8)))
    configs += [(f"depth@{r}", dict(bits=None, vision_bits=None, depth_image_size=r))
                for r in args.depth_res]
    entries = []
    for label, kwargs in configs:
        policy = loader(args.checkpoint_dir).quantize(**kwargs)
        q_ids, q_acts = run(policy)
        agree = float((q_ids == base_ids).mean())
        l1 = float(np.abs(q_acts - base_acts).mean())
        worst = float(np.abs(q_acts - base_acts).max())
        print(f"{label}: token agreement {agree:.1%}  action L1 {l1:.4f}  "
              f"max |delta| {worst:.4f}")
        if agree < 0.99 and label != "int8":
            print(f"  -> {label} diverges from the bf16 baseline on these observations; gate "
                  "on closed-loop task success before serving with it")
        entries.append({"label": label, "knobs": policy_quality_knobs(policy),
                        "token_agreement": agree, "action_l1": l1, "max_abs_delta": worst})

    if args.gate_out:
        write_gate(args.gate_out, {
            "checkpoint": args.checkpoint_dir,
            "observations": {"source": "images" if args.images else "synthetic",
                             "count": len(obs), "files": args.images or []},
            "instruction": args.instruction,
            "entries": entries,
        })
        print(f"gate artifact written: {args.gate_out}")
        if not args.images:
            print("  (synthetic observations: a smoke-signal gate — re-gate with --images "
                  "from the target task before production serving)")


if __name__ == "__main__":
    sys.exit(main())
