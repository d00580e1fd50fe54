"""Offline quantization for the PyTorch port: bake a serving checkpoint once,
serve it from then on (the port's form of scripts/quantize_checkpoint.py).

Loads a checkpoint of the port's own format (``SpatialVLAPolicy.load``) or,
with ``--hf``, a reference-format HF checkpoint (``from_hf_checkpoint``),
applies the serving parameterization (``SpatialVLAPolicy.quantize``: int8 /
int4 LM, int8 vision front, precomputed ZoeDepth bias, optional int8 KV
cache / reduced-resolution depth) and writes a ``save_serving`` checkpoint,
which ``SpatialVLAPolicy.load_serving`` reads without a bf16 tree or a
quantize pass. Imports no jax. Quality-gate the knobs first
(scripts/eval_quant.py of the JAX package writes the gate artifact).

Usage:
    python scripts/quantize_checkpoint_torch.py --ckpt /path/to/ckpt [--hf] \\
        --out /path/to/serving_ckpt [--bits 8] [--vision_bits 8] [--mlp_bits 4] \\
        [--kv_bits 8] [--depth_res 256] [--group_size 128] [--gate GATE_JSON] \\
        [--device cuda]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="source checkpoint directory")
    ap.add_argument("--hf", action="store_true",
                    help="source is a reference-format HF checkpoint")
    ap.add_argument("--out", required=True, help="serving checkpoint to write")
    ap.add_argument("--bits", type=int, default=8, help="LM weight bits (0 = keep bf16)")
    ap.add_argument("--vision_bits", type=int, default=8,
                    help="vision-front weight bits (0 = keep bf16)")
    ap.add_argument("--mlp_bits", type=int, default=0,
                    help="4 = int4 MLP with int8 attention/head (mixed)")
    ap.add_argument("--kv_bits", type=int, default=0,
                    help="8 = int8 KV cache on the fused decode path")
    ap.add_argument("--depth_res", type=int, default=0,
                    help="reduced zoe internal resolution (0 = full)")
    ap.add_argument("--group_size", type=int, default=0,
                    help="int4 grouped scales (128 = accuracy mode)")
    ap.add_argument("--gate", default=None, metavar="GATE_JSON",
                    help="quality-gate artifact to bake into serving_config.json; rejected "
                         "unless it covers exactly the knobs baked here")
    ap.add_argument("--device", default="cuda",
                    help="where to load and quantize (cuda raises without a card; cpu)")
    args = ap.parse_args(argv)

    from spatialvla_tpu_torch.inference import SpatialVLAPolicy
    from spatialvla_tpu_torch.serve.gating import load_gate

    gate = load_gate(args.gate) if args.gate else None
    load = SpatialVLAPolicy.from_hf_checkpoint if args.hf else SpatialVLAPolicy.load
    policy = load(args.ckpt, device=args.device)
    policy.quantize(
        args.bits or None,
        vision_bits=args.vision_bits or None,
        mlp_bits=args.mlp_bits or None,
        kv_bits=args.kv_bits or None,
        depth_image_size=args.depth_res or None,
        group_size=args.group_size or None,
    )
    policy.save_serving(args.out, quality_gate=gate)
    print(f"serving checkpoint written to {args.out} "
          f"(quant={policy.quant_desc}, kv_bits={policy.kv_bits}, "
          f"depth_res={policy.depth_image_size}, device={policy.device})", flush=True)


if __name__ == "__main__":
    main()
