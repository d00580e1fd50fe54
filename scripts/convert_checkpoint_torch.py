#!/usr/bin/env python
"""Convert a reference-format HF SpatialVLA checkpoint directory
(safetensors) to the port's own checkpoint layout (``params.safetensors``,
``config.json`` and the processor files: what the port's training CLIs
write and ``SpatialVLAPolicy.load`` and ``train.finetune --pretrained_dir``
read). Imports nothing of jax; the port's counterpart of
scripts/convert_checkpoint.py.

Usage:
    python scripts/convert_checkpoint_torch.py --hf_dir /ckpts/spatialvla-4b-224-pt \\
        --output out/spatialvla-4b-224-pt [--dtype float32] [--device cpu]

Each tensor is read onto ``--device`` (default cuda; without a card that
raises, and the CPU is used only with --device cpu) in ``--dtype`` (default:
as stored), then written as it is.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DTYPES = ("stored", "float32", "bfloat16")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--hf_dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--dtype", default="stored", choices=DTYPES,
                   help="the floating leaves' dtype (stored: as in the HF files)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from spatialvla_tpu_torch.convert.hf_checkpoint import load_hf_checkpoint
    from spatialvla_tpu_torch.convert.params import target_device
    from spatialvla_tpu_torch.train.checkpoints import save_params

    dtype = None if args.dtype == "stored" else getattr(torch, args.dtype)
    params, config, processor = load_hf_checkpoint(args.hf_dir, dtype=dtype,
                                                   device=target_device(args.device))
    nbytes = save_params(args.output, params, config_json=config.to_json())
    processor.save(args.output)
    print(f"converted {args.hf_dir} -> {args.output} ({nbytes} bytes)")
    return args.output


if __name__ == "__main__":
    main()
