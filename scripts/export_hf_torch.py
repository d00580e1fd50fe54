#!/usr/bin/env python
"""Export a checkpoint directory of the port (``params.safetensors`` +
``config.json`` + ``processor_config.json``, as the port's training CLIs
write it) to a reference-format HF checkpoint directory (model.safetensors +
config.json + processor artifacts) loadable by the reference torch stack
with AutoModel.from_pretrained(trust_remote_code=True). Imports nothing of
jax; the port's counterpart of scripts/export_hf.py, over
``convert/export_hf.py``.

    python scripts/export_hf_torch.py --checkpoint_dir out/pretrain --output_dir out/hf \\
        [--from_hf] [--device cpu]

The tree is exported in float32, as the JAX script exports it. The tensors
are read onto ``--device`` (default cuda; without a card that raises, and
the CPU is used only with --device cpu).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint_dir", required=True,
                   help="a checkpoint dir of the port (or a reference HF dir with --from_hf "
                        "for format conversion)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--from_hf", action="store_true",
                   help="input is already an HF dir (re-export/normalize)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from spatialvla_tpu_torch.convert.export_hf import export_hf_checkpoint
    from spatialvla_tpu_torch.inference import SpatialVLAPolicy

    loader = SpatialVLAPolicy.from_hf_checkpoint if args.from_hf else SpatialVLAPolicy.load
    policy = loader(args.checkpoint_dir, device=args.device, param_dtype=torch.float32)
    out = export_hf_checkpoint(policy.params, policy.config, args.output_dir,
                               processor=policy.processor)
    print(f"exported HF checkpoint to {out}")
    return out


if __name__ == "__main__":
    main()
