"""Fine-tuning entry point of the port (port of
spatialvla_tpu/train/finetune.py; reference: train/spatialvla_finetune.py).

Loads a pretrained directory of the port's own format (``params.safetensors``
and ``processor_config.json``, what ``train.pretrain`` writes), optionally
re-grids the spatial-token embeddings to the fine-tune data's Gaussian action
statistics (``--adapt_emb``, reference :229-238), and trains either the full
model or LoRA adapters (target presets 'linear' / 'linear+emb' /
'linear+emb+h' with the spatial embedding in modules_to_save, reference
:262-302), on one device or over a mesh of processes (the mesh and
multi-host flags as in ``train.pretrain``; the full model's step is sharded,
the LoRA step holds its factors whole on every rank and its base whole but
over ``--mesh_model``, whose shards take the factors' matching blocks).
New-mixture statistics
are merged into the processor so old unnorm keys survive (reference
:315-327). Checkpoints go to ``<output_dir>/checkpoints`` and a restart
resumes from the latest.

    python -m spatialvla_tpu_torch.train.finetune \\
        --pretrained_dir out/pretrain --data_root_dir /data/oxe \\
        --mixture bridge --output_dir out/finetune --use_lora
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    """The JAX CLI's flags (finetune.py:24), plus ``--device``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pretrained_dir", type=str, required=True,
                   help="dir with params.safetensors + processor_config.json")
    p.add_argument("--data_root_dir", type=str, required=True)
    p.add_argument("--mixture", type=str, default="uiuc_d3field")
    p.add_argument("--output_dir", type=str, required=True)
    # lora
    p.add_argument("--use_lora", action="store_true")
    p.add_argument("--lora_rank", type=int, default=32)
    p.add_argument("--lora_alpha", type=float, default=32.0)
    p.add_argument("--lora_target", type=str, default="linear",
                   choices=["linear", "linear+emb", "linear+emb+h"])
    # adaptation
    p.add_argument("--adapt_emb", type=str, default=None,
                   help="gaussian stats json to re-grid spatial embeddings to")
    p.add_argument("--tokenizer_path", type=str, default=None,
                   help="override the tokenizer persisted beside the pretrained checkpoint")
    p.add_argument("--prompt_template", type=str, default=None,
                   help="opt-in prompt template; default is the bare lowercased instruction "
                        "(reference parity)")
    p.add_argument("--min_sigma", type=float, default=0.0)
    # optimization
    p.add_argument("--learning_rate", type=float, default=5e-4)
    p.add_argument("--warmup_ratio", type=float, default=0.005)
    p.add_argument("--max_steps", type=int, default=10_000)
    p.add_argument("--per_device_batch_size", type=int, default=2)
    p.add_argument("--seq_len", type=int, default=320)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--action_forward_steps", type=int, default=3)
    p.add_argument("--shuffle_buffer_size", type=int, default=2048)
    p.add_argument("--attn_backend", type=str, default="flash",
                   choices=["xla", "flash", "ring", "pipeline"])
    p.add_argument("--mesh_sp", type=int, default=1)
    p.add_argument("--mesh_pp", type=int, default=1)
    p.add_argument("--pp_microbatches", type=int, default=0)
    p.add_argument("--no_remat", action="store_true")
    p.add_argument("--loss_chunk_size", type=int, default=256)
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_fsdp", type=int, default=-1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--save_steps", type=int, default=10_000)
    p.add_argument("--logging_steps", type=int, default=100)
    p.add_argument("--model_preset", type=str, default="spatialvla_4b",
                   choices=["spatialvla_4b", "spatialvla_tiny"])
    p.add_argument("--no_vision_zoe", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda; without a card this raises, and "
                        "the CPU is used only with --device cpu)")
    return p


def load_pretrained(pretrained_dir: str, *, device, text_tokenizer=None):
    """(params with fp32 floating leaves on ``device``, processor) of a
    pretrained directory of the port's format (finetune.py:131-145)."""
    from ..processor import SpatialVLAProcessor
    from .checkpoints import load_params

    processor = SpatialVLAProcessor.load(pretrained_dir, text_tokenizer)
    params = load_params(pretrained_dir, device=device, float_dtype=torch.float32)
    return params, processor


def build_everything(args):
    from ..config import spatialvla_4b, spatialvla_tiny
    from ..data import FrameTransformConfig, InterleavedRLDSDataset, TrajTransformConfig, VLABatcher
    from ..processor import load_text_tokenizer
    from . import (OptimizerConfig, TrainStepConfig, build_decode_luts, init_lora_train_state,
                   init_train_state, make_lora_train_step, make_optimizer, make_train_step,
                   shard_lora_train_step, shard_train_step, trainable_mask)
    from .checkpoints import CheckpointManager
    from .lora import TARGET_PRESETS
    from ..parallel import form_global_batch, model_group_batches, process_index
    from .pretrain import setup_parallel, training_device

    device = training_device(args)
    device, mesh, batch_rank, n_batch = setup_parallel(args, device, explain=False)
    cfg = spatialvla_4b() if args.model_preset == "spatialvla_4b" else spatialvla_tiny()
    if args.no_vision_zoe:
        cfg = dataclasses.replace(cfg, use_vision_zoe=False, zoe=None)

    # processor from the pretrained dir (restores the persisted tokenizer
    # unless overridden)
    text_tokenizer = load_text_tokenizer(args.tokenizer_path) if args.tokenizer_path else None
    params, processor = load_pretrained(args.pretrained_dir, device=device,
                                        text_tokenizer=text_tokenizer)
    processor.action_chunk_size = args.action_forward_steps + 1
    if args.adapt_emb:  # optional spatial-embedding re-gridding to new gaussian stats
        with open(args.adapt_emb) as f:
            gs = json.load(f)
        emb = params["spatial_embed"]
        new_emb = processor.action_tokenizer.adapt_to_gaussian(
            gs, min_sigma=args.min_sigma, embeddings=emb.float().cpu().numpy())
        # processor.bin_policy is a live view of the tokenizer's bins now
        params = {**params, "spatial_embed": torch.as_tensor(
            np.asarray(new_emb), dtype=emb.dtype, device=emb.device)}

    ds = InterleavedRLDSDataset(
        args.mixture, args.data_root_dir,
        traj_config=TrajTransformConfig(forward_window_size=args.action_forward_steps),
        frame_config=FrameTransformConfig(resize_size=(args.image_size, args.image_size)),
        shuffle_buffer_size=args.shuffle_buffer_size, seed=args.seed + 3407 * batch_rank,
        shard_by_rank=(batch_rank, n_batch),
    )
    # merge new statistics into processor (old unnorm keys survive)
    processor.statistics = {**processor.statistics, **ds.statistics}

    ocfg = OptimizerConfig(learning_rate=args.learning_rate, warmup_ratio=args.warmup_ratio,
                           total_steps=args.max_steps)
    luts = {k: torch.as_tensor(v, device=device)
            for k, v in build_decode_luts(processor.action_tokenizer).items()}
    scfg = TrainStepConfig(use_remat=not args.no_remat, compute_dtype=torch.bfloat16,
                           attn_backend=args.attn_backend, pp_microbatches=args.pp_microbatches,
                           loss_chunk_size=args.loss_chunk_size)
    if args.use_lora:
        tx = make_optimizer(ocfg, None, None)
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        state = init_lora_train_state(gen, params, tx,
                                      target_patterns=TARGET_PRESETS[args.lora_target],
                                      rank=args.lora_rank)
        step = make_lora_train_step(cfg, tx, scfg, alpha=args.lora_alpha, rank=args.lora_rank,
                                    luts=luts, mesh=mesh)
        step, params = shard_lora_train_step(step, mesh, params)
        step_args = (params,)
    else:
        mask = trainable_mask(params, freeze_llm_embed=cfg.use_spatial_token)
        tx = make_optimizer(ocfg, params, mask)
        step = make_train_step(cfg, tx, scfg, luts=luts, mesh=mesh)
        step, state = shard_train_step(step, mesh, init_train_state(params, tx))
        step_args = ()

    batcher = VLABatcher(processor, batch_size=args.per_device_batch_size, seq_len=args.seq_len,
                         prompt_template=args.prompt_template)

    def batches():
        for batch in model_group_batches(mesh, batcher.batches(ds.frames())):
            batch.pop("actions", None)
            yield form_global_batch(mesh, batch)

    ckpt = CheckpointManager(os.path.join(args.output_dir, "checkpoints"),
                             save_interval_steps=args.save_steps, max_to_keep=3,
                             shards=getattr(step, "shards", None))
    if process_index() == 0:
        processor.save(args.output_dir)
    return dict(cfg=cfg, state=state, step=step, step_args=step_args, batches=batches(),
                ckpt=ckpt, processor=processor, dataset=ds, base_params=params, device=device)


def main(argv=None):
    from .trainer import TrainerConfig, train_loop

    args = build_argparser().parse_args(argv)
    parts = build_everything(args)
    config = TrainerConfig(output_dir=args.output_dir, max_steps=args.max_steps,
                           log_every=args.logging_steps, save_every=args.save_steps)
    state = train_loop(state=parts["state"], train_step=parts["step"], batches=parts["batches"],
                       config=config, checkpoint_manager=parts["ckpt"],
                       step_args=parts["step_args"])
    parts["ckpt"].close()  # lets go of its saves' host buffers
    return state


if __name__ == "__main__":
    main()
