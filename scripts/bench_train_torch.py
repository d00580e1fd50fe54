#!/usr/bin/env python3
"""Training-throughput benchmark of the port: one JSON line for the
train-step envelope, as scripts/bench_train.py prints it for the JAX
package. Imports nothing of jax.

Defaults: flagship 4B (SigLIP + ZoeDepth + Gemma2), batch 2 x seq 2048 with
~298 real tokens a row (the reference's pretrain sparsity: samples pad to
seq_len 2048), remat, the port's flash attention forward and backward,
chunked CE, LoRA-r32 trainables (``--full``: full-parameter AdamW on fp32
masters).

Usage (on the card):
    python scripts/bench_train_torch.py [--full] [--seq 320]
    # a tiny full-parameter smoke run on the CPU (also run by the tests):
    python scripts/bench_train_torch.py --preset spatialvla_tiny --full --batch 2 --real_tokens 40 \\
        --seq 64 --attn xla --reps 2 --sets 1 --device cpu

Each set is ``reps`` steps timed by ``utils.profiling.timeit`` (the mean
over the set, one synchronize at its end); the metric is the least mean
over the sets.
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_batch(cfg, B, seq, real_tokens, rng):
    """A numpy batch as bench_train.py makes it: image tokens, text, 12
    action tokens, right padding; frames and the bridge intrinsics."""
    N = cfg.num_image_tokens
    n_action = 12
    n_text = max(real_tokens - N - n_action, 1)
    real = N + n_text + n_action
    if real > seq:
        raise ValueError(f"{real} real tokens exceed seq {seq}")
    ids = np.concatenate([
        np.full((B, N), cfg.image_token_index),
        rng.randint(10, 1000, (B, n_text)),
        rng.randint(cfg.action_token_begin_idx,
                    cfg.action_token_begin_idx + cfg.spatial_token_num, (B, n_action)),
        np.zeros((B, seq - real), np.int64),  # right pad
    ], axis=1).astype(np.int32)
    attn = np.zeros((B, seq), np.int32)
    attn[:, :real] = 1
    ttype = np.zeros((B, seq), np.int32)
    ttype[:, N + n_text:real] = 1
    labels = np.where((ttype == 1) & (attn == 1), ids, -100)
    s = cfg.vision.image_size
    K = np.asarray([[623.588 * s / 640, 0, 319.5 * s / 640],
                    [0, 623.588 * s / 480, 239.5 * s / 480],
                    [0, 0, 1.0]], np.float32)
    return {"input_ids": ids, "attention_mask": attn, "token_type_ids": ttype, "labels": labels,
            "pixel_values": rng.rand(B, s, s, 3).astype(np.float32),
            "intrinsic": np.broadcast_to(K, (B, 3, 3)).copy()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="spatialvla_4b",
                    choices=["spatialvla_4b", "spatialvla_tiny"])
    ap.add_argument("--full", action="store_true",
                    help="full-parameter AdamW instead of the LoRA envelope")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--real_tokens", type=int, default=298,
                    help="non-pad tokens a row (reference pretrain sparsity: ~278-298 of 2048)")
    ap.add_argument("--attn", default="flash", choices=["xla", "flash"])
    ap.add_argument("--zoe", action="store_true",
                    help="use_vision_zoe on the tiny preset (the flagship always has it)")
    ap.add_argument("--lora_rank", type=int, default=32)
    ap.add_argument("--loss_chunk", type=int, default=256)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sets", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; without a card this raises, and the "
                         "CPU is used only with --device cpu)")
    args = ap.parse_args(argv)

    import torch

    from spatialvla_tpu_torch.config import spatialvla_4b, spatialvla_tiny
    from spatialvla_tpu_torch.convert.params import target_device
    from spatialvla_tpu_torch.models import spatialvla
    from spatialvla_tpu_torch.train import (OptimizerConfig, TrainStepConfig, init_lora_train_state,
                                            init_train_state, make_lora_train_step,
                                            make_optimizer, make_train_step, trainable_mask)
    from spatialvla_tpu_torch.train.lora import TARGET_PRESETS
    from spatialvla_tpu_torch.utils.profiling import timeit

    device = target_device(args.device)
    flagship = args.preset == "spatialvla_4b"
    cfg = spatialvla_4b() if flagship else spatialvla_tiny(use_vision_zoe=args.zoe)
    lora = not args.full
    params = spatialvla.init_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                                    device=device,
                                    dtype=torch.bfloat16 if lora else torch.float32)
    ocfg = OptimizerConfig(learning_rate=1e-4, total_steps=100, schedule="constant")
    scfg = TrainStepConfig(use_remat=True, compute_dtype=torch.bfloat16, attn_backend=args.attn,
                           loss_chunk_size=args.loss_chunk)
    if lora:
        tx = make_optimizer(ocfg, None, None)
        state = init_lora_train_state(torch.Generator(device=device).manual_seed(1), params, tx,
                                      target_patterns=TARGET_PRESETS["linear"],
                                      rank=args.lora_rank)
        step = make_lora_train_step(cfg, tx, scfg, rank=args.lora_rank)
        step_args = (params,)
    else:
        tx = make_optimizer(ocfg, params, trainable_mask(params, freeze_llm_embed=True))
        state = init_train_state(params, tx)
        step = make_train_step(cfg, tx, scfg)
        step_args = ()
    batch = make_batch(cfg, args.batch, args.seq, args.real_tokens, np.random.RandomState(0))

    def one_step():
        nonlocal state
        state, metrics = step(state, *step_args, batch)
        return metrics

    metrics = None
    for _ in range(2):  # warm-up
        metrics = one_step()
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"the warm-up steps' loss is {loss}")
    best = min(timeit(one_step, iters=args.reps, warmup=0) for _ in range(args.sets))
    result = {
        "metric": "%s %s train step (B%d x T%d, %s attn, remat, chunked CE)" % (
            args.preset, "LoRA-r%d" % args.lora_rank if lora else "full-AdamW",
            args.batch, args.seq, args.attn),
        "ms_per_step": round(best * 1e3, 1),
        "samples_per_sec": round(args.batch / best, 2),
        "loss": round(loss, 4),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
