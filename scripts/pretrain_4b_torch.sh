#!/usr/bin/env bash
# Flagship pretrain recipe of the PyTorch port on NVIDIA GPUs: the settings
# of scripts/pretrain_4b.sh (reference: scripts/spatialvla_4b_pretrain/
# torchrun_pretrain.sh — global batch 2048, lr 2e-5 linear w/ 0.005 warmup,
# bf16, grad ckpt, seq 2048 budget, shuffle buffer 65536, ZeRO-1), run by
# `python -m spatialvla_tpu_torch.train.pretrain`.
# GPU mapping: one process a card (NPROC of them, through torchrun), the
# fp32 masters and AdamW moments fsdp-sharded over all of them; gradient
# accumulation chosen so per_device * NPROC * accum == 2048.
#
# DEBUG=true is a one-card smoke run (the reference's DEBUG profile: buffer
# 2, tiny batch) over the committed RLDS fixture tests/fixtures_rlds (set
# DATA_ROOT to read other data): 20 steps and one step checkpoint, at the
# end (a full-width state is about 41 GB; with the export, 57 GB of disk).
#
# Several hosts: run torchrun with its rendezvous flags on every host, or
# pass --coordinator_address host:port --num_processes N --process_id i to
# each process (see tests/test_torch_distributed.py).
set -euo pipefail

DEBUG=${DEBUG:-false}
OUTPUT=${OUTPUT:-out/pretrain_4b_torch}
NPROC=${NPROC:-1}

if [ "$DEBUG" = "true" ]; then
  DATA_ROOT=${DATA_ROOT:-tests/fixtures_rlds}
  BATCH=2; ACCUM=1; BUFFER=2; STEPS=20; SAVE=20; LOG=1; MIXTURE=${MIXTURE:-bridge}
else
  DATA_ROOT=${DATA_ROOT:-/data/oxe}
  BATCH=8; ACCUM=${ACCUM:-8}; BUFFER=65536; STEPS=200000; SAVE=20000; LOG=500
  MIXTURE=${MIXTURE:-oxe_spatial_vla_plus}
fi

if [ "$NPROC" -gt 1 ]; then
  LAUNCH=(torchrun --nproc_per_node "$NPROC" -m spatialvla_tpu_torch.train.pretrain)
else
  LAUNCH=(python -m spatialvla_tpu_torch.train.pretrain)
fi

"${LAUNCH[@]}" \
  --data_root_dir "$DATA_ROOT" \
  --mixture "$MIXTURE" \
  --output_dir "$OUTPUT" \
  --model_preset spatialvla_4b \
  --per_device_batch_size "$BATCH" \
  --grad_accum "$ACCUM" \
  --learning_rate 2e-5 \
  --warmup_ratio 0.005 \
  --max_steps "$STEPS" \
  --shuffle_buffer_size "$BUFFER" \
  --action_forward_steps 3 \
  --seq_len 320 \
  --mesh_fsdp -1 \
  --attn_backend flash \
  --save_steps "$SAVE" \
  --logging_steps "$LOG" \
  "$@"
