#!/usr/bin/env bash
# LoRA fine-tune recipe of the PyTorch port: the settings of
# scripts/finetune_lora.sh (reference: scripts/spatialvla_4b_finetune/
# finetune_lora.sh — r=32 alpha=32, lr 5e-4, uiuc_d3field default mixture),
# run by `python -m spatialvla_tpu_torch.train.finetune` on one card.
# PRETRAINED is a directory of the port's format (what
# scripts/pretrain_4b_torch.sh or scripts/convert_checkpoint_torch.py write).
#
# DEBUG=true is a one-card smoke run over the committed RLDS fixture
# tests/fixtures_rlds (bridge; 20 steps, a checkpoint every 10).
set -euo pipefail

DEBUG=${DEBUG:-false}
PRETRAINED=${PRETRAINED:-out/pretrain_4b_torch}
OUTPUT=${OUTPUT:-out/finetune_lora_torch}

if [ "$DEBUG" = "true" ]; then
  DATA_ROOT=${DATA_ROOT:-tests/fixtures_rlds}
  MIXTURE=${MIXTURE:-bridge}; STEPS=20; SAVE=10; BUFFER=2; LOG=1
else
  DATA_ROOT=${DATA_ROOT:-/data/oxe}
  MIXTURE=${MIXTURE:-uiuc_d3field}; STEPS=10000; SAVE=10000; BUFFER=2048; LOG=100
fi

python -m spatialvla_tpu_torch.train.finetune \
  --pretrained_dir "$PRETRAINED" \
  --data_root_dir "$DATA_ROOT" \
  --mixture "$MIXTURE" \
  --output_dir "$OUTPUT" \
  --use_lora --lora_rank 32 --lora_alpha 32 --lora_target linear \
  --learning_rate 5e-4 \
  --max_steps "$STEPS" \
  --save_steps "$SAVE" \
  --shuffle_buffer_size "$BUFFER" \
  --logging_steps "$LOG" \
  --attn_backend flash \
  "$@"
