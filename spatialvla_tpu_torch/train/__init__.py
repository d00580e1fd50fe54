"""Training for the port: the train step with flash attention, remat and
gradient accumulation, the LoRA step (``lora``), AdamW with optax's
semantics, the step loop with step-numbered checkpoints and resume
(``checkpoints.CheckpointManager``), and the pretraining and fine-tuning
CLIs, on one device or sharded over a mesh of processes
(spatialvla_tpu_torch/parallel). Imports no jax and no optax."""
from .metrics import action_metrics, build_decode_luts
from .optimizer import OptimizerConfig, make_optimizer, make_schedule, trainable_mask
from .train_step import (TrainStepConfig, init_lora_train_state, init_train_state, make_loss_fn,
                         make_lora_train_step, make_train_step, shard_lora_train_step,
                         shard_train_step)

__all__ = [
    "OptimizerConfig",
    "TrainStepConfig",
    "action_metrics",
    "build_decode_luts",
    "init_lora_train_state",
    "init_train_state",
    "make_loss_fn",
    "make_lora_train_step",
    "make_optimizer",
    "make_schedule",
    "make_train_step",
    "shard_lora_train_step",
    "shard_train_step",
    "trainable_mask",
]
