"""Training for the port: the train step with flash attention, remat and
gradient accumulation, AdamW with optax's semantics, the step loop and the
pretraining CLI. Imports no jax and no optax."""
from .metrics import action_metrics, build_decode_luts
from .optimizer import OptimizerConfig, make_optimizer, make_schedule, trainable_mask
from .train_step import TrainStepConfig, init_train_state, make_loss_fn, make_train_step

__all__ = [
    "OptimizerConfig",
    "TrainStepConfig",
    "action_metrics",
    "build_decode_luts",
    "init_train_state",
    "make_loss_fn",
    "make_optimizer",
    "make_schedule",
    "make_train_step",
    "trainable_mask",
]
