"""spatialvla_tpu_torch: the PyTorch / CUDA port of spatialvla_tpu for one
NVIDIA H100 (Hopper, sm_90a).

Layers:
    config, action, processor   the port's own copies of the JAX package's
                                jax-free modules; the processor's image step
                                is jax-free (processor/image.py)
    data, train                 the RLDS data layer (copied); the train steps
                                (full and LoRA), step checkpoints with resume,
                                the pretrain and fine-tuning CLIs
    eval                        the closed-loop eval driver (copied)
    utils.tree                  '/'-joined tree paths
    convert.bridge              numpy pytree <-> nested dict of tensors
    models                      SigLIP, ZoeDepth, Ego3D, Gemma2, the fusion model
    ops                         quantized matvec, decode-step and flash kernels
                                (csrc/*.cu)
    inference                   SpatialVLAPolicy

Importing this package never loads jax.
"""

__version__ = "0.1.0"

from . import action, config
from .config import (
    Ego3DConfig,
    Gemma2Config,
    SiglipVisionConfig,
    SpatialVLAConfig,
    ZoeDepthConfig,
    spatialvla_4b,
    spatialvla_tiny,
)

from . import processor
from .inference import SpatialVLAPolicy

__all__ = [
    "Ego3DConfig",
    "Gemma2Config",
    "SiglipVisionConfig",
    "SpatialVLAConfig",
    "SpatialVLAPolicy",
    "ZoeDepthConfig",
    "action",
    "config",
    "processor",
    "spatialvla_4b",
    "spatialvla_tiny",
]
