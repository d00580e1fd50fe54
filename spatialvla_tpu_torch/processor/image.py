"""Image preprocessing without jax.

The JAX package's processor resizes with PIL and, where PIL is missing,
falls back to ``jax.image`` (spatialvla_tpu/processor/image.py:45-51). The
port must not load jax, so here: PIL when it is importable; otherwise an
image that already is (size, size, 3) uint8 maps exactly to u8 / 255 (what
PIL's resize to the same size returns); anything else raises. The port's
copy of processor.py takes its image step from here.
"""
from __future__ import annotations

import numpy as np


def resize_image_u8(image, size: int = 224) -> np.ndarray:
    """PIL image / (H, W, 3) array -> (size, size, 3) uint8."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        if not isinstance(image, Image.Image):
            image = Image.fromarray(np.asarray(image).astype(np.uint8))
        return np.asarray(image.convert("RGB").resize((size, size), Image.BICUBIC),
                          dtype=np.uint8)
    arr = np.asarray(image)
    if arr.dtype == np.uint8 and arr.shape == (size, size, 3):
        return arr
    raise ValueError(
        f"an image of shape {arr.shape} and dtype {arr.dtype} needs resizing to "
        f"({size}, {size}, 3) uint8, which needs PIL (pillow); without PIL, pass "
        "(size, size, 3) uint8 frames"
    )


def preprocess_image(image, size: int = 224) -> np.ndarray:
    """PIL image / (H, W, 3) array -> (size, size, 3) float32 in [0, 1]."""
    return resize_image_u8(image, size).astype(np.float32) / 255.0


def preprocess_images(images, size: int = 224) -> np.ndarray:
    """List of images -> (B, size, size, 3) float32 batch."""
    return np.stack([preprocess_image(im, size) for im in images])


def preprocess_images_u8(images, size: int = 224) -> np.ndarray:
    """List of images -> (B, size, size, 3) uint8 batch whose /255 is
    preprocess_images; never None (there is no off-grid fallback here)."""
    return np.stack([resize_image_u8(im, size) for im in images])
