"""Image preprocessing without jax.

The same rules as the JAX package's processor (spatialvla_tpu/processor/
image.py): PIL's bicubic resize to the model's size when PIL is importable,
with its exact uint8 form (``pixel_values == u8 / 255`` bit for bit);
without PIL, ``resize_image_u8`` and ``preprocess_images_u8`` return None and
frames go through the bicubic resize that the reference takes from
``jax.image.resize(..., "bicubic")``. The port must not load jax, so that
resize is ``bicubic_resize`` here, a numpy twin of jax's
``_scale_and_translate`` (jax/_src/image/scale.py). The port's copy of
processor.py takes its image step from here.
"""
from __future__ import annotations

import numpy as np


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 (jax's _fill_keys_cubic_kernel)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _weight_mat(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 resampling weights, as jax's
    compute_weight_mat with antialias=True: sample points (i + 0.5) / scale
    - 0.5, the kernel widened by max(1 / scale, 1) when downsampling, weights
    normalised per output pixel, samples outside the input zeroed."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def bicubic_resize(arr: np.ndarray, shape) -> np.ndarray:
    """float32 ``jax.image.resize(arr, shape, "bicubic")``: each axis whose
    size changes is resampled with its weight matrix, in float32; an axis
    that keeps its size is left as it is (the kernel is interpolating)."""
    out = np.asarray(arr, dtype=np.float32)
    for axis, n in enumerate(shape):
        if out.shape[axis] != n:
            w = _weight_mat(out.shape[axis], n)
            out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])), -1, axis)
    return np.ascontiguousarray(out, dtype=np.float32)


def resize_image_u8(image, size: int = 224):
    """PIL bicubic resize to (size, size, 3) uint8, or None without PIL
    (the PIL-free resize lands off the u8 grid)."""
    try:
        from PIL import Image
    except ImportError:
        return None
    if not isinstance(image, Image.Image):
        image = Image.fromarray(np.asarray(image).astype(np.uint8))
    return np.asarray(image.convert("RGB").resize((size, size), Image.BICUBIC), dtype=np.uint8)


def preprocess_image(image, size: int = 224) -> np.ndarray:
    """PIL image / (H, W, 3) array -> (size, size, 3) float32 in [0, 1]."""
    u8 = resize_image_u8(image, size)
    if u8 is not None:
        return u8.astype(np.float32) / 255.0
    arr = bicubic_resize(np.asarray(image, dtype=np.float32), (size, size, 3))
    return np.clip(arr, 0, 255) / np.float32(255.0)


def preprocess_images(images, size: int = 224) -> np.ndarray:
    """List of images -> (B, size, size, 3) float32 batch."""
    return np.stack([preprocess_image(im, size) for im in images])


def preprocess_images_u8(images, size: int = 224):
    """List of images -> (B, size, size, 3) uint8 batch whose /255 equals
    preprocess_images bitwise, or None on the PIL-free path."""
    out = []
    for im in images:
        u8 = resize_image_u8(im, size)
        if u8 is None:
            return None
        out.append(u8)
    return np.stack(out)
