"""Image augmentations, NumPy (host CPU), matching the reference's fixed
augmentation recipe (data/dataset.py:84-101): random_resized_crop with
scale [0.9, 0.9] / ratio [1, 1], brightness 0.2, contrast [0.8, 1.2],
saturation [0.8, 1.2], hue 0.05, applied in that order, with a shared seed
across camera views of a frame (obs_transforms.py:17-44; padding images are
skipped upstream).

Throughput notes (>2k frames/sec/host target): resize is two BLAS matmuls
(separable bilinear), saturation is a grayscale blend (the torchvision
formulation — equivalent in effect to TF's HSV multiply for photometric
jitter), hue is a fully-arithmetic HSV shift (no per-pixel branching).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

DEFAULT_AUGMENT_KWARGS = {
    "random_resized_crop": {"scale": [0.9, 0.9], "ratio": [1.0, 1.0]},
    "random_brightness": [0.2],
    "random_contrast": [0.8, 1.2],
    "random_saturation": [0.8, 1.2],
    "random_hue": [0.05],
    "augment_order": [
        "random_resized_crop",
        "random_brightness",
        "random_contrast",
        "random_saturation",
        "random_hue",
    ],
}

_LIN_CACHE: Dict = {}


def _linear_matrix(out_size: int, in_size: int) -> np.ndarray:
    key = (out_size, in_size)
    m = _LIN_CACHE.get(key)
    if m is not None:
        return m
    if out_size == 1:
        src = np.zeros((1,))
    else:
        src = np.clip(
            (np.arange(out_size) + 0.5) * in_size / out_size - 0.5, 0, in_size - 1
        )
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, in_size - 1)
    w = (src - lo).astype(np.float32)
    m = np.zeros((out_size, in_size), dtype=np.float32)
    m[np.arange(out_size), lo] += 1 - w
    m[np.arange(out_size), hi] += w
    if len(_LIN_CACHE) < 64:
        _LIN_CACHE[key] = m
    return m


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Separable bilinear resize as two BLAS matmuls; (H, W, C) float32."""
    H, W = img.shape[:2]
    mh = _linear_matrix(out_h, H)
    mw = _linear_matrix(out_w, W)
    x = img.astype(np.float32).reshape(H, -1)
    x = mh @ x  # (out_h, W*C)
    x = x.reshape(out_h, W, -1).transpose(0, 2, 1)  # (out_h, C, W)
    x = x @ mw.T  # (out_h, C, out_w)
    return x.transpose(0, 2, 1)


def random_resized_crop(img, rng, scale=(0.9, 0.9), ratio=(1.0, 1.0)):
    H, W = img.shape[:2]
    area = H * W
    s = rng.uniform(scale[0], scale[1])
    r = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
    ch = int(round(np.sqrt(area * s / r)))
    cw = int(round(np.sqrt(area * s * r)))
    ch, cw = min(ch, H), min(cw, W)
    y = rng.integers(0, H - ch + 1)
    x = rng.integers(0, W - cw + 1)
    crop = img[y : y + ch, x : x + cw]
    return _resize_bilinear(crop, H, W)


def random_brightness(img, rng, max_delta=0.2):
    delta = rng.uniform(-max_delta, max_delta) * 255.0
    return img + np.float32(delta)


def random_contrast(img, rng, lo=0.8, hi=1.2):
    f = np.float32(rng.uniform(lo, hi))
    mean = img.mean(axis=(0, 1), keepdims=True)
    return (img - mean) * f + mean


def random_saturation(img, rng, lo=0.8, hi=1.2):
    f = np.float32(rng.uniform(lo, hi))
    gray = (
        0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    )[..., None]
    return gray + (img - gray) * f


def _rgb_to_hsv(img01: np.ndarray):
    mx = img01.max(-1)
    mn = img01.min(-1)
    diff = mx - mn
    safe = np.where(diff > 0, diff, 1.0)
    r, g, b = img01[..., 0], img01[..., 1], img01[..., 2]
    # branch-free hue: pick the sector arithmetic by max channel
    h = np.where(
        mx == r, (g - b) / safe % 6.0,
        np.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0),
    )
    h = np.where(diff > 0, h / 6.0, 0.0)
    s = np.where(mx > 0, diff / np.where(mx > 0, mx, 1.0), 0.0)
    return h, s, mx


def _hsv_to_rgb(h, s, v):
    """Arithmetic HSV->RGB (no gathers): f(n) = v - v s max(0, min(k,4-k,1)),
    k = (n + 6h) mod 6."""
    h6 = h * 6.0

    def chan(n):
        k = (n + h6) % 6.0
        return v - v * s * np.clip(np.minimum(k, 4.0 - k), 0.0, 1.0)

    return np.stack([chan(5.0), chan(3.0), chan(1.0)], axis=-1)


def random_hue(img, rng, max_delta=0.05):
    delta = rng.uniform(-max_delta, max_delta)
    img01 = np.clip(img, 0, 255) * np.float32(1 / 255.0)
    h, s, v = _rgb_to_hsv(img01)
    h = (h + np.float32(delta)) % 1.0
    return _hsv_to_rgb(h, s, v) * np.float32(255.0)


def sample_augment_params(img_hw, rng, kwargs: Optional[Dict] = None) -> Dict:
    """Draw the per-frame augmentation parameters (shared across camera
    views, obs_transforms.py:17-44)."""
    kwargs = kwargs or DEFAULT_AUGMENT_KWARGS
    H, W = img_hw
    out: Dict = {}
    rrc = kwargs.get("random_resized_crop")
    if rrc:
        s = rng.uniform(*rrc.get("scale", (0.9, 0.9)))
        ratio = rrc.get("ratio", (1.0, 1.0))
        r = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        ch = min(int(round(np.sqrt(H * W * s / r))), H)
        cw = min(int(round(np.sqrt(H * W * s * r))), W)
        out["crop"] = (int(rng.integers(0, H - ch + 1)),
                       int(rng.integers(0, W - cw + 1)), ch, cw)
    else:
        out["crop"] = (0, 0, H, W)
    b = kwargs.get("random_brightness")
    out["b_delta"] = float(rng.uniform(-b[0], b[0]) * 255.0) if b else 0.0
    c = kwargs.get("random_contrast")
    out["c_factor"] = float(rng.uniform(*c)) if c else 1.0
    sat = kwargs.get("random_saturation")
    out["s_factor"] = float(rng.uniform(*sat)) if sat else 1.0
    h = kwargs.get("random_hue")
    out["h_delta"] = float(rng.uniform(-h[0], h[0])) if h else 0.0
    return out


def augment_image(
    img: np.ndarray,
    rng: np.random.Generator,
    kwargs: Optional[Dict] = None,
    *,
    use_native: bool = True,
    params: Optional[Dict] = None,  # precomputed sample_augment_params draw
) -> np.ndarray:
    """uint8 (H, W, 3) -> uint8 (H, W, 3) with the configured augmentations."""
    kwargs = kwargs or DEFAULT_AUGMENT_KWARGS
    p = params or sample_augment_params(img.shape[:2], rng, kwargs)
    if use_native:
        from . import native

        out = native.augment_native(
            img, p["crop"], p["b_delta"], p["c_factor"], p["s_factor"], p["h_delta"]
        )
        if out is not None:
            return out
    # python fallback applies the SAME pre-drawn params as the native path
    # (sample_augment_params draws in the default augment_order, matching
    # the per-op rng consumption of the previous draw-inside-each-op form)
    H, W = img.shape[:2]
    out = img.astype(np.float32)
    for op in kwargs.get("augment_order", []):
        if op == "random_resized_crop" and "random_resized_crop" in kwargs:
            cy, cx, ch, cw = p["crop"]
            out = _resize_bilinear(
                np.clip(out, 0, 255)[cy : cy + ch, cx : cx + cw], H, W
            )
        elif op == "random_brightness" and "random_brightness" in kwargs:
            out = out + np.float32(p["b_delta"])
        elif op == "random_contrast" and "random_contrast" in kwargs:
            mean = out.mean(axis=(0, 1), keepdims=True)
            out = (out - mean) * np.float32(p["c_factor"]) + mean
        elif op == "random_saturation" and "random_saturation" in kwargs:
            gray = (
                0.299 * out[..., 0] + 0.587 * out[..., 1] + 0.114 * out[..., 2]
            )[..., None]
            out = gray + (out - gray) * np.float32(p["s_factor"])
        elif op == "random_hue" and "random_hue" in kwargs:
            img01 = np.clip(out, 0, 255) * np.float32(1 / 255.0)
            h, s, v = _rgb_to_hsv(img01)
            h = (h + np.float32(p["h_delta"])) % 1.0
            out = _hsv_to_rgb(h, s, v) * np.float32(255.0)
    return np.clip(out, 0, 255).astype(np.uint8)
