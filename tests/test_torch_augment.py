"""The port's image augmentation: the NumPy path against the native (C++) one.

``augment_image(..., use_native=False)``, and the same call when the native
library is unavailable, apply the pre-drawn parameters of
``sample_augment_params`` in NumPy; the native path applies them in one C++
pass. Tolerance, measured on 20 seeds of noise and gradient frames of
(64, 48), (96, 96), (33, 71) and (224, 224): at most 1 uint8 step on any
pixel (the native reader is built with -ffast-math, which its loader
documents as within 1 LSB of strict math), on at most 1.5e-4 of the values;
the bound below leaves room to 1e-3.
"""
import numpy as np
import pytest

from spatialvla_tpu_torch.data import augment
from spatialvla_tpu_torch.data import native

MAX_STEP = 1  # uint8 steps
MAX_SHARE = 1e-3  # of the values that differ at all


def _frame(seed, H, W, smooth):
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    return np.stack([yy * 255 // H, xx * 255 // W, (yy + xx) * 127 // (H + W) + 60],
                    -1).astype(np.uint8)


@pytest.fixture(autouse=True)
def _needs_native():
    if not native.available():
        pytest.skip("the native reader did not build here (no g++ or libjpeg)")


@pytest.mark.parametrize("H,W", [(64, 48), (33, 71), (224, 224)])
@pytest.mark.parametrize("smooth", [False, True])
def test_numpy_path_matches_native(H, W, smooth):
    img = _frame(H * W, H, W, smooth)
    params = augment.sample_augment_params((H, W), np.random.default_rng(H + W))
    got = augment.augment_image(img, None, use_native=False, params=params)
    ref = augment.augment_image(img, None, use_native=True, params=params)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    step = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert step.max() <= MAX_STEP
    assert (step > 0).mean() <= MAX_SHARE


def test_fallback_when_native_returns_none(monkeypatch):
    """A None from the native path falls through to the NumPy path, which
    draws nothing more from the generator."""
    img = _frame(5, 96, 96, True)
    params = augment.sample_augment_params((96, 96), np.random.default_rng(7))
    want = augment.augment_image(img, None, use_native=False, params=params)
    monkeypatch.setattr(native, "augment_native", lambda *a, **k: None)
    rng = np.random.default_rng(1)
    state = rng.bit_generator.state
    got = augment.augment_image(img, rng, params=params)
    assert np.array_equal(got, want)
    assert rng.bit_generator.state == state


def test_numpy_path_draws_its_own_params():
    """Without params the NumPy path draws them from rng, as the native one."""
    img = _frame(9, 64, 64, False)
    a = augment.augment_image(img, np.random.default_rng(3), use_native=False)
    b = augment.augment_image(img, np.random.default_rng(3), use_native=True)
    assert a.shape == (64, 64, 3) and a.dtype == np.uint8
    assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= MAX_STEP
