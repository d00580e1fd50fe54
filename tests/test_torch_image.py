"""The port's PIL-free image step against the JAX package's.

Without PIL the reference resizes with ``jax.image.resize(..., "bicubic")``
(spatialvla_tpu/processor/image.py:45-51); the port has a numpy twin of it
(spatialvla_tpu_torch/processor/image.py:bicubic_resize). PIL is blocked with
``sys.modules["PIL"] = None``, and frames are uint8 from a seeded numpy
generator.

Tolerance: 1e-4 on the [0, 1] scale. Both sides compute in float32; what
differs is that XLA compiles the weight matrix (the cubic polynomial and the
normalising division) with other roundings than numpy's eager float32 (up to
about 1e-5 of a weight), and sums the products in another order, so pixels
differ by up to about 1.1e-5 after the /255. A frame that already has the
model's size is not resampled on either side and matches u8 / 255 bit for bit.
"""
import sys

import numpy as np
import pytest

from spatialvla_tpu.processor import SpatialVLAProcessor as Base
from spatialvla_tpu.processor import image as ref_image
from spatialvla_tpu_torch.processor import SpatialVLAProcessor as Port
from spatialvla_tpu_torch.processor import image as port_image

TOL = 1e-4
SIZE = 224


@pytest.fixture
def no_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


def _frame(shape, seed=0):
    return (np.random.RandomState(seed).rand(*shape) * 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [
    (480, 640, 3),   # downsample, both axes
    (100, 150, 3),   # upsample, both axes
    (300, 224, 3),   # non-square: one axis down, one kept
    (224, 224, 3),   # already the model's size
])
def test_resize_matches_jax_bicubic(no_pil, shape):
    frame = _frame(shape)
    got = port_image.preprocess_image(frame, SIZE)
    ref = ref_image.preprocess_image(frame, SIZE)
    assert got.dtype == np.float32 and got.shape == (SIZE, SIZE, 3)
    assert np.abs(got - np.asarray(ref, np.float32)).max() <= TOL
    if shape == (SIZE, SIZE, 3):
        np.testing.assert_array_equal(got, frame.astype(np.float32) / 255.0)
        np.testing.assert_array_equal(got, ref)


def test_exact_u8_form_needs_pil(no_pil):
    frames = [_frame((SIZE, SIZE, 3)), _frame((100, 150, 3), seed=1)]
    assert port_image.resize_image_u8(frames[0], SIZE) is None
    assert port_image.preprocess_images_u8(frames, SIZE) is None
    assert ref_image.preprocess_images_u8(frames, SIZE) is None


@pytest.mark.parametrize("shapes", [[(480, 640, 3)], [(100, 150, 3), (224, 224, 3)]])
def test_processor_matches_base_processor_without_pil(no_pil, shapes):
    frames = [_frame(s, seed=i) for i, s in enumerate(shapes)]
    texts = ["pick up the cup", "move the red block left"][: len(frames)]
    kw = dict(image_token_id=1000, action_token_begin_idx=1024, image_seq_length=16,
              image_size=SIZE)
    a = Port(**kw)(frames, texts)
    b = Base(**kw)(frames, texts)
    assert sorted(a) == sorted(b) and "pixel_values_u8" not in a
    for k in b:
        if k == "pixel_values":
            assert a[k].shape == b[k].shape == (len(frames), SIZE, SIZE, 3)
            assert np.abs(a[k] - b[k]).max() <= TOL
        else:
            np.testing.assert_array_equal(a[k], b[k])


def test_model_size_frame_is_bit_identical_with_and_without_pil(monkeypatch):
    """A (224, 224, 3) uint8 frame gives the same pixel_values on the PIL
    route and the PIL-free one (the cubic weights at integer offsets are 1
    and 0), so serving results do not depend on PIL."""
    frame = _frame((SIZE, SIZE, 3), seed=3)
    proc = Port(image_token_id=1000, action_token_begin_idx=1024, image_seq_length=16,
                image_size=SIZE)
    with_pil = proc(frame, "open the drawer")
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    without = proc(frame, "open the drawer")
    np.testing.assert_array_equal(with_pil["pixel_values"], without["pixel_values"])
    np.testing.assert_array_equal(with_pil["pixel_values_u8"][0], frame)
