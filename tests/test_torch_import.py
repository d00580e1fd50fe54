"""The port never loads jax or optax, and its image step needs no PIL for
frames that already have the model's size.

A fresh interpreter (this test process has jax loaded) imports every module
of spatialvla_tpu_torch with PIL blocked, runs a tiny predict, and reports
which jax modules are loaded."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, pkgutil, importlib, sys
sys.modules["PIL"] = None  # the card's machine has no PIL
import numpy as np
import spatialvla_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(spatialvla_tpu_torch.__path__, "spatialvla_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import torch
torch.set_num_threads(2)
from spatialvla_tpu_torch import SpatialVLAPolicy, spatialvla_tiny
cfg = spatialvla_tiny(use_vision_zoe=True)
policy = SpatialVLAPolicy.init_random(cfg, "cpu", seed=0).quantize(bits=8)
size = cfg.vision.image_size
frame = (np.random.RandomState(0).rand(size, size, 3) * 255).astype(np.uint8)
out = policy.predict(frame, "pick up the cup")
try:
    policy.processor(frame[:-1], "resized frames need PIL")
    needs_pil = None
except ValueError as e:
    needs_pil = str(e)
print(json.dumps({
    "modules": mods,
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "optax": sorted(m for m in sys.modules if m == "optax" or m.startswith("optax.")),
    "actions_shape": list(np.asarray(out["actions"]).shape),
    "finite": bool(np.isfinite(out["actions"]).all()),
    "ids": np.asarray(out["action_ids"]).tolist(),
    "needs_pil": needs_pil,
}))
"""


@pytest.fixture(scope="module")
def child():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax(child):
    for m in ("ops.decode_step", "ops.flash_attention", "models.zoe", "train.train_step",
              "train.optimizer", "train.trainer", "train.pretrain"):
        assert f"spatialvla_tpu_torch.{m}" in child["modules"]
    assert child["jax"] == []
    assert child["optax"] == []


def test_tiny_predict_without_pil(child):
    from spatialvla_tpu.config import spatialvla_tiny

    cfg = spatialvla_tiny(use_vision_zoe=True)
    assert child["actions_shape"] == [4, 7] and child["finite"]
    ids = np.asarray(child["ids"])
    begin = cfg.action_token_begin_idx
    assert ((ids >= begin) & (ids < begin + cfg.spatial_token_num)).all()
    assert child["needs_pil"] is not None and "PIL" in child["needs_pil"]


@pytest.mark.parametrize("texts", [["pick up the cup"], ["a", "move the red block left"]])
def test_processor_matches_base_processor(texts):
    """With PIL present the port's processor gives the base processor's
    arrays exactly (ids, masks, token types, intrinsics, pixels)."""
    from spatialvla_tpu.processor import SpatialVLAProcessor as Base
    from spatialvla_tpu_torch.processor import SpatialVLAProcessor as Port

    rng = np.random.RandomState(0)
    images = [(rng.rand(40, 52, 3) * 255).astype(np.uint8) for _ in texts]
    kw = dict(image_token_id=1000, action_token_begin_idx=1024, image_seq_length=16,
              image_size=56)
    a = Port(**kw)(images, texts, suffix_actions=np.zeros((4, 7)))
    b = Base(**kw)(images, texts, suffix_actions=np.zeros((4, 7)))
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
