"""The two serving forms of bench.py's headline and of its reduced-depth
variant, held to the JAX package on the CPU with the same numpy-seeded
weights (spatialvla_tiny(use_vision_zoe=True), lm_head scaled by 50 so the
greedy margins are not flat):

* an int8 LM with the vision front kept unquantized (quantize(bits=8,
  vision_bits=None): bench.py's VISION_BITS = 0);
* a request through ZoeDepth at a reduced internal resolution
  (depth_image_size=32 on the tiny config, as tests/test_serving_front.py
  runs it in JAX): the int8 front with the relative-position table
  interpolated per forward, and the serving tree with the bias
  precomputed at that size (quantize(bits=8, depth_image_size=32)).

In fp32 the image features agree within 1e-5 absolute and the greedy ids
are identical; through SpatialVLAPolicy in bf16 the ids follow JAX's under
the margin rule (first token equal, then equal up to the first step whose
JAX margin is below 0.5)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvla_tpu.config import spatialvla_tiny
from spatialvla_tpu.inference import SpatialVLAPolicy as JaxPolicy
from spatialvla_tpu.models import spatialvla as jsv
from spatialvla_tpu.models.zoe import precompute_rel_bias as j_rel_bias
from spatialvla_tpu.ops.quant import quantize_lm_params as j_qlm
from spatialvla_tpu.ops.quant import quantize_vision_params as j_qvis
from spatialvla_tpu.processor import SpatialVLAProcessor as JaxProcessor
from spatialvla_tpu_torch import SpatialVLAPolicy
from spatialvla_tpu_torch.convert import from_numpy_tree
from spatialvla_tpu_torch.inference import default_processor
from spatialvla_tpu_torch.models import spatialvla as tsv
from spatialvla_tpu_torch.models.zoe import precompute_rel_bias as t_rel_bias
from spatialvla_tpu_torch.ops.quant import quantize_lm_params as t_qlm
from spatialvla_tpu_torch.ops.quant import quantize_vision_params as t_qvis

torch.set_num_threads(2)

CFG = spatialvla_tiny(use_vision_zoe=True)
DEPTH = 32  # the tiny ZoeDepth runs at 64: half its resolution
FEATURES_ATOL = 1e-5
MARGIN_BOUND = 0.5


@pytest.fixture(scope="module")
def params():
    p = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: jsv.init_params(key, CFG))(jax.random.PRNGKey(0)))
    p["lm"]["lm_head"] = p["lm"]["lm_head"] * 50.0
    return p


def _inputs(B=2, seed=0):
    rng = np.random.RandomState(seed)
    N = CFG.num_image_tokens
    ids = np.concatenate([np.full((B, N), CFG.image_token_index),
                          rng.randint(3, 250, (B, 5))], axis=1).astype(np.int32)
    size = CFG.vision.image_size
    px = rng.rand(B, size, size, 3).astype(np.float32)
    K = np.array([[60.0, 0, 28], [0, 55.0, 27], [0, 0, 1]], np.float32)[None].repeat(B, 0)
    return ids, px, K


def _trees(params, form):
    """(JAX tree, port tree) of a serving form, fp32 weights."""
    jq, tq = dict(params), from_numpy_tree(params)
    if form == "depth-table":  # tests/test_serving_front.py: the int8 front, the table kept
        return j_qvis(jq, bits=8), t_qvis(tq, bits=8)
    jq["lm"], tq["lm"] = j_qlm(params["lm"], bits=8), t_qlm(tq["lm"], bits=8)
    depth = DEPTH if form == "depth-precomputed" else None
    jq["zoe"] = j_rel_bias(jq["zoe"], CFG.zoe, image_size=depth)
    tq["zoe"] = t_rel_bias(tq["zoe"], CFG.zoe, image_size=depth)
    if form == "depth-precomputed":
        jq, tq = j_qvis(jq, bits=8), t_qvis(tq, bits=8)
    return jq, tq


@pytest.mark.parametrize("form", ["bf16-front", "depth-table", "depth-precomputed"])
def test_fp32_features_and_ids_equal_jax(params, form):
    jq, tq = _trees(params, form)
    depth = None if form == "bf16-front" else DEPTH
    ids, px, K = _inputs(seed=3)
    feats_j = jax.jit(lambda p, x, k: jsv.get_image_features(
        p, CFG, x, k, depth_image_size=depth))(jq, jnp.asarray(px), jnp.asarray(K))
    with torch.inference_mode():
        feats_t = tsv.get_image_features(tq, CFG, torch.from_numpy(px), torch.from_numpy(K),
                                         depth_image_size=depth)
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), atol=FEATURES_ATOL, rtol=0)
    ids_j = jax.jit(lambda p, i, x, k: jsv.predict_action(
        p, CFG, i, pixel_values=x, intrinsic=k, compute_dtype=jnp.float32,
        depth_image_size=depth))(jq, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(K))
    with torch.inference_mode():
        ids_t = tsv.predict_action(tq, CFG, torch.from_numpy(ids).long(),
                                   pixel_values=torch.from_numpy(px),
                                   intrinsic=torch.from_numpy(K), compute_dtype=torch.float32,
                                   depth_image_size=depth)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))


def _policies(params, **qkw):
    """The JAX and the port's policy on the same bf16 weights after
    quantize(**qkw)."""
    j_proc = JaxProcessor(image_token_id=CFG.image_token_index,
                          action_token_begin_idx=CFG.action_token_begin_idx,
                          image_seq_length=CFG.num_image_tokens,
                          image_size=CFG.vision.image_size,
                          statistics=default_processor(CFG).statistics)
    jp = JaxPolicy(jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16)
        if np.issubdtype(a.dtype, np.floating) else jnp.asarray(a), params),
        CFG, j_proc, compute_dtype=jnp.bfloat16).quantize(**qkw)
    tp = SpatialVLAPolicy(from_numpy_tree(params, dtype=torch.bfloat16), CFG,
                          default_processor(CFG), device="cpu").quantize(**qkw)
    return jp, tp


@pytest.mark.parametrize("qkw", [dict(bits=8, vision_bits=None),
                                 dict(bits=8, depth_image_size=DEPTH)],
                         ids=["int8-bf16front", "int8-depth"])
def test_policy_forms_follow_jax_under_the_margin_rule(params, qkw):
    jp, tp = _policies(params, **qkw)
    assert tp.quant_desc == jp.quant_desc and tp.depth_image_size == jp.depth_image_size
    # the front stays unquantized with vision_bits=None, and is int8 otherwise
    q_front = isinstance(tp.params["vision"]["layers"]["attn"]["q"]["w"], dict)
    assert q_front == (qkw.get("vision_bits", 8) is not None)
    rng = np.random.RandomState(5)
    size = CFG.vision.image_size
    for text in ("pick up the cup", "open the drawer"):
        img = (rng.rand(size, size, 3) * 255).astype(np.uint8)
        a = tp.predict(img, text, return_margins=True)
        b = jp.predict(img, text, return_margins=True)
        assert a["actions"].shape == (4, 7) and np.isfinite(a["actions"]).all()
        ids, ref, margins = a["action_ids"], b["action_ids"], np.asarray(b["margins"], np.float32)
        assert ids[0] == ref[0], (ids, ref)
        for t in range(1, len(ref)):
            if margins[t] < MARGIN_BOUND:
                break  # a near tie: this token and the rest may differ
            assert ids[t] == ref[t], (ids, ref, margins)
