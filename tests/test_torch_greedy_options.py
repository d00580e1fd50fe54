"""generate_greedy's options against the JAX package on the CPU, with the
same seeded weights and inputs, on spatialvla_tiny(use_vision_zoe=True):

* full-vocabulary greedy (token_range=None) and predict_action's
  restrict_to_action_tokens=False: ids identical in fp32 through the unfused
  loop (the softcapped logits); on the int8 tree in bf16 through the fused
  loop (the port's forced on the CPU, JAX's Pallas step in interpret mode),
  under the margin rule, and the port's fused loop on its static buffers
  equal to its eager loop;
* cache_dtype=float32: ids identical; the fused loop refuses it;
* a given depth map in place of ZoeDepth's: image features allclose and ids
  identical;
* the unfused quantized tree (quantize_lm_params(fuse=False)) takes the
  unfused loop: JAX's ids on JAX's tree (test_torch_quant.py holds the trees
  bit for bit)."""
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvla_tpu.config import spatialvla_tiny
from spatialvla_tpu.models import spatialvla as jsv
from spatialvla_tpu.models.zoe import precompute_rel_bias as j_precompute_rel_bias
from spatialvla_tpu.ops import decode_step as j_decode_step
from spatialvla_tpu.ops.quant import quantize_lm_params as j_qlm
from spatialvla_tpu_torch.convert import from_numpy_tree
from spatialvla_tpu_torch.models import spatialvla as tsv
from spatialvla_tpu_torch.models.zoe import precompute_rel_bias as t_precompute_rel_bias
from spatialvla_tpu_torch.ops.quant import quantize_lm_params as t_qlm
from tests.test_torch_spatialvla import assert_margin_rule

torch.set_num_threads(2)

CFG = spatialvla_tiny(use_vision_zoe=True)
CFG_WIDE = dataclasses.replace(CFG, text=dataclasses.replace(CFG.text, sliding_window=512))


@pytest.fixture(scope="module")
def params():
    p = jax.tree_util.tree_map(
        np.asarray, jax.jit(jsv.init_params, static_argnums=1)(jax.random.PRNGKey(2), CFG))
    p["lm"]["lm_head"] = p["lm"]["lm_head"] * 50.0  # logits not flat: ids mean something
    return p


def _inputs(B, seed):
    rng = np.random.RandomState(seed)
    N = CFG.num_image_tokens
    ids = np.concatenate([np.full((B, N), CFG.image_token_index),
                          rng.randint(3, 250, (B, 5))], axis=1).astype(np.int32)
    size = CFG.vision.image_size
    px = rng.rand(B, size, size, 3).astype(np.float32)
    K = np.array([[60.0, 0, 28], [0, 55.0, 27], [0, 0, 1]], np.float32)[None].repeat(B, 0)
    return ids, px, K


def _jax(fn, p, cfg, ids, px, K, **kw):
    return fn(p, cfg, jnp.asarray(ids), pixel_values=jnp.asarray(px), intrinsic=jnp.asarray(K),
              return_margins=True, **kw)


def _port(fn, p, cfg, ids, px, K, **kw):
    with torch.inference_mode():
        return fn(p, cfg, torch.from_numpy(ids).long(), pixel_values=torch.from_numpy(px),
                  intrinsic=torch.from_numpy(K), return_margins=True, **kw)


@pytest.mark.parametrize("entry", ["generate_greedy", "predict_action"])
def test_full_vocabulary_greedy_fp32(params, entry):
    ids, px, K = _inputs(2, seed=0)
    kw = (dict(max_new_tokens=6, compute_dtype=jnp.float32) if entry == "generate_greedy"
          else dict(restrict_to_action_tokens=False, compute_dtype=jnp.float32))
    ids_j, m_j = _jax(getattr(jsv, entry), params, CFG, ids, px, K, **kw)
    kw["compute_dtype"] = torch.float32
    ids_t, m_t = _port(getattr(tsv, entry), from_numpy_tree(params), CFG, ids, px, K, **kw)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=1e-3, rtol=1e-4)
    assert ids_t.shape == (2, 6 if entry == "generate_greedy" else 12)


def test_full_vocabulary_greedy_fused_int8(params, monkeypatch):
    """The int8 serving tree in bf16 with the argmax over the whole vocabulary
    on the fused loop: JAX's fused loop's ids under the margin rule, and the
    port's static-buffer loop (the one the card captures) equal to its eager
    run with the exact P + 12 cache."""
    bf = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)),
                                params)
    jq = dict(bf, lm=j_qlm(bf["lm"], fuse=True))
    jq["zoe"] = j_precompute_rel_bias(jq["zoe"], CFG.zoe)
    tq = from_numpy_tree(bf)
    tq["lm"] = t_qlm(tq["lm"])
    tq["zoe"] = t_precompute_rel_bias(tq["zoe"], CFG.zoe)
    monkeypatch.setattr(j_decode_step, "fused_decode_step",
                        functools.partial(j_decode_step.fused_decode_step, interpret=True))
    ids, px, K = _inputs(2, seed=1)
    kw = dict(restrict_to_action_tokens=False, use_fused_decode=True)
    ids_j, m_j = _jax(jsv.predict_action, jq, CFG_WIDE, ids, px, K, **kw)
    runs = []
    for bucket in (tsv.SLOT_BUCKET, 1):
        monkeypatch.setattr(tsv, "SLOT_BUCKET", bucket)
        runs.append(_port(tsv.predict_action, tq, CFG_WIDE, ids, px, K, **kw))
    (ids_s, m_s), (ids_e, m_e) = runs
    assert torch.equal(ids_s, ids_e) and torch.equal(m_s, m_e)
    assert_margin_rule(ids_s, ids_j, m_j)
    # and the unfused loop of the same tree (the card's reference) agrees
    ids_u, _ = _port(tsv.predict_action, tq, CFG_WIDE, ids, px, K,
                     restrict_to_action_tokens=False, use_fused_decode=False)
    assert_margin_rule(ids_u, ids_j, m_j)


def test_cache_dtype_float32(params):
    ids, px, K = _inputs(1, seed=2)
    ids_j, _ = _jax(jsv.generate_greedy, params, CFG, ids, px, K, max_new_tokens=6,
                    compute_dtype=jnp.float32, cache_dtype=jnp.float32,
                    token_range=(CFG.action_token_begin_idx, CFG.spatial_token_num))
    ids_t, _ = _port(tsv.generate_greedy, from_numpy_tree(params), CFG, ids, px, K,
                     max_new_tokens=6, compute_dtype=torch.float32, cache_dtype=torch.float32,
                     token_range=(CFG.action_token_begin_idx, CFG.spatial_token_num))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    tq = from_numpy_tree(params)
    tq["lm"] = t_qlm(tq["lm"])
    with pytest.raises(ValueError, match="bf16"):
        _port(tsv.generate_greedy, tq, CFG_WIDE, ids, px, K, max_new_tokens=6,
              cache_dtype=torch.float32, use_fused_decode=True)


def test_given_depth(params):
    ids, px, K = _inputs(2, seed=3)
    size = CFG.vision.image_size
    depth = (0.5 + np.random.RandomState(4).rand(2, size, size) * 3).astype(np.float32)
    feats_j = jsv.get_image_features(params, CFG, jnp.asarray(px), jnp.asarray(K),
                                     depth=jnp.asarray(depth))
    with torch.inference_mode():
        feats_t = tsv.get_image_features(from_numpy_tree(params), CFG, torch.from_numpy(px),
                                         torch.from_numpy(K), depth=torch.from_numpy(depth))
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), atol=1e-5, rtol=0)
    ids_j, _ = _jax(jsv.predict_action, params, CFG, ids, px, K, depth=jnp.asarray(depth),
                    compute_dtype=jnp.float32)
    ids_t, _ = _port(tsv.predict_action, from_numpy_tree(params), CFG, ids, px, K,
                     depth=torch.from_numpy(depth), compute_dtype=torch.float32)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    ids_z, _ = _port(tsv.predict_action, from_numpy_tree(params), CFG, ids, px, K,
                     compute_dtype=torch.float32)
    assert ids_z.shape == ids_t.shape  # ZoeDepth's own estimate: another input


@pytest.mark.parametrize("bits", [8, 4])
def test_unfused_quantized_tree_greedy(params, bits):
    """quantize_lm_params(fuse=False) in fp32 compute: the unfused loop on
    separate q / k / v / gate / up, JAX's ids on JAX's tree."""
    jlm = j_qlm(params["lm"], fuse=False, bits=bits)
    tlm = t_qlm(from_numpy_tree(params)["lm"], fuse=False, bits=bits)
    assert "q" in tlm["layers"]["attn"] and "gate" in tlm["layers"]["mlp"]
    ids, px, K = _inputs(2, seed=5)
    ids_j, _ = _jax(jsv.predict_action, dict(params, lm=jlm), CFG, ids, px, K,
                    compute_dtype=jnp.float32)
    ids_t, _ = _port(tsv.predict_action, dict(from_numpy_tree(params), lm=tlm), CFG, ids, px, K,
                     compute_dtype=torch.float32)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
