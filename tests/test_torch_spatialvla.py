"""The port's serving path against the JAX package on the CPU, with the same
numpy-seeded weights and inputs, on spatialvla_tiny(use_vision_zoe=True):

* fp32: image features allclose and predict_action ids identical;
* the int8 serving tree in bf16 (LM, vision front, precomputed Zoe bias),
  unpadded and right-padded: greedy ids follow the margin rule;
* the window widened so the fused decode path applies: the port's fused
  path, forced on the CPU (the kernels' plain versions), against JAX
  predict_action under the same rule;
* SpatialVLAPolicy.predict / predict_batch against the JAX policy, after
  quantize(bits=8), quantize(bits=4) and quantize(bits=8, mlp_bits=4,
  kv_bits=8) (both packages' fused loops forced on the CPU, JAX's Pallas
  step in interpret mode);
* quantize's int4, mixed and grouped trees bit-identical to JAX's;
* the flash-attention prefill (use_flash_prefill=True): fp32 ids identical
  to JAX's flash prefill and to the port's masked prefill; on the int8 tree
  in bf16, JAX's ids under the margin rule.

Margin rule (bf16): the first token must match exactly, and ids must be
equal up to the first step whose JAX argmax margin (top1 - top2 logit) is
below 0.5, where a rounding difference may flip a near tie. The lm_head is
scaled up so that random-weight logits are not flat and the rule checks
more than the first token."""
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvla_tpu.config import spatialvla_tiny
from spatialvla_tpu.inference import SpatialVLAPolicy as JaxPolicy
from spatialvla_tpu.models import spatialvla as jsv
from spatialvla_tpu.ops import decode_step as j_decode_step
from spatialvla_tpu.models.zoe import precompute_rel_bias as j_precompute_rel_bias
from spatialvla_tpu.ops.quant import quantize_lm_params as j_qlm
from spatialvla_tpu.ops.quant import quantize_vision_params as j_qvis
from spatialvla_tpu.processor import SpatialVLAProcessor as JaxProcessor
from spatialvla_tpu_torch import SpatialVLAPolicy
from spatialvla_tpu_torch.convert import from_numpy_tree, to_numpy_tree
from spatialvla_tpu_torch.inference import default_processor
from spatialvla_tpu_torch.models import spatialvla as tsv
from spatialvla_tpu_torch.models.zoe import precompute_rel_bias as t_precompute_rel_bias
from spatialvla_tpu_torch.ops.quant import quantize_lm_params as t_qlm
from spatialvla_tpu_torch.ops.quant import quantize_vision_params as t_qvis

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False

CFG = spatialvla_tiny(use_vision_zoe=True)
# serving S = P + 12 must fit the window for the fused decode path
CFG_WIDE = dataclasses.replace(CFG, text=dataclasses.replace(CFG.text, sliding_window=512))
MARGIN_BOUND = 0.5


@pytest.fixture(scope="module")
def params():
    p = jax.tree_util.tree_map(np.asarray, jsv.init_params(jax.random.PRNGKey(0), CFG))
    p["lm"]["lm_head"] = p["lm"]["lm_head"] * 50.0
    return p


def _inputs(B, n_text=5, padded=False, seed=0):
    rng = np.random.RandomState(seed)
    N = CFG.num_image_tokens
    ids = np.concatenate([np.full((B, N), CFG.image_token_index),
                          rng.randint(3, 250, (B, n_text))], axis=1).astype(np.int32)
    am = None
    if padded:
        am = np.ones(ids.shape, np.int32)
        am[1, -3:] = 0
        ids[1, -3:] = 0
    size = CFG.vision.image_size
    px = rng.rand(B, size, size, 3).astype(np.float32)
    K = np.array([[60.0, 0, 28], [0, 55.0, 27], [0, 0, 1]], np.float32)[None].repeat(B, 0)
    return ids, px, K, am


def _jax_predict(p, cfg, ids, px, K, am, dtype):
    return jsv.predict_action(
        p, cfg, jnp.asarray(ids), pixel_values=jnp.asarray(px), intrinsic=jnp.asarray(K),
        attention_mask=None if am is None else jnp.asarray(am), compute_dtype=dtype,
        return_margins=True)


def _port_predict(p, cfg, ids, px, K, am, dtype, **kw):
    with torch.inference_mode():
        return tsv.predict_action(
            p, cfg, torch.from_numpy(ids).long(), pixel_values=torch.from_numpy(px),
            intrinsic=torch.from_numpy(K), attention_mask=None if am is None else torch.from_numpy(am),
            compute_dtype=dtype, return_margins=True, **kw)


def assert_margin_rule(port_ids, jax_ids, jax_margins):
    port_ids, jax_ids = np.asarray(port_ids), np.asarray(jax_ids)
    jax_margins = np.asarray(jax_margins, np.float32)
    for row in range(jax_ids.shape[0]):
        assert port_ids[row, 0] == jax_ids[row, 0], (row, port_ids[row], jax_ids[row])
        for t in range(1, jax_ids.shape[1]):
            if jax_margins[row, t] < MARGIN_BOUND:
                break  # a near tie: this token and the rest may differ
            assert port_ids[row, t] == jax_ids[row, t], (
                f"row {row} step {t}: {port_ids[row]} vs {jax_ids[row]}, "
                f"margins {jax_margins[row]}")


def _serving_trees(params):
    bf = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
                                if np.issubdtype(a.dtype, np.floating) else a, params)
    jq = dict(bf)
    jq["lm"] = j_qlm(bf["lm"], fuse=True)
    jq = j_qvis(jq)
    jq["zoe"] = j_precompute_rel_bias(jq["zoe"], CFG.zoe)
    tq = from_numpy_tree(bf)
    tq["lm"] = t_qlm(tq["lm"])
    tq = t_qvis(tq)
    tq["zoe"] = t_precompute_rel_bias(tq["zoe"], CFG.zoe)
    return jq, tq


@pytest.fixture(scope="module")
def serving(params):
    return _serving_trees(params)


def test_fp32_image_features_and_ids(params):
    ids, px, K, _ = _inputs(2)
    tp = from_numpy_tree(params)
    feats_j = jsv.get_image_features(params, CFG, jnp.asarray(px), jnp.asarray(K))
    with torch.inference_mode():
        feats_t = tsv.get_image_features(tp, CFG, torch.from_numpy(px), torch.from_numpy(K))
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), atol=1e-5, rtol=0)
    ids_j, _ = _jax_predict(params, CFG, ids, px, K, None, jnp.float32)
    ids_t, _ = _port_predict(tp, CFG, ids, px, K, None, torch.float32)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))


def test_fp32_image_features_multi_observation(params):
    """(B, k, H, W, 3) pixels: k observations per sample, their features
    concatenated along the token axis."""
    _, px, K, _ = _inputs(2, seed=3)
    px5, K1 = px[None], K[:1]
    feats_j = jsv.get_image_features(params, CFG, jnp.asarray(px5), jnp.asarray(K1))
    with torch.inference_mode():
        feats_t = tsv.get_image_features(from_numpy_tree(params), CFG, torch.from_numpy(px5),
                                         torch.from_numpy(K1))
    assert feats_t.shape == (1, 2 * CFG.num_image_tokens, CFG.text.hidden_size)
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "right-padded"])
def test_int8_serving_tree_bf16(serving, padded):
    jq, tq = serving
    ids, px, K, am = _inputs(2, padded=padded, seed=1)
    ids_j, m_j = _jax_predict(jq, CFG, ids, px, K, am, jnp.bfloat16)
    ids_t, _ = _port_predict(tq, CFG, ids, px, K, am, torch.bfloat16)
    assert_margin_rule(ids_t, ids_j, m_j)


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "right-padded"])
def test_fused_path_forced_on_cpu(serving, padded):
    jq, tq = serving
    ids, px, K, am = _inputs(2, padded=padded, seed=2)
    ids_j, m_j = _jax_predict(jq, CFG_WIDE, ids, px, K, am, jnp.bfloat16)
    ids_t, _ = _port_predict(tq, CFG_WIDE, ids, px, K, am, torch.bfloat16, use_fused_decode=True)
    assert_margin_rule(ids_t, ids_j, m_j)


def _policies(params, quantize, cfg=CFG, **qkw):
    """The JAX and the port's policy on the same weights; with ``quantize``
    both in bf16 after quantize(**qkw) (default bits=8)."""
    j_proc = JaxProcessor(image_token_id=cfg.image_token_index,
                          action_token_begin_idx=cfg.action_token_begin_idx,
                          image_seq_length=cfg.num_image_tokens, image_size=cfg.vision.image_size,
                          statistics=default_processor(cfg).statistics)
    dtype = jnp.bfloat16 if quantize else jnp.float32
    jp = JaxPolicy(params, cfg, j_proc, compute_dtype=dtype)
    tp = SpatialVLAPolicy(from_numpy_tree(params), cfg, default_processor(cfg), device="cpu",
                          compute_dtype=torch.bfloat16 if quantize else torch.float32)
    if quantize:
        jp.params = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16) if jnp.issubdtype(a.dtype, jnp.floating) else a,
            jax.tree_util.tree_map(jnp.asarray, params))
        jp.quantize(**(qkw or dict(bits=8)))
        tp.params = from_numpy_tree(params, dtype=torch.bfloat16)
        tp.quantize(**(qkw or dict(bits=8)))
    return jp, tp


def _frames(n, seed):
    rng = np.random.RandomState(seed)
    s = CFG.vision.image_size
    return [(rng.rand(s, s, 3) * 255).astype(np.uint8) for _ in range(n)]


def test_policy_predict_fp32_identical(params):
    jp, tp = _policies(params, quantize=False)
    for img, text in zip(_frames(2, 3), ["pick up the cup", "open the drawer"]):
        a, b = tp.predict(img, text), jp.predict(img, text)
        np.testing.assert_array_equal(a["action_ids"], b["action_ids"])
        np.testing.assert_array_equal(a["actions"], b["actions"])
    imgs, texts = _frames(2, 4), ["a", "move the red block left"]
    a, b = tp.predict_batch(imgs, texts), jp.predict_batch(imgs, texts)
    np.testing.assert_array_equal(a["action_ids"], b["action_ids"])
    np.testing.assert_array_equal(a["actions"], b["actions"])


def test_policy_predict_int8_margin_rule(params):
    jp, tp = _policies(params, quantize=True)
    for img, text in zip(_frames(2, 5), ["pick up the cup", "open the drawer"]):
        a = tp.predict(img, text, return_margins=True)
        b = jp.predict(img, text, return_margins=True)
        assert_margin_rule(a["action_ids"][None], b["action_ids"][None], b["margins"][None])
        n_same = int(np.argmax(a["action_ids"] != b["action_ids"])) if (
            a["action_ids"] != b["action_ids"]).any() else 12
        # the actions of every leading 3-token step with equal ids are equal
        np.testing.assert_array_equal(a["actions"][: n_same // 3], b["actions"][: n_same // 3])
        assert a["actions"].shape == (4, 7) and np.isfinite(a["actions"]).all()
    # kv_bits=8 needs the fused decode path, which neither package takes on
    # the CPU by default (nor with this window, 8 < S): both refuse alike
    for p in (jp, tp):
        p.quantize(bits=None, vision_bits=None, kv_bits=8)
        with pytest.raises(ValueError, match="fused decode path"):
            p.predict(_frames(1, 5)[0], "pick up the cup")


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """Both policies on the CPU through their fused decode loops (each takes
    the fused path only on its accelerator by default): JAX's Pallas step in
    interpret mode, the port's kernels' plain versions."""
    monkeypatch.setattr(j_decode_step, "fused_decode_step",
                        functools.partial(j_decode_step.fused_decode_step, interpret=True))
    for mod in (jsv, tsv):
        monkeypatch.setattr(mod, "predict_action",
                            functools.partial(mod.predict_action, use_fused_decode=True))


@pytest.mark.parametrize("qkw", [dict(bits=4), dict(bits=8, mlp_bits=4, kv_bits=8)],
                         ids=["int4", "int8+mlp4+kv8"])
def test_policy_predict_int4_and_kv8_margin_rule(params, qkw, request):
    """quantize(bits=4) (the unfused decode on the CPU in both packages) and
    quantize(bits=8, mlp_bits=4, kv_bits=8) (the fused loop on the int8
    cache: the port's plain versions against JAX's Pallas step)."""
    if qkw.get("kv_bits"):
        request.getfixturevalue("fused_on_cpu")
    jp, tp = _policies(params, quantize=True, cfg=CFG_WIDE, **qkw)
    assert tp.kv_bits == qkw.get("kv_bits") and tp.quant_desc == jp.quant_desc
    for img, text in zip(_frames(2, 6), ["pick up the cup", "open the drawer"]):
        a = tp.predict(img, text, return_margins=True)
        b = jp.predict(img, text, return_margins=True)
        assert_margin_rule(a["action_ids"][None], b["action_ids"][None], b["margins"][None])
        assert a["actions"].shape == (4, 7) and np.isfinite(a["actions"]).all()


@pytest.mark.parametrize("call", [
    lambda p: p.quantize(bits=4),
    lambda p: p.quantize(mlp_bits=4),
    lambda p: p.quantize(bits=4, group_size=128, vision_bits=4),
])
def test_unported_surfaces_name_their_roadmap_item(call, params):
    """The quantize options give the trees of JAX's
    quantize functions bit for bit (run eagerly: under jit XLA may turn the
    scale divisions into reciprocal products, one ulp away) and JAX's
    quant_desc. (shard() and the engines over a sharded policy, ported since,
    are tested against JAX in test_torch_tensor_parallel.py.)"""
    class Record:
        def quantize(self, bits=8, **kw):
            self.kw = dict(bits=bits, **kw)

    call(rec := Record())
    jp, tp = _policies(params, quantize=False)
    call(jp)
    call(tp)
    assert tp.quant_desc == jp.quant_desc
    kw = rec.kw
    want = j_qvis(dict(params), bits=kw.get("vision_bits", 8))
    want["lm"] = j_qlm(params["lm"], fuse=True, bits=kw["bits"], mlp_bits=kw.get("mlp_bits"),
                       group_size=kw.get("group_size"))
    for key in ("lm", "vision", "projector"):
        flat_j, def_j = jax.tree_util.tree_flatten(
            jax.tree_util.tree_map(np.asarray, want[key]))
        flat_t, def_t = jax.tree_util.tree_flatten(to_numpy_tree(tp.params[key]))
        assert def_j == def_t
        for a, b in zip(flat_t, flat_j):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_flash_prefill_matches_jax_and_the_masked_prefill(params, serving):
    ids, px, K, _ = _inputs(2, seed=4)
    tp = from_numpy_tree(params)
    ids_j, _ = jsv.predict_action(
        params, CFG, jnp.asarray(ids), pixel_values=jnp.asarray(px), intrinsic=jnp.asarray(K),
        compute_dtype=jnp.float32, use_flash_prefill=True, return_margins=True)
    ids_flash, _ = _port_predict(tp, CFG, ids, px, K, None, torch.float32, use_flash_prefill=True)
    ids_masked, _ = _port_predict(tp, CFG, ids, px, K, None, torch.float32)
    np.testing.assert_array_equal(ids_flash.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(ids_flash.numpy(), ids_masked.numpy())
    jq, tq = serving
    ids_j, m_j = jsv.predict_action(
        jq, CFG, jnp.asarray(ids), pixel_values=jnp.asarray(px), intrinsic=jnp.asarray(K),
        compute_dtype=jnp.bfloat16, use_flash_prefill=True, return_margins=True)
    ids_t, _ = _port_predict(tq, CFG, ids, px, K, None, torch.bfloat16, use_flash_prefill=True)
    assert_margin_rule(ids_t, ids_j, m_j)
    with pytest.raises(ValueError, match="unpadded"):
        _port_predict(tp, CFG, ids, px, K, np.ones(ids.shape, np.int32), torch.float32,
                      use_flash_prefill=True)


# ---------------------------------------------------------------------------
# the fused loop on static buffers (the CUDA graph's loop, run eagerly)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [None, 8], ids=["bf16kv", "kv8"])
@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "right-padded"])
def test_static_buffer_loop_matches_the_eager_loop_and_jax(serving, padded, kv_bits,
                                                           monkeypatch):
    """The fused loop runs on a GreedyLoop's own buffers (the loop the card
    captures): the prefill cache copied into the first P of its slots, every
    step's buffers allocated once, each row's slots from a device tensor,
    written in place. With the cache rounded up to 64 slots (the graphs'
    buckets) and with exactly P + 12 slots it gives the same ids and margins,
    and JAX's fused loop's ids (Pallas in interpret mode) under the margin
    rule (the inputs of test_fused_path_forced_on_cpu). A CUDA graph of CPU
    tensors raises."""
    jq, tq = serving
    ids, px, K, am = _inputs(2, padded=padded, seed=2)
    monkeypatch.setattr(j_decode_step, "fused_decode_step",
                        functools.partial(j_decode_step.fused_decode_step, interpret=True))
    ids_j, m_j = jsv.predict_action(
        jq, CFG_WIDE, jnp.asarray(ids), pixel_values=jnp.asarray(px), intrinsic=jnp.asarray(K),
        attention_mask=None if am is None else jnp.asarray(am), compute_dtype=jnp.bfloat16,
        use_fused_decode=True, kv_bits=kv_bits, return_margins=True)
    runs = []
    for bucket in (tsv.SLOT_BUCKET, 1):
        monkeypatch.setattr(tsv, "SLOT_BUCKET", bucket)
        runs.append(_port_predict(tq, CFG_WIDE, ids, px, K, am, torch.bfloat16,
                                  use_fused_decode=True, kv_bits=kv_bits))
    (ids_s, m_s), (ids_e, m_e) = runs
    assert torch.equal(ids_s, ids_e) and torch.equal(m_s, m_e)
    assert ids_s.shape == (2, 12) and m_s.shape == (2, 12)
    assert_margin_rule(ids_s, ids_j, m_j)
    with pytest.raises(ValueError, match="CUDA graph needs CUDA tensors"):
        _port_predict(tq, CFG_WIDE, ids, px, K, am, torch.bfloat16, use_fused_decode=True,
                      kv_bits=kv_bits, use_cuda_graph=True)


def test_decode_graphs_are_dropped_with_the_tree(params):
    """A graph holds the weights' addresses: quantize and .to drop every
    cached graph, and so does a lookup with another tree; at most `limit`
    graphs stay, the least recently used dropped first."""
    tp = SpatialVLAPolicy(from_numpy_tree(params), CFG, default_processor(CFG), device="cpu")
    graphs = tp.decode_graphs
    made = []

    def build():
        made.append(object())
        return made[-1]

    a = graphs.get(tp.params, ("a",), build)
    assert graphs.get(tp.params, ("a",), build) is a and len(graphs) == 1
    tp.to("cpu")
    assert len(graphs) == 0
    graphs.get(tp.params, ("a",), build)
    tp.quantize(bits=8)
    assert len(graphs) == 0
    graphs.get(tp.params, ("a",), build)
    other = dict(tp.params, lm=dict(tp.params["lm"]))
    assert graphs.get(other, ("a",), build) is made[-1] and len(made) == 4  # rebuilt
    small = tsv.DecodeGraphs(limit=2)
    for key in ("x", "y", "x", "z"):
        small.get(tp.params, (key,), build)
    assert len(small) == 2 and small.get(tp.params, ("x",), build) is made[-3]
