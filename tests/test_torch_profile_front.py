"""scripts/profile_front_torch.py, the port of scripts/profile_front.py, on
the CPU at the tiny size:

* ``--preset spatialvla_tiny --device cpu`` prints a line for each stage
  (full predict, ZoeDepth, SigLIP, image features, prefill), the decode
  remainder and one JSON line with every stage's wall ms, timed
  round-robin, and the remainder's negative rounds (device time is not
  measured on the CPU), for the headline's bf16 front, int4 with a
  reduced-resolution ZoeDepth, and two replicated rows;
* the stages it times compute JAX's: on the same weights and request, its
  serving tree (int8 LM, the front bf16 or int8, the ZoeDepth bias at full
  or reduced resolution) gives JAX's image features within 1e-5 and JAX's
  prefill hidden state within 1e-4 absolute (fp32 compute; the same
  function in another summation order), and the greedy ids of its full
  predict equal JAX's.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvla_tpu.config import spatialvla_tiny
from spatialvla_tpu.models import gemma2 as jg
from spatialvla_tpu.models import spatialvla as jsv
from spatialvla_tpu.models.zoe import precompute_rel_bias as j_rel_bias
from spatialvla_tpu.ops.quant import quantize_lm_params as j_qlm
from spatialvla_tpu.ops.quant import quantize_vision_params as j_qvis
from spatialvla_tpu_torch.convert import from_numpy_tree

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = spatialvla_tiny(use_vision_zoe=True)
FEATURES_ATOL = 1e-5
HIDDEN_ATOL = 1e-4


def _script():
    spec = importlib.util.spec_from_file_location(
        "profile_front_torch", os.path.join(ROOT, "scripts", "profile_front_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flags", [["--vision_bits", "0"], ["--bits", "4", "--depth_res", "32"],
                                   ["--batch", "2"]],
                         ids=["int8-bf16front", "int4-depth32", "int8-batch2"])
def test_profiler_prints_every_stage(flags, capsys):
    argv = ["--preset", "spatialvla_tiny", "--device", "cpu", "--iters", "1"] + flags
    assert _script().main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    for stage in ("full_predict", "zoe_depth", "siglip", "image_features", "prefill",
                  "decode (resid)"):
        assert any(line.strip().startswith(stage + ":") for line in lines), (stage, lines)
    report = json.loads(lines[-1])["profile_front"]
    assert list(report["stages"]) == ["full_predict", "zoe_depth", "siglip", "image_features",
                                      "prefill"]
    for row in report["stages"].values():
        assert row["wall_ms"] > 0 and row["busy_ms"] is None and row["idle_share"] is None
    # timed round-robin: a remainder a round, negative ones counted
    assert report["rounds"] == 1 and report["decode_resid_negative_rounds"] in (0, 1)
    assert report["decode_resid_min_ms"] <= report["decode_resid_ms"]
    batch = 2 if "--batch" in flags else 1
    assert report["batch"] == batch and report["P"] == CFG.num_image_tokens + 10
    assert report["device"] == "cpu" and report["card"] is None


@pytest.mark.parametrize("vision_bits, depth", [(0, None), (8, 32)],
                         ids=["bf16front", "int8front-depth32"])
def test_stages_compute_jax(vision_bits, depth):
    mod = _script()
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: jsv.init_params(key, CFG))(jax.random.PRNGKey(0)))
    params["lm"]["lm_head"] = params["lm"]["lm_head"] * 50.0
    jq = dict(params)
    jq["lm"] = j_qlm(params["lm"], bits=8)
    jq["zoe"] = j_rel_bias(jq["zoe"], CFG.zoe, image_size=depth)
    if vision_bits:
        jq = j_qvis(jq, bits=vision_bits)
    tq = mod.serving_params(from_numpy_tree(params), CFG, bits=8, vision_bits=vision_bits,
                            depth_res=depth)
    ids, px, intr = mod.request(CFG, batch=1, device="cpu")
    with torch.inference_mode():
        fns = mod.stage_fns(tq, CFG, ids, px, intr, depth_res=depth,
                            compute_dtype=torch.float32)
        feats_t = fns["image_features"]()
        hidden_t, _ = fns["prefill"]()
        ids_t = fns["full_predict"]()
    jids, jpx, jintr = (jnp.asarray(t.numpy()) for t in (ids, px, intr))
    B, P = ids.shape
    S = P + 12

    @jax.jit
    def jax_stages(p, i, x, k):
        feats = jsv.get_image_features(p, CFG, x, k, compute_dtype=jnp.float32,
                                       depth_image_size=depth)
        embeds = jsv.merge_input_embeddings(p, CFG, i, feats, dtype=jnp.float32)
        cache = jg.init_cache(CFG.text, B, S, dtype=jnp.float32)
        pos = jnp.broadcast_to(jnp.arange(1, P + 1)[None], (B, P))
        hidden, _ = jg.forward(p["lm"], CFG.text, embeds, pos,
                               jsv.bidirectional_prefill_mask(P, S, B), cache=cache,
                               cache_position=0)
        out = jsv.predict_action(p, CFG, i, pixel_values=x, intrinsic=k, action_chunk_size=4,
                                 compute_dtype=jnp.float32, depth_image_size=depth)
        return feats, hidden, out

    feats_j, hidden_j, ids_j = jax_stages(jq, jids, jpx, jintr)
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), atol=FEATURES_ATOL, rtol=0)
    np.testing.assert_allclose(hidden_t.numpy(), np.asarray(hidden_j), atol=HIDDEN_ATOL, rtol=0)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
