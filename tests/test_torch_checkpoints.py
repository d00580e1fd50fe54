"""Checkpoints of the port against the JAX package on the CPU, on
spatialvla_tiny(use_vision_zoe=True) with seeded weights from the JAX
initializers:

* a reference-format HF directory written by the JAX package's
  export_hf_checkpoint (ZoeDepth and ego3d included) loads through the port's
  from_hf_checkpoint (its own safetensors reader) into JAX load_hf_checkpoint's
  tree leaf by leaf, config and processor state, and predicts the same ids
  (actions within 1e-5 in fp32); the port's own export loads to the same tree
  in both packages, its state dict and config.json equal JAX's, and a bf16
  tree comes back bit for bit, through float32 too;
* save_serving / load_serving round-trip the int8, int4, int8 + int4 MLP +
  int8 KV and int4-g128 + int4 vision trees bit for bit with their knobs,
  write JAX's serving_config.json, and serve the same ids; a quality gate that
  does not cover the knobs is refused;
* load reads train/checkpoints.py's format and refuses an Orbax directory;
* every loader defaults to the card and raises without one;
* scripts/quantize_checkpoint_torch.py bakes a loadable serving directory
  from an HF directory."""
import dataclasses
import functools
import importlib.util
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvla_tpu.config import spatialvla_tiny
from spatialvla_tpu.convert import config_to_hf as j_config_to_hf
from spatialvla_tpu.convert import export_hf_checkpoint as j_export
from spatialvla_tpu.convert import spatialvla_to_state_dict as j_to_sd
from spatialvla_tpu.convert.hf_checkpoint import load_hf_checkpoint as j_load_hf
from spatialvla_tpu.inference import SpatialVLAPolicy as JaxPolicy
from spatialvla_tpu.models import spatialvla as jsv
from spatialvla_tpu.processor import SpatialVLAProcessor as JaxProcessor
from spatialvla_tpu_torch import SpatialVLAPolicy
from spatialvla_tpu_torch.convert import (config_to_hf, export_hf_checkpoint, from_numpy_tree,
                                          map_tree, spatialvla_to_state_dict, to_numpy_tree)
from spatialvla_tpu_torch.inference import default_processor
from spatialvla_tpu_torch.models import spatialvla as tsv
from spatialvla_tpu_torch.processor import SpatialVLAProcessor as PortProcessor
from spatialvla_tpu_torch.train import checkpoints as t_ckpt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = spatialvla_tiny(use_vision_zoe=True)
# serving S = P + 12 must fit the window for the fused decode path
CFG_WIDE = dataclasses.replace(CFG, text=dataclasses.replace(CFG.text, sliding_window=512))
STATS = {"bridge_orig/1.0.0": {"action": {"q01": [-0.1] * 6 + [0.0], "q99": [0.1] * 6 + [1.0],
                                          "mask": [True] * 6 + [False]}}}
PROCESSOR_STATE = ("image_token_id", "action_token_begin_idx", "image_seq_length", "image_size",
                   "statistics", "bin_policy", "intrinsic_config", "action_config",
                   "num_obs_steps", "obs_delta", "action_chunk_size", "min_sigma")
SERVING_FORMATS = [dict(bits=8), dict(bits=4), dict(bits=8, mlp_bits=4, kv_bits=8),
                   dict(bits=4, group_size=128, vision_bits=4)]


@pytest.fixture(scope="module")
def params():
    p = jax.tree_util.tree_map(
        np.asarray, jax.jit(jsv.init_params, static_argnums=1)(jax.random.PRNGKey(0), CFG))
    p["lm"]["lm_head"] = p["lm"]["lm_head"] * 50.0  # logits not flat: ids mean something
    return p


def _processor_kw(cfg):
    return dict(image_token_id=cfg.image_token_index,
                action_token_begin_idx=cfg.action_token_begin_idx,
                image_seq_length=cfg.num_image_tokens, image_size=cfg.vision.image_size,
                statistics=STATS)


@pytest.fixture(scope="module")
def hf_dir(params, tmp_path_factory):
    """A reference-format directory written by the JAX package."""
    d = str(tmp_path_factory.mktemp("hf_jax"))
    j_export(params, CFG, d, processor=JaxProcessor(**_processor_kw(CFG)))
    return d


@pytest.fixture(scope="module")
def loaded(hf_dir):
    jax_params, jax_cfg, jax_proc = j_load_hf(hf_dir, dtype=jnp.float32)
    port = SpatialVLAPolicy.from_hf_checkpoint(hf_dir, device="cpu", param_dtype=torch.float32)
    return jax_params, jax_cfg, jax_proc, port


def _leaves(tree, prefix=""):
    """(path, leaf) of a nested dict / list, dict keys sorted as JAX flattens."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def assert_trees_equal(port_tree, ref_tree):
    """Same paths, shapes and dtypes, equal values (ref: numpy or torch)."""
    a, b = list(_leaves(port_tree)), list(_leaves(ref_tree))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        if isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype)
            assert torch.equal(x, y), k
        else:
            x = to_numpy_tree(x)
            y = np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=k)


def _frames(n, seed):
    rng = np.random.RandomState(seed)
    s = CFG.vision.image_size
    return [(rng.rand(s, s, 3) * 255).astype(np.uint8) for _ in range(n)]


def test_hf_checkpoint_loads_as_in_jax(loaded, params):
    jax_params, jax_cfg, jax_proc, port = loaded
    assert_trees_equal(port.params, jax.tree_util.tree_map(np.asarray, jax_params))
    assert_trees_equal(port.params, params)  # and both are the exported tree
    assert dataclasses.asdict(port.config) == dataclasses.asdict(jax_cfg)
    for name in PROCESSOR_STATE:
        assert getattr(port.processor, name) == getattr(jax_proc, name), name
    assert type(port.processor.text_tokenizer).__name__ == \
        type(jax_proc.text_tokenizer).__name__
    assert port.processor.build_prompt_ids("pick up the cup") == \
        jax_proc.build_prompt_ids("pick up the cup")


def test_hf_checkpoint_predicts_as_in_jax(hf_dir, loaded):
    """fp32 compute on both sides: ids identical, actions within 1e-5."""
    jp = JaxPolicy.from_hf_checkpoint(hf_dir, param_dtype=jnp.float32)
    jp.compute_dtype = jnp.float32
    tp = loaded[3]
    tp.compute_dtype = torch.float32
    for img, text in zip(_frames(2, 3), ["pick up the cup", "open the drawer"]):
        a = tp.predict(img, text, unnorm_key="bridge_orig/1.0.0")
        b = jp.predict(img, text, unnorm_key="bridge_orig/1.0.0")
        np.testing.assert_array_equal(a["action_ids"], b["action_ids"])
        np.testing.assert_allclose(a["actions"], b["actions"], atol=1e-5, rtol=0)


def test_port_export_loads_to_the_same_tree(params, tmp_path):
    """The port's export_hf_checkpoint writes what both packages load as the
    tree it was given; its state dict and config.json are JAX's."""
    tree = from_numpy_tree(params)
    sd = spatialvla_to_state_dict(tree, CFG)
    ref = j_to_sd(params, CFG)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == v.shape
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert config_to_hf(CFG) == j_config_to_hf(CFG)
    d = str(tmp_path / "hf_port")
    export_hf_checkpoint(tree, CFG, d, processor=PortProcessor(**_processor_kw(CFG)))
    with open(os.path.join(d, "config.json")) as f:
        assert json.load(f) == j_config_to_hf(CFG)
    port = SpatialVLAPolicy.from_hf_checkpoint(d, device="cpu", param_dtype=None)
    assert_trees_equal(port.params, params)
    jax_params, _, jax_proc = j_load_hf(d)
    assert_trees_equal(port.params, jax.tree_util.tree_map(np.asarray, jax_params))
    for name in PROCESSOR_STATE:
        assert getattr(port.processor, name) == getattr(jax_proc, name), name


def test_bf16_export_round_trip_is_bit_identical(params, tmp_path):
    """A bf16 tree exported in bf16 and loaded in bf16 is the same tree, bit
    for bit, and so is one loaded in float32 and cast back."""
    tree = from_numpy_tree(params, dtype=torch.bfloat16)
    d = str(tmp_path / "hf_bf16")
    export_hf_checkpoint(tree, CFG, d)
    bf16 = SpatialVLAPolicy.from_hf_checkpoint(d, device="cpu")  # param_dtype=bfloat16
    assert_trees_equal(bf16.params, tree)
    f32 = SpatialVLAPolicy.from_hf_checkpoint(d, device="cpu", param_dtype=torch.float32)
    assert_trees_equal(map_tree(lambda t: t.to(torch.bfloat16), f32.params), tree)


def test_loaders_default_to_the_card_and_raise_without_one(hf_dir, tmp_path, monkeypatch):
    """from_hf_checkpoint, load and load_serving load onto "cuda" unless asked
    for the CPU; without a card they raise rather than fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    policy = SpatialVLAPolicy.init_random(CFG, "cpu", seed=0)
    policy.save_serving(str(tmp_path / "serving"))
    t_ckpt.save_params(str(tmp_path / "ckpt"), policy.params, config_json=CFG.to_json())
    policy.processor.save(str(tmp_path / "ckpt"))
    for call in (lambda: SpatialVLAPolicy.from_hf_checkpoint(hf_dir),
                 lambda: SpatialVLAPolicy.load(str(tmp_path / "ckpt")),
                 lambda: SpatialVLAPolicy.load_serving(str(tmp_path / "serving"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def _fused_on_cpu(monkeypatch):
    monkeypatch.setattr(tsv, "predict_action",
                        functools.partial(tsv.predict_action, use_fused_decode=True))


@pytest.mark.parametrize("qkw", SERVING_FORMATS,
                         ids=["int8", "int4", "int8+mlp4+kv8", "int4-g128+vision4"])
def test_serving_checkpoint_round_trip(params, qkw, tmp_path, monkeypatch):
    """save_serving then load_serving: the packed tree bit for bit (dtypes,
    the ZoeDepth bias table included), kv_bits / depth_image_size /
    quant_desc restored, JAX's serving_config.json for the same knobs, and
    the same ids through the fused loop (forced on the CPU)."""
    _fused_on_cpu(monkeypatch)
    tp = SpatialVLAPolicy(from_numpy_tree(params, dtype=torch.bfloat16), CFG_WIDE,
                          default_processor(CFG_WIDE), device="cpu")
    tp.quantize(**qkw)
    d = str(tmp_path / "serving")
    tp.save_serving(d)
    lp = SpatialVLAPolicy.load_serving(d, device="cpu")
    assert_trees_equal(lp.params, tp.params)
    assert "rel_pos_bias" in lp.params["zoe"]["backbone"]["layers"]
    assert (lp.kv_bits, lp.depth_image_size, lp.quant_desc) == \
        (tp.kv_bits, tp.depth_image_size, tp.quant_desc)
    assert lp.config.to_json() == tp.config.to_json()
    jp = JaxPolicy(jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params),
                   CFG_WIDE, JaxProcessor(**dict(_processor_kw(CFG_WIDE),
                                                 statistics=tp.processor.statistics)))
    jp.quantize(**qkw)
    jd = str(tmp_path / "serving_jax")
    jp.save_serving(jd)
    with open(os.path.join(d, "serving_config.json")) as a, \
            open(os.path.join(jd, "serving_config.json")) as b:
        assert a.read() == b.read()
    for img, text in zip(_frames(2, 4), ["pick up the cup", "open the drawer"]):
        a = lp.predict(img, text, return_margins=True)
        b = tp.predict(img, text, return_margins=True)
        np.testing.assert_array_equal(a["action_ids"], b["action_ids"])
        np.testing.assert_array_equal(a["margins"], b["margins"])


def test_quality_gate_must_cover_the_baked_knobs(params, tmp_path):
    tp = SpatialVLAPolicy(from_numpy_tree(params, dtype=torch.bfloat16), CFG,
                          default_processor(CFG), device="cpu").quantize(bits=4)
    wrong = {"format_version": 1, "entries": [{"knobs": {"bits": 8}, "token_agreement": 1.0}]}
    with pytest.raises(ValueError, match="does not cover"):
        tp.save_serving(str(tmp_path / "refused"), quality_gate=wrong)
    assert not (tmp_path / "refused").exists()
    gate = {"format_version": 1,
            "entries": [{"knobs": {"bits": 4, "vision_bits": 8}, "token_agreement": 0.97}]}
    tp.save_serving(str(tmp_path / "gated"), quality_gate=gate)
    assert SpatialVLAPolicy.load_serving(str(tmp_path / "gated"), device="cpu").quality_gate == gate


def test_load_reads_the_port_format_and_refuses_orbax(params, tmp_path):
    tree = from_numpy_tree(params)
    d = str(tmp_path / "ckpt")
    t_ckpt.save_params(d, tree, config_json=CFG.to_json())
    PortProcessor(**_processor_kw(CFG)).save(d)
    f32 = SpatialVLAPolicy.load(d, device="cpu", param_dtype=torch.float32)
    assert_trees_equal(f32.params, tree)
    assert f32.config.to_json() == CFG.to_json() and f32.processor.statistics == STATS
    bf16 = SpatialVLAPolicy.load(d, device="cpu")
    assert_trees_equal(bf16.params, map_tree(lambda t: t.to(torch.bfloat16), tree))
    orbax = tmp_path / "orbax"
    (orbax / "params").mkdir(parents=True)
    (orbax / "config.json").write_text(CFG.to_json())
    PortProcessor(**_processor_kw(CFG)).save(str(orbax))
    with pytest.raises(ValueError, match="Orbax"):
        SpatialVLAPolicy.load(str(orbax), device="cpu")
    with pytest.raises(FileNotFoundError, match="save_serving"):
        SpatialVLAPolicy.load_serving(d, device="cpu")


def test_quantize_checkpoint_script_bakes_a_loadable_directory(hf_dir, tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "quantize_checkpoint_torch", os.path.join(ROOT, "scripts", "quantize_checkpoint_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = str(tmp_path / "baked")
    script.main(["--ckpt", hf_dir, "--hf", "--out", out, "--bits", "4", "--kv_bits", "8",
                 "--device", "cpu"])
    assert "serving checkpoint written" in capsys.readouterr().out
    policy = SpatialVLAPolicy.load_serving(out, device="cpu")
    assert policy.quant_desc == {"bits": 4, "vision_bits": 8, "mlp_bits": None,
                                 "group_size": None}
    assert policy.kv_bits == 8
    assert policy.params["lm"]["layers"]["attn"]["qkv"]["qt"].dtype == torch.uint8
    assert policy.processor.statistics == STATS
    baked = SpatialVLAPolicy.from_hf_checkpoint(hf_dir, device="cpu").quantize(bits=4,
                                                                                kv_bits=8)
    assert_trees_equal(policy.params, baked.params)
