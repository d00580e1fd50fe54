"""The port's LoRA (spatialvla_tpu_torch/train/lora.py, the LoRA branch of
ops/quant.qmatmul, train_step.make_lora_train_step) and its tree utilities
(utils/tree.py) against the JAX package on the CPU, with the same
numpy-seeded weights and factors, on spatialvla_tiny(use_vision_zoe=True).

Tolerances (fp32):
* lora_init: the same target paths, shapes and dtypes (the values come from
  another generator);
* lora_merge, lora_apply_tree, lora_fold, extract_saved / insert_saved on
  bridged factors with B non-zero: rtol 1e-6 (atol 1e-7);
* qmatmul's LoRA branch on plain, int8, int4 and int4-g128 bases: rtol
  1e-5, atol 1e-5 * max|ref| (JAX's XLA branch, the port's plain one);
* three LoRA steps with the xla and the flash backend: loss and metrics
  rtol 1e-5 (atol 1e-6) every step; factors and saved tensors atol 1e-6
  after every step (eps = 1e-3, as tests/test_torch_train.py: the first
  update has lr 0); the base tree bit-identical and without gradients.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvla_tpu.action import SpatialActionTokenizer
from spatialvla_tpu.config import spatialvla_tiny
from spatialvla_tpu.models import spatialvla as jsv
from spatialvla_tpu.ops import quant as jq
from spatialvla_tpu.train import lora as jlora
from spatialvla_tpu.train import optimizer as jopt
from spatialvla_tpu.train import train_step as jts
from spatialvla_tpu.train.metrics import build_decode_luts as j_luts
from spatialvla_tpu.utils import tree as jtree
from spatialvla_tpu_torch.convert import from_numpy_tree, to_numpy_tree
from spatialvla_tpu_torch.ops import quant as tq
from spatialvla_tpu_torch.train import lora as tlora
from spatialvla_tpu_torch.train import optimizer as topt
from spatialvla_tpu_torch.train import train_step as tts
from spatialvla_tpu_torch.utils import tree as ttree
from tests.test_torch_train import make_batch

torch.set_num_threads(2)

CFG = spatialvla_tiny(use_vision_zoe=True)
METRICS = ("loss", "accuracy", "translation_accuracy", "rotation_accuracy",
           "gripper_accuracy", "l1_loss")
ALPHA, RANK = 8.0, 4


@pytest.fixture(scope="module")
def params():
    init = jax.jit(lambda key: jsv.init_params(key, CFG))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def luts():
    tok = SpatialActionTokenizer(token_begin_idx=CFG.action_token_begin_idx)
    return j_luts(tok)


def bridged_factors(params, preset="linear", seed=5, b_scale=0.02):
    """JAX's factor tree for ``preset`` with B drawn non-zero from a numpy
    seed, as numpy."""
    factors = jlora.lora_init(jax.random.PRNGKey(1), params,
                              target_patterns=jlora.TARGET_PRESETS[preset], rank=RANK)
    rng = np.random.RandomState(seed)
    return {p: {"a": np.asarray(f["a"]),
                "b": (rng.randn(*f["b"].shape) * b_scale).astype(np.float32)}
            for p, f in factors.items()}


def assert_trees_close(port_tree, jax_tree, **tol):
    """The same leaf paths (in any order: JAX sorts dict keys), shapes,
    dtypes and values."""
    jl = dict(jtree.leaves_with_paths(jax.tree_util.tree_map(np.asarray, jax_tree)))
    tl = dict(ttree.leaves_with_paths(to_numpy_tree(port_tree)))
    assert sorted(tl) == sorted(jl)
    for path, a in tl.items():
        b = jl[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(a, b, err_msg=path, **tol)


# ---------------------------------------------------------------------------
# utils/tree.py
# ---------------------------------------------------------------------------

def test_tree_utils_match_jax(params):
    """Paths, maps and counts as JAX's (JAX walks dict keys sorted, the port
    in insertion order: this tree's keys are inserted sorted)."""
    tree = {"a": {"b": [np.ones(4, np.float32), None], "w": np.zeros((2, 3), np.float32)},
            "c": (np.ones((1,), np.float32),)}
    tt = from_numpy_tree({"a": {"b": [tree["a"]["b"][0]], "w": tree["a"]["w"]},
                          "c": tree["c"]})
    tt["a"]["b"].append(None)
    assert [p for p, _ in ttree.leaves_with_paths(tt)] == \
        [p for p, _ in jtree.leaves_with_paths(tree)] == ["a/b/0", "a/w", "c/0"]
    mapped = ttree.map_with_paths(lambda p, t: p, tt)
    assert mapped == jtree.map_with_paths(lambda p, t: p, tree)
    assert ttree.path_str(("lm", "layers", 3)) == "lm/layers/3"
    port = from_numpy_tree(params)
    assert ttree.count_params(port) == jtree.count_params(params)
    for depth in (1, 2, 3):
        assert ttree.param_summary(port, depth) == jtree.param_summary(params, depth)


def test_trainable_mask_on_the_shared_walker(params):
    port = from_numpy_tree(params)
    for kw in ({}, dict(freeze_vision=True), dict(freeze_llm_embed=False, freeze_zoe=False),
               dict(extra_frozen_paths=("lm/layers/mlp",))):
        assert topt.trainable_mask(port, **kw) == jopt.trainable_mask(params, **kw)


# ---------------------------------------------------------------------------
# train/lora.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", sorted(jlora.TARGET_PRESETS))
def test_lora_init_targets_match_jax(params, preset):
    pats = jlora.TARGET_PRESETS[preset]
    assert tlora.TARGET_PRESETS[preset] == pats
    jf = jlora.lora_init(jax.random.PRNGKey(1), params, target_patterns=pats, rank=RANK)
    gen = torch.Generator().manual_seed(1)
    tf = tlora.lora_init(gen, from_numpy_tree(params), target_patterns=pats, rank=RANK)
    assert list(tf) == list(jf)
    assert "spatial_embed" not in tf and "lm/embed" not in tf
    for p in jf:
        for k in ("a", "b"):
            assert tuple(tf[p][k].shape) == jf[p][k].shape, (p, k)
            assert str(tf[p][k].dtype).split(".")[-1] == str(jf[p][k].dtype), (p, k)
        assert not tf[p]["b"].any()
        a = tf[p]["a"].numpy()  # N(0, 1) / r
        assert abs(a.std() * RANK - 1.0) < 0.2 and abs(a.mean() * RANK) < 0.2


def test_lora_merge_apply_and_fold_match_jax(params):
    factors = bridged_factors(params)
    jfac = jax.tree_util.tree_map(jnp.asarray, factors)
    port, tfac = from_numpy_tree(params), from_numpy_tree(factors)
    tol = dict(rtol=1e-6, atol=1e-7)
    kw = dict(alpha=ALPHA, rank=RANK)
    assert_trees_close(tlora.lora_merge(port, tfac, **kw), jlora.lora_merge(params, jfac, **kw),
                       **tol)
    applied = tlora.lora_apply_tree(port, tfac, **kw)
    assert_trees_close(applied, jlora.lora_apply_tree(params, jfac, **kw), **tol)
    assert set(applied["lm"]["layers"]["attn"]["q"]) == {"w", "a", "b"}
    assert torch.is_tensor(applied["vision"]["layers"]["attn"]["q"]["w"])  # a dense delta
    folded = tlora.lora_fold(port, tfac, **kw)
    assert_trees_close(folded, jlora.lora_fold(params, jfac, **kw), **tol)
    assert not any(t.requires_grad for _, t in ttree.iter_leaves(folded))


def test_extract_and_insert_saved_match_jax(params):
    port = from_numpy_tree(params)
    saved = tlora.extract_saved(port)
    assert list(saved) == list(jlora.extract_saved(params)) == ["spatial_embed"]
    new = np.random.RandomState(3).randn(*params["spatial_embed"].shape).astype(np.float32)
    back = tlora.insert_saved(port, {"spatial_embed": torch.from_numpy(new)})
    assert_trees_close(back, jlora.insert_saved(params, {"spatial_embed": jnp.asarray(new)}),
                       rtol=0, atol=0)
    assert back["lm"]["embed"] is port["lm"]["embed"]  # the other leaves are the same tensors


def test_lora_grads_reach_only_the_factors(params):
    """Through lora_merge and lora_apply_tree the base takes no gradient."""
    port = from_numpy_tree(params)
    for _, t in ttree.iter_leaves(port):
        t.requires_grad_(True)
    tfac = from_numpy_tree(bridged_factors(params))
    for _, t in ttree.iter_leaves(tfac):
        t.requires_grad_(True)
    x = torch.randn(3, CFG.text.hidden_size)
    for fn in (tlora.lora_merge, tlora.lora_apply_tree):
        tree = fn(port, tfac, alpha=ALPHA, rank=RANK)
        tq.qmatmul(x, tree["lm"]["layers"]["attn"]["q"]).sum().backward()
    assert port["lm"]["layers"]["attn"]["q"].grad is None
    assert tfac["lm/layers/attn/q"]["a"].grad is not None


# ---------------------------------------------------------------------------
# ops/quant.qmatmul: the LoRA branch
# ---------------------------------------------------------------------------

BASES = {"plain": None, "int8": jq.quantize_int8, "int4": jq.quantize_int4,
         "int4-g128": functools.partial(jq.quantize_int4, group_size=128)}


@pytest.mark.parametrize("M", [1, 16, 40])
@pytest.mark.parametrize("base", sorted(BASES))
def test_qmatmul_lora_branch_matches_jax(base, M):
    K, N, r = 256, 96, 8
    rng = np.random.RandomState(M)
    w = (rng.randn(K, N) * 0.05).astype(np.float32)
    x = rng.randn(M, K).astype(np.float32)
    a = (rng.randn(K, r) * 0.1).astype(np.float32)
    b = (rng.randn(r, N) * 0.1).astype(np.float32)
    jw = jnp.asarray(w) if BASES[base] is None else BASES[base](jnp.asarray(w))
    ref = np.asarray(jq.qmatmul(jnp.asarray(x), {"w": jw, "a": jnp.asarray(a),
                                                 "b": jnp.asarray(b)}, use_kernel=False))
    tw = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jw))
    out = tq.qmatmul(torch.from_numpy(x), {"w": tw, "a": torch.from_numpy(a),
                                           "b": torch.from_numpy(b)})
    assert tq.is_lora_factored({"w": tw, "a": a, "b": b}) and not tq.is_quantized({"w": tw})
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    # the low-rank product is added to the base product
    base_only = tq.qmatmul(torch.from_numpy(x), tw).numpy()
    np.testing.assert_allclose(out.numpy() - base_only, x @ a @ b, rtol=1e-4, atol=1e-4)


def test_qnorm_matmul_hands_a_lora_dict_to_qmatmul():
    from spatialvla_tpu_torch.models.layers import rms_norm

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 3, 64).astype(np.float32))
    nw = torch.from_numpy(rng.randn(64).astype(np.float32) * 0.1)
    w = {"w": tq.quantize_int8(torch.from_numpy(rng.randn(64, 32).astype(np.float32))),
         "a": torch.from_numpy(rng.randn(64, 4).astype(np.float32)),
         "b": torch.from_numpy(rng.randn(4, 32).astype(np.float32))}
    torch.testing.assert_close(tq.qnorm_matmul(x, nw, w), tq.qmatmul(rms_norm(nw, x, 1e-6), w),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# train_step.make_lora_train_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_lora_steps_match_jax(params, luts, backend):
    ocfg = dict(learning_rate=1e-3, warmup_ratio=0.2, total_steps=10, eps=1e-3)
    step_kw = dict(use_remat=True, attn_backend=backend, loss_chunk_size=7)
    pats = jlora.TARGET_PRESETS["linear"]
    # JAX
    jtx = jopt.make_optimizer(jopt.OptimizerConfig(**ocfg), None, None)
    jbase = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jts.init_lora_train_state(jax.random.PRNGKey(1), jbase, jtx,
                                       target_patterns=pats, rank=RANK)
    factors = bridged_factors(params)
    jstate["trainable"]["lora"] = jax.tree_util.tree_map(jnp.asarray, factors)
    jstate["opt_state"] = jtx.init(jstate["trainable"])
    jstep = jax.jit(jts.make_lora_train_step(
        CFG, jtx, jts.TrainStepConfig(compute_dtype=jnp.float32, **step_kw), alpha=ALPHA,
        rank=RANK, luts={k: jnp.asarray(v) for k, v in luts.items()}))
    # the port, on the same factors
    ttx = topt.make_optimizer(topt.OptimizerConfig(**ocfg), None, None)
    tbase = from_numpy_tree(params)
    tstate = tts.init_lora_train_state(torch.Generator().manual_seed(1), tbase, ttx,
                                       target_patterns=pats, rank=RANK)
    with torch.no_grad():
        for p, f in factors.items():
            for k in ("a", "b"):
                tstate["trainable"]["lora"][p][k].copy_(torch.from_numpy(np.array(f[k])))
    tstep = tts.make_lora_train_step(
        CFG, ttx, tts.TrainStepConfig(compute_dtype=torch.float32, **step_kw), alpha=ALPHA,
        rank=RANK, luts={k: torch.from_numpy(v) for k, v in luts.items()})
    for i, seed in enumerate((3, 4, 5)):
        batch = make_batch(seed)
        jstate, jm = jstep(jstate, jbase, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, tbase, batch)
        assert sorted(tm) == sorted(jm) and "grad_norm" not in tm
        for k in METRICS:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k} step {i}")
        assert_trees_close(tstate["trainable"], jstate["trainable"], rtol=0, atol=1e-6)
    assert tstate["step"] == 3 and int(jstate["step"]) == 3
    for path, t in ttree.iter_leaves(tbase):  # the base: bit-identical, no gradient
        assert t.grad is None and not t.requires_grad, path
        np.testing.assert_array_equal(t.numpy(), dict(jtree.leaves_with_paths(params))[path])
    assert not np.array_equal(tstate["trainable"]["saved"]["spatial_embed"].detach().numpy(),
                              params["spatial_embed"])


def test_lora_step_refuses_micro_batches():
    tx = topt.make_optimizer(topt.OptimizerConfig(), None, None)
    with pytest.raises(ValueError, match="one batch a step"):
        tts.make_lora_train_step(CFG, tx, tts.TrainStepConfig(micro_steps=2))
