"""The port's split-phase serving functions (models/spatialvla.py) against the
JAX package's on the CPU, with the same numpy-seeded weights (through the
bridge) and inputs, on spatialvla_tiny(use_vision_zoe=True) with the
sliding window widened to 512 (the serving cache must fit it), the int8
serving tree in bf16, with a bf16 and an int8 KV cache:

* prefill_for_serving: first tokens and prefix lengths identical; the K / V
  rows (dequantized for kv8) and the kv8 scales within 1e-2 of JAX's,
  relative to the largest value (bf16 rounding through the layers);
* init_serving_state: the same keys, shapes, dtypes and values;
* admit_rows_serving: bit-identical states from identical inputs;
* xla_decode_step: hidden and new K / V rows within 1e-2 relative;
* decode_steps_serving over a whole request (3 dispatches of 4 steps) from
  one admitted state: the port's xla route and its fused route (the
  kernels' plain versions on the CPU) against JAX's xla route
  (use_fused=False, so no interpret-mode Pallas): first token equal, then
  the margin rule against JAX's greedy margins on the same padded rows, the
  positions and step counts identical, a free slot's output untouched.

Margin rule (bf16): ids equal up to the first step whose JAX argmax margin
(top1 - top2 logit) is below 0.5. The lm_head is scaled up (as in
test_torch_spatialvla.py) so that the rule checks more than the first
token."""
import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvla_tpu.models import spatialvla as jsv
from spatialvla_tpu_torch import SpatialVLAPolicy
from spatialvla_tpu_torch.convert import from_numpy_tree, map_tree, to_numpy_tree
from spatialvla_tpu_torch.inference import default_processor
from spatialvla_tpu_torch.models import spatialvla as tsv
from tests.test_torch_spatialvla import CFG_WIDE, assert_margin_rule

torch.set_num_threads(2)

TOL = 1e-2  # max|port - jax| / max|jax| of bf16 values through one decode step
FP32_TOL = 1e-4  # the same in fp32 through the whole prefill (1.4e-6 measured)
N_TOKENS = 12
TOKEN_RANGE = (CFG_WIDE.action_token_begin_idx, CFG_WIDE.spatial_token_num)
KV_IDS = ["bf16kv", "kv8"]


def jax_tree(tree):
    """A tree of tensors as numpy for JAX, bf16 kept bf16 (the bridge's
    other way)."""
    def leaf(t):
        if t.dtype == torch.bfloat16:
            return t.float().numpy().astype(ml_dtypes.bfloat16)
        return t.numpy()

    return map_tree(leaf, tree)


def seeded_params(cfg):
    """fp32 weights from a seeded generator as numpy (the bridge's form),
    the lm_head scaled up so that greedy margins are not flat."""
    with torch.no_grad():
        p = to_numpy_tree(tsv.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                           device="cpu"))
    p["lm"]["lm_head"] = p["lm"]["lm_head"] * 50.0
    return p


@pytest.fixture(scope="module")
def trees():
    """(JAX, port) trees: fp32 as initialized, and the int8 serving tree in
    bf16 and in fp32 (the port's quantize, bit-identical to JAX's:
    test_torch_quant.py)."""
    p = seeded_params(CFG_WIDE)

    def quantized(dtype):
        return SpatialVLAPolicy(from_numpy_tree(p, dtype=dtype), CFG_WIDE,
                                default_processor(CFG_WIDE), device="cpu").quantize(bits=8).params

    tq, tq32 = quantized(torch.bfloat16), quantized(torch.float32)
    return {"fp32": (p, from_numpy_tree(p)), "int8": (jax_tree(tq), tq),
            "int8_fp32": (jax_tree(tq32), tq32)}


def _rows_inputs(seed=0):
    """Two right-padded rows of different prefix lengths in a 32-token bucket."""
    rng = np.random.RandomState(seed)
    N, T = CFG_WIDE.num_image_tokens, 32
    ids = np.zeros((2, T), np.int32)
    am = np.zeros((2, T), np.int32)
    for b, n_text in enumerate((9, 4)):
        ids[b, :N] = CFG_WIDE.image_token_index
        ids[b, N : N + n_text] = rng.randint(3, 250, n_text)
        am[b, : N + n_text] = 1
    s = CFG_WIDE.vision.image_size
    px = rng.rand(2, s, s, 3).astype(np.float32)
    K = np.array([[60.0, 0, 28], [0, 55.0, 27], [0, 0, 1]], np.float32)[None].repeat(2, 0)
    return ids, am, px, K


def _dtype(x) -> str:
    """A tensor's or array's dtype name (bfloat16 for JAX's ml_dtypes bf16)."""
    return str(x.dtype).split(".")[-1] if isinstance(x, torch.Tensor) else np.asarray(x).dtype.name


def _f32(a):
    """numpy values (bf16 widened exactly to f32) for comparison."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


DTYPES = {"fp32": (jnp.float32, torch.float32), "int8": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def prefills(trees):
    """prefills(kv_bits, kind): both packages' prefill_for_serving of the
    same two rows (JAX's as numpy), fp32 on the fp32 tree (and cache), bf16
    on the int8 serving tree, each computed once for the module. JAX's
    under jit (a quarter of its op-by-op time on the CPU)."""
    done = {}

    def get(kv_bits, kind="int8"):
        if (kind, kv_bits) not in done:
            (jp, tp), (jd, td) = trees[kind], DTYPES[kind]
            ids, am, px, K = _rows_inputs()
            kw = dict(cache_len=ids.shape[1] + N_TOKENS, token_range=TOKEN_RANGE,
                      kv_bits=kv_bits)
            rj = jax.jit(lambda p, i, x, k, a: jsv.prefill_for_serving(
                p, CFG_WIDE, i, pixel_values=x, intrinsic=k, attention_mask=a,
                compute_dtype=jd, cache_dtype=jd, **kw))(jp, ids, px, K, am)
            with torch.inference_mode():
                rt = tsv.prefill_for_serving(tp, CFG_WIDE, torch.from_numpy(ids).long(),
                                             pixel_values=torch.from_numpy(px),
                                             intrinsic=torch.from_numpy(K),
                                             attention_mask=torch.from_numpy(am),
                                             compute_dtype=td, cache_dtype=td, **kw)
            done[kind, kv_bits] = (jax.tree_util.tree_map(np.asarray, rj), rt,
                                   (ids, am, px, K))
        return done[kind, kv_bits]

    return get


@pytest.mark.parametrize("kv_bits", [None, 8], ids=KV_IDS)
@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_prefill_for_serving_matches_jax(prefills, kind, kv_bits):
    """First tokens and prefix lengths identical; keys, dtypes and shapes
    JAX's. In fp32 the K / V rows (dequantized for kv8) and the kv8 scales
    within FP32_TOL of JAX's, the kv8 codes identical. In bf16 on the int8
    tree the rows differ by bf16 roundings that start in the vision front
    (1.2-1.6% of the largest value, measured), so bf16 is held by its ids
    here and in test_decode_steps_serving_matches_jax."""
    rj, rt, (ids, am, _, _) = prefills(kv_bits, kind)
    assert sorted(rt) == sorted(rj)
    assert {k: _dtype(v) for k, v in rt.items()} == {k: _dtype(v) for k, v in rj.items()}
    rt = to_numpy_tree(rt)
    for key in ("tok", "valid"):
        np.testing.assert_array_equal(rt[key], rj[key])
    np.testing.assert_array_equal(rt["valid"], am.sum(-1))
    L, Nkv, D = CFG_WIDE.text.num_layers, CFG_WIDE.text.num_kv_heads, CFG_WIDE.text.head_dim
    for key in ("k", "v"):
        assert rt[key].shape == (L, 2, Nkv, ids.shape[1], D)
        if kind == "int8":
            continue
        if kv_bits == 8:
            np.testing.assert_array_equal(rt[key], rj[key])
            assert _rel(rt[key + "_scale"], rj[key + "_scale"]) < FP32_TOL
        else:
            assert _rel(rt[key], rj[key]) < FP32_TOL


@pytest.mark.parametrize("kv_bits", [None, 8], ids=KV_IDS)
def test_init_serving_state_matches_jax(kv_bits):
    sj = jax.tree_util.tree_map(np.asarray, jsv.init_serving_state(CFG_WIDE, 3, 44, N_TOKENS,
                                                                   kv_bits=kv_bits))
    st = tsv.init_serving_state(CFG_WIDE, 3, 44, N_TOKENS, kv_bits=kv_bits)
    assert sorted(st) == sorted(sj)
    for key in sj:
        assert tuple(st[key].shape) == sj[key].shape and _dtype(st[key]) == _dtype(sj[key]), key
        np.testing.assert_array_equal(to_numpy_tree(st[key]), _f32(sj[key]))


def _random_state_and_rows(kv_bits, n_slots=3, S=44, P=32, Bp=2, seed=1):
    """A used state and a prefill group's rows, random, as numpy."""
    rng = np.random.RandomState(seed)
    L, Nkv, D = CFG_WIDE.text.num_layers, CFG_WIDE.text.num_kv_heads, CFG_WIDE.text.head_dim
    st = {"tok": rng.randint(0, 9000, n_slots).astype(np.int32),
          "pos": rng.randint(0, S, n_slots).astype(np.int32),
          "steps": rng.randint(0, N_TOKENS + 1, n_slots).astype(np.int32),
          "out": rng.randint(0, 9000, (n_slots, N_TOKENS)).astype(np.int32)}
    rows = {"tok": rng.randint(0, 9000, Bp).astype(np.int32),
            "valid": rng.randint(1, P + 1, Bp).astype(np.int32)}
    if kv_bits == 8:
        for name, shape in (("", (L, n_slots, Nkv, S, D)), ("_scale", (L, Nkv, 1, n_slots * S))):
            for kv in ("k", "v"):
                st[kv + name] = (rng.randint(-127, 128, shape).astype(np.int8) if not name
                                 else rng.rand(*shape).astype(np.float32))
        for kv in ("k", "v"):
            rows[kv] = rng.randint(-127, 128, (L, Bp, Nkv, P, D)).astype(np.int8)
            rows[kv + "_scale"] = rng.rand(L, Bp, Nkv, P).astype(np.float32)
    else:
        bf16 = ml_dtypes.bfloat16
        for kv in ("k", "v"):
            st[kv] = rng.randn(L, n_slots, Nkv, S, D).astype(bf16)
            rows[kv] = rng.randn(L, Bp, Nkv, P, D).astype(bf16)
    return st, rows


@pytest.mark.parametrize("kv_bits", [None, 8], ids=KV_IDS)
def test_admit_rows_serving_is_bit_identical_to_jax(kv_bits):
    st, rows = _random_state_and_rows(kv_bits)
    slots = np.array([2, 0], np.int32)
    want = jax.tree_util.tree_map(np.asarray, jsv.admit_rows_serving(
        jax.tree_util.tree_map(jnp.asarray, st), jax.tree_util.tree_map(jnp.asarray, rows),
        jnp.asarray(slots)))
    state = from_numpy_tree(st)
    got = tsv.admit_rows_serving(state, from_numpy_tree(rows), torch.from_numpy(slots))
    assert got is state  # written in place
    for key in want:
        assert _dtype(got[key]) == _dtype(want[key]), key
        np.testing.assert_array_equal(to_numpy_tree(got[key]), _f32(want[key]), err_msg=key)


@pytest.mark.parametrize("kv_bits", [None, 8], ids=KV_IDS)
def test_xla_decode_step_matches_jax(trees, kv_bits):
    """One step on the fused int8 tree with fp32 norms, in fp32, from a bf16
    or an int8 cache at three positions: the hidden state and the new K / V
    rows (bf16 by the contract) within TOL of JAX's (measured: at most
    3.5e-5). In bf16 the two packages round the int8 matmuls at other points
    (1.5% on the hidden state), which the decode test holds through ids."""
    jq, tq = trees["int8_fp32"]
    rng = np.random.RandomState(2)
    tcfg = CFG_WIDE.text
    L, Nkv, D, H = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim, tcfg.hidden_size
    M, S = 3, 40
    x = (rng.randn(M, H) * H ** 0.5 * 0.3).astype(np.float32)
    pos = np.array([5, 17, 39], np.int32)
    if kv_bits == 8:
        ck, cv = (rng.randint(-127, 128, (L, M, Nkv, S, D)).astype(np.int8) for _ in range(2))
        ks, vs = (rng.rand(L, Nkv, 1, M * S).astype(np.float32) * 0.02 for _ in range(2))
    else:
        ck, cv = ((rng.randn(L, M, Nkv, S, D) * 0.5).astype(ml_dtypes.bfloat16)
                  for _ in range(2))
        ks = vs = None
    j = jax.jit(lambda lm, *a: jsv.xla_decode_step(
        lm, tcfg, *a[:5], cache_k_scale=a[5], cache_v_scale=a[6], compute_dtype=jnp.float32))(
        jq["lm"], x, ck, cv, pos, pos + 1, ks, vs)
    t = lambda a: None if a is None else from_numpy_tree({"a": a})["a"]  # noqa: E731
    with torch.inference_mode():
        p = tsv.xla_decode_step(tq["lm"], tcfg, t(x), t(ck), t(cv), torch.from_numpy(pos),
                                torch.from_numpy(pos + 1), cache_k_scale=t(ks),
                                cache_v_scale=t(vs), compute_dtype=torch.float32)
    for a, b in zip(p, j):
        assert tuple(a.shape) == b.shape and _dtype(a) == _dtype(b) == "bfloat16"
        assert _rel(to_numpy_tree(a), _f32(b)) < TOL


@pytest.mark.parametrize("kv_bits", [None, 8], ids=KV_IDS)
def test_decode_steps_serving_matches_jax(trees, prefills, kv_bits):
    jq, tq = trees["int8"]
    rj, _, (ids, am, px, K) = prefills(kv_bits)
    S = ids.shape[1] + N_TOKENS
    slots = np.array([2, 0], np.int32)
    # one admitted state, JAX's prefill rows, for both packages
    st0 = jax.tree_util.tree_map(np.asarray, jsv.admit_rows_serving(
        jsv.init_serving_state(CFG_WIDE, 3, S, N_TOKENS, kv_bits=kv_bits),
        jax.tree_util.tree_map(jnp.asarray, rj), jnp.asarray(slots)))
    step = jax.jit(lambda p, st: jsv.decode_steps_serving(
        p, CFG_WIDE, st, n_steps=4, n_tokens=N_TOKENS, token_range=TOKEN_RANGE,
        compute_dtype=jnp.bfloat16, use_fused=False))
    sj = jax.tree_util.tree_map(jnp.asarray, st0)
    for _ in range(3):
        sj = step(jq, sj)
    sj = jax.tree_util.tree_map(np.asarray, sj)
    # the greedy margins of the same padded rows (JAX's unfused loop)
    ref_ids, ref_m = jax.jit(lambda p, i, x, k, a: jsv.generate_greedy(
        p, CFG_WIDE, i, pixel_values=x, intrinsic=k, attention_mask=a,
        max_new_tokens=N_TOKENS, token_range=TOKEN_RANGE, compute_dtype=jnp.bfloat16,
        use_fused_decode=False, return_margins=True))(jq, ids, px, K, am)
    assert_margin_rule(sj["out"][slots], np.asarray(ref_ids), np.asarray(ref_m))
    for use_fused in (False, True):
        state = from_numpy_tree(st0)
        with torch.inference_mode():
            for _ in range(3):
                out = tsv.decode_steps_serving(tq, CFG_WIDE, state, n_steps=4,
                                               n_tokens=N_TOKENS, token_range=TOKEN_RANGE,
                                               compute_dtype=torch.bfloat16,
                                               use_fused=use_fused)
        assert out is state
        st = to_numpy_tree(state)
        np.testing.assert_array_equal(st["out"][slots, 0], sj["out"][slots, 0])
        assert_margin_rule(st["out"][slots], sj["out"][slots], np.asarray(ref_m))
        for key in ("pos", "steps"):
            np.testing.assert_array_equal(st[key], sj[key])
        np.testing.assert_array_equal(st["steps"], N_TOKENS)
        np.testing.assert_array_equal(st["pos"][slots], np.minimum(am.sum(-1) + 12, S - 1))
        np.testing.assert_array_equal(st["out"][1], 0)  # the free slot wrote nothing
