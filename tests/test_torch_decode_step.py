"""The port's decode step (its kernels' plain versions, as the wrappers run
them on the CPU) against the Pallas fused_decode_step in interpret mode, on
the config of tests/test_decode_step.py: the int8, int4, int8 + int4 MLP and
grouped-int4 serving trees, each with a bf16 and an int8 KV cache, batch 1
and 3 at one position, and 3 rows at per-row positions; and a chained
3-step decode on the int8 cache that must emit JAX's greedy ids. Tolerances
are those of tests/test_decode_step.py (hidden atol 0.06 / rtol 0.02, new
k/v atol 0.02)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvla_tpu.config import Gemma2Config
from spatialvla_tpu.models import gemma2 as j_gemma2
from spatialvla_tpu.ops.decode_step import fused_decode_step as j_fused_decode_step
from spatialvla_tpu.ops.quant import qmatmul as j_qmatmul
from spatialvla_tpu.ops.quant import quantize_kv as j_quantize_kv
from spatialvla_tpu.ops.quant import quantize_lm_params as j_quantize_lm_params
from spatialvla_tpu_torch.convert import from_numpy_tree
from spatialvla_tpu_torch.models.spatialvla import _scatter_scale
from spatialvla_tpu_torch.ops import decode_step as t_ds
from spatialvla_tpu_torch.ops import quant as t_quant

torch.set_num_threads(2)

CFG = Gemma2Config(
    vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=4,
    num_heads=4, num_kv_heads=2, head_dim=32, sliding_window=512,
    query_pre_attn_scalar=32.0,
)


FORMATS = {"int8": dict(bits=8), "int4": dict(bits=4), "int8+mlp4": dict(bits=8, mlp_bits=4),
           "int4-g16": dict(bits=4, group_size=16)}


@pytest.fixture(scope="module")
def base_params():
    params = j_gemma2.init_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)
    for i, k in enumerate(["input_norm", "post_attn_norm", "pre_ffn_norm", "post_ffn_norm"]):
        params["layers"][k] = 0.1 * jax.random.normal(
            jax.random.PRNGKey(i + 1), params["layers"][k].shape)
    params["final_norm"] = 0.1 * jax.random.normal(jax.random.PRNGKey(9), (CFG.hidden_size,))
    return params


def _trees(params, fmt):
    q = j_quantize_lm_params(params, fuse=True, **FORMATS[fmt])
    return q, from_numpy_tree(jax.tree_util.tree_map(np.asarray, q))


@pytest.fixture(scope="module")
def qparams(base_params):
    return _trees(base_params, "int8")


def _serving_cache(qp, B, P, Smax, seed):
    """A prefilled JAX cache in serving layout (L, B, Nkv, S, D), and the
    next token's scaled embedding."""
    rng = np.random.RandomState(seed)
    embeds = jnp.asarray(rng.randn(B, P, CFG.hidden_size).astype(np.float32)).astype(jnp.bfloat16)
    cache = j_gemma2.init_cache(CFG, B, Smax, dtype=jnp.bfloat16)
    mask = jnp.broadcast_to(jnp.arange(Smax) < P, (B, 1, P, Smax))
    _, cache = j_gemma2.forward(qp, CFG, embeds, jnp.arange(1, P + 1)[None], mask,
                                cache=cache, cache_position=0)
    x = jnp.asarray(rng.randn(B, CFG.hidden_size).astype(np.float32)).astype(jnp.bfloat16)
    x = x * jnp.asarray(CFG.hidden_size ** 0.5, dtype=jnp.bfloat16)
    return (x, jnp.transpose(cache["k"], (0, 1, 3, 2, 4)),
            jnp.transpose(cache["v"], (0, 1, 3, 2, 4)))


def _torch(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(torch.bfloat16)


def _compare(port, ref):
    (h_t, k_t, v_t), (h_j, k_j, v_j) = port, ref
    f = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    np.testing.assert_allclose(h_t.float().numpy(), f(h_j), atol=0.06, rtol=0.02)
    np.testing.assert_allclose(k_t.float().numpy(), f(k_j), atol=0.02)
    np.testing.assert_allclose(v_t.float().numpy(), f(v_j), atol=0.02)
    assert h_t.dtype == k_t.dtype == v_t.dtype == torch.bfloat16


def _kv8(ck, cv):
    """The int8 cache of both packages: JAX's codes and scales, and the same
    numbers as tensors (codes int8, scales f32 in the (L, M, Nkv, S) layout)."""
    (ck8, ks), (cv8, vs) = j_quantize_kv(ck), j_quantize_kv(cv)
    jkw = dict(cache_k_scale=ks, cache_v_scale=vs)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return (ck8, cv8, jkw), (t(ck8), t(cv8), dict(cache_k_scale=t(ks), cache_v_scale=t(vs)))


def _run_both(jq, tq, x, ck, cv, pos, kv8):
    """JAX's Pallas step (interpret mode) and the port's step on the same
    cache, bf16 or int8."""
    jpos = jnp.asarray(pos, jnp.int32)
    tpos = torch.as_tensor(np.asarray(pos), dtype=torch.int32)
    if kv8:
        (jck, jcv, jkw), (tck, tcv, tkw) = _kv8(ck, cv)
    else:
        jck, jcv, jkw = ck, cv, {}
        tck, tcv, tkw = _torch(ck), _torch(cv), {}
    ref = j_fused_decode_step(jq, CFG, x, jck, jcv, jpos, jpos + 1, interpret=True, **jkw)
    port = t_ds.fused_decode_step(tq, CFG, _torch(x), tck, tcv, tpos, tpos + 1, **tkw)
    return port, ref, (tq, _torch(x), tck, tcv, tpos, tkw)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("kv8", [False, True], ids=["bf16kv", "kv8"])
def test_decode_step_matches_pallas(base_params, B, fmt, kv8):
    jq, tq = _trees(base_params, fmt)
    P, Smax = 6, 16
    x, ck, cv = _serving_cache(jq, B, P, Smax, seed=B)
    port, ref, (tq, tx, tck, tcv, tpos, tkw) = _run_both(jq, tq, x, ck, cv, [P] * B, kv8)
    _compare(port, ref)
    # the wrappers on CPU tensors are the plain versions: same bits
    plain = t_ds.fused_decode_step_plain(tq, CFG, tx, tck, tcv, tpos, tpos + 1, **tkw)
    for a, b in zip(port, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("kv8", [False, True], ids=["bf16kv", "kv8"])
def test_decode_step_per_row_positions(base_params, fmt, kv8):
    jq, tq = _trees(base_params, fmt)
    lens, Smax = [6, 4, 5], 16
    rows = [_serving_cache(jq, 1, p, Smax, seed=20 + i) for i, p in enumerate(lens)]
    x, ck, cv = (jnp.concatenate([r[i] for r in rows], axis=i and 1) for i in range(3))
    port, ref, _ = _run_both(jq, tq, x, ck, cv, lens, kv8)
    _compare(port, ref)


def test_decode_step_rejects_unported_formats(qparams):
    """The int8 cache is ported: its scales in the (L, M, Nkv, S) layout and
    in the flat (L, Nkv, 1, M*S) layout give the same step, and a cache
    without scales, or scales of another shape, is refused."""
    _, tq = qparams
    M, S = 2, 8
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(M, CFG.hidden_size).astype(np.float32)).to(torch.bfloat16)
    cache = torch.from_numpy(rng.randint(-127, 128, (CFG.num_layers, M, CFG.num_kv_heads, S,
                                                     CFG.head_dim)).astype(np.int8))
    sc = torch.from_numpy(rng.rand(CFG.num_layers, M, CFG.num_kv_heads, S).astype(np.float32))
    a = t_ds.fused_decode_step(tq, CFG, x, cache, cache, 3, 4, cache_k_scale=sc, cache_v_scale=sc)
    flat = t_ds.flatten_kv_scales(sc)
    assert flat.shape == (CFG.num_layers, CFG.num_kv_heads, 1, M * S)
    b = t_ds.fused_decode_step(tq, CFG, x, cache, cache, 3, 4, cache_k_scale=flat,
                               cache_v_scale=flat)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="per-slot"):
        t_ds.fused_decode_step(tq, CFG, x, cache, cache, 2, 3)
    with pytest.raises(ValueError, match="expected"):
        t_ds.fused_decode_step(tq, CFG, x, cache, cache, 2, 3, cache_k_scale=sc[:, :1],
                               cache_v_scale=sc[:, :1])


def test_chained_int8_kv_decode_matches_jax_ids(qparams):
    """Three chained steps on the int8 cache (quantized prefill cache, each
    step's new rows quantized and written with their scales), as
    tests/test_decode_step.py:271-330 runs JAX's: the same greedy ids."""
    jq, tq = qparams
    B, P, Smax = 1, 5, 16
    x, ck, cv = _serving_cache(jq, B, P, Smax, seed=3)
    head, emb = jq["lm_head"], jq["embed"]
    normalizer = jnp.asarray(CFG.hidden_size ** 0.5, dtype=jnp.bfloat16)

    (jck, jcv, jkw), (tck, tcv, tkw) = _kv8(ck, cv)
    jks, jvs = jkw["cache_k_scale"], jkw["cache_v_scale"]
    tks, tvs = (t_ds.flatten_kv_scales(tkw[k]) for k in ("cache_k_scale", "cache_v_scale"))
    tok_j = tok_t = jnp.argmax(j_qmatmul(x / normalizer, head), axis=-1)
    toks_j, toks_t = [int(tok_j[0])], [int(tok_t[0])]
    theads = from_numpy_tree(jax.tree_util.tree_map(np.asarray, {"h": head}))["h"]
    for t in range(3):
        e = jnp.take(emb, tok_j, axis=0).astype(jnp.bfloat16)
        h_j, k_new, v_new = j_fused_decode_step(jq, CFG, e * normalizer, jck, jcv,
                                                jnp.int32(P + t), jnp.int32(P + t + 1),
                                                cache_k_scale=jks, cache_v_scale=jvs,
                                                interpret=True)
        k8, ks_new = j_quantize_kv(k_new)
        v8, vs_new = j_quantize_kv(v_new)
        jck = jax.lax.dynamic_update_slice(jck, k8[:, :, :, None, :], (0, 0, 0, P + t, 0))
        jcv = jax.lax.dynamic_update_slice(jcv, v8[:, :, :, None, :], (0, 0, 0, P + t, 0))
        jks = jax.lax.dynamic_update_slice(jks, ks_new[:, :, :, None], (0, 0, 0, P + t))
        jvs = jax.lax.dynamic_update_slice(jvs, vs_new[:, :, :, None], (0, 0, 0, P + t))
        tok_j = jnp.argmax(j_qmatmul(h_j, head), axis=-1)
        toks_j.append(int(tok_j[0]))

        te = _torch(jnp.take(emb, jnp.asarray(toks_t[-1:]), axis=0)) * _torch(normalizer)
        h_t, k_t, v_t = t_ds.fused_decode_step(tq, CFG, te, tck, tcv, P + t, P + t + 1,
                                               cache_k_scale=tks, cache_v_scale=tvs)
        k8t, ks_t = t_quant.quantize_kv(k_t)
        v8t, vs_t = t_quant.quantize_kv(v_t)
        tck[:, :, :, P + t] = k8t
        tcv[:, :, :, P + t] = v8t
        _scatter_scale(tks, ks_t, P + t, Smax)
        _scatter_scale(tvs, vs_t, P + t, Smax)
        toks_t.append(int(torch.argmax(t_quant.qmatmul(h_t, theads), dim=-1)[0]))
    assert toks_t == toks_j



def _split_attention(qkv, cos, sin, ck, cv, position, *, num_heads, q_scale, cap, chunk,
                     ks=None, vs=None):
    """The chunk-and-merge arithmetic of csrc/decode.cu:decode_attention_kernel
    in torch: per chunk of `chunk` slots a local max, a local sum and a
    partial p @ V with p = bf16(exp(l - local max) [* V scale]); the merge
    rescales each partial by exp(local max - global max) in chunk order and
    adds the self term. Returns attn_out (M, Nq D) bf16."""
    M, Nkv, S, D = ck.shape
    G, NqD, NkvD = num_heads // Nkv, num_heads * D, Nkv * D
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    f = qkv.float()
    c, s = bf(cos)[:, None, :], bf(sin)[:, None, :]
    k = t_ds._rope(f[:, NqD: NqD + NkvD].reshape(M, Nkv, D), c, s)
    v = f[:, NqD + NkvD:].reshape(M, Nkv, D)
    q16 = bf(t_ds._rope(f[:, :NqD].reshape(M, num_heads, D), c, s) * q_scale).reshape(M, Nkv, G, D)
    logits = torch.einsum("mhgd,mhsd->mhgs", q16, ck.float())
    if ks is not None:
        logits = logits * t_ds._slot_scales(ks, M, S)
    logits = t_ds._softcap(logits, cap)
    self_l = t_ds._softcap((q16 * bf(k)[:, :, None, :]).sum(-1), cap)  # (M, Nkv, G)
    vsc = None if vs is None else t_ds._slot_scales(vs, M, S)
    out = torch.empty(M, Nkv, G, D)
    for m in range(M):
        pos = int(position[m])
        parts = []  # (local max, local sum, partial p @ V) per live chunk
        for t0 in range(0, max(pos, 1), chunk):
            t1 = min(t0 + chunk, pos)
            if t1 <= t0:  # chunk 0 of an empty cache
                parts.append((torch.full((Nkv, G), -float("inf")), torch.zeros(Nkv, G),
                              torch.zeros(Nkv, G, D)))
                continue
            lg = logits[m, :, :, t0:t1]
            mx = lg.amax(-1)
            e = torch.exp(lg - mx[..., None])
            p = bf(e if vsc is None else e * vsc[m, :, :, t0:t1])
            parts.append((mx, e.sum(-1), torch.einsum("hgs,hsd->hgd", p, cv[m, :, t0:t1].float())))
        gmx = self_l[m]
        for mx, _, _ in parts:
            gmx = torch.maximum(gmx, mx)
        den = torch.zeros(Nkv, G)
        acc = torch.zeros(Nkv, G, D)
        for mx, se, o in parts:
            w = torch.exp(mx - gmx)
            den = den + se * w
            acc = acc + w[..., None] * o
        e_self = torch.exp(self_l[m] - gmx)
        den = den + e_self
        out[m] = acc / den[..., None] + bf(e_self / den)[..., None] * v[m][:, None, :]
    return out.reshape(M, NqD).to(torch.bfloat16)


@pytest.mark.parametrize("kv8", [False, True], ids=["bf16kv", "kv8"])
@pytest.mark.parametrize("M,S,positions", [
    (1, 278, [270]),                      # the serving path at batch 1
    (2, 278, [266, 259]),                 # predict_batch's per-row positions
    (3, 100, [0, 64, 100]),               # empty, on a chunk boundary, every slot
    (16, 332, list(range(300, 316))),     # the decode-step matrix
])
def test_split_attention_merge_holds_to_plain(M, S, positions, kv8):
    """The split kernel's merge algebra and its rounding point (bf16 p
    relative to each chunk's max, times the V scale on the int8 cache) hold
    to decode_attention_plain within the kernels' bound, 1e-2 of max|plain|,
    at the chunk size the kernel uses; the flagship's heads (8 / 4, D = 256)."""
    Nq, Nkv, D = 8, 4, 256
    rng = np.random.RandomState(7 + M)
    qkv = torch.from_numpy(rng.randn(M, (Nq + 2 * Nkv) * D).astype(np.float32)).to(torch.bfloat16)
    ck, cv = (torch.from_numpy(0.3 * rng.randn(M, Nkv, S, D).astype(np.float32)).to(torch.bfloat16)
              for _ in range(2))
    position = torch.tensor(positions, dtype=torch.int32)
    cos, sin = t_ds.rope_tables(position + 1, D, 10000.0)
    kw = dict(num_heads=Nq, q_scale=D ** -0.5, cap=50.0)
    if kv8:
        flat = lambda sc: sc.permute(1, 0, 2).reshape(Nkv, 1, M * S).contiguous()  # noqa: E731
        (ck, ks), (cv, vs) = t_quant.quantize_kv(ck), t_quant.quantize_kv(cv)
        kw.update(ks=flat(ks), vs=flat(vs))
    bufs = dict(attn_out=torch.empty(M, Nq * D, dtype=torch.bfloat16),
                k_new=torch.empty(M, Nkv, D, dtype=torch.bfloat16),
                v_new=torch.empty(M, Nkv, D, dtype=torch.bfloat16))
    t_ds.decode_attention_plain(qkv, cos, sin, ck, cv, position, **kw, **bufs)
    split = _split_attention(qkv, cos, sin, ck, cv, position, chunk=t_ds.attention_chunk(M, Nkv, S), **kw)
    ref = bufs["attn_out"].float()
    assert ((split.float() - ref).abs().max() / ref.abs().max()).item() < 1e-2


# ---------------------------------------------------------------------------
# the residual kernels' plain version and the step's route by shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 3])
@pytest.mark.parametrize("fmt", ["int8", "int4", "int4-g16", "int4-g8"])
def test_residual_plain_is_norm_residual_then_rmsnorm_matvec(base_params, M, fmt):
    """The residual kernels' plain version is norm_residual_plain followed by
    rmsnorm_matvec_plain, bit for bit (h_out and the output), and leaves
    h_in as it was; the wrapper on CPU tensors is that plain version."""
    qkw = dict(FORMATS.get(fmt, dict(bits=4, group_size=8)))
    tq = t_quant.quantize_lm_params(from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, base_params), dtype=torch.bfloat16), **qkw)
    w = tq["layers"]["mlp"]["gate_up"]
    post, norm = tq["layers"]["post_attn_norm"][1], tq["layers"]["pre_ffn_norm"][1]
    rng = np.random.RandomState(M)
    h_in = torch.from_numpy(8 * rng.randn(M, CFG.hidden_size).astype(np.float32))
    upd = torch.from_numpy(rng.randn(M, CFG.hidden_size).astype(np.float32)).to(torch.bfloat16)
    keep = h_in.clone()
    h_ref = h_in.clone()
    t_ds.norm_residual_plain(h_ref, upd, post, eps=1e-6)
    want = t_quant.rmsnorm_matvec_plain(h_ref, norm, w["qt"][1], w["scale"][1], eps=1e-6)
    for fn in (t_quant.residual_rmsnorm_matvec_plain, t_quant.residual_rmsnorm_matvec):
        h_out = torch.full_like(h_in, float("nan"))
        got = fn(h_in, upd, post, norm, w["qt"][1], w["scale"][1], eps=1e-6, h_out=h_out)
        assert torch.equal(h_out, h_ref) and torch.equal(got, want)
        assert torch.equal(h_in, keep)


class _Recorder:
    """An ops namespace of the decode step that counts each op's calls (the
    routes aside; ``gelu``: the calls with the gelu epilogue) and runs the
    plain version."""

    def __init__(self):
        self.calls, self.gelu = {}, {}
        for name in vars(t_ds.PLAIN):
            setattr(self, name, self._counted(name, getattr(t_ds.PLAIN, name)))

    def _counted(self, name, fn):
        def call(*args, **kw):
            if not name.endswith("_route"):
                self.calls[name] = self.calls.get(name, 0) + 1
            if kw.get("gelu"):
                self.gelu[name] = self.gelu.get(name, 0) + 1
            return fn(*args, **kw)
        return call


def _check_step_ops(rec, n_fold, gelu_op):
    """The ops of one step on CFG's L layers: ``n_fold`` residual kernels, a
    norm_residual with the next norm's x' + matvec for every other residual
    update, layer 0's rmsnorm_matvec, o and down, the final norm_residual;
    gate|up's gelu·up in the epilogue of ``gelu_op`` once a layer, or (None)
    gelu_mul. 5 L + 1 ops with every update folded and the epilogue, 7 L with
    none folded."""
    L = CFG.num_layers
    n_pair = 2 * L - 1 - n_fold
    assert rec.calls.get("residual_rmsnorm_matvec", 0) == n_fold
    assert rec.calls["norm_residual"] == n_pair + 1
    assert rec.calls["rmsnorm_matvec"] == 1
    assert rec.calls["matvec"] == 2 * L + n_pair
    assert rec.calls["attention"] == L
    assert rec.calls.get("gelu_mul", 0) == (0 if gelu_op else L)
    assert rec.gelu == ({gelu_op: L} if gelu_op else {})
    assert sum(rec.calls.values()) == 5 * L + 1 + n_pair + (0 if gelu_op else L)


@pytest.mark.parametrize("M", [1, 2, 4])
@pytest.mark.parametrize("fmt,folds", [("int8", (True, True)), ("int8+mlp4", (True, True)),
                                       ("int4-g16", (True, True)), ("int4-g8", (False, False))])
def test_step_folds_the_residual_update_by_shape(base_params, M, fmt, folds):
    """The step takes the residual kernel for qkv (from layer 1 on) and for
    gate|up where ``residual_route`` takes the weight, with gelu(gate) * up
    in gate|up's epilogue where ``gelu_route`` takes it: 5 ops a layer and
    the final norm_residual, 5 L + 1 in all; a weight it refuses (int4 in
    8-column groups) gets norm_residual with the next norm's x' + matvec in
    its place, and gate|up then gelu_mul. Either way the step holds to the
    Pallas kernel (interpret mode), at 1, 2 and 4 rows."""
    qkw = FORMATS.get(fmt, dict(bits=4, group_size=8))
    jq = j_quantize_lm_params(base_params, fuse=True, **qkw)
    tq = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jq))
    x, ck, cv = _serving_cache(jq, M, 6, 16, seed=5)
    tpos = torch.full((M,), 6, dtype=torch.int32)
    w = tq["layers"]
    h = torch.zeros(M, CFG.hidden_size)
    assert (t_quant.residual_route(h, w["attn"]["qkv"]["qt"][0], w["attn"]["qkv"]["scale"][0]),
            t_quant.residual_route(h, w["mlp"]["gate_up"]["qt"][0],
                                   w["mlp"]["gate_up"]["scale"][0])) == folds
    assert t_quant.gelu_route(h, w["mlp"]["gate_up"]["qt"][0],
                              w["mlp"]["gate_up"]["scale"][0]) == folds[1]
    rec = _Recorder()
    port = t_ds._step(rec, tq, CFG, _torch(x), _torch(ck), _torch(cv), tpos, tpos + 1, None, None)
    L = CFG.num_layers
    _check_step_ops(rec, (L - 1) * folds[0] + L * folds[1],
                    "residual_rmsnorm_matvec" if folds[1] else None)
    jpos = jnp.full((M,), 6, jnp.int32)
    ref = j_fused_decode_step(jq, CFG, x, ck, cv, jpos, jpos + 1, interpret=True)
    _compare(port, ref)


def test_residual_route_rules():
    """residual_route: at most 4 rows and K <= 4096, 16-byte aligned x and
    weight, int8 K a multiple of 16, int4 K / 2 a multiple of 16 in groups of
    a multiple of 16 columns or per channel."""
    K = 64
    x = torch.zeros(5, K)
    q8 = t_quant.quantize_int8(torch.randn(K, 40))
    q4 = t_quant.quantize_int4(torch.randn(K, 40))
    g16 = t_quant.quantize_int4(torch.randn(K, 40), group_size=16)
    g8 = t_quant.quantize_int4(torch.randn(K, 40), group_size=8)
    route = lambda x, w: t_quant.residual_route(x, w["qt"], w["scale"])  # noqa: E731
    assert route(x[:4], q8) and route(x[:1], q4) and route(x[:4], g16)
    assert not route(x, q8) and not route(x, q4) and not route(x[:2], g8)
    assert route(torch.zeros(4, 4096), t_quant.quantize_int8(torch.randn(4096, 8)))
    assert not route(torch.zeros(1, 4112), t_quant.quantize_int8(torch.randn(4112, 8)))
    assert not route(x.reshape(-1)[1:1 + 4 * K].reshape(4, K), q8)  # x 4 bytes off
    k48 = t_quant.quantize_int4(torch.randn(48, 40))  # K / 2 = 24
    assert route(torch.zeros(1, 48), t_quant.quantize_int8(torch.randn(48, 40)))
    assert not route(torch.zeros(1, 48), k48)


def test_gelu_route_rules():
    """gelu_route: the few-row kernel's operands (at most 16 rows, 16-byte
    aligned x and weight, int8 K a multiple of 16, int4 K / 2 a multiple of
    16 per channel or in groups of a multiple of 16 columns) and gate | up
    rows in pairs (N even)."""
    K = 64
    x = torch.zeros(17, K)
    q8 = t_quant.quantize_int8(torch.randn(K, 40))
    q4 = t_quant.quantize_int4(torch.randn(K, 40))
    g16 = t_quant.quantize_int4(torch.randn(K, 40), group_size=16)
    g8 = t_quant.quantize_int4(torch.randn(K, 40), group_size=8)
    route = lambda x, w: t_quant.gelu_route(x, w["qt"], w["scale"])  # noqa: E731
    assert route(x[:16], q8) and route(x[:1], q4) and route(x[:8], g16) and route(x[:5], q4)
    assert not route(x, q8) and not route(x, q4) and not route(x[:2], g8)
    assert not route(x[:1], t_quant.quantize_int8(torch.randn(K, 41)))  # N odd
    assert not route(x.reshape(-1)[1:1 + 4 * K].reshape(4, K), q8)  # x 4 bytes off
    assert not route(torch.zeros(1, 48), t_quant.quantize_int4(torch.randn(48, 40)))  # K/2 = 24
    assert route(torch.zeros(1, 4608), t_quant.quantize_int8(torch.randn(4608, 8)))


@pytest.mark.parametrize("M", [1, 5])
@pytest.mark.parametrize("fmt", ["int8", "int4", "int4-g16", "int4-g8"])
def test_norm_residual_with_next_norm_then_matvec_is_the_pair(base_params, M, fmt):
    """norm_residual_plain writing the next norm's x' (final_w, final_out)
    followed by matvec_plain on x' (the step above 4 rows and for weights
    the residual kernels refuse) gives the h and the output of
    norm_residual_plain followed by rmsnorm_matvec_plain on h (the pair it
    replaces). On the CPU both norm h in one fp32 order, so the two agree bit
    for bit; on the card the order of the sum of squares moves from the
    matvec's prologue into norm_residual (held there within 1e-2)."""
    qkw = dict(FORMATS.get(fmt, dict(bits=4, group_size=8)))
    tq = t_quant.quantize_lm_params(from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, base_params), dtype=torch.bfloat16), **qkw)
    w = tq["layers"]["mlp"]["gate_up"]
    post, norm = tq["layers"]["post_attn_norm"][2], tq["layers"]["pre_ffn_norm"][2]
    rng = np.random.RandomState(10 + M)
    h0 = torch.from_numpy(8 * rng.randn(M, CFG.hidden_size).astype(np.float32))
    upd = torch.from_numpy(rng.randn(M, CFG.hidden_size).astype(np.float32)).to(torch.bfloat16)
    h_pair, h_new = h0.clone(), h0.clone()
    t_ds.norm_residual_plain(h_pair, upd, post, eps=1e-6)
    want = t_quant.rmsnorm_matvec_plain(h_pair, norm, w["qt"][2], w["scale"][2], eps=1e-6)
    xn = torch.full((M, CFG.hidden_size), float("nan"), dtype=torch.bfloat16)
    t_ds.norm_residual(h_new, upd, post, eps=1e-6, final_w=norm, final_out=xn)
    got = t_quant.matvec(xn, w["qt"][2], w["scale"][2])
    assert torch.equal(h_new, h_pair) and torch.equal(got, want)


@pytest.mark.parametrize("slot_kind", ["int", "tensor"])
def test_scatter_scale_int_and_device_slots(slot_kind):
    """_scatter_scale writes row m's new scales at flat column m * S +
    slot[m], the slot a Python int (unpadded rows) or a (B,) tensor (per-row
    slots), with the columns computed on the scales' device."""
    L, B, Nkv, S = 2, 3, 2, 7
    rng = np.random.RandomState(1)
    sc = torch.from_numpy(rng.rand(L, Nkv, 1, B * S).astype(np.float32))
    new = torch.from_numpy(rng.rand(L, B, Nkv).astype(np.float32))
    slots = 4 if slot_kind == "int" else torch.tensor([1, 5, 6], dtype=torch.int32)
    want = sc.clone()
    for m in range(B):
        s = slots if slot_kind == "int" else int(slots[m])
        want[:, :, 0, m * S + s] = new[:, m]
    got = _scatter_scale(sc.clone(), new, slots, S)
    assert torch.equal(got, want)


@pytest.mark.parametrize("B", [t_quant.RESIDUAL_MAX_M + 1, 8, 16])
def test_step_keeps_the_pair_above_four_rows(qparams, B):
    """Above RESIDUAL_MAX_M rows (where the residual kernels lose on the
    card) the step runs the pair norm_residual, writing the next norm's x',
    + the plain matvec on x' twice a layer (never rmsnorm_matvec on h after
    layer 0), gate|up with gelu(gate) * up in its epilogue: 7 ops a layer, 6
    in layer 0 and the final norm_residual (7 L); the same ops through the
    plain versions hold to the Pallas kernel (interpret mode) at 5, 8 and 16
    rows."""
    jq, tq = qparams
    x, ck, cv = _serving_cache(jq, B, 6, 16, seed=8)
    tpos = torch.full((B,), 6, dtype=torch.int32)
    rec = _Recorder()
    port = t_ds._step(rec, tq, CFG, _torch(x), _torch(ck), _torch(cv), tpos, tpos + 1, None, None)
    _check_step_ops(rec, 0, "matvec")
    assert sum(rec.calls.values()) == 7 * CFG.num_layers
    jpos = jnp.full((B,), 6, jnp.int32)
    _compare(port, j_fused_decode_step(jq, CFG, x, ck, cv, jpos, jpos + 1, interpret=True))
