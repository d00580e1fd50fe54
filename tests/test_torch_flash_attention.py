"""The port's flash attention (spatialvla_tpu_torch/ops/flash_attention.py)
against the JAX package on the CPU, at fp32, with inputs from a numpy seed.

* The port's plain forward (out and LSE) and plain backward (dq, dk, dv from
  the LSE and delta) against JAX's ``_attention_reference`` and its
  ``jax.vjp`` for each mask case: causal GQA with softcap, prefix + right
  padding, sliding window, window + prefix, lengths that are not a multiple
  of any tile, and a q_offset. Tolerance: atol 2e-5, rtol 1e-5 (fp32; the
  sums run in another order).
* One forward and one backward case against the Pallas kernels themselves
  (interpret mode, block 16, as tests/test_flash_attention.py runs them),
  LSE included, at the same tolerance.
* The ``torch.autograd.Function`` against ``torch.autograd`` through the
  port's ``attention_reference``: outputs and gradients, atol 2e-5.
* On the CPU each kernel wrapper takes its plain version and counts no
  launch.

Rows are compared where the query has at least one allowed key (every row
in these cases; ``allowed_rows`` checks it)."""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvla_tpu_torch.ops import flash_attention as tfa

# the JAX package's ops/__init__ re-exports the function under the module's name
jfa = importlib.import_module("spatialvla_tpu.ops.flash_attention")

torch.set_num_threads(2)

ATOL, RTOL = 2e-5, 1e-5

# name: (B, Tq, Tk, Nq, Nkv, D, softcap, window, prefix, valid, q_offset)
CASES = {
    "causal_gqa_softcap": (2, 24, 24, 4, 2, 16, 50.0, None, [0, 0], [24, 24], [0, 0]),
    "prefix_padding": (2, 24, 24, 4, 2, 32, 50.0, None, [10, 17], [24, 19], [0, 0]),
    "window": (2, 24, 24, 4, 1, 16, None, 5, [0, 0], [24, 24], [0, 0]),
    "window_prefix": (2, 24, 24, 4, 2, 16, 30.0, 6, [12, 3], [22, 24], [0, 0]),
    "ragged": (2, 37, 37, 6, 3, 16, 50.0, 11, [13, 0], [37, 30], [0, 0]),
    "q_offset": (2, 9, 29, 4, 2, 16, 50.0, 8, [5, 0], [29, 25], [20, 14]),
}


def _inputs(case, seed):
    B, Tq, Tk, Nq, Nkv, D, cap, window, prefix, valid, qoff = case
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Tq, Nq, D).astype(np.float32)
    k = rng.randn(B, Tk, Nkv, D).astype(np.float32)
    v = rng.randn(B, Tk, Nkv, D).astype(np.float32)
    do = rng.randn(B, Tq, Nq, D).astype(np.float32)
    lens = [np.asarray(x, np.int32) for x in (prefix, valid, qoff)]
    kw = dict(scale=D ** -0.5, logit_softcap=cap, window=window, causal=True)
    return (q, k, v, do), lens, kw


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jax_ref(arrays, lens, kw):
    q, k, v, do = (jnp.asarray(a) for a in arrays)
    lj = [jnp.asarray(x) for x in lens]
    f = lambda q, k, v: jfa._attention_reference(q, k, v, *lj, **kw)  # noqa: E731
    out, vjp = jax.vjp(f, q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(do)]


def _jax_lse(arrays, lens, kw):
    """LSE of the masked, softcapped logits, in JAX, (B, Nq, Tq, 1)."""
    q, k = jnp.asarray(arrays[0]), jnp.asarray(arrays[1])
    B, Tq, Nq, D = q.shape
    Tk, Nkv = k.shape[1], k.shape[2]
    s = jnp.einsum("btngd,bsnd->bngts", q.reshape(B, Tq, Nkv, Nq // Nkv, D), k) * kw["scale"]
    if kw["logit_softcap"] is not None:
        s = jnp.tanh(s / kw["logit_softcap"]) * kw["logit_softcap"]
    mask = tfa.attention_mask(*_t(*lens), Tq, Tk, window=kw["window"], causal=True).numpy()
    s = jnp.where(jnp.asarray(mask)[:, None, None], s, jfa.NEG_INF)
    lse = jax.scipy.special.logsumexp(s, axis=-1)
    return np.asarray(lse).reshape(B, Nq, Tq, 1)


def _assert_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_fwd_bwd_match_jax_reference(name):
    arrays, lens, kw = _inputs(CASES[name], seed=len(name))
    B, Tq, Tk = CASES[name][:3]
    prefix, valid, qoff = _t(*lens)
    assert tfa.allowed_rows(prefix, valid, qoff, Tq, Tk, window=kw["window"], causal=True).all()
    out_j, (dq_j, dk_j, dv_j) = _jax_ref(arrays, lens, kw)
    q, k, v, do = _t(*arrays)
    out, lse = tfa.flash_attention_fwd_plain(q, k, v, prefix, valid, qoff, **kw)
    _assert_close(out, out_j)
    _assert_close(lse, _jax_lse(arrays, lens, kw))
    _assert_close(tfa.attention_reference(q, k, v, prefix, valid, qoff, **kw), out_j)
    dq, dk, dv = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, prefix, valid, qoff, **kw)
    _assert_close(dq, dq_j)
    _assert_close(dk, dk_j)
    _assert_close(dv, dv_j)
    # the per-kernel plain versions take delta, as the kernels do
    delta = tfa.attention_delta(out, do)
    _assert_close(tfa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, prefix, valid, qoff,
                                                   **kw), dq_j)
    dk2, dv2 = tfa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, prefix, valid, qoff,
                                                 **kw)
    _assert_close(dk2, dk_j)
    _assert_close(dv2, dv_j)


@pytest.fixture(scope="module")
def interpret_case():
    """Pallas interpret mode at block 16 on a ragged case (37 rows: the JAX
    wrapper pads to 48, the port's kernels mask the edge)."""
    case = CASES["ragged"]
    arrays, lens, kw = _inputs(case, seed=7)
    return case, arrays, lens, kw


def test_fwd_against_pallas_interpret(interpret_case):
    case, arrays, lens, kw = interpret_case
    q, k, v, _ = (jnp.asarray(a) for a in arrays)
    out_p, lse_p = jfa._flash_attention_impl(
        q, k, v, *(jnp.asarray(x) for x in lens), kw["scale"], kw["logit_softcap"], kw["window"],
        True, 16, 16, interpret=True, with_lse=True)
    tq, tk, tv, _ = _t(*arrays)
    out, lse = tfa.flash_attention_fwd_plain(tq, tk, tv, *_t(*lens), **kw)
    _assert_close(out, out_p)
    _assert_close(lse, lse_p)


def test_bwd_against_pallas_interpret(interpret_case):
    case, arrays, lens, kw = interpret_case
    q, k, v, do = (jnp.asarray(a) for a in arrays)
    lj = [jnp.asarray(x) for x in lens]
    args = (kw["scale"], kw["logit_softcap"], kw["window"], True, 16, 16)
    out_p, lse_p = jfa._flash_attention_impl(q, k, v, *lj, *args, interpret=True, with_lse=True)
    dq_p, dk_p, dv_p = jfa._flash_attention_bwd_impl(q, k, v, out_p, lse_p, do, *lj, *args,
                                                     interpret=True)
    tq, tk, tv, tdo = _t(*arrays)
    out, lse = _t(out_p, lse_p)
    dq, dk, dv = tfa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, *_t(*lens), **kw)
    _assert_close(dq, dq_p)
    _assert_close(dk, dk_p)
    _assert_close(dv, dv_p)


@pytest.mark.parametrize("name", ["prefix_padding", "window_prefix", "q_offset"])
def test_autograd_function_matches_autograd_through_reference(name):
    arrays, lens, kw = _inputs(CASES[name], seed=11)
    prefix, valid, qoff = _t(*lens)
    grads = []
    for fn in (
        lambda q, k, v: tfa.flash_attention(q, k, v, prefix, valid, qoff, kw["scale"],
                                            kw["logit_softcap"], kw["window"], True),
        lambda q, k, v: tfa.attention_reference(q, k, v, prefix, valid, qoff, **kw),
    ):
        q, k, v, do = (t.requires_grad_(i < 3) for i, t in enumerate(_t(*arrays)))
        out = fn(q, k, v)
        out.backward(do)
        grads.append([out.detach(), q.grad, k.grad, v.grad])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=RTOL)


def test_wrappers_take_the_plain_version_on_the_cpu():
    arrays, lens, kw = _inputs(CASES["prefix_padding"], seed=3)
    q, k, v, do = _t(*arrays)
    lens_t = _t(*lens)
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    out, lse = tfa.flash_attention_fwd(q, k, v, *lens_t, **kw)
    ref_out, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, *lens_t, **kw)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    delta = tfa.attention_delta(out, do)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, *lens_t, **kw)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, *lens_t, **kw)
    ref = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, *lens_t, **kw)
    for a, b in zip((dq, dk, dv), ref):
        assert torch.equal(a, b)
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="window"):
        tfa._geometry("x", q, k, v, *lens_t, window=0)


# ---------------------------------------------------------------------------
# the backward's route and tile rules (twins of csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [16, 24, 32, 64, 144, 256, 272])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_bwd_route_twin(dtype, D):
    want = None
    if D % 16 == 0 and 16 <= D <= 256:
        want = {torch.bfloat16: "mma", torch.float32: "fma"}.get(dtype)
    assert tfa.bwd_route(dtype, D) == want


@pytest.mark.parametrize("D", [16, 24, 32, 64, 144, 256, 272])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_fwd_route_twin(dtype, D):
    """The forward takes the backward's rule: bf16 -> "mma", fp32 -> "fma"."""
    want = None
    if D % 16 == 0 and 16 <= D <= 256:
        want = {torch.bfloat16: "mma", torch.float32: "fma"}.get(dtype)
    assert tfa.fwd_route(dtype, D) == want


@pytest.mark.parametrize("B,T,Nkv,G,want", [(2, 320, 4, 2, 2), (2, 2048, 4, 2, 1),
                                             (1, 320, 1, 16, 8), (2, 320, 4, 1, 1)])
def test_bwd_split_fills_a_wave(B, T, Nkv, G, want):
    """On 132 SMs at the training shape (B=2, 4 kv heads, groups of 2) the
    80 dk/dv blocks of 32 keys become 160 in clusters of 2; T=2048 fills
    the card without; clusters stop at 8."""
    assert tfa.bwd_split(B, T, Nkv, G, 132) == want


# name: (B, T, prefix, valid, window) of the training path, T=2048 and the flash prefill
TILE_CASES = {
    "path_global": (2, 320, [277, 277], [320, 301], None),
    "path_window": (2, 320, [277, 277], [320, 301], 4096),
    "T2048_window": (2, 2048, [256, 256], [2048, 1900], 4096),
    # the flash prefill (B=1, 277 tokens, all of them prefix), both layer kinds
    "prefill_window": (1, 277, [277], [277], 4096),
    "prefill_global": (1, 277, [277], [277], None),
    # a window shorter than T, where whole tiles left of the window die
    "T2048_window300": (2, 2048, [256, 256], [2048, 1900], 300),
}


def _tile_case(name):
    if name in CASES:
        B, Tq, Tk, _, _, _, _, window, prefix, valid, qoff = CASES[name]
    else:
        B, Tq, prefix, valid, window = TILE_CASES[name]
        Tk, qoff = Tq, [0] * B
    lens = [torch.tensor(x, dtype=torch.int32) for x in (prefix, valid, qoff)]
    return lens, Tq, Tk, window


def _check_dead_tiles(name, block_q, block_k):
    lens, Tq, Tk, window = _tile_case(name)
    dead = tfa.dead_tiles(*lens, Tq, Tk, block_q, block_k, window=window, causal=True)
    mask = tfa.attention_mask(*lens, Tq, Tk, window=window, causal=True)
    nq, nk = -(-Tq // block_q), -(-Tk // block_k)
    assert dead.shape == (mask.shape[0], nq, nk)
    padded = torch.nn.functional.pad(mask, (0, nk * block_k - Tk, 0, nq * block_q - Tq))
    live = padded.reshape(-1, nq, block_q, nk, block_k).any(4).any(2)
    assert not (dead & live).any()
    q_end = lens[2].long()[:, None, None] + torch.arange(nq)[None, :, None] * block_q + block_q - 1
    above = torch.arange(nk)[None, None, :] * block_k > q_end
    assert dead[above & ~live].all()


@pytest.mark.parametrize("name", list(CASES) + list(TILE_CASES))
def test_dead_tiles_hold_no_allowed_pair(name):
    """A tile the backward kernels skip (32 q rows x 32 keys, the dq and
    dk/dv kernels' tiles) holds no (q, k) pair that attention_mask allows;
    and every empty tile above the diagonal (all keys past its last q row)
    is skipped."""
    _check_dead_tiles(name, tfa.BWD_TILE, tfa.BWD_TILE)


@pytest.mark.parametrize("name", list(CASES) + list(TILE_CASES))
@pytest.mark.parametrize("rows", [tfa.FWD_WARP_ROWS, tfa.FWD_ROWS])
def test_fwd_dead_tiles_hold_no_allowed_pair(name, rows):
    """The tensor-core forward's tiles: 32 keys against a warp's 16 q rows
    (the warp skips such a tile) and against a block's 64 rows (the block
    skips it)."""
    _check_dead_tiles(name, rows, tfa.BWD_TILE)
