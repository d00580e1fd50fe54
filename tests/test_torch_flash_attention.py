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
