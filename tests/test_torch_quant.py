"""The port's int8 / int4 quantization and its matvec kernels' plain
versions against the JAX package on the CPU: codes and scales bit-identical
(int8, int4 per channel and grouped, the LM and vision trees in every format,
the int8 KV cache), the plain q8_* / q4_* matvecs against the Pallas kernels
run in interpret mode (fp32 out, atol 1e-4 * max|ref|), and the
dequantize-matmul branch of qmatmul against JAX's XLA branch. The kernels
themselves are held to these plain versions on an NVIDIA GPU by
test_torch_cuda_kernels.py."""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvla_tpu.config import Gemma2Config, spatialvla_tiny
from spatialvla_tpu.models import gemma2 as j_gemma2
from spatialvla_tpu.models import spatialvla as j_spatialvla
from spatialvla_tpu.ops import quant as jq
from spatialvla_tpu_torch.convert import from_numpy_tree, to_numpy_tree
from spatialvla_tpu_torch.ops import quant as tq

torch.set_num_threads(2)


def _assert_tree_equal(port_tree, jax_tree):
    flat_j, def_j = jax.tree_util.tree_flatten(jax.tree_util.tree_map(np.asarray, jax_tree))
    flat_t, def_t = jax.tree_util.tree_flatten(to_numpy_tree(port_tree))
    assert def_j == def_t
    for a, b in zip(flat_t, flat_j):
        assert a.shape == b.shape
        if b.dtype == np.int8:
            assert a.dtype == np.int8
        np.testing.assert_array_equal(a, np.asarray(b, a.dtype))


@pytest.mark.parametrize("shape", [(64, 48), (3, 96, 40), (2304, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_bit_identical(shape, dtype):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32) * 0.05
    w[..., 0] = 0.0  # an all-zero channel takes the 1e-12 floor
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(getattr(torch, dtype))
    jref = jq.quantize_int8(jw)
    port = tq.quantize_int8(tw)
    np.testing.assert_array_equal(port["qt"].numpy(), np.asarray(jref["qt"]))
    np.testing.assert_array_equal(port["scale"].numpy(), np.asarray(jref["scale"]))
    assert port["qt"].dtype == torch.int8 and port["scale"].dtype == torch.float32
    np.testing.assert_array_equal(tq.dequantize(port).numpy(), np.asarray(jq.dequantize(jref)))


def test_quantize_lm_params_bit_identical():
    cfg = Gemma2Config(vocab_size=300, hidden_size=32, intermediate_size=64, num_layers=3,
                       num_heads=4, num_kv_heads=2, head_dim=8)
    params = jax.tree_util.tree_map(
        np.asarray, j_gemma2.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16))
    port = tq.quantize_lm_params(from_numpy_tree(params, dtype=torch.bfloat16))
    _assert_tree_equal(port, jq.quantize_lm_params(params, fuse=True))


def test_quantize_vision_params_bit_identical():
    cfg = spatialvla_tiny(use_vision_zoe=True)
    params = jax.tree_util.tree_map(
        np.asarray, j_spatialvla.init_params(jax.random.PRNGKey(1), cfg))
    del params["lm"]
    port = tq.quantize_vision_params(from_numpy_tree(params))
    _assert_tree_equal(port, jq.quantize_vision_params(params))


@pytest.mark.parametrize("unported", [dict(bits=4), dict(mlp_bits=4), dict(group_size=128),
                                      dict(fuse=False)])
def test_unported_lm_formats_raise(unported):
    """The LM formats beyond the fused int8 tree give JAX's tree bit for bit:
    int4, mixed and grouped (group_size=128 with bits=8 leaves the int8 tree
    as it is, as in JAX), and the unfused tree (fuse=False: q, k, v, o, gate,
    up and down quantized apart; test_torch_greedy_options.py decodes it)."""
    cfg = Gemma2Config(vocab_size=64, hidden_size=16, intermediate_size=32, num_layers=2,
                       num_heads=2, num_kv_heads=1, head_dim=8)
    params = jax.tree_util.tree_map(np.asarray, j_gemma2.init_params(jax.random.PRNGKey(0), cfg))
    kw = dict(unported)
    fuse = kw.pop("fuse", True)
    port = tq.quantize_lm_params(from_numpy_tree(params), fuse=fuse, **kw)
    _assert_tree_equal(port, jq.quantize_lm_params(params, fuse=fuse, **kw))
    if not fuse:
        assert sorted(port["layers"]["attn"]) == ["k", "o", "q", "v"]
        for bits in (4, 8):  # and per format, with the mixed MLP
            mixed = dict(bits=bits, mlp_bits=12 - bits, group_size=16 if bits == 4 else None)
            _assert_tree_equal(tq.quantize_lm_params(from_numpy_tree(params), fuse=False, **mixed),
                               jq.quantize_lm_params(params, fuse=False, **mixed))


@pytest.mark.parametrize("shape", [(64, 48), (3, 96, 40), (2304, 7)])
@pytest.mark.parametrize("group_size", [None, 16, 128])
def test_quantize_int4_bit_identical(shape, group_size):
    w = np.random.RandomState(3).randn(*shape).astype(np.float32) * 0.05
    w[..., 0] = 0.0  # an all-zero channel takes the 1e-12 floor
    jref = jq.quantize_int4(jnp.asarray(w), group_size=group_size)
    port = tq.quantize_int4(torch.from_numpy(w), group_size=group_size)
    assert port["qt"].dtype == torch.uint8 and port["scale"].dtype == torch.float32
    np.testing.assert_array_equal(port["qt"].numpy(), np.asarray(jref["qt"]))
    np.testing.assert_array_equal(port["scale"].numpy(), np.asarray(jref["scale"]))
    np.testing.assert_array_equal(tq.unpack_int4(port["qt"]).numpy(),
                                  np.asarray(jq.unpack_int4(jref["qt"])))
    np.testing.assert_array_equal(tq.dequantize(port).numpy(), np.asarray(jq.dequantize(jref)))
    assert tq.is_int4(port) and tq.is_grouped(port) == (group_size is not None)


@pytest.mark.parametrize("fmt", [dict(bits=4), dict(bits=4, group_size=16),
                                 dict(bits=8, mlp_bits=4), dict(bits=4, mlp_bits=8)],
                         ids=["int4", "int4-g16", "int8+mlp4", "int4+mlp8"])
def test_quantize_lm_params_formats_bit_identical(fmt):
    cfg = Gemma2Config(vocab_size=300, hidden_size=32, intermediate_size=64, num_layers=3,
                       num_heads=4, num_kv_heads=2, head_dim=8)
    params = jax.tree_util.tree_map(
        np.asarray, j_gemma2.init_params(jax.random.PRNGKey(2), cfg, dtype=jnp.bfloat16))
    port = tq.quantize_lm_params(from_numpy_tree(params, dtype=torch.bfloat16), **fmt)
    _assert_tree_equal(port, jq.quantize_lm_params(params, fuse=True, **fmt))


def test_quantize_vision_params_int4_bit_identical():
    cfg = spatialvla_tiny(use_vision_zoe=True)
    params = jax.tree_util.tree_map(
        np.asarray, j_spatialvla.init_params(jax.random.PRNGKey(4), cfg))
    del params["lm"]
    port = tq.quantize_vision_params(from_numpy_tree(params), bits=4)
    _assert_tree_equal(port, jq.quantize_vision_params(params, bits=4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_identical(dtype):
    x = np.random.RandomState(5).randn(2, 3, 2, 7, 16).astype(np.float32)
    x[0, 0, 0, 0] = 0.0  # an all-zero slot takes the 1e-12 floor
    jx = jnp.asarray(x).astype(dtype)
    codes_j, scale_j = jq.quantize_kv(jx)
    codes_t, scale_t = tq.quantize_kv(
        torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype)))
    assert codes_t.dtype == torch.int8 and scale_t.dtype == torch.float32
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(scale_t.numpy(), np.asarray(scale_j))


def _operands(M, K, N, x_dtype, seed=0, quantize=jq.quantize_int8):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    if x_dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    w = quantize(jnp.asarray(rng.randn(K, N).astype(np.float32) * 0.05))
    norm_w = (0.2 * rng.randn(K)).astype(np.float32)
    jx = jnp.asarray(x).astype(x_dtype)
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    tw = from_numpy_tree(jax.tree_util.tree_map(np.asarray, w))
    return jx, tx, w, tw, norm_w


@pytest.mark.parametrize("M", [1, 5, 16])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_q8_matvec_plain_matches_pallas(M, x_dtype):
    jx, tx, w, tw, _ = _operands(M, 256, 384, x_dtype)
    ref = np.asarray(jq.int8_matmul(jx, w["qt"], w["scale"], out_dtype=jnp.float32,
                                    interpret=True))
    got = tq.q8_matvec(tx, tw["qt"], tw["scale"], out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("M", [1, 5, 16])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_q8_rmsnorm_matvec_plain_matches_pallas(M, x_dtype):
    jx, tx, w, tw, norm_w = _operands(M, 256, 384, x_dtype, seed=1)
    ref = np.asarray(jq.int8_rmsnorm_matmul(jx, jnp.asarray(norm_w), w["qt"], w["scale"],
                                            out_dtype=jnp.float32, interpret=True))
    got = tq.q8_rmsnorm_matvec(tx, torch.from_numpy(norm_w), tw["qt"], tw["scale"],
                               out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


INT4 = {"per_channel": jq.quantize_int4,
        "g32": lambda w: jq.quantize_int4(w, group_size=32)}


@pytest.mark.parametrize("M", [1, 5, 16, 40])
@pytest.mark.parametrize("fmt", list(INT4))
def test_q4_matvec_plain_matches_pallas(M, fmt):
    jx, tx, w, tw, _ = _operands(M, 256, 384, "float32", seed=6, quantize=INT4[fmt])
    ref = np.asarray(jq.int8_matmul(jx, w["qt"], w["scale"], out_dtype=jnp.float32,
                                    interpret=True))
    got = tq.q4_matvec(tx, tw["qt"], tw["scale"], out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("M", [1, 5, 16, 40])
@pytest.mark.parametrize("fmt", list(INT4))
def test_q4_rmsnorm_matvec_plain_matches_pallas(M, fmt):
    jx, tx, w, tw, norm_w = _operands(M, 256, 384, "bfloat16", seed=7, quantize=INT4[fmt])
    ref = np.asarray(jq.int8_rmsnorm_matmul(jx, jnp.asarray(norm_w), w["qt"], w["scale"],
                                            out_dtype=jnp.float32, interpret=True))
    got = tq.q4_rmsnorm_matvec(tx, torch.from_numpy(norm_w), tw["qt"], tw["scale"],
                               out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("M", [3, 40])
@pytest.mark.parametrize("fmt", ["int8", "per_channel", "g32"])
def test_qmatmul_dequant_branch_matches_xla(M, fmt):
    """On the CPU both packages take the dequantize + matmul branch."""
    quantize = jq.quantize_int8 if fmt == "int8" else INT4[fmt]
    jx, tx, w, tw, norm_w = _operands(M, 64, 96, "bfloat16", seed=2, quantize=quantize)
    got = tq.qmatmul(tx, tw).float().numpy()
    ref = np.asarray(jq.qmatmul(jx, w).astype(jnp.float32))
    np.testing.assert_allclose(got, ref, atol=1e-2 * np.abs(ref).max(), rtol=0)
    got = tq.qnorm_matmul(tx, torch.from_numpy(norm_w), tw).float().numpy()
    ref = np.asarray(jq.qnorm_matmul(jx, jnp.asarray(norm_w), w).astype(jnp.float32))
    np.testing.assert_allclose(got, ref, atol=1e-2 * np.abs(ref).max(), rtol=0)


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor on any device but the CPU never takes the plain version:
    off CUDA the wrapper raises instead of falling back."""
    _, tx, _, tw, norm_w = _operands(1, 64, 32, "float32")
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(RuntimeError, match="no kernel"):
        tq.q8_matvec(meta(tx), meta(tw["qt"]), meta(tw["scale"]))
    with pytest.raises(RuntimeError, match="no kernel"):
        tq.q8_rmsnorm_matvec(meta(tx), meta(torch.from_numpy(norm_w)), meta(tw["qt"]),
                             meta(tw["scale"]))
    _, tx, _, t4, norm_w = _operands(1, 64, 32, "float32", quantize=jq.quantize_int4)
    with pytest.raises(RuntimeError, match="no kernel"):
        tq.q4_matvec(meta(tx), meta(t4["qt"]), meta(t4["scale"]))
    with pytest.raises(RuntimeError, match="no kernel"):
        tq.q4_rmsnorm_matvec(meta(tx), meta(torch.from_numpy(norm_w)), meta(t4["qt"]),
                             meta(t4["scale"]))
    assert tq.q8_matvec.launches == 0 and tq.q8_rmsnorm_matvec.launches == 0
    assert tq.q4_matvec.launches == 0 and tq.q4_rmsnorm_matvec.launches == 0


GELU_FORMATS = {"int8": jq.quantize_int8, "int4": jq.quantize_int4,
                "int4-g16": functools.partial(jq.quantize_int4, group_size=16)}


@pytest.mark.parametrize("M", [1, 5, 16])
@pytest.mark.parametrize("fmt", list(GELU_FORMATS))
def test_gelu_epilogue_plain_is_matvec_then_gelu_mul(M, fmt):
    """The plain version of the gate|up matvec with the gelu epilogue
    (gelu=True, N = 2 I = 384) is matvec_plain followed by gelu_mul_plain,
    bit for bit: through the wrapper on CPU tensors (with and without
    ``out``), matvec_plain, and the residual kernels' wrapper and plain
    version (the update, then the RMSNorm matvec, then gelu_mul_plain). It
    holds to the JAX decode kernel's gate|up and _activate
    (decode_step.py:345-355) on the Pallas matvec in interpret mode within
    1e-2 of max|ref| (the two fp32 sums may round gate or up a bf16 unit
    apart)."""
    jx, tx, w, tw, norm_w = _operands(M, 256, 384, "bfloat16", seed=8, quantize=GELU_FORMATS[fmt])
    qt, scale, I = tw["qt"], tw["scale"], 192
    def gelu_mul(gu):
        return tq.gelu_mul_plain(gu, out=torch.empty(M, I, dtype=torch.bfloat16))

    want = gelu_mul(tq.matvec_plain(tx, qt, scale))
    nan = torch.full((M, I), float("nan"), dtype=torch.bfloat16)
    for got in (tq.matvec(tx, qt, scale, gelu=True), tq.matvec(tx, qt, scale, gelu=True, out=nan),
                tq.matvec_plain(tx, qt, scale, gelu=True)):
        assert got.dtype == torch.bfloat16 and got.shape == (M, I) and torch.equal(got, want)

    rng = np.random.RandomState(M)
    h_in = torch.from_numpy(8 * rng.randn(M, 256).astype(np.float32))
    upd = torch.from_numpy(rng.randn(M, 256).astype(np.float32)).to(torch.bfloat16)
    post, norm = torch.from_numpy(0.1 * rng.randn(256).astype(np.float32)), torch.from_numpy(norm_w)
    h_ref = torch.empty_like(h_in)
    r_want = gelu_mul(tq.residual_rmsnorm_matvec_plain(h_in, upd, post, norm, qt, scale,
                                                       h_out=h_ref))
    for fn in (tq.residual_rmsnorm_matvec, tq.residual_rmsnorm_matvec_plain):
        h_out = torch.empty_like(h_in)
        got = fn(h_in, upd, post, norm, qt, scale, h_out=h_out, gelu=True)
        assert torch.equal(got, r_want) and torch.equal(h_out, h_ref)

    gu = jq.int8_matmul(jx, w["qt"], w["scale"], out_dtype=jnp.bfloat16, interpret=True)
    ref = np.asarray((jax.nn.gelu(gu[:, :I].astype(jnp.float32), approximate=True)
                      .astype(jnp.bfloat16) * gu[:, I:]).astype(jnp.float32))
    np.testing.assert_allclose(want.float().numpy(), ref, atol=1e-2 * np.abs(ref).max(), rtol=0)


def test_gelu_epilogue_refuses_odd_rows_and_other_outputs():
    """gelu=True needs gate | up rows in pairs and a bf16 output, on every
    device; off the CPU it raises before any launch."""
    _, tx, _, tw, _ = _operands(1, 64, 33, "float32")
    with pytest.raises(ValueError, match="gelu"):
        tq.matvec(tx, tw["qt"], tw["scale"], gelu=True)
    _, tx, _, tw, _ = _operands(1, 64, 32, "float32")
    with pytest.raises(ValueError, match="gelu"):
        tq.matvec_plain(tx, tw["qt"], tw["scale"], gelu=True, out_dtype=torch.float32)
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(RuntimeError, match="no kernel"):
        tq.q8_matvec(meta(tx), meta(tw["qt"]), meta(tw["scale"]), gelu=True)
    assert tq.q8_matvec.launches == 0 and tq.q8_matvec.gelu_launches == 0



def _signed_int4_codes(qt: np.ndarray) -> np.ndarray:
    """The int4 unpack of the few-row kernel (``csrc/q8_matvec.cu:codes4``)
    in numpy: each little-endian 32-bit word of packed bytes masked to its
    low nibbles (or, shifted right by 4, its high ones); the byte permute
    ``__byte_perm(b, 0x4B000000, 0x7540 + j)`` as views (byte j of the word
    into byte 0 of 0x4B000000), read as fp32, 2^23 + nibble, and 2^23 + 8
    taken off. (N, K/2) uint8 -> (N, K) fp32 codes, column order."""
    N, Kh = qt.shape
    words = np.ascontiguousarray(qt).view("<u4")  # (N, Kh / 4)
    halves = []
    for h in (0, 1):
        b = (words >> np.uint32(4 * h)) & np.uint32(0x0F0F0F0F)
        perm = np.zeros(b.shape + (4, 4), np.uint8)  # [word][j][byte of the result]
        perm[..., 0] = b.view(np.uint8).reshape(b.shape + (4,))
        perm[..., 3] = 0x4B
        f = perm.view("<f4")[..., 0]  # 2^23 + nibble j of each word, exact
        halves.append((f - np.float32(8388616.0)).reshape(N, Kh))
    return np.concatenate(halves, axis=-1)


def test_int4_byte_permute_gives_signed_codes():
    """Over every byte value and both nibbles, the mask + 0x4B000000 magic
    unpack gives unpack_int4's codes c - 8 exactly, in column order."""
    every = np.arange(256, dtype=np.uint8)
    qt = np.stack([every, every[::-1], np.roll(every, 77)])  # (3, 256): K = 512
    got = _signed_int4_codes(qt)
    want = tq.unpack_int4(torch.from_numpy(qt)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (3, 512)
    np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("M", [1, 16])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_q4_signed_code_sums_match_pallas(M, x_dtype):
    """sum_k bf16(x) * (c - 8), times the per-channel scale (the few-row
    kernel's int4 function, in another fp32 order than the TPU kernel's
    (sum x c - 8 sum x) * s) against int8_matmul in interpret mode, as
    test_q4_matvec_plain_matches_pallas holds the plain version."""
    jx, tx, w, tw, _ = _operands(M, 2304, 256, x_dtype, seed=8, quantize=jq.quantize_int4)
    ref = np.asarray(jq.int8_matmul(jx, w["qt"], w["scale"], out_dtype=jnp.float32,
                                    interpret=True))
    codes = torch.from_numpy(_signed_int4_codes(tw["qt"].numpy()))
    got = ((tx.to(torch.bfloat16).float() @ codes.t()) * tw["scale"]).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


def _grouped_half_unit_sums(xb, qt, scale, order):
    """The grouped instance of the few-row kernel (``csrc/q8_matvec.cu``,
    kGrouped) in numpy: signed codes c - 8 from the byte permute, one scale
    per 16-column half of a packed weight unit (s[n, 16 b // g] for columns
    16 b .. 16 b + 15), fp32 throughout. "partial": each half's sum of
    x * (c - 8) times its scale, then the halves added (fewer than
    kScaleCodesFromRows rows); "scaled_codes": each code times its half's
    scale, then one sum (from kScaleCodesFromRows rows on). xb (M, K) holds
    the bf16 values the kernel stages; -> (M, N) fp32."""
    codes = _signed_int4_codes(qt)  # (N, K)
    N, K = codes.shape
    g = K // scale.shape[1]
    s_half = np.repeat(scale.astype(np.float32), g // 16, axis=1)  # (N, K / 16)
    xh = xb.astype(np.float32).reshape(xb.shape[0], K // 16, 16)
    ch = codes.reshape(N, K // 16, 16)
    if order == "partial":
        part = np.einsum("mbk,nbk->mnb", xh, ch)
        return (part * s_half[None]).sum(-1, dtype=np.float32)
    return np.einsum("mbk,nbk->mn", xh, ch * s_half[:, :, None])


@pytest.mark.parametrize("M", [1, 16])
@pytest.mark.parametrize("group_size", [16, 128])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["partial", "scaled_codes"])
def test_q4_grouped_half_unit_sums_match_pallas(M, group_size, x_dtype, order):
    """The grouped instance's function, one scale per half unit on signed
    codes (in another fp32 order than the TPU kernel's biased partial dots
    per group minus 8 (x sums @ s)), against int8_matmul and
    int8_rmsnorm_matmul in interpret mode, with either way of applying the
    scales."""
    quantize = functools.partial(jq.quantize_int4, group_size=group_size)
    jx, tx, w, tw, norm_w = _operands(M, 1024, 128, x_dtype, seed=9, quantize=quantize)
    assert w["scale"].shape == (128, 1024 // group_size)
    qt, scale = tw["qt"].numpy(), tw["scale"].numpy()
    ref = np.asarray(jq.int8_matmul(jx, w["qt"], w["scale"], out_dtype=jnp.float32,
                                    interpret=True))
    got = _grouped_half_unit_sums(tx.to(torch.bfloat16).float().numpy(), qt, scale, order)
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)
    ref = np.asarray(jq.int8_rmsnorm_matmul(jx, jnp.asarray(norm_w), w["qt"], w["scale"],
                                            out_dtype=jnp.float32, interpret=True))
    xn = tq._rms_bf16(tx, torch.from_numpy(norm_w), 1e-6).numpy()
    got = _grouped_half_unit_sums(xn, qt, scale, order)
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


def _codes2(v: np.ndarray) -> np.ndarray:
    """``codes2`` of the tensor-core kernel (``csrc/q4_matvec.cu``) in numpy
    and torch: the nibbles at bits 0-3 and 16-19 of each uint32 masked and
    ORed into 0x4300 (the bf16 value 128 + c), then 136 taken off in bf16.
    (...) uint32 -> (..., 2) fp32: the low and the high 16-bit lane."""
    r = (v.astype(np.uint32) & np.uint32(0x000F000F)) | np.uint32(0x43004300)
    lanes = torch.from_numpy(np.ascontiguousarray(r).view("<i2").copy()).view(torch.bfloat16)
    out = lanes - torch.tensor(136.0, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    return out.float().numpy().reshape(v.shape + (2,))


def test_int4_bf16_magic_gives_signed_codes():
    """Over every byte value, at every byte of a 32-bit word, and both
    nibbles: the 0x4300 OR and the bf16 subtraction of 136 give c - 8
    exactly; a word's bytes (0, 2) feed one bf16x2 and, shifted by 8, bytes
    (1, 3) the other; shifted by 4 (12), the high nibbles."""
    every = np.arange(256, dtype=np.uint32)
    for pos in range(4):
        words = every << np.uint32(8 * pos)
        for h in (0, 1):
            for shift, lane_of in ((0, {0: 0, 2: 1}), (8, {1: 0, 3: 1})):
                got = _codes2(words >> np.uint32(4 * h + shift))
                want = ((every >> np.uint32(4 * h)) & np.uint32(15)).astype(np.float32) - 8
                for p, lane in lane_of.items():
                    np.testing.assert_array_equal(got[:, lane], want if p == pos else -8.0)


def _q4_mma_emulation(xb: torch.Tensor, qt: np.ndarray, scale: np.ndarray,
                      splits: int = 1) -> np.ndarray:
    """The tensor-core kernel (``csrc/q4_matvec.cu:q4_mma_kernel``) in torch,
    lane by lane: x' columns of each 16-column step placed as ``kcol`` says; a
    lane t's codes from the 32-bit word of bytes 4t..4t+3 (``_codes2`` of the
    word and of the word >> 8, >> 4 and >> 12 for the high nibbles) at k =
    2t, 2t + 1 and 2t + 8, 2t + 9; one fp32 product a 16-column step
    (computed in fp64, rounded once). The steps alternate low and high
    half; grouped, each half has one open partial, added times its group's
    scale as the group closes (j and G/2 + j together). K is split in
    `splits` ranges of whole 32-column stages and groups, each summed apart
    (``q4_split_sum`` adds them in order); per channel the scale multiplies
    the total. xb (M, K) holds the bf16 values of x'; -> (M, N) fp32."""
    M, K = xb.shape
    N, Kh = qt.shape
    assert Kh % 32 == 0
    words = np.ascontiguousarray(qt).view("<u4").reshape(N, Kh // 16, 4)  # [n][step][t]
    kcol = [4 * ((l & 7) >> 1) + (l >> 3) + 2 * (l & 1) for l in range(16)]
    assert sorted(kcol) == list(range(16))

    def step(h, s):  # the product of 16-column step s of half h, fp32
        a = xb[:, [h * Kh + 16 * s + c for c in kcol]].double()
        b = np.zeros((N, 16), np.float32)
        for t in range(4):
            v = words[:, s, t] >> np.uint32(4 * h)
            b[:, [2 * t, 2 * t + 1]] = _codes2(v)
            b[:, [2 * t + 8, 2 * t + 9]] = _codes2(v >> np.uint32(8))
        return (a @ torch.from_numpy(b).double().t()).float()

    grouped = scale.ndim == 2
    G = scale.shape[1] if grouped else 0
    g = K // G if grouped else Kh
    n_steps = Kh // 16
    per = n_steps // splits  # 16-column steps a split
    assert per * splits == n_steps and per % 2 == 0 and (not grouped or (16 * per) % g == 0)
    total = torch.zeros(M, N)
    for z in range(splits):
        acc = torch.zeros(M, N)
        part = [torch.zeros(M, N), torch.zeros(M, N)]
        for s in range(z * per, (z + 1) * per):
            for h in (0, 1):
                if grouped:
                    part[h] += step(h, s)
                else:
                    acc += step(h, s)
            if grouped and (16 * (s + 1)) % g == 0:  # groups j and G/2 + j close
                for h in (0, 1):
                    acc += torch.from_numpy(scale[:, h * (G // 2) + 16 * s // g]) * part[h]
                    part[h] = torch.zeros(M, N)
        total += acc
    return (total if grouped else total * torch.from_numpy(scale)).numpy()


@pytest.mark.parametrize("fmt", [None, 16, 128], ids=["per_channel", "g16", "g128"])
@pytest.mark.parametrize("fn,x_dtype", [("matmul", "float32"), ("matmul", "bfloat16"),
                                        ("rmsnorm_matmul", "bfloat16")])
@pytest.mark.parametrize("splits", [1, 2])
def test_q4_mma_order_matches_pallas(fmt, fn, x_dtype, splits):
    """The tensor-core kernel's function and order at 40 rows (signed-code
    products a 16-column step; per channel scaled at the end, grouped one
    partial a group, scaled as it closes; K whole or split in two, as the
    kernel splits it where its grid is small) against int8_matmul and
    int8_rmsnorm_matmul in interpret mode (fp32 out, atol 1e-4 max|ref|).
    The norm takes bf16 x, as test_q4_rmsnorm_matvec_plain_matches_pallas
    holds the plain version (from fp32 x, the two packages' RMSNorms round a
    few x' values to neighbouring bf16 values)."""
    quantize = functools.partial(jq.quantize_int4, group_size=fmt)
    jx, tx, w, tw, norm_w = _operands(40, 512, 96, x_dtype, seed=10, quantize=quantize)
    qt, scale = tw["qt"].numpy(), tw["scale"].numpy()
    if fn == "matmul":
        ref = jq.int8_matmul(jx, w["qt"], w["scale"], out_dtype=jnp.float32, interpret=True)
        xb = tx.to(torch.bfloat16).float()
    else:
        ref = jq.int8_rmsnorm_matmul(jx, jnp.asarray(norm_w), w["qt"], w["scale"],
                                     out_dtype=jnp.float32, interpret=True)
        xb = tq._rms_bf16(tx, torch.from_numpy(norm_w), 1e-6)
    ref = np.asarray(ref)
    got = _q4_mma_emulation(xb, qt, scale, splits)
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)
