"""Weight-only int8 / int4 quantization for serving, and its matvec kernels.

Port of ``spatialvla_tpu/ops/quant.py``: the same leaves, bit-identical codes
and scales, and the same dispatch in ``qmatmul`` / ``qnorm_matmul``.

Formats (``{"qt", "scale"}``, the weight stored transposed so an output
channel is one contiguous row):
  * int8: ``qt`` int8 (..., N, K), ``scale`` f32 (..., N) per channel;
  * int4: ``qt`` uint8 (..., N, K/2), column j packed with column j + K/2
    offset-binary (low nibble = code_j + 8, high nibble = code_{j+K/2} + 8),
    ``scale`` f32 (..., N) per channel or (..., N, G) grouped along K.

Rows up to ``_qkernel_max_m`` (16 for int8, 512 for int4, as quant.py:262-267)
on the card go to a hand-written kernel; everything else dequantizes to the
activation dtype and runs one plain matmul (the branch the JAX package leaves
to XLA).

Kernels:
  * ``q8_matvec`` / ``q8_rmsnorm_matvec`` (``csrc/q8_matvec.cu``) replace the
    int8 branch of the Pallas ``int8_matmul`` (quant.py:297) and
    ``int8_rmsnorm_matmul`` (quant.py:336);
  * ``q4_matvec`` / ``q4_rmsnorm_matvec`` (``csrc/q4_matvec.cu``) replace
    their int4 branches, per channel and grouped (``_q_dot_scaled``
    quant.py:205-243, ``grouped_int4_dot`` :163); at M <= 16, per channel or
    in groups of a multiple of 16 columns, they launch the int4 instances of
    ``csrc/q8_matvec.cu``'s kernel, above 16 rows the bf16 tensor-core
    kernel of ``csrc/q4_matvec.cu`` (``q4_route`` says which kernel a call
    takes);
  * ``q8_residual_rmsnorm_matvec`` / ``q4_residual_rmsnorm_matvec`` (the
    residual instances of ``csrc/q8_matvec.cu``'s few-row kernel) fold the
    decode step's residual update (``decode_step.norm_residual``) into the
    RMSNorm matvec that follows it, as the JAX decode kernel's ``_post_attn``
    and ``_post_ffn`` + ``_input_norm`` phases do; ``residual_route`` says
    which weights take them.
  * ``gelu=True`` on ``q8_matvec`` / ``q4_matvec`` and the residual kernels:
    the decode step's gate|up projection with ``gelu_mul`` in the few-row
    kernel's epilogue (out (M, N / 2) = gelu(gate) * up, the bits of the
    matvec followed by ``decode_step.gelu_mul``); ``gelu_route`` says which
    weights take it.
Each wrapper runs its plain PyTorch version (``*_plain``) only for CPU
tensors, launches the kernel for CUDA tensors, and counts its launches in
``<wrapper>.launches`` (the q4 wrappers those on the tensor-core route also
in ``<wrapper>.tiled_launches``, the matvecs those with the gelu epilogue
also in ``<wrapper>.gelu_launches``).

``qmatmul`` also takes LoRA-factored weights ``{"w", "a", "b"}`` over a
plain or quantized base: the base through the kernels as above, plus the
low-rank product in plain PyTorch.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from . import _lib

QuantW = Dict[str, Any]

# Rows above these take the dequantize + matmul path. The values are the JAX
# package's per-format thresholds (quant.py:262-263), tuned on a TPU; they
# have not been re-derived on the H100 yet (ROADMAP).
QKERNEL_MAX_M = 16  # int8 qt
QKERNEL_MAX_M_INT4 = 512  # packed-int4 qt (uint8 nibbles)
# The residual kernels' shapes (csrc/q8_matvec.cu, kResidMaxRows): every
# block passes over all M rows of h and upd before its weight stream, so
# the fold's cost grows with M; on an H100 (scripts/bench_q8_matvec.py
# --residual) it beats norm_residual + the RMSNorm matvec at 1, 2 and 4 rows
# and loses from 8 rows on (int8 qkv at 16 rows 0.0587 ms against 0.0399).
# All of K is staged at once, even before the kernel's opt-in to more than
# 48 KB of shared memory: K <= 4096 at 4 rows.
RESIDUAL_MAX_M = 4
RESIDUAL_MAX_K = 4096


def _qkernel_max_m(qt) -> int:
    return QKERNEL_MAX_M_INT4 if qt.dtype == torch.uint8 else QKERNEL_MAX_M


def matvec_refusal(qt_dtype, K: int, G: int, rows: int) -> Optional[str]:
    """Why the matvec kernels refuse a weight over K inputs (qt of
    ``qt_dtype``: int8, or uint8 for packed int4; G scale groups, 0 per
    channel) at ``rows`` rows, or None where they take it: int8 up to
    ``QKERNEL_MAX_M`` rows with K a multiple of 16; packed int4 up to
    ``QKERNEL_MAX_M_INT4`` rows, its G groups tiling both halves of K. The
    shape rule of ``_check_matvec`` and ``_check_q4`` (the operands'
    addresses apart)."""
    if qt_dtype == torch.uint8:
        if G and (G < 2 or G % 2 or K % G):
            return (f"{G} groups over K={K}; both halves of K must hold whole groups (an "
                    "even G that divides K, as quantize_int4 makes)")
        if not 1 <= rows <= QKERNEL_MAX_M_INT4:
            return f"{rows} rows; the kernel takes 1..{QKERNEL_MAX_M_INT4}"
        return None
    if not 1 <= rows <= QKERNEL_MAX_M:
        return f"{rows} rows; the kernel takes 1..{QKERNEL_MAX_M}"
    if K % 16:
        return f"K={K} must be a multiple of 16"
    return None


def qmatmul_refusal(qt_dtype, K: int, G: int, rows: int) -> Optional[str]:
    """``matvec_refusal`` for a call that ``qmatmul`` / ``qnorm_matmul``
    send to the kernels (CUDA operands of at most the format's kernel rows);
    None for a call of more rows, which they dequantize. The model cut
    (``parallel/partitioning.py:TensorShards``) keeps a block whole where
    this refuses a shard's weight at the fewest rows its calls have."""
    if rows > (QKERNEL_MAX_M_INT4 if qt_dtype == torch.uint8 else QKERNEL_MAX_M):
        return None
    return matvec_refusal(qt_dtype, K, G, rows)


# ---------------------------------------------------------------------------
# formats (quant.py:34-146)
# ---------------------------------------------------------------------------

def quantize_int8(w: torch.Tensor) -> QuantW:
    """(..., K, N) float -> symmetric per-N-channel int8, stored (..., N, K).

    fp32 math from the same source values as quant.py:34, so codes and
    scales are bit-identical (both round half to even)."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)  # (..., 1, N)
    scale = amax / 127.0
    q = torch.round(wf / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return {"qt": q.transpose(-1, -2).contiguous(), "scale": scale[..., 0, :]}


def quantize_kv(x: torch.Tensor):
    """KV-cache int8 (quant.py:43): symmetric per-slot quantization over the
    head dim. (..., D) float -> (codes int8 (..., D), scale f32 (...))."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-12) / 127.0
    codes = torch.round(xf / scale[..., None]).to(torch.int8)
    return codes, scale


def quantize_int4(w: torch.Tensor, group_size: Optional[int] = None) -> QuantW:
    """(..., K, N) float -> symmetric int4 (levels [-8, 7]) stored (..., N, K/2)
    uint8 (quant.py:59). group_size: None = one scale per output channel;
    otherwise scales per group of K, (..., N, G), clamped to K/2 so the two
    packed halves stay group-aligned."""
    wf = w.float()
    K = wf.shape[-2]
    if K % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, got {K}")
    if group_size is not None:
        group_size = min(group_size, K // 2)
        if not (group_size > 0 and K % group_size == 0 and (K // 2) % group_size == 0):
            raise ValueError(f"group_size {group_size} does not tile K={K} and its halves")
        G = K // group_size
        wg = wf.reshape(*wf.shape[:-2], G, group_size, wf.shape[-1])
        scale_g = wg.abs().amax(dim=-2, keepdim=True) / 7.0  # (..., G, 1, N)
        q = torch.clamp(torch.round(wg / torch.clamp(scale_g, min=1e-12)), -8, 7)
        q = q.reshape(wf.shape).to(torch.int32)
        scale = scale_g[..., 0, :].transpose(-1, -2).contiguous()  # (..., N, G)
    else:
        scale = wf.abs().amax(dim=-2, keepdim=True) / 7.0  # (..., 1, N)
        q = torch.clamp(torch.round(wf / torch.clamp(scale, min=1e-12)), -8, 7).to(torch.int32)
        scale = scale[..., 0, :]
    qt = q.transpose(-1, -2)  # (..., N, K)
    lo = qt[..., : K // 2] + 8
    hi = qt[..., K // 2 :] + 8
    return {"qt": (lo | (hi << 4)).to(torch.uint8).contiguous(), "scale": scale}


def unpack_int4(qt: torch.Tensor) -> torch.Tensor:
    """(..., N, K/2) uint8 -> (..., N, K) int32 codes in [-8, 7]."""
    w32 = qt.to(torch.int32)
    return torch.cat([(w32 & 15) - 8, ((w32 >> 4) & 15) - 8], dim=-1)


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "qt" in w and "scale" in w


def is_lora_factored(w) -> bool:
    """{'w': base, 'a': (..., in, r), 'b': (..., r, out)}, applied as
    x @ w + (x @ a) @ b without forming the delta (train/lora.py)."""
    return isinstance(w, dict) and "w" in w and "a" in w and "b" in w


def is_int4(w) -> bool:
    return is_quantized(w) and w["qt"].dtype == torch.uint8


def is_grouped(w) -> bool:
    """Group-wise scales: (..., N, G), the rank of qt, instead of (..., N)."""
    return is_quantized(w) and w["scale"].dim() == w["qt"].dim()


def grouped_dequant_t(qt_codes: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """codes (..., N, K) x scale (..., N, G) -> (..., N, K) in ``dtype``
    (quant.py:124): (N, G, K/G) * scale[..., None]."""
    N, K = qt_codes.shape[-2:]
    G = scale.shape[-1]
    lead = qt_codes.shape[:-2]
    q3 = qt_codes.to(dtype).reshape(*lead, N, G, K // G)
    return (q3 * scale[..., None].to(dtype)).reshape(*lead, N, K)


def dequantize(qw: QuantW, dtype=torch.float32) -> torch.Tensor:
    """-> (..., K, N) float, every format (quant.py:138)."""
    qt = unpack_int4(qw["qt"]) if is_int4(qw) else qw["qt"]
    if is_grouped(qw):
        return grouped_dequant_t(qt, qw["scale"], torch.float32).transpose(-1, -2).to(dtype)
    q = qt.transpose(-1, -2).float()
    return (q * qw["scale"][..., None, :]).to(dtype)


# ---------------------------------------------------------------------------
# kernel 1: x (M, K) @ int8 (N, K)^T * scale (N,) -> (M, N)
# ---------------------------------------------------------------------------

def q8_matvec_plain(x, qt, scale, *, out_dtype=torch.bfloat16):
    """Plain version of the q8_matvec kernel: bf16-rounded activations,
    fp32 accumulation, per-channel scale on the fp32 sum."""
    acc = x.to(torch.bfloat16).float() @ qt.float().t()
    return (acc * scale.float()).to(out_dtype)


def gelu_mul_plain(gu, *, out):
    """out (M, I) bf16 <- bf16(bf16(gelu_tanh(gate)) * up), gu = gate | up
    (M, 2 I) bf16: the decode step's gelu·up (decode_step.py:345-355), the
    plain version of ``decode_step.gelu_mul`` and of the gelu epilogue."""
    I = out.shape[-1]
    gate, up = gu[:, :I].float(), gu[:, I:].float()
    g = torch.nn.functional.gelu(gate, approximate="tanh").to(torch.bfloat16).float()
    return out.copy_(g * up)


def _check_gelu(name, out_dtype, N):
    """The gelu epilogue's operands: gate | up rows (N even) into bf16."""
    if out_dtype != torch.bfloat16 or N % 2:
        raise ValueError(f"{name}: gelu takes a gate | up weight (N even, got {N}) and a bf16 "
                         f"output (got {out_dtype})")


def _plain_out(y, out, gelu):
    """The plain matvec's output y (M, N) into ``out`` (allocated where
    None); with ``gelu``, y is bf16 gate | up and ``out`` (M, N / 2) gets
    gelu_mul_plain of it."""
    if not gelu:
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty((y.shape[0], y.shape[1] // 2), dtype=torch.bfloat16, device=y.device)
    return gelu_mul_plain(y, out=out)


def _empty_out(x, N, out_dtype, gelu):
    return torch.empty((x.shape[0], N // 2 if gelu else N), dtype=out_dtype, device=x.device)


def _check_matvec(name, x, qt, scale, out, gelu=False):
    _lib.check_cuda(name, x, qt, scale, out)
    M, K = x.shape
    if qt.dtype != torch.int8 or qt.dim() != 2 or qt.shape[1] != K:
        raise ValueError(f"{name}: qt must be int8 (N, {K}), got {qt.dtype} {tuple(qt.shape)}")
    N = qt.shape[0]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (N,):
        raise ValueError(f"{name}: scale must be float32 ({N},), got {scale.dtype} {tuple(scale.shape)}")
    if gelu:
        _check_gelu(name, out.dtype, N)
    if tuple(out.shape) != (M, N // 2 if gelu else N):
        raise ValueError(f"{name}: out must be ({M}, {N // 2 if gelu else N}), got "
                         f"{tuple(out.shape)}")
    why = matvec_refusal(qt.dtype, K, 0, M)
    if why:
        raise ValueError(f"{name}: {why}")
    if x.data_ptr() % 16 or qt.data_ptr() % 16:
        raise ValueError(f"{name}: the x/qt addresses must be multiples of 16")
    return M, N, K


def q8_matvec(x, qt, scale, *, out_dtype=torch.bfloat16, out=None, gelu=False):
    """x (M, K) f32/bf16 @ dequant(qt (N, K) int8, scale (N,) f32) -> (M, N).

    ``out`` (optional) receives the result in place. ``gelu``: qt is gate |
    up (N = 2 I) and the result is gelu_mul_plain of the bf16 (M, N) output,
    (M, I) bf16, from the kernel's epilogue (``gelu_route``)."""
    if gelu:
        _check_gelu("q8_matvec", out_dtype, qt.shape[0])
    if x.device.type == "cpu":
        return _plain_out(q8_matvec_plain(x, qt, scale, out_dtype=out_dtype), out, gelu)
    if out is None:
        out = _empty_out(x, qt.shape[0], out_dtype, gelu)
    M, N, K = _check_matvec("q8_matvec", x, qt, scale, out, gelu)
    _lib.launch(
        "q8_matvec", x.data_ptr(), _lib.dtype_code(x), qt.data_ptr(), scale.data_ptr(),
        out.data_ptr(), _lib.dtype_code(out), M, N, K, int(gelu),
    )
    q8_matvec.launches += 1
    q8_matvec.gelu_launches += gelu
    return out


_lib.counted(q8_matvec, "gelu_launches")  # of them, with the gelu epilogue


# ---------------------------------------------------------------------------
# kernel 2: Gemma rms_norm(x) fused in front of kernel 1
# ---------------------------------------------------------------------------

def _rms_bf16(x, norm_w, eps):
    """fp32 ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` rounded to bf16 (as fp32)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + norm_w.float())).to(torch.bfloat16).float()


def q8_rmsnorm_matvec_plain(x, norm_w, qt, scale, *, eps=1e-6, out_dtype=torch.bfloat16):
    """Plain version: the bf16-rounded Gemma RMSNorm, then q8_matvec_plain."""
    return q8_matvec_plain(_rms_bf16(x, norm_w, eps), qt, scale, out_dtype=out_dtype)


def q8_rmsnorm_matvec(x, norm_w, qt, scale, *, eps=1e-6, out_dtype=torch.bfloat16, out=None):
    """rms_norm(x; norm_w) @ dequant(qt, scale) in one kernel; x is NOT normed."""
    if x.device.type == "cpu":
        y = q8_rmsnorm_matvec_plain(x, norm_w, qt, scale, eps=eps, out_dtype=out_dtype)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty((x.shape[0], qt.shape[0]), dtype=out_dtype, device=x.device)
    M, N, K = _check_matvec("q8_rmsnorm_matvec", x, qt, scale, out)
    _check_norm_w("q8_rmsnorm_matvec", x, norm_w, K)
    _lib.launch(
        "q8_rmsnorm_matvec", x.data_ptr(), _lib.dtype_code(x), norm_w.data_ptr(),
        _lib.dtype_code(norm_w), float(eps), qt.data_ptr(), scale.data_ptr(),
        out.data_ptr(), _lib.dtype_code(out), M, N, K,
    )
    q8_rmsnorm_matvec.launches += 1
    return out


_lib.counted(q8_rmsnorm_matvec)


def _check_norm_w(name, x, norm_w, K):
    _lib.check_cuda(name, x, norm_w)
    if tuple(norm_w.shape) != (K,):
        raise ValueError(f"{name}: norm_w must be ({K},), got {tuple(norm_w.shape)}")


# ---------------------------------------------------------------------------
# kernels 1 and 2, int4: x (M, K) @ packed-int4 (N, K/2)^T, per-channel
# (N,) or grouped (N, G) scales
# ---------------------------------------------------------------------------

def _q4_dot_plain(xb, qt, scale):
    """(M, K) fp32 holding bf16 values @ packed int4 -> (M, N) fp32, as
    ``_q_dot_scaled`` computes it (quant.py:221-238): dots on the biased
    nibble codes, then the +8 bias taken out as 8 * sum(x) (per channel) or
    8 * (group sums @ scales) (grouped, ``grouped_int4_dot``)."""
    w = qt.to(torch.int32)
    codes = torch.cat([(w & 15), (w >> 4)], dim=-1).float()  # (N, K) biased, column order
    if scale.dim() == 2:  # grouped: one partial dot per group, scaled
        M, K = xb.shape
        N, G = scale.shape
        x3 = xb.reshape(M, G, K // G)
        parts = torch.einsum("mgk,ngk->mng", x3, codes.reshape(N, G, K // G))
        acc = (parts * scale.float()[None]).sum(-1)
        return acc - 8.0 * (x3.sum(-1) @ scale.float().t())
    acc = xb @ codes.t()
    return (acc - 8.0 * xb.sum(-1, keepdim=True)) * scale.float()


def q4_matvec_plain(x, qt, scale, *, out_dtype=torch.bfloat16):
    """Plain version of the q4_matvec kernel: bf16-rounded activations, fp32
    sums."""
    return _q4_dot_plain(x.to(torch.bfloat16).float(), qt, scale).to(out_dtype)


def q4_rmsnorm_matvec_plain(x, norm_w, qt, scale, *, eps=1e-6, out_dtype=torch.bfloat16):
    """Plain version: the bf16-rounded Gemma RMSNorm, then q4_matvec_plain."""
    return _q4_dot_plain(_rms_bf16(x, norm_w, eps), qt, scale).to(out_dtype)


def _check_q4(name, x, qt, scale, out, gelu=False):
    """Shapes the q4 kernels take; returns (M, N, K, G), G = 0 per channel.
    ``gelu``: out (M, N / 2) bf16, on the few-row kernel's route only."""
    _lib.check_cuda(name, x, qt, scale, out)
    M, K = x.shape
    if qt.dtype != torch.uint8 or qt.dim() != 2 or 2 * qt.shape[1] != K:
        raise ValueError(f"{name}: qt must be uint8 (N, {K // 2}), got {qt.dtype} {tuple(qt.shape)}")
    N = qt.shape[0]
    grouped = scale.dim() == 2
    G = scale.shape[-1] if grouped else 0
    if scale.dtype != torch.float32 or tuple(scale.shape) != ((N, G) if grouped else (N,)):
        raise ValueError(f"{name}: scale must be float32 ({N},) or ({N}, G), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    why = matvec_refusal(qt.dtype, K, G, M)
    if why:
        raise ValueError(f"{name}: {why}")
    if gelu:
        _check_gelu(name, out.dtype, N)
        if not _rows_route(x, qt, G):
            raise ValueError(f"{name}: {M} rows, K={K}, {G} groups: the gelu epilogue is the "
                             "few-row kernel's (gelu_route)")
    if tuple(out.shape) != (M, N // 2 if gelu else N):
        raise ValueError(f"{name}: out must be ({M}, {N // 2 if gelu else N}), got "
                         f"{tuple(out.shape)}")
    return M, N, K, G


def _q4_work(x, qt, M, N, K, G):
    """The work buffer of the tensor-core route of ``csrc/q4_matvec.cu`` (x'
    staged as bf16, and the partial sums of a K split), as
    ``q4_work_bytes`` sizes it; None where the call takes another kernel.
    The aligned calls of M <= 16 (the decode steps) never take that route
    and skip the query."""
    if M <= 16 and not (x.data_ptr() % 16 or qt.data_ptr() % 16 or (K // 2) % 16):
        return None
    nbytes = _lib.library().q4_work_bytes(x.data_ptr(), qt.data_ptr(), M, N, K, G)
    return torch.empty(nbytes, dtype=torch.uint8, device=x.device) if nbytes else None


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def q4_matvec(x, qt, scale, *, out_dtype=torch.bfloat16, out=None, gelu=False):
    """x (M, K) f32/bf16 @ dequant(qt (N, K/2) packed int4, scale (N,) or
    (N, G)) -> (M, N), 1 <= M <= 512. ``gelu`` as for ``q8_matvec``, on the
    few-row kernel's route only (``gelu_route``)."""
    if gelu:
        _check_gelu("q4_matvec", out_dtype, qt.shape[0])
    if x.device.type == "cpu":
        return _plain_out(q4_matvec_plain(x, qt, scale, out_dtype=out_dtype), out, gelu)
    if out is None:
        out = _empty_out(x, qt.shape[0], out_dtype, gelu)
    M, N, K, G = _check_q4("q4_matvec", x, qt, scale, out, gelu)
    work = _q4_work(x, qt, M, N, K, G)
    _lib.launch(
        "q4_matvec", x.data_ptr(), _lib.dtype_code(x), qt.data_ptr(), scale.data_ptr(), G,
        _ptr(work), out.data_ptr(), _lib.dtype_code(out), M, N, K, int(gelu),
    )
    q4_matvec.launches += 1
    q4_matvec.tiled_launches += work is not None
    q4_matvec.gelu_launches += gelu
    return out


# of them, on the tensor-core route and with the gelu epilogue
_lib.counted(q4_matvec, "tiled_launches", "gelu_launches")


def q4_rmsnorm_matvec(x, norm_w, qt, scale, *, eps=1e-6, out_dtype=torch.bfloat16, out=None):
    """rms_norm(x; norm_w) @ dequant(packed int4), the norm fused into the
    kernel; x is NOT normed."""
    if x.device.type == "cpu":
        y = q4_rmsnorm_matvec_plain(x, norm_w, qt, scale, eps=eps, out_dtype=out_dtype)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty((x.shape[0], qt.shape[0]), dtype=out_dtype, device=x.device)
    M, N, K, G = _check_q4("q4_rmsnorm_matvec", x, qt, scale, out)
    _check_norm_w("q4_rmsnorm_matvec", x, norm_w, K)
    work = _q4_work(x, qt, M, N, K, G)
    _lib.launch(
        "q4_rmsnorm_matvec", x.data_ptr(), _lib.dtype_code(x), norm_w.data_ptr(),
        _lib.dtype_code(norm_w), float(eps), qt.data_ptr(), scale.data_ptr(), G,
        _ptr(work), out.data_ptr(), _lib.dtype_code(out), M, N, K,
    )
    q4_rmsnorm_matvec.launches += 1
    q4_rmsnorm_matvec.tiled_launches += work is not None
    return out


_lib.counted(q4_rmsnorm_matvec, "tiled_launches")

Q4_ROUTES = ("rows", "small", "tiled", "tiled_fma")


# ---------------------------------------------------------------------------
# kernel 2 with the decode step's residual update in front
# ---------------------------------------------------------------------------

def residual_rmsnorm_matvec_plain(h_in, upd, post_w, norm_w, qt, scale, *, eps=1e-6, h_out,
                                  out_dtype=torch.bfloat16, out=None, gelu=False):
    """Plain version of the residual kernels: ``decode_step.norm_residual_plain``
    (h_out = bf16(bf16(h_in) + bf16(rms(upd) * (1 + post_w))), fp32) followed
    by ``rmsnorm_matvec_plain`` of h_out with norm_w (and with ``gelu``,
    ``gelu_mul_plain`` of its output), the same operations in the same order.
    h_in is left as it is."""
    h_out.copy_((h_in.to(torch.bfloat16).float() + _rms_bf16(upd, post_w, eps))
                .to(torch.bfloat16).float())
    if gelu:
        _check_gelu("residual_rmsnorm_matvec", out_dtype, qt.shape[0])
    y = rmsnorm_matvec_plain(h_out, norm_w, qt, scale, eps=eps, out_dtype=out_dtype)
    return _plain_out(y, out, gelu)


def residual_route(x, qt, scale) -> bool:
    """Whether ``residual_rmsnorm_matvec`` takes these operands (x the (M,
    K) residual stream, qt and scale one layer's weight): M <= 4 and K <=
    4096 (``RESIDUAL_MAX_M``, ``RESIDUAL_MAX_K``), and the rule of
    ``csrc/q4_matvec.cu:route_of`` for the few-row kernel: x and qt 16-byte
    aligned, int8 with K a multiple of 16, or packed int4 with K / 2 a
    multiple of 16, per channel or in groups of a multiple of 16 columns.
    On any device, from shapes and addresses alone; for the operands it
    refuses the decode step runs ``norm_residual`` with the next norm's x'
    and then the plain ``matvec``."""
    M, K = x.shape
    return 1 <= M <= RESIDUAL_MAX_M and K <= RESIDUAL_MAX_K and _few_rows(x, qt, scale)


def _rows_route(x, qt, G):
    """``csrc/q4_matvec.cu:route_of``'s "rows" (the few-row kernel of
    ``csrc/q8_matvec.cu``) for packed int4: M <= 16, x and qt 16-byte
    aligned, K / 2 a multiple of 16, per channel or in groups of a multiple
    of 16 columns."""
    M, K = x.shape
    return (M <= 16 and x.data_ptr() % 16 == 0 and qt.data_ptr() % 16 == 0 and (K // 2) % 16 == 0
            and (G == 0 or (K % G == 0 and (K // G) % 16 == 0)))


def _few_rows(x, qt, scale) -> bool:
    """Whether the few-row kernel of ``csrc/q8_matvec.cu`` takes x @ qt: M
    <= 16 and, for int8, K a multiple of 16 with x and qt 16-byte aligned;
    for packed int4 ``_rows_route``."""
    M, K = x.shape
    if qt.dtype == torch.int8:
        return (1 <= M <= QKERNEL_MAX_M and K % 16 == 0 and scale.dim() == 1
                and x.data_ptr() % 16 == 0 and qt.data_ptr() % 16 == 0)
    return M >= 1 and _rows_route(x, qt, scale.shape[-1] if scale.dim() == 2 else 0)


def gelu_route(x, qt, scale) -> bool:
    """Whether the gate|up matvec of x (M, K) with this layer's weight qt,
    scale (gate | up, N = 2 I rows) takes the gelu epilogue (``gelu=True``):
    the few-row kernel takes the operands (``_few_rows``: M <= 16, aligned,
    int8 or int4 per channel or in groups of a multiple of 16 columns) and
    N is even. On any device, from shapes and addresses alone; for the
    operands it refuses the decode step writes gate | up and launches
    ``decode_step.gelu_mul``."""
    return qt.shape[0] % 2 == 0 and _few_rows(x, qt, scale)


def _check_residual(name, h_in, upd, post_w, norm_w, qt, scale, h_out):
    _lib.check_cuda(name, h_in, upd, post_w, norm_w, h_out)
    M, K = h_in.shape
    if h_in.dtype != torch.float32 or h_out.dtype != torch.float32 or upd.dtype != torch.bfloat16:
        raise TypeError(f"{name}: h_in and h_out must be float32, upd bfloat16")
    if tuple(upd.shape) != (M, K) or tuple(h_out.shape) != (M, K):
        raise ValueError(f"{name}: upd and h_out must be ({M}, {K}) like h_in")
    if tuple(post_w.shape) != (K,) or tuple(norm_w.shape) != (K,):
        raise ValueError(f"{name}: post_w and norm_w must be ({K},)")
    a, b, n = h_in.data_ptr(), h_out.data_ptr(), 4 * M * K
    if a < b + n and b < a + n:
        raise ValueError(f"{name}: h_out overlaps h_in (other blocks still read h_in while "
                         "the first writes h_out)")
    if a % 16 or b % 16 or upd.data_ptr() % 16:
        raise ValueError(f"{name}: h_in, h_out and upd must start 16-byte aligned")
    if not residual_route(h_in, qt, scale):
        raise ValueError(f"{name}: {M} rows, K={K}, scale {tuple(scale.shape)}: the kernel "
                         f"takes M <= {RESIDUAL_MAX_M}, K <= {RESIDUAL_MAX_K}, aligned operands "
                         "and int4 groups of a multiple of 16 columns (residual_route)")


def q8_residual_rmsnorm_matvec(h_in, upd, post_w, norm_w, qt, scale, *, eps=1e-6, h_out,
                               out_dtype=torch.bfloat16, out=None, gelu=False):
    """h_out (M, K) f32 <- bf16(bf16(h_in) + bf16(rms(upd) * (1 + post_w))),
    then rms_norm(h_out; norm_w) @ dequant(qt int8, scale) -> (M, N), in one
    kernel, at most 4 rows (``residual_route``). h_out must not overlap
    h_in. ``gelu`` as for ``q8_matvec``."""
    if h_in.device.type == "cpu":
        return residual_rmsnorm_matvec_plain(h_in, upd, post_w, norm_w, qt, scale, eps=eps,
                                             h_out=h_out, out_dtype=out_dtype, out=out, gelu=gelu)
    if out is None:
        out = _empty_out(h_in, qt.shape[0], out_dtype, gelu)
    M, N, K = _check_matvec("q8_residual_rmsnorm_matvec", h_in, qt, scale, out, gelu)
    _check_residual("q8_residual_rmsnorm_matvec", h_in, upd, post_w, norm_w, qt, scale, h_out)
    _lib.launch(
        "q8_residual_rmsnorm_matvec", h_in.data_ptr(), upd.data_ptr(), post_w.data_ptr(),
        _lib.dtype_code(post_w), norm_w.data_ptr(), _lib.dtype_code(norm_w), float(eps),
        qt.data_ptr(), scale.data_ptr(), h_out.data_ptr(), out.data_ptr(), _lib.dtype_code(out),
        M, N, K, int(gelu),
    )
    q8_residual_rmsnorm_matvec.launches += 1
    q8_residual_rmsnorm_matvec.gelu_launches += gelu
    return out


_lib.counted(q8_residual_rmsnorm_matvec, "gelu_launches")


def q4_residual_rmsnorm_matvec(h_in, upd, post_w, norm_w, qt, scale, *, eps=1e-6, h_out,
                               out_dtype=torch.bfloat16, out=None, gelu=False):
    """q8_residual_rmsnorm_matvec for packed int4 weights, per channel or in
    groups of a multiple of 16 columns, at most 4 rows (``residual_route``);
    other operands raise."""
    if h_in.device.type == "cpu":
        return residual_rmsnorm_matvec_plain(h_in, upd, post_w, norm_w, qt, scale, eps=eps,
                                             h_out=h_out, out_dtype=out_dtype, out=out, gelu=gelu)
    if out is None:
        out = _empty_out(h_in, qt.shape[0], out_dtype, gelu)
    M, N, K, G = _check_q4("q4_residual_rmsnorm_matvec", h_in, qt, scale, out, gelu)
    _check_residual("q4_residual_rmsnorm_matvec", h_in, upd, post_w, norm_w, qt, scale, h_out)
    _lib.launch(
        "q4_residual_rmsnorm_matvec", h_in.data_ptr(), upd.data_ptr(), post_w.data_ptr(),
        _lib.dtype_code(post_w), norm_w.data_ptr(), _lib.dtype_code(norm_w), float(eps),
        qt.data_ptr(), scale.data_ptr(), G, h_out.data_ptr(), out.data_ptr(),
        _lib.dtype_code(out), M, N, K, int(gelu),
    )
    q4_residual_rmsnorm_matvec.launches += 1
    q4_residual_rmsnorm_matvec.gelu_launches += gelu
    return out


_lib.counted(q4_residual_rmsnorm_matvec, "gelu_launches")


def q4_route(x, qt, scale) -> str:
    """The kernel that ``q4_matvec`` / ``q4_rmsnorm_matvec`` launch for
    these CUDA operands, as ``csrc/q4_matvec.cu:route_of`` decides: "rows"
    (the few-row kernel of ``csrc/q8_matvec.cu``: M <= 16, x and qt 16-byte
    aligned, per channel or in groups of a multiple of 16 columns), "small"
    (``q4_small_kernel``: the other aligned grouped calls of M <= 16),
    "tiled" (the bf16 tensor-core kernel: the other calls, per channel or in
    groups of a multiple of 16 columns) or "tiled_fma" (``q4_tile_kernel``
    on the fp32 FMA units: the rest, groups of other widths). Launches
    nothing."""
    _lib.check_cuda("q4_route", x, qt, scale)
    G = scale.shape[-1] if scale.dim() == 2 else 0
    return Q4_ROUTES[_lib.library().q4_route(x.data_ptr(), qt.data_ptr(), x.shape[0],
                                             x.shape[1], G)]


# ---------------------------------------------------------------------------
# dispatch on the weight format (quant.py:395-436)
# ---------------------------------------------------------------------------

def matvec(x, qt, scale, *, out_dtype=torch.bfloat16, out=None, gelu=False):
    """The int8 or int4 kernel wrapper, by the dtype of ``qt``."""
    fn = q4_matvec if qt.dtype == torch.uint8 else q8_matvec
    return fn(x, qt, scale, out_dtype=out_dtype, out=out, gelu=gelu)


def rmsnorm_matvec(x, norm_w, qt, scale, *, eps=1e-6, out_dtype=torch.bfloat16, out=None):
    fn = q4_rmsnorm_matvec if qt.dtype == torch.uint8 else q8_rmsnorm_matvec
    return fn(x, norm_w, qt, scale, eps=eps, out_dtype=out_dtype, out=out)


def residual_rmsnorm_matvec(h_in, upd, post_w, norm_w, qt, scale, *, eps=1e-6, h_out,
                            out_dtype=torch.bfloat16, out=None, gelu=False):
    """The int8 or int4 residual kernel wrapper, by the dtype of ``qt``."""
    fn = q4_residual_rmsnorm_matvec if qt.dtype == torch.uint8 else q8_residual_rmsnorm_matvec
    return fn(h_in, upd, post_w, norm_w, qt, scale, eps=eps, h_out=h_out, out_dtype=out_dtype,
              out=out, gelu=gelu)


def matvec_plain(x, qt, scale, *, out_dtype=torch.bfloat16, out=None, gelu=False):
    """The plain version of ``matvec``'s kernel (with ``gelu``, then
    ``gelu_mul_plain``), on any device."""
    if gelu:
        _check_gelu("matvec", out_dtype, qt.shape[0])
    fn = q4_matvec_plain if qt.dtype == torch.uint8 else q8_matvec_plain
    return _plain_out(fn(x, qt, scale, out_dtype=out_dtype), out, gelu)


def rmsnorm_matvec_plain(x, norm_w, qt, scale, *, eps=1e-6, out_dtype=torch.bfloat16, out=None):
    fn = q4_rmsnorm_matvec_plain if qt.dtype == torch.uint8 else q8_rmsnorm_matvec_plain
    y = fn(x, norm_w, qt, scale, eps=eps, out_dtype=out_dtype)
    return y if out is None else out.copy_(y)


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """x (..., K) @ w, where w is a plain (K, N) tensor, a QuantW of any
    format, or a LoRA factor dict over either (the base product plus the
    low-rank one, quant.py:416-419). The kernels take CUDA tensors of at
    most ``_qkernel_max_m`` rows (the JAX package takes its kernel
    off-CPU)."""
    if is_lora_factored(w):
        return qmatmul(x, w["w"]) + (x @ w["a"].to(x.dtype)) @ w["b"].to(x.dtype)
    if not is_quantized(w):
        return x @ w.to(x.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x2.shape[0] <= _qkernel_max_m(w["qt"]):
        y = matvec(x2.contiguous(), w["qt"], w["scale"], out_dtype=x.dtype)
    else:
        y = dequant_matmul(x2, w)
    return y.reshape(*lead, y.shape[-1])


def dequant_matmul(x2: torch.Tensor, w: QuantW) -> torch.Tensor:
    """x2 (M, K) @ a QuantW: a transient dequant in the activation dtype and
    one plain matmul (``qmatmul``'s path above the kernels' rows)."""
    qt = unpack_int4(w["qt"]) if is_int4(w) else w["qt"]
    if is_grouped(w):
        wd = grouped_dequant_t(qt, w["scale"], x2.dtype)
    else:
        wd = qt.to(x2.dtype) * w["scale"].to(x2.dtype)[:, None]
    return x2 @ wd.t()


def qnorm_matmul(x, norm_w, w, *, eps: float = 1e-6):
    """Fused rms_norm + matmul when w is quantized and the rows fit the
    kernel; otherwise rms_norm then qmatmul."""
    from ..models.layers import rms_norm

    if is_quantized(w) and x.is_cuda:
        x2 = x.reshape(-1, x.shape[-1])
        if x2.shape[0] <= _qkernel_max_m(w["qt"]):
            y = rmsnorm_matvec(x2.contiguous(), norm_w, w["qt"], w["scale"], eps=eps,
                               out_dtype=x.dtype)
            return y.reshape(*x.shape[:-1], y.shape[-1])
    return qmatmul(rms_norm(norm_w, x, eps), w)


# ---------------------------------------------------------------------------
# parameter-tree quantization (quant.py:443, :510)
# ---------------------------------------------------------------------------

def _format(bits: int, group_size: Optional[int]):
    if bits == 4:
        return functools.partial(quantize_int4, group_size=group_size)
    return quantize_int8


def _stack(parts) -> QuantW:
    return {"qt": torch.stack([p["qt"] for p in parts]),
            "scale": torch.stack([p["scale"] for p in parts])}


def _quantize_stacked(w: torch.Tensor, quantize=quantize_int8) -> QuantW:
    """quantize one layer of a stacked (L, K, N) tensor at a time, so the
    fp32 temporaries stay one layer's size (the flagship's gate|up is 2.2 GB
    in bf16)."""
    if w.dim() == 2:
        return quantize(w)
    return _stack([quantize(w[i]) for i in range(w.shape[0])])


def _quantize_head(w: torch.Tensor, quantize, chunk: int = 16384) -> QuantW:
    """(K, V) head in column chunks (per-channel and per-group scales are
    independent per column, so chunking changes no bit)."""
    parts = [quantize(w[:, i : i + chunk]) for i in range(0, w.shape[1], chunk)]
    return {"qt": torch.cat([p["qt"] for p in parts]),
            "scale": torch.cat([p["scale"] for p in parts])}


def quantize_lm_params(
    lm_params: Dict[str, Any], *, fuse: bool = True, bits: int = 8,
    group_size: Optional[int] = None, mlp_bits: Optional[int] = None,
) -> Dict[str, Any]:
    """The serving tree of quant.py:443: int8 (bits=8) or packed int4
    (bits=4, per channel or with ``group_size``) weight matrices; ``mlp_bits``
    overrides the MLP's precision (bits=8, mlp_bits=4 is the mixed tree).
    ``fuse`` concatenates q|k|v and gate|up along the output dim (one kernel
    a projection group; the fused decode path needs it); fuse=False keeps
    q, k, v, o, gate, up and down apart, which the unfused decode loop
    serves. Embedding and norms stay."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: weight quantization supports 8 or 4")
    if mlp_bits is not None and mlp_bits not in (4, 8):
        raise ValueError(f"mlp_bits={mlp_bits}: supports 8 or 4 (or None)")
    quantize = _format(bits, group_size)
    quantize_mlp = _format(mlp_bits if mlp_bits is not None else bits, group_size)
    out = dict(lm_params)
    attn = lm_params["layers"]["attn"]
    mlp = lm_params["layers"]["mlp"]
    layers = dict(lm_params["layers"])
    L = attn["q"].shape[0]
    cat = lambda *ws: [torch.cat([w[i] for w in ws], dim=-1) for i in range(L)]  # noqa: E731
    if fuse:
        layers["attn"] = {
            "qkv": _stack([quantize(w) for w in cat(attn["q"], attn["k"], attn["v"])]),
            "o": _quantize_stacked(attn["o"], quantize)}
        layers["mlp"] = {
            "gate_up": _stack([quantize_mlp(w) for w in cat(mlp["gate"], mlp["up"])]),
            "down": _quantize_stacked(mlp["down"], quantize_mlp)}
    else:
        layers["attn"] = {k: _quantize_stacked(v, quantize) for k, v in attn.items()}
        layers["mlp"] = {k: _quantize_stacked(v, quantize_mlp) for k, v in mlp.items()}
    out["layers"] = layers
    if "lm_head" in lm_params:
        out["lm_head"] = _quantize_head(lm_params["lm_head"], quantize)
    return out


def _quantize_wb(p: Dict[str, Any], quantize) -> Dict[str, Any]:
    out = dict(p)
    out["w"] = _quantize_stacked(p["w"], quantize)
    return out


def quantize_vision_params(
    params: Dict[str, Any], *, bits: int = 8, group_size: Optional[int] = None
) -> Dict[str, Any]:
    """int8 or int4 SigLIP encoder matmuls, ZoeDepth BEiT-backbone matmuls and
    the projector (quant.py:510); everything else stays."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: weight quantization supports 8 or 4")
    quantize = _format(bits, group_size)
    out = dict(params)
    if "vision" in params:
        vis = dict(params["vision"])
        layers = dict(vis["layers"])
        layers["attn"] = {k: _quantize_wb(v, quantize) for k, v in layers["attn"].items()}
        layers["mlp"] = {k: _quantize_wb(v, quantize) for k, v in layers["mlp"].items()}
        vis["layers"] = layers
        out["vision"] = vis
    if "zoe" in params:
        zoe = dict(params["zoe"])
        backbone = dict(zoe["backbone"])
        layers = dict(backbone["layers"])
        for name in ("q", "k", "v", "proj", "fc1", "fc2"):
            layers[name] = _quantize_wb(layers[name], quantize)
        backbone["layers"] = layers
        zoe["backbone"] = backbone
        out["zoe"] = zoe
    if "projector" in params:
        out["projector"] = _quantize_wb(params["projector"], quantize)
    return out
