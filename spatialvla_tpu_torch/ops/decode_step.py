"""One greedy decode position through every Gemma2 layer, on any fused
serving tree (int8, int4, grouped int4, int8 + int4 MLP) with a bf16 or an
int8 KV cache.

Port of the Pallas kernel ``spatialvla_tpu/ops/decode_step.py:fused_decode_step``
(``_decode_kernel``). The TPU runs the whole stack as one kernel whose grid
walks (layer, phase); Hopper blocks run in no order and keep nothing between
launches, so here each layer is a fixed sequence of hand-written kernels
launched from a Python loop over the stacked layer tensors, 5 a layer and
one at the end (131 for Gemma2-2B's 26 layers) at up to 4 rows:

    residual_rmsnorm_matvec  the previous layer's post-FFN norm + residual
                             (JAX _post_ffn), then the input norm + fused qkv
                             (_input_norm; layer 0: rmsnorm_matvec of x)
                             (csrc/q8_matvec.cu, q4_matvec.cu)
    decode_attention    RoPE, cache + self logits, softcap, softmax, p @ V,
                        the cache split across blocks and merged in the
                        same launch (decode_attention_kv8 on an int8 cache)
                        (csrc/decode.cu)
    matvec              o projection
    residual_rmsnorm_matvec  post-attention norm + residual, then the
                             pre-FFN norm + fused gate|up (_post_attn), and in
                             its epilogue gelu_tanh(gate) * up (gelu=True)
    matvec              down projection
    norm_residual       (after the last layer) its post-FFN norm + residual
                        and the final norm

Where the residual kernels do not take the operands (``quant.residual_route``:
above 4 rows, where the fold loses to the pair on the card; misaligned; int4
groups of a width that is not a multiple of 16 columns), ``norm_residual``
updates the residual and writes the next norm's bf16 x' (its ``final_w``
mode: what JAX's ``xn_scr`` holds), and the plain ``matvec`` takes x' (7
launches a layer, 6 in layer 0, and one at the end: 182 a step). Where the
few-row kernel does not take gate|up (``quant.gelu_route``: int4 groups of
another width, misaligned) the projection writes gate | up and ``gelu_mul``
follows it. The routes are chosen by shape before the first launch.

Each projection takes the kernel of its own format (``_matvec_block``,
decode_step.py:120-168): q8_* for int8 weights, q4_* for packed int4, per
channel or grouped, so ``mlp_bits=4`` runs int8 attention and an int4 MLP.
The loop only launches kernels; no step of the layer math is a torch op,
and the buffers, the attention kernels' scratch among them, are allocated
once per step before it (``step_buffers``; the decode loop's CUDA graph
passes its own). The residual stream alternates between two fp32 (M, H)
buffers: a residual kernel reads one and writes the other, which its other
blocks must not see half-written. The bf16 rounding points are those of
decode_step.py:220-372.
The per-row RoPE cos/sin tables are built here, as the JAX wrapper builds
them outside its kernel (decode_step.py:461-467).

What bounds a step: streaming the weights, 26 layers x 77.9 MB = 2.02 GB in
int8 on the flagship (about half in int4), plus the cache (about 30 MB in
bf16 at S = 278, half in int8). The launches are many and short: the host
takes longer to enqueue them than the card to run them, unless they are
replayed as a CUDA graph (``models/spatialvla.py`` captures the whole
greedy loop, step after step, into one). A persistent kernel is left for
later work.

``fused_decode_step_plain`` runs the same loop with every kernel's plain
PyTorch version; it is the reference the kernels are held to on the card.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Any, Dict, Tuple

import torch

from . import _lib
from .quant import (gelu_mul_plain, gelu_route, matvec, matvec_plain, residual_rmsnorm_matvec,
                    residual_rmsnorm_matvec_plain, residual_route, rmsnorm_matvec,
                    rmsnorm_matvec_plain)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def _softcap(x, cap):
    return torch.tanh(x / cap) * cap if cap else x


def decode_attention_plain(qkv, cos, sin, ck, cv, position, *, num_heads, q_scale, cap,
                           attn_out, k_new, v_new, ks=None, vs=None):
    """Plain version of the decode_attention kernels for one layer.

    qkv (M, (Nq + 2 Nkv) D) bf16; cos/sin (M, D) f32; ck/cv (M, Nkv, S, D)
    bf16, or int8 codes with this layer's per-slot scales ks / vs in the flat
    (Nkv, 1, M S) layout (decode_attention_kv8); position (M,) int32 (row m
    attends to cache slots [0, position[m]) plus itself). Writes attn_out
    (M, Nq D), k_new / v_new (M, Nkv, D), unquantized."""
    M, Nkv, S, D = ck.shape
    Nq = num_heads
    G = Nq // Nkv
    NqD, NkvD = Nq * D, Nkv * D
    f = qkv.float()
    c = cos.to(torch.bfloat16).float()[:, None, :]
    s = sin.to(torch.bfloat16).float()[:, None, :]
    k = _rope(f[:, NqD : NqD + NkvD].reshape(M, Nkv, D), c, s)
    v = f[:, NqD + NkvD :].reshape(M, Nkv, D)
    q = _rope(f[:, :NqD].reshape(M, Nq, D), c, s) * q_scale
    q16 = q.to(torch.bfloat16).float().reshape(M, Nkv, G, D)
    k16 = k.to(torch.bfloat16).float()
    logits = torch.einsum("mhgd,mhsd->mhgs", q16, ck.float())
    if ks is not None:  # per-slot K scales fold into the logits (decode_step.py:289-293)
        logits = logits * _slot_scales(ks, M, S)
    logits = _softcap(logits, cap)
    self_l = _softcap((q16 * k16[:, :, None, :]).sum(-1), cap)  # (M, Nkv, G)
    valid = torch.arange(S, device=ck.device)[None, :] < position.to(ck.device)[:, None]
    logits = torch.where(valid[:, None, None, :], logits, torch.full_like(logits, -1e30))
    mx = torch.maximum(logits.amax(-1), self_l)
    e = torch.exp(logits - mx[..., None])
    e_self = torch.exp(self_l - mx)
    denom = e.sum(-1) + e_self
    probs = e / denom[..., None]
    if vs is not None:  # per-slot V scales fold into the probabilities (:313-316)
        probs = probs * _slot_scales(vs, M, S)
    out = torch.einsum("mhgs,mhsd->mhgd", probs.to(torch.bfloat16).float(), cv.float())
    out = out + (e_self / denom).to(torch.bfloat16).float()[..., None] * v[:, :, None, :]
    attn_out.copy_(out.reshape(M, NqD))
    k_new.copy_(k)
    v_new.copy_(v)


def _slot_scales(sc, M, S):
    """Flat (Nkv, 1, M S) per-slot scales -> (M, Nkv, 1, S)."""
    return sc.float().reshape(sc.shape[0], M, S).permute(1, 0, 2)[:, :, None, :]


def _check_attention(name, qkv, cos, sin, ck, cv, position, num_heads, attn_out, k_new, v_new,
                     cache_dtype, scales=()):
    _lib.check_cuda(name, qkv, cos, sin, ck, cv, position, attn_out, k_new, v_new, *scales)
    M, Nkv, S, D = ck.shape
    for t in (qkv, attn_out, k_new, v_new):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: qkv and the outputs must be bf16, got {t.dtype}")
    if ck.dtype != cache_dtype or cv.dtype != cache_dtype:
        raise TypeError(f"{name}: the cache must be {cache_dtype}, got {ck.dtype} / {cv.dtype}")
    if cos.dtype != torch.float32 or sin.dtype != torch.float32 or position.dtype != torch.int32:
        raise TypeError(f"{name}: cos/sin must be float32 and position int32")
    shapes = ((qkv, (M, (num_heads + 2 * Nkv) * D)), (cos, (M, D)), (sin, (M, D)),
              (cv, (M, Nkv, S, D)), (position, (M,)), (attn_out, (M, num_heads * D)),
              (k_new, (M, Nkv, D)), (v_new, (M, Nkv, D)))
    shapes += tuple((t, (Nkv, 1, M * S)) for t in scales)
    if any(tuple(t.shape) != s for t, s in shapes):
        raise ValueError(f"{name}: operand shapes do not match the cache "
                         f"(M, Nkv, S, D) = {(M, Nkv, S, D)} and {num_heads} query heads")
    if any(t.dtype != torch.float32 for t in scales):
        raise TypeError(f"{name}: the per-slot scales must be float32")
    if D % 32 or D > 1024 or num_heads % Nkv or num_heads // Nkv > 8:
        raise ValueError(f"{name}: the kernel takes head_dim a multiple of 32 up to "
                         f"1024 and at most 8 query heads per kv head, got D={D}, "
                         f"{num_heads}/{Nkv} heads")
    if ck.data_ptr() % 16 or cv.data_ptr() % 16:
        raise ValueError(f"{name}: the cache must start 16-byte aligned (the kernel reads "
                         "16-byte vectors)")
    return M, Nkv, S, D


def attention_chunk(M, Nkv, S):
    """Cache slots per block of the split attention kernels (csrc/decode.cu),
    from the shapes alone (a CUDA graph may replay the launch at other
    positions): 32, doubled while a (row, kv head) would have more than 64
    chunks (the merge keeps their statistics in shared memory) or the grid
    more than 512 blocks. 36 blocks at batch 1 on the serving path's S = 278,
    384 at 16 rows and S = 332, 256 at batch 1 and S = 4096."""
    C = 32
    while C < 1024 and (-(-S // C) > 64 or M * Nkv * -(-S // C) > 512):
        C *= 2
    if -(-S // C) > 64:
        raise ValueError(f"decode attention: the kernels take caches of up to 65536 slots, got {S}")
    return C


def _scratch_layout(M, Nkv, S, D, num_heads, C):
    """(tickets, partial floats) of the attention scratch at chunk C; the
    partials start 16-byte aligned."""
    G = num_heads // Nkv
    return -(-M * Nkv // 4) * 4, M * Nkv * -(-S // C) * G * (D + 2)


def attention_scratch(M, Nkv, S, D, num_heads, device):
    """Zeroed fp32 scratch of the decode_attention kernels for an (M, Nkv, S,
    D) cache: M * Nkv tickets, which each launch leaves zero, then each
    chunk's partial max, sum and p @ V. One scratch serves every layer of a
    step: launches on one stream run in order."""
    n_tickets, n_part = _scratch_layout(M, Nkv, S, D, num_heads, attention_chunk(M, Nkv, S))
    return torch.zeros(n_tickets + n_part, dtype=torch.float32, device=device)


def _scratch_ptrs(name, scratch, M, Nkv, S, D, num_heads, C, device):
    """(partials, tickets) pointers, allocating the scratch when not given."""
    n_tickets, n_part = _scratch_layout(M, Nkv, S, D, num_heads, C)
    if scratch is None:
        scratch = attention_scratch(M, Nkv, S, D, num_heads, device)
    elif (scratch.dtype != torch.float32 or scratch.device != device
          or not scratch.is_contiguous() or scratch.numel() < n_tickets + n_part):
        raise ValueError(f"{name}: scratch must be attention_scratch{(M, Nkv, S, D, num_heads)}")
    return scratch.data_ptr() + 4 * n_tickets, scratch.data_ptr()


def decode_attention(qkv, cos, sin, ck, cv, position, *, num_heads, q_scale, cap,
                     attn_out, k_new, v_new, scratch=None):
    """Kernel wrapper, bf16 cache; see decode_attention_plain for the contract.
    ``scratch``: an ``attention_scratch`` of this shape, allocated here when
    not given (the decode step allocates one per step)."""
    if qkv.device.type == "cpu":
        return decode_attention_plain(
            qkv, cos, sin, ck, cv, position, num_heads=num_heads, q_scale=q_scale,
            cap=cap, attn_out=attn_out, k_new=k_new, v_new=v_new,
        )
    M, Nkv, S, D = _check_attention("decode_attention", qkv, cos, sin, ck, cv, position,
                                    num_heads, attn_out, k_new, v_new, torch.bfloat16)
    C = attention_chunk(M, Nkv, S)
    part, tickets = _scratch_ptrs("decode_attention", scratch, M, Nkv, S, D, num_heads, C,
                                  qkv.device)
    _lib.launch(
        "decode_attention", qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), ck.data_ptr(),
        cv.data_ptr(), position.data_ptr(), attn_out.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), part, tickets, M, num_heads, Nkv, D, S, C, float(q_scale),
        float(cap or 0.0),
    )
    decode_attention.launches += 1


_lib.counted(decode_attention)


def decode_attention_kv8(qkv, cos, sin, ck, cv, position, *, ks, vs, num_heads, q_scale, cap,
                         attn_out, k_new, v_new, scratch=None):
    """Kernel wrapper, int8 cache ck / cv (M, Nkv, S, D) with this layer's
    per-slot scales ks / vs (Nkv, 1, M S) f32; see decode_attention_plain
    and, for ``scratch``, decode_attention."""
    if qkv.device.type == "cpu":
        return decode_attention_plain(
            qkv, cos, sin, ck, cv, position, num_heads=num_heads, q_scale=q_scale,
            cap=cap, attn_out=attn_out, k_new=k_new, v_new=v_new, ks=ks, vs=vs,
        )
    M, Nkv, S, D = _check_attention("decode_attention_kv8", qkv, cos, sin, ck, cv, position,
                                    num_heads, attn_out, k_new, v_new, torch.int8, (ks, vs))
    C = attention_chunk(M, Nkv, S)
    part, tickets = _scratch_ptrs("decode_attention_kv8", scratch, M, Nkv, S, D, num_heads, C,
                                  qkv.device)
    _lib.launch(
        "decode_attention_kv8", qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), ck.data_ptr(),
        cv.data_ptr(), ks.data_ptr(), vs.data_ptr(), position.data_ptr(), attn_out.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), part, tickets, M, num_heads, Nkv, D, S, C,
        float(q_scale), float(cap or 0.0),
    )
    decode_attention_kv8.launches += 1


_lib.counted(decode_attention_kv8)


# ---------------------------------------------------------------------------
# norm_residual
# ---------------------------------------------------------------------------

def _rms(x, w, eps):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * (1.0 + w.float())


def norm_residual_plain(h, upd, w, *, eps, final_w=None, final_out=None):
    """h (M, H) f32 <- bf16(bf16(h) + bf16(rms(upd) * (1 + w))) in place;
    with final_w also final_out (M, H) bf16 <- bf16(rms(h) * (1 + final_w))."""
    up = _rms(upd, w, eps).to(torch.bfloat16).float()
    h.copy_((h.to(torch.bfloat16).float() + up).to(torch.bfloat16).float())
    if final_w is not None:
        final_out.copy_(_rms(h, final_w, eps))


# the kernel holds a row in registers, 8 columns a thread, up to 1024 threads
NORM_RESIDUAL_MAX_H = 8192


def norm_residual(h, upd, w, *, eps, final_w=None, final_out=None):
    """Kernel wrapper; see norm_residual_plain. H a multiple of 8 up to
    ``NORM_RESIDUAL_MAX_H`` (Gemma2's 2304, 3584, 4608), every operand
    16-byte aligned; others raise."""
    if h.device.type == "cpu":
        return norm_residual_plain(h, upd, w, eps=eps, final_w=final_w, final_out=final_out)
    if (final_w is None) != (final_out is None):
        raise ValueError("norm_residual: final_w and final_out go together")
    extra = () if final_w is None else (final_w, final_out)
    _lib.check_cuda("norm_residual", h, upd, w, *extra)
    M, H = h.shape
    if h.dtype != torch.float32 or upd.dtype != torch.bfloat16 or tuple(upd.shape) != (M, H):
        raise TypeError("norm_residual: h must be float32 (M, H) and upd bf16 (M, H)")
    if final_out is not None and final_out.dtype != torch.bfloat16:
        raise TypeError("norm_residual: final_out must be bf16")
    if tuple(w.shape) != (H,) or (final_w is not None and (
            tuple(final_w.shape) != (H,) or tuple(final_out.shape) != (M, H))):
        raise ValueError(f"norm_residual: norm weights must be ({H},) and final_out ({M}, {H})")
    if H % 8 or H > NORM_RESIDUAL_MAX_H:
        raise ValueError(f"norm_residual: the kernel holds a row in registers, 8 columns a "
                         f"thread: H a multiple of 8 up to {NORM_RESIDUAL_MAX_H}, got {H}")
    if any(t.data_ptr() % 16 for t in (h, upd, w) + extra):
        raise ValueError("norm_residual: every operand must start 16-byte aligned (the kernel "
                         "reads and writes 16-byte vectors)")
    _lib.launch(
        "norm_residual", h.data_ptr(), upd.data_ptr(), w.data_ptr(), _lib.dtype_code(w),
        None if final_w is None else final_w.data_ptr(),
        _lib.DT_F32 if final_w is None else _lib.dtype_code(final_w),
        None if final_out is None else final_out.data_ptr(), M, H, float(eps),
    )
    norm_residual.launches += 1


_lib.counted(norm_residual)


# ---------------------------------------------------------------------------
# gelu_mul
# ---------------------------------------------------------------------------

# gelu_mul_plain (quant.py, also the plain version of the matvecs' gelu
# epilogue): out (M, I) bf16 <- bf16(bf16(gelu_tanh(gate)) * up)

def gelu_mul(gu, *, out):
    """Kernel wrapper; see gelu_mul_plain. The decode step launches it only
    where its gate|up matvec does not take the gelu epilogue
    (``quant.gelu_route``)."""
    if gu.device.type == "cpu":
        return gelu_mul_plain(gu, out=out)
    _lib.check_cuda("gelu_mul", gu, out)
    M, I = out.shape
    if gu.dtype != torch.bfloat16 or out.dtype != torch.bfloat16 or tuple(gu.shape) != (M, 2 * I):
        raise TypeError("gelu_mul: gu must be bf16 (M, 2I) and out bf16 (M, I)")
    _lib.launch("gelu_mul", gu.data_ptr(), out.data_ptr(), M, I)
    gelu_mul.launches += 1


_lib.counted(gelu_mul)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _attention_kernel(qkv, cos, sin, ck, cv, position, *, ks, vs, **kw):
    """decode_attention on a bf16 cache, decode_attention_kv8 on an int8 one."""
    if ks is None:
        return decode_attention(qkv, cos, sin, ck, cv, position, **kw)
    return decode_attention_kv8(qkv, cos, sin, ck, cv, position, ks=ks, vs=vs, **kw)


def _attention_plain(*args, scratch, **kw):
    """decode_attention_plain, which needs no scratch."""
    return decode_attention_plain(*args, **kw)


KERNELS = SimpleNamespace(
    rmsnorm_matvec=rmsnorm_matvec, residual_rmsnorm_matvec=residual_rmsnorm_matvec,
    residual_route=residual_route, gelu_route=gelu_route, matvec=matvec,
    attention=_attention_kernel, norm_residual=norm_residual, gelu_mul=gelu_mul,
)
PLAIN = SimpleNamespace(
    rmsnorm_matvec=rmsnorm_matvec_plain, residual_rmsnorm_matvec=residual_rmsnorm_matvec_plain,
    residual_route=residual_route, gelu_route=gelu_route, matvec=matvec_plain,
    attention=_attention_plain, norm_residual=norm_residual_plain, gelu_mul=gelu_mul_plain,
)


def flatten_kv_scales(sc: torch.Tensor) -> torch.Tensor:
    """(L, M, Nkv, S) per-slot KV scales -> the flat (L, Nkv, 1, M*S) layout
    (decode_step.py:91-103): column j of a (layer, kv head) row is cache slot
    (m = j // S, s = j % S). Persistent callers keep their scales in this
    layout and write each step's new scales into it directly."""
    L, M, Nkv, S = sc.shape
    return sc.float().permute(0, 2, 1, 3).reshape(L, Nkv, 1, M * S).contiguous()


def rope_tables(rope_position: torch.Tensor, head_dim: int, theta: float):
    """(M,) int positions -> per-row (M, D) fp32 cos, sin (decode_step.py:461-467)."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=rope_position.device)
                  / head_dim)
    )
    freqs = rope_position.float()[:, None] * inv_freq[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).contiguous(), torch.sin(emb).contiguous()


def _kv_scales(cfg, M, S, cache_k, cache_k_scale, cache_v_scale):
    """The flat (L, Nkv, 1, M*S) f32 scales of an int8 cache, from either
    layout (decode_step.py:411-435); (None, None) for a bf16 cache."""
    if cache_k.dtype != torch.int8:
        return None, None
    if cache_k_scale is None or cache_v_scale is None:
        raise ValueError("int8 KV cache requires per-slot cache_k_scale/cache_v_scale")
    L, Nkv = cfg.num_layers, cfg.num_kv_heads
    flat_shape = (L, Nkv, 1, M * S)
    if tuple(cache_k_scale.shape) == flat_shape and tuple(cache_v_scale.shape) == flat_shape:
        return cache_k_scale.float().contiguous(), cache_v_scale.float().contiguous()
    for sc in (cache_k_scale, cache_v_scale):
        if tuple(sc.shape) != (L, M, Nkv, S):
            raise ValueError(f"cache_k_scale: expected {(L, M, Nkv, S)} or {flat_shape}, "
                             f"got {tuple(sc.shape)}")
    return flatten_kv_scales(cache_k_scale), flatten_kv_scales(cache_v_scale)


def step_buffers(cfg, M: int, S: int, device) -> SimpleNamespace:
    """The buffers of one step at M rows and an S-slot cache: the two fp32
    residual buffers the step alternates between (a residual kernel reads
    one and writes the other), the normed x' of a projection that the
    residual kernels do not take, the projections' and attention's outputs,
    the final hidden state, the new K / V rows, and (on the card) the
    attention scratch. ``fused_decode_step`` allocates them per call unless
    given; the decode loop's CUDA graph allocates them once."""
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    Nq, Nkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    empty = functools.partial(torch.empty, dtype=torch.bfloat16, device=device)
    return SimpleNamespace(
        h=(torch.empty((M, H), dtype=torch.float32, device=device),
           torch.empty((M, H), dtype=torch.float32, device=device)),
        xn=empty((M, H)), qkv=empty((M, (Nq + 2 * Nkv) * D)), attn=empty((M, Nq * D)),
        o=empty((M, H)),
        gu=empty((M, 2 * I)), act=empty((M, I)), dn=empty((M, H)), hidden=empty((M, H)),
        k_new=empty((L, M, Nkv, D)), v_new=empty((L, M, Nkv, D)),
        scratch=(attention_scratch(M, Nkv, S, D, Nq, device)
                 if torch.device(device).type == "cuda" else None),
    )


def _step(ops, lm_params: Params, cfg, x, cache_k, cache_v, position, rope_position,
          cache_k_scale, cache_v_scale, bufs=None):
    layers = lm_params["layers"]
    qkv, o = layers["attn"]["qkv"], layers["attn"]["o"]
    gu, dn = layers["mlp"]["gate_up"], layers["mlp"]["down"]
    for w in (qkv, o, gu, dn):
        if w["qt"].dtype not in (torch.int8, torch.uint8):
            raise TypeError(f"decode step: weights must be int8 or packed int4, got {w['qt'].dtype}")
    if cache_k.dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"decode step: the KV cache must be bf16 or int8, got {cache_k.dtype}")
    L, M = cfg.num_layers, x.shape[0]
    Nq, D = cfg.num_heads, cfg.head_dim
    S = cache_k.shape[3]
    if S > cfg.sliding_window:
        raise ValueError(
            "serving cache exceeds the sliding window; the decode step treats "
            "window and global layers identically"
        )
    ks, vs = _kv_scales(cfg, M, S, cache_k, cache_k_scale, cache_v_scale)
    dev = x.device
    position = torch.as_tensor(position, dtype=torch.int32, device=dev).reshape(-1).expand(M).contiguous()
    rope_position = torch.as_tensor(rope_position, dtype=torch.int32, device=dev).reshape(-1).expand(M)
    cos, sin = rope_tables(rope_position, D, cfg.rope_theta)

    bf = torch.bfloat16
    b = step_buffers(cfg, M, S, dev) if bufs is None else bufs
    h, spare = b.h  # the residual stream; a residual kernel writes its update into `spare`
    h.copy_(x)
    # the weights whose RMSNorm matvec takes the residual update in front
    # (one launch instead of norm_residual with the next norm's x' + matvec),
    # and whether gate|up's kernel computes gelu(gate) * up in its epilogue
    # (one launch instead of gate|up + gelu_mul): routes by rows, shape and
    # alignment, chosen before any launch
    fold = {"qkv": ops.residual_route(h, qkv["qt"][0], qkv["scale"][0]),
            "gu": ops.residual_route(h, gu["qt"][0], gu["scale"][0])}
    gelu = ops.gelu_route(h if fold["gu"] else b.xn, gu["qt"][0], gu["scale"][0])
    eps = cfg.rms_norm_eps
    q_scale = cfg.query_pre_attn_scalar ** -0.5

    def norm_matvec(upd, post_w, norm_w, name, w, l, out, gelu=False):
        """out <- the RMSNorm matvec (norm_w, layer l of w; with ``gelu``
        gelu(gate) * up of it) of h after h's residual update by upd with
        post_w (no update: upd None)."""
        nonlocal h, spare
        q, s = w["qt"][l], w["scale"][l]
        if upd is None:
            ops.rmsnorm_matvec(h, norm_w, q, s, eps=eps, out_dtype=bf, out=out)
        elif fold[name]:
            ops.residual_rmsnorm_matvec(h, upd, post_w, norm_w, q, s, eps=eps, h_out=spare,
                                        out_dtype=bf, out=out, gelu=gelu)
            h, spare = spare, h
        else:  # the update writes the normed x' (JAX's xn_scr), the matvec reads it
            ops.norm_residual(h, upd, post_w, eps=eps, final_w=norm_w, final_out=b.xn)
            ops.matvec(b.xn, q, s, out_dtype=bf, out=out, gelu=gelu)

    for l in range(L):
        # layer l - 1's post-FFN residual update and layer l's input norm
        # (JAX: _post_ffn, then _input_norm); layer 0 norms x itself
        norm_matvec(b.dn if l else None, layers["post_ffn_norm"][l - 1],
                    layers["input_norm"][l], "qkv", qkv, l, b.qkv)
        ops.attention(b.qkv, cos, sin, cache_k[l], cache_v[l], position,
                      ks=None if ks is None else ks[l], vs=None if vs is None else vs[l],
                      num_heads=Nq, q_scale=q_scale, cap=cfg.attn_logit_softcap,
                      attn_out=b.attn, k_new=b.k_new[l], v_new=b.v_new[l], scratch=b.scratch)
        ops.matvec(b.attn, o["qt"][l], o["scale"][l], out_dtype=bf, out=b.o)
        # the post-attention residual update and the pre-FFN norm (_post_attn),
        # gate|up and gelu(gate) * up
        norm_matvec(b.o, layers["post_attn_norm"][l], layers["pre_ffn_norm"][l], "gu", gu, l,
                    b.act if gelu else b.gu, gelu)
        if not gelu:
            ops.gelu_mul(b.gu, out=b.act)
        ops.matvec(b.act, dn["qt"][l], dn["scale"][l], out_dtype=bf, out=b.dn)
    ops.norm_residual(h, b.dn, layers["post_ffn_norm"][L - 1], eps=eps,
                      final_w=lm_params["final_norm"], final_out=b.hidden)
    b.residual = h  # which of b.h holds the residual stream after the last layer
    return b.hidden, b.k_new, b.v_new


def fused_decode_step(
    lm_params: Params, cfg, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
    position, rope_position, *, cache_k_scale=None, cache_v_scale=None, buffers=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same signature and results as the JAX ``fused_decode_step``.

    x (M, H) embeddings * sqrt(H); cache_k / cache_v (L, M, Nkv, S, D) in
    serving layout, bf16, or int8 codes with per-slot f32 ``cache_*_scale``
    in (L, M, Nkv, S) or the flat (L, Nkv, 1, M*S) layout
    (``flatten_kv_scales``); valid slots [0, position); position /
    rope_position int scalars or (M,) per-row vectors. Returns (hidden (M, H)
    bf16 final-normed, k_new, v_new (L, M, Nkv, D) bf16, unquantized); the
    caller writes k_new / v_new (quantized, for an int8 cache) into the cache
    at ``position``. ``buffers``: a ``step_buffers`` of this shape, which the
    results then live in (allocated per call when not given)."""
    return _step(KERNELS, lm_params, cfg, x, cache_k, cache_v, position, rope_position,
                 cache_k_scale, cache_v_scale, buffers)


def fused_decode_step_plain(lm_params, cfg, x, cache_k, cache_v, position, rope_position, *,
                            cache_k_scale=None, cache_v_scale=None, buffers=None):
    """fused_decode_step with every kernel replaced by its plain version."""
    return _step(PLAIN, lm_params, cfg, x, cache_k, cache_v, position, rope_position,
                 cache_k_scale, cache_v_scale, buffers)
