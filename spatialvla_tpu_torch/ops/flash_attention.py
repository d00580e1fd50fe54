"""Flash attention with Gemma2's softcap, GQA, prefix-LM, padding and
sliding-window mask, for the training path (port of
``spatialvla_tpu/ops/flash_attention.py``).

Kernels (``csrc/flash_attention.cu``):
  * ``flash_attention_fwd`` replaces the Pallas forward
    (``_flash_attention_impl`` :188 with ``with_lse``, ``_fa_kernel`` :67);
  * ``flash_attention_bwd_dq`` replaces ``_fa_bwd_dq_kernel`` (:340);
  * ``flash_attention_bwd_dkv`` replaces ``_fa_bwd_dkv_kernel`` (:390) and
    the sum over the q-head group that follows it (:553).
Each wrapper runs its plain PyTorch version (``*_plain``) only for CPU
tensors, launches the kernel for CUDA tensors (or raises), and counts its
launches in ``<wrapper>.launches``.

The forward and the backward each take one of two routes (``fwd_route`` /
``bwd_route``, the twins of the C entries ``flash_fwd_route`` /
``flash_bwd_route``): bf16 operands the bf16 tensor-core kernels ("mma"),
fp32 operands the FMA kernels ("fma"). The tensor-core kernels skip dead
tiles by ``_dead_block``'s rule at their own tiles (``dead_tiles``): 32 x 32
in the backward; in the forward 32 keys against a block's 64 q rows and
against each warp's 16. Where the dk/dv grid would leave SMs idle, a
cluster of blocks shares each kv head's q heads (``bwd_split``).
``flash_attention_fwd_fma``
and ``flash_attention_bwd_fma`` launch the FMA kernels in either dtype, as
a yardstick; no wrapper of the training or serving path calls them.

Layouts follow the JAX package: q (B, Tq, Nq, D), k / v (B, Tk, Nkv, D),
prefix / valid / q_offset (B,) int32, LSE (B, Nq, Tq, 1) fp32. Masked
logits are -1e30 (not -inf), as in the Pallas kernel; a query row with no
allowed key is defined differently by the kernel (0 when every tile is
dead, else uniform over the keys of its live tiles) and by the plain
versions (uniform over all keys, as ``_attention_reference``). Such rows
occur only in padding and receive no gradient; compare rows with at least
one allowed key (``allowed_rows``).

``flash_attention`` is the differentiable entry point
(``torch.autograd.Function``); ``flash_attention_with_lse`` and
``flash_attention_bwd`` are the LSE-returning forward and the backward that
ring attention calls (``spatialvla_tpu/parallel/ring_attention.py:110,161``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _lib

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# mask and the reference
# ---------------------------------------------------------------------------

def attention_mask(prefix_lens, valid_lens, q_offset, Tq: int, Tk: int, *,
                   window: Optional[int], causal: bool) -> torch.Tensor:
    """(B, Tq, Tk) bool: k < valid AND (k <= q OR k < prefix) AND q - k < window,
    with q positions offset by q_offset (flash_attention.py:51-60)."""
    dev = valid_lens.device
    q_pos = q_offset.long()[:, None] + torch.arange(Tq, device=dev)[None, :]
    k_pos = torch.arange(Tk, device=dev)[None, None, :]
    mask = k_pos < valid_lens.long()[:, None, None]
    if causal:
        allowed = k_pos <= q_pos[:, :, None]
        if prefix_lens is not None:
            allowed = allowed | (k_pos < prefix_lens.long()[:, None, None])
        mask = mask & allowed
    if window is not None:
        mask = mask & ((q_pos[:, :, None] - k_pos) < window)
    return mask


def allowed_rows(prefix_lens, valid_lens, q_offset, Tq: int, Tk: int, *,
                 window: Optional[int], causal: bool) -> torch.Tensor:
    """(B, Tq) bool: query rows that may attend to at least one key."""
    return attention_mask(prefix_lens, valid_lens, q_offset, Tq, Tk,
                          window=window, causal=causal).any(-1)


def _capped_logits(q, k, scale, logit_softcap):
    """(B, Nkv, g, Tq, Tk) fp32 scaled, softcapped logits and 1 - tanh^2."""
    B, Tq, Nq, D = q.shape
    Nkv = k.shape[2]
    qg = q.reshape(B, Tq, Nkv, Nq // Nkv, D)
    s = torch.einsum("btngd,bsnd->bngts", qg.float(), k.float()) * scale
    if logit_softcap is None:
        return s, None
    s = torch.tanh(s / logit_softcap) * logit_softcap
    return s, 1.0 - (s / logit_softcap) ** 2


def attention_reference(q, k, v, prefix_lens, valid_lens, q_offset, *,
                        scale, logit_softcap=None, window=None, causal=True):
    """Port of ``_attention_reference`` (flash_attention.py:39): dense fp32
    logits and softmax, probabilities in q's dtype before p @ v."""
    B, Tq, Nq, D = q.shape
    s, _ = _capped_logits(q, k, scale, logit_softcap)
    mask = attention_mask(prefix_lens, valid_lens, q_offset, Tq, k.shape[1],
                          window=window, causal=causal)
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bngts,bsnd->btngd", probs, v)
    return out.reshape(B, Tq, Nq, D)


# ---------------------------------------------------------------------------
# plain versions of the kernels
# ---------------------------------------------------------------------------

def flash_attention_fwd_plain(q, k, v, prefix_lens, valid_lens, q_offset, *,
                              scale, logit_softcap=None, window=None, causal=True):
    """(out (B, Tq, Nq, D) in q's dtype, lse (B, Nq, Tq, 1) fp32): dense
    logits and an fp32 softmax; p is rounded to v's dtype before p @ v and
    the sum l is taken before that rounding, as in the kernel."""
    B, Tq, Nq, D = q.shape
    Nkv = k.shape[2]
    s, _ = _capped_logits(q, k, scale, logit_softcap)
    mask = attention_mask(prefix_lens, valid_lens, q_offset, Tq, k.shape[1],
                          window=window, causal=causal)
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bngts,bsnd->bngtd", p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)  # (B, Nkv, g, Tq, D)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Tq, Nq, D)
    lse = (m + torch.log(l)).reshape(B, Nkv * (Nq // Nkv), Tq, 1)
    return out, lse


def _bwd_plain(q, k, v, dout, lse, delta, prefix_lens, valid_lens, q_offset, *,
               scale, logit_softcap=None, window=None, causal=True, need_dq=True,
               need_dkv=True):
    B, Tq, Nq, D = q.shape
    Nkv = k.shape[2]
    g = Nq // Nkv
    s, dcap = _capped_logits(q, k, scale, logit_softcap)
    mask = attention_mask(prefix_lens, valid_lens, q_offset, Tq, k.shape[1],
                          window=window, causal=causal)
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.exp(s - lse.float().reshape(B, Nkv, g, Tq, 1))
    dog = dout.reshape(B, Tq, Nkv, g, D).float()
    dp = torch.einsum("btngd,bsnd->bngts", dog, v.float())
    ds = p * (dp - delta.float().reshape(B, Nkv, g, Tq, 1))
    if dcap is not None:
        ds = ds * dcap
    dq = dk = dv = None
    if need_dq:
        dq = scale * torch.einsum("bngts,bsnd->btngd", ds.to(k.dtype).float(), k.float())
        dq = dq.reshape(B, Tq, Nq, D).to(q.dtype)
    if need_dkv:
        dk = scale * torch.einsum("bngts,btngd->bsnd", ds.to(q.dtype).float(),
                                  q.reshape(B, Tq, Nkv, g, D).float())
        dv = torch.einsum("bngts,btngd->bsnd", p.to(dout.dtype).float(), dog)
        dk, dv = dk.to(k.dtype), dv.to(v.dtype)
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, out, lse, dout, prefix_lens, valid_lens, q_offset, *,
                              scale, logit_softcap=None, window=None, causal=True):
    """(dq, dk, dv) as the Pallas backward computes them: p recomputed from
    the LSE, delta = rowsum(dO * O), ds = p (dp - delta) (1 - tanh^2);
    dq = scale ds k, dk = scale ds^T q, dv = p^T dO, with p and ds rounded to
    the operand dtype before their products; dk / dv summed over the q-head
    group in fp32 and cast to k's dtype."""
    return _bwd_plain(q, k, v, dout, lse, attention_delta(out, dout), prefix_lens, valid_lens,
                      q_offset, scale=scale, logit_softcap=logit_softcap, window=window,
                      causal=causal)


def flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, prefix_lens, valid_lens, q_offset,
                                 **kw):
    """Plain version of the dq kernel (same arguments)."""
    return _bwd_plain(q, k, v, dout, lse, delta, prefix_lens, valid_lens, q_offset,
                      need_dkv=False, **kw)[0]


def flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta, prefix_lens, valid_lens, q_offset,
                                  **kw):
    """Plain version of the dk/dv kernel (same arguments)."""
    return _bwd_plain(q, k, v, dout, lse, delta, prefix_lens, valid_lens, q_offset,
                      need_dq=False, **kw)[1:]


def attention_delta(out, dout) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, Nq, Tq) (flash_attention.py:476)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# the routes and tiles (twins of csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

ROUTES = {0: "fma", 1: "mma"}
# the tensor-core kernels' tiles: a block owns 32 q rows (dq) or keys
# (dk/dv) and streams tiles of 32 keys (dq) or q rows (dk/dv)
BWD_TILE = 32


def bwd_route(dtype: torch.dtype, head_dim: int) -> Optional[str]:
    """The backward kernels a call takes: "mma" (bf16, tensor cores), "fma"
    (fp32), or None for operands the kernels refuse (``route_of`` in
    csrc/flash_attention.cu)."""
    if head_dim % 16 or not 16 <= head_dim <= 256:
        return None
    return {torch.bfloat16: "mma", torch.float32: "fma"}.get(dtype)


fwd_route = bwd_route  # the forward's route follows the same rule (route_of)

# the tensor-core forward: 4 warps of 16 q rows a block
FWD_WARP_ROWS, FWD_ROWS = 16, 64


def bwd_split(B: int, Tk: int, Nkv: int, G: int, sms: int) -> int:
    """Blocks of a cluster that share one dk/dv tile's G q heads on a card
    of ``sms`` SMs: 1 where the 32-key blocks give every SM one, else G up
    to 8 (``dkv_split``)."""
    return 1 if -(-Tk // BWD_TILE) * Nkv * B >= sms else min(G, 8)


def dead_tiles(prefix_lens, valid_lens, q_offset, Tq: int, Tk: int, block_q: int, block_k: int,
               *, window: Optional[int], causal: bool) -> torch.Tensor:
    """(B, ceil(Tq / block_q), ceil(Tk / block_k)) bool: the tiles that a
    tensor-core kernel skips, by the rule of ``_dead_block``
    (flash_attention.py:327; ``dead_block`` in csrc/flash_attention.cu)."""
    dev = valid_lens.device
    q_start = (q_offset.long()[:, None, None]
               + torch.arange(0, Tq, block_q, device=dev)[None, :, None])
    k_start = torch.arange(0, Tk, block_k, device=dev)[None, None, :]
    dead = (k_start >= valid_lens.long()[:, None, None]).expand(-1, q_start.shape[1], -1)
    if causal:
        dead = dead | ((k_start > q_start + block_q - 1)
                       & (k_start >= prefix_lens.long()[:, None, None]))
    if window is not None:
        dead = dead | ((q_start - (k_start + block_k - 1)) >= window)
    return dead


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

# the devices whose tensors the wrappers below hand to the plain versions:
# the CPU, and "meta", whose tensors carry shapes without data (a training
# step's shapes at full width with no card); the other kernels' wrappers
# raise on meta
PLAIN_DEVICES = ("cpu", "meta")


def _geometry(name, q, k, v, prefix_lens, valid_lens, q_offset, window):
    B, Tq, Nq, D = q.shape
    _, Tk, Nkv, Dk = k.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape[0] != B or Dk != D or tuple(v.shape) != tuple(k.shape) or Nq % Nkv:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "are not (B, Tq, Nq, D), (B, Tk, Nkv, D) with Nkv dividing Nq")
    if D % 16 or not 16 <= D <= 256:
        raise ValueError(f"{name}: the kernel takes head_dim a multiple of 16 up to 256, got {D}")
    for t in (prefix_lens, valid_lens, q_offset):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise TypeError(f"{name}: prefix/valid/q_offset must be int32 ({B},)")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive or None, got {window}")
    return B, Tq, Tk, Nq, Nkv, D


def _tail(dims, scale, logit_softcap, window, causal):
    return (*dims, float(scale), float(logit_softcap or 0.0), int(window or 0), int(bool(causal)))


def flash_attention_fwd(q, k, v, prefix_lens, valid_lens, q_offset, *,
                        scale, logit_softcap=None, window=None, causal=True):
    """Kernel wrapper; see flash_attention_fwd_plain for the contract."""
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_fwd_plain(q, k, v, prefix_lens, valid_lens, q_offset, scale=scale,
                                         logit_softcap=logit_softcap, window=window, causal=causal)
    out, lse = _launch_fwd("flash_attention_fwd", "flash_fwd", q, k, v, prefix_lens, valid_lens,
                           q_offset, scale, logit_softcap, window, causal)
    flash_attention_fwd.launches += 1
    return out, lse


_lib.counted(flash_attention_fwd)


def _launch_fwd(name, entry, q, k, v, prefix_lens, valid_lens, q_offset, scale, logit_softcap,
                window, causal):
    _lib.check_cuda(name, q, k, v, prefix_lens, valid_lens, q_offset)
    dims = _geometry(name, q, k, v, prefix_lens, valid_lens, q_offset, window)
    B, Tq, _, Nq, _, _ = dims
    q, k, v = _aligned16(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, Nq, Tq, 1), dtype=torch.float32, device=q.device)
    _lib.launch(
        entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), prefix_lens.data_ptr(),
        valid_lens.data_ptr(), q_offset.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _lib.dtype_code(q), *_tail(dims, scale, logit_softcap, window, causal),
    )
    return out, lse


def flash_attention_fwd_fma(q, k, v, prefix_lens, valid_lens, q_offset, *,
                            scale, logit_softcap=None, window=None, causal=True):
    """(out, lse) from the FMA forward in the operands' dtype: the route bf16
    calls took before the tensor-core kernel, kept to time the two side by
    side. CUDA tensors only; counts no launch, and neither the training nor
    the serving path calls it."""
    return _launch_fwd("flash_attention_fwd_fma", "flash_fwd_fma", q, k, v, prefix_lens,
                       valid_lens, q_offset, scale, logit_softcap, window, causal)


def _check_bwd(name, q, k, v, dout, lse, delta, prefix_lens, valid_lens, q_offset, window):
    _lib.check_cuda(name, q, k, v, dout, lse, delta, prefix_lens, valid_lens, q_offset)
    dims = _geometry(name, q, k, v, prefix_lens, valid_lens, q_offset, window)
    B, Tq, _, Nq, _, _ = dims
    if dout.dtype != q.dtype or dout.shape != q.shape:
        raise ValueError(f"{name}: dout must match q ({q.dtype} {tuple(q.shape)})")
    if lse.dtype != torch.float32 or lse.numel() != B * Nq * Tq:
        raise ValueError(f"{name}: lse must be float32 (B, Nq, Tq, 1)")
    if delta.dtype != torch.float32 or tuple(delta.shape) != (B, Nq, Tq):
        raise ValueError(f"{name}: delta must be float32 (B, Nq, Tq)")
    return dims


def _aligned16(*ts):
    """The tensors, each copied where its data does not start on 16 bytes:
    the tensor-core route loads 16 bytes at a time."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, prefix_lens, valid_lens, q_offset, *,
                           scale, logit_softcap=None, window=None, causal=True):
    """dq kernel: (B, Tq, Nq, D) in q's dtype, from the LSE and delta; bf16
    on tensor cores, fp32 on the FMA units (``bwd_route``)."""
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, prefix_lens, valid_lens,
                                            q_offset, scale=scale, logit_softcap=logit_softcap,
                                            window=window, causal=causal)
    name = "flash_attention_bwd_dq"
    dims = _check_bwd(name, q, k, v, dout, lse, delta, prefix_lens, valid_lens, q_offset, window)
    q, k, v, dout = _aligned16(q, k, v, dout)
    dq = torch.empty_like(q)
    _lib.launch(
        "flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), prefix_lens.data_ptr(), valid_lens.data_ptr(),
        q_offset.data_ptr(), dq.data_ptr(), _lib.dtype_code(q),
        *_tail(dims, scale, logit_softcap, window, causal),
    )
    flash_attention_bwd_dq.launches += 1
    return dq


_lib.counted(flash_attention_bwd_dq)


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, prefix_lens, valid_lens, q_offset, *,
                            scale, logit_softcap=None, window=None, causal=True):
    """dk / dv kernel: (B, Tk, Nkv, D) each in k's dtype, summed over the
    q-head group inside the kernel."""
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta, prefix_lens, valid_lens,
                                             q_offset, scale=scale, logit_softcap=logit_softcap,
                                             window=window, causal=causal)
    name = "flash_attention_bwd_dkv"
    dims = _check_bwd(name, q, k, v, dout, lse, delta, prefix_lens, valid_lens, q_offset, window)
    q, k, v, dout = _aligned16(q, k, v, dout)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _lib.launch(
        "flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), prefix_lens.data_ptr(), valid_lens.data_ptr(),
        q_offset.data_ptr(), dk.data_ptr(), dv.data_ptr(), _lib.dtype_code(q),
        *_tail(dims, scale, logit_softcap, window, causal),
    )
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


_lib.counted(flash_attention_bwd_dkv)


def flash_attention_bwd_fma(q, k, v, dout, lse, delta, prefix_lens, valid_lens, q_offset, *,
                            scale, logit_softcap=None, window=None, causal=True, dq=True,
                            dkv=True):
    """(dq, dk, dv) from the FMA kernels in the operands' dtype (None for a
    kernel not asked for): the route bf16 calls took before the tensor-core
    kernels, kept to time the two side by side. CUDA tensors only; counts no
    launch, and the training path never calls it."""
    name = "flash_attention_bwd_fma"
    dims = _check_bwd(name, q, k, v, dout, lse, delta, prefix_lens, valid_lens, q_offset, window)
    dq_t = torch.empty_like(q) if dq else None
    dk_t, dv_t = (torch.empty_like(k), torch.empty_like(v)) if dkv else (None, None)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    _lib.launch(
        "flash_bwd_fma", q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), prefix_lens.data_ptr(), valid_lens.data_ptr(),
        q_offset.data_ptr(), ptr(dq_t), ptr(dk_t), ptr(dv_t), _lib.dtype_code(q),
        *_tail(dims, scale, logit_softcap, window, causal),
    )
    return dq_t, dk_t, dv_t


def library_bwd_route(dtype: torch.dtype, head_dim: int) -> Optional[str]:
    """``bwd_route`` as the kernel library decides it (C entry
    ``flash_bwd_route``; builds the library, launches nothing)."""
    code = {torch.float32: _lib.DT_F32, torch.bfloat16: _lib.DT_BF16}.get(dtype, -1)
    return ROUTES.get(_lib.library().flash_bwd_route(code, head_dim))


def library_fwd_route(dtype: torch.dtype, head_dim: int) -> Optional[str]:
    """``fwd_route`` as the kernel library decides it (C entry
    ``flash_fwd_route``; builds the library, launches nothing)."""
    code = {torch.float32: _lib.DT_F32, torch.bfloat16: _lib.DT_BF16}.get(dtype, -1)
    return ROUTES.get(_lib.library().flash_fwd_route(code, head_dim))


def fwd_plan(q, k, *, fma: bool = False) -> dict:
    """What the forward launches for CUDA operands shaped as q and k,
    without launching it: route, grid, threads a block, dynamic shared
    bytes, blocks an SM (the occupancy calculator's), blocks a cluster (1), q
    rows a block, registers and local memory bytes a thread (spills).
    ``fma`` asks about the FMA kernel of ``flash_attention_fwd_fma``
    instead."""
    import ctypes

    B, Tq, Nq, D = q.shape
    Tk, Nkv = k.shape[1], k.shape[2]
    out = (ctypes.c_int * 10)()
    route = _lib.library().flash_fwd_plan(int(fma), _lib.dtype_code(q), B, Tq, Tk, Nq, Nkv, D,
                                          out)
    if route < 0:
        raise RuntimeError(f"flash_fwd_plan failed: {route}")
    return {"route": ROUTES[route], "grid": tuple(out[:3]), "threads": out[3],
            "smem_bytes": out[4], "blocks_per_sm": out[5], "cluster": out[6],
            "rows": out[7], "registers": out[8], "local_bytes": out[9]}


def bwd_plan(kernel: str, q, k, *, fma: bool = False) -> dict:
    """What the backward ``kernel`` ("dq" or "dkv") launches for CUDA
    operands shaped as q and k, without launching it: route, grid, threads a
    block, dynamic shared bytes, blocks an SM (the occupancy calculator's)
    and blocks a cluster. ``fma`` asks about the FMA kernels of
    ``flash_attention_bwd_fma`` instead of the wrappers' route."""
    import ctypes

    B, Tq, Nq, D = q.shape
    Tk, Nkv = k.shape[1], k.shape[2]
    out = (ctypes.c_int * 7)()
    route = _lib.library().flash_bwd_plan(int(kernel == "dkv"), int(fma), _lib.dtype_code(q), B,
                                          Tq, Tk, Nq, Nkv, D, out)
    if route < 0:
        raise RuntimeError(f"flash_bwd_plan({kernel}) failed: {route}")
    return {"route": ROUTES[route], "grid": tuple(out[:3]), "threads": out[3],
            "smem_bytes": out[4], "blocks_per_sm": out[5], "cluster": out[6]}


def flash_attention_bwd(q, k, v, out, lse, dout, prefix_lens, valid_lens, q_offset, *,
                        scale, logit_softcap=None, window=None, causal=True):
    """(dq, dk, dv): delta in torch, then the dq and dk/dv kernels (their
    plain versions for CPU tensors)."""
    kw = dict(scale=scale, logit_softcap=logit_softcap, window=window, causal=causal)
    dout = dout.contiguous()
    delta = attention_delta(out, dout)
    args = (q, k, v, dout, lse, delta, prefix_lens, valid_lens, q_offset)
    dq = flash_attention_bwd_dq(*args, **kw)
    dk, dv = flash_attention_bwd_dkv(*args, **kw)
    return dq, dk, dv


def flash_attention_with_lse(q, k, v, prefix_lens, valid_lens, q_offset, *,
                             scale, logit_softcap=None, window=None, causal=True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) without autograd: the forward ring attention merges."""
    return flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                               *_lens(prefix_lens, valid_lens, q_offset), scale=scale,
                               logit_softcap=logit_softcap, window=window, causal=causal)


def _lens(*ts):
    return tuple(t.to(torch.int32).contiguous() for t in ts)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, prefix_lens, valid_lens, q_offset, scale, logit_softcap, window,
                causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_fwd(q, k, v, prefix_lens, valid_lens, q_offset, scale=scale,
                                       logit_softcap=logit_softcap, window=window, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse, prefix_lens, valid_lens, q_offset)
        ctx.kw = dict(scale=scale, logit_softcap=logit_softcap, window=window, causal=causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, prefix_lens, valid_lens, q_offset = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, prefix_lens, valid_lens,
                                         q_offset, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q, k, v, prefix_lens, valid_lens, q_offset, scale: float = 1.0,
                    logit_softcap: Optional[float] = None, window: Optional[int] = None,
                    causal: bool = True) -> torch.Tensor:
    """Differentiable flash attention with the JAX argument order
    (flash_attention.py:168): q (B, Tq, Nq, D), k / v (B, Tk, Nkv, D),
    prefix / valid / q_offset (B,) -> (B, Tq, Nq, D) in q's dtype. The
    backward runs the dq and dk/dv kernels from the saved LSE."""
    return _FlashAttention.apply(q, k, v, *_lens(prefix_lens, valid_lens, q_offset),
                                 scale, logit_softcap, window, causal)
