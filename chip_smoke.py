#!/usr/bin/env python3
"""Start the PyTorch port (spatialvla_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

1. Builds the CUDA kernels from spatialvla_tpu_torch/csrc (nvcc, sm_90a).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it, and times both, beside
   the least time the card could take (bytes over 3.35 TB/s or operations
   over 989 TFLOP/s) and one PyTorch call computing the same function where
   there is one (torch._weight_int8pack_mm, torch._weight_int4pack_mm; for
   the RMSNorm variants their matmul alone, in the log): the int8 and int4
   matvecs (per channel and in 128-column groups, 1 and 16 rows; int4 also
   the prefill's projections at 277 rows, SigLIP's and the projector's at
   256, qkv at 512 and 17, beside the FMA tiles that took those rows before
   the tensor-core kernel; 16- and 24-column groups checked untimed; each
   int4 call's kernel printed and held to its route, its fp32 output to
   plain within 5e-3 and its bf16 output within 2e-2), the bf16- and
   int8-cache decode attention (also on a 4096-slot cache), norm_residual,
   gelu_mul, the residual kernels (norm_residual folded into the next
   RMSNorm matvec: int8, int4, int4-g128 at 1 and 4 rows, qkv and gate|up,
   bf16 and fp32 out, timed beside the norm_residual + RMSNorm matvec pair
   they replace), a 2-layer decode step, the flash kernels (the bf16
   backward on its tensor-core route, each call's route and grid printed,
   two launches bit-identical, and timed beside the FMA kernels it
   replaces, with its TFLOP/s and share of the bound).
3. The decode-step matrix of bench.py:111-160 at full width (26 layers,
   M = 16, S = 332, per-row positions): {int8, int4, int4-g128, int8+mlp4}
   x {bf16, int8} KV cache, the fused step against the masked forward on the
   same tree (relative drift below 0.05 / 0.08); and the step of every
   format at batch 1 (S = 289, bf16 cache).
4. Drives the serving path: SpatialVLAPolicy.predict on full-width
   spatialvla_4b() (SigLIP-so400m, ZoeDepth BEiT-L, Gemma2-2B with 26 layers)
   with random weights from a seed, after quantize(bits=8): first requests
   that capture the decode loop's CUDA graphs (one per batch size and
   64-slot cache bucket; capture times printed), then three requests and
   one right-padded predict_batch of two rows through them. The kernels'
   launch counts over that run must all be positive and those of the decode
   steps exact: per step 2 L - 1 residual kernels, one norm_residual. The
   wrappers' counts are credited per graph replay, so each graph is replayed
   once under torch.profiler and the library's kernels in the trace, by
   wrapper, must equal its credits (also in (5) below). The
   actions must be finite, of shape (4, 7), from action ids in the action
   block, and the greedy ids must follow the unfused decode path's (first
   token equal; equal up to the first step whose margin is below 0.5). One
   more request runs with the flash-attention prefill (use_flash_prefill=True)
   and is held to the default path's ids under the same rule. The decode
   loop through the graph and eagerly on the same request and 2-row batch:
   identical ids and margins, each loop's time (CUDA events); warm predict
   medians through the graph and with use_cuda_graph=False, in turns; a
   stream of 24 requests with 24 instruction lengths from no graph at all,
   each through the graphs and eagerly (captures, hit rate, both ways'
   latency, identical ids and margins); the
   26-layer step at M=1, S=289 (each layer alone also held to plain) and at
   M=16, S=332 (graph, eager and enqueue times); then the bf16 tree put back
   and quantize(bits=4): the next request must follow the int4 tree.
5. The same entry point after quantize(bits=4), quantize(bits=8, mlp_bits=4,
   kv_bits=8) (plus a 16-row predict_batch) and quantize(bits=4,
   group_size=128, vision_bits=4): warm-up requests (the captures) and five
   timed requests each through the decode graph and five eagerly, the
   decode loop both ways with identical ids and margins,
   the launches of one request (the int4 kernels in the prefill and every
   decode step, the int8-cache attention 26 x 11 times, and how many int4
   calls took the tensor-core kernel: none fails), the device time of the
   vision front and the prefill (CUDA events) with the tensor-core kernel
   and with the FMA tiles in its place, and two requests' ids under the
   margin rule against the unfused path and the served path with the q4
   wrappers' plain versions, or the bf16 cache.
6. Drives the training path: full-parameter training of full-width
   spatialvla_4b() (fp32 masters, bf16 compute, remat, flash attention,
   256-token loss chunks, AdamW with clipping, batch 2 x 320 built by the
   port's processor) through train_loop for 5 steps. The flash kernels must
   launch 2 x 26 (forward, with remat) and 26 (dq, dk/dv) times per step;
   the metrics must be finite; the frozen LM embedding and ZoeDepth must be
   bit-identical afterwards. Before that, one loss and gradient of the same
   batch and weights with attn_backend="xla" is held to the flash one
   (LOSS_BOUND, GRAD_NORM_BOUND). Then spatialvla_tiny(use_vision_zoe=True)
   must overfit one batch through the kernels (loss down by more than 0.5 in
   8 steps at lr 5e-3).
7. Prints the card, the kernels' JSON line (with each decode kernel's
   launches in one replay of the graphs checked, traced and credited), and
   last {"ok": true, ...}.

Needs CUDA; there is no CPU path. Imports nothing of jax.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

MARGIN_BOUND = 0.5  # greedy ids may differ only after a step with a smaller margin
# flash vs xla attention on one bf16 training step of spatialvla_4b: the two
# backends round p, the attention output and the gradients to bf16 at other
# points (about 2^-8 relative each), through 26 layers
LOSS_BOUND = 1e-2  # |loss_flash - loss_xla| / |loss_xla|
GRAD_NORM_BOUND = 5e-2  # |gn_flash - gn_xla| / gn_xla
# flash kernels against their plain versions: max|kernel - plain| / max|plain|
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# int4 matvecs with fp32 outputs against their plain versions: the same
# function in another fp32 summation order
Q4_FP32_TOL = 5e-3


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


class Timer:
    """Device time of a callable in ms, with a 64 MB write before each run so
    that the run finds the 50 MB L2 cold, as on the serving path (a decode
    step streams ~2 GB of weights).

    ``timer(fn)``: `n` runs of [write, fn] captured into one CUDA graph; the
    median of 5 replays, minus that of a graph of the writes alone, over `n`.
    The host's launch overhead is not in it, so calls on hosts of different
    speed agree. ``timer.eager(fn)``: the median of `n` eager runs between
    CUDA events, which includes the gaps where the card waits for the host."""

    def __init__(self, torch, n: int = 20):
        self.torch, self.n = torch, n
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def _events(self, run) -> float:
        a = self.torch.cuda.Event(enable_timing=True)
        b = self.torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def _graph_ms(self, body) -> float:
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the capture, as CUDA graphs need
            for _ in range(3):
                body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(self.n):
                body()
        graph.replay()
        return statistics.median(self._events(graph.replay) for _ in range(5))

    def __call__(self, fn) -> float:
        both = self._graph_ms(lambda: (self.flush.zero_(), fn()))
        return (both - self._graph_ms(self.flush.zero_)) / self.n

    def eager(self, fn) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(self.n):
            self.flush.zero_()
            times.append(self._events(fn))
        return statistics.median(times)


# the H100 SXM's published peaks (NVIDIA data sheet): HBM3 bytes/s and dense
# bf16 tensor-core operations/s; the bound of a call is the larger of its
# bytes (each input read once, each output written once) and its operations
# over these rates
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12


def bound(nbytes: float, ops: float):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record_kernel(results, name, shape, err, ms, plain_ms, *, nbytes=None, ops=None,
                  library_ms=None):
    """One timed (or, with ms None, only checked) shape of a kernel; the
    first timed shape of each kernel is its main path's shape."""
    entry = results.setdefault(name, {"max_abs_err": 0.0, "ms": {}, "plain_ms": {},
                                      "bound": {}, "library_ms": {}})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if ms is not None:
        entry["ms"][shape], entry["plain_ms"][shape] = ms, plain_ms
        entry["bound"][shape] = bound(nbytes, ops)
        entry["library_ms"][shape] = library_ms


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict, list or tuple."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return nbytes_of(tree) if hasattr(tree, "element_size") else 0


def library_int8pack(torch, timer, x, qt, scale):
    """torch._weight_int8pack_mm (x bf16 @ int8 (N, K)^T * bf16 per-channel
    scale): the one PyTorch call that computes q8_matvec's function, where
    this build has its CUDA kernel. Returns (ms, rel err vs the plain
    version) or (None, the reason)."""
    s16 = scale.to(torch.bfloat16)
    x16 = x.to(torch.bfloat16)
    try:
        y = torch._weight_int8pack_mm(x16, qt, s16)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        return None, f"torch._weight_int8pack_mm unavailable on CUDA here: {str(e)[:120]}"
    from spatialvla_tpu_torch.ops import quant

    _, r = rel_err(y, quant.q8_matvec_plain(x, qt, scale))
    return timer(lambda: torch._weight_int8pack_mm(x16, qt, s16)), f"rel err {r:.2e} vs plain"


def library_int4pack(torch, timer, x, qt, scale):
    """torch._weight_int4pack_mm (x bf16 @ ((c - 8) * scale + zero)^T, c the
    biased 4-bit codes, bf16 scales and zeros per group of 32-256 columns):
    q4_matvec's function with zero = 0, once the weight is repacked to its
    layout outside the timer (adjacent columns per byte, high nibble first,
    then _convert_weight_to_int4pack's tiles). Per-channel scales repeat over
    256-column groups; 128-column groups map one to one. N is padded to a
    multiple of 8 with zero channels, as its tiles need. Returns (ms, a note
    with the rel err vs the plain version and the padding) or (None, the
    reason)."""
    from spatialvla_tpu_torch.ops import quant

    N, K = qt.shape[0], 2 * qt.shape[1]
    w32 = qt.to(torch.int32)
    codes = torch.cat([w32 & 15, w32 >> 4], dim=-1)  # (N, K) biased, column order
    gsize = K // scale.shape[1] if scale.dim() == 2 else (256 if K % 256 == 0 else 128)
    s = scale.float() if scale.dim() == 2 else scale.float()[:, None].expand(N, K // gsize)
    pad = -N % 8
    codes = torch.nn.functional.pad(codes, (0, 0, 0, pad))
    s = torch.nn.functional.pad(s, (0, 0, 0, pad))
    packed = ((codes[:, ::2] << 4) | codes[:, 1::2]).to(torch.uint8)
    sz = torch.stack([s.t(), torch.zeros_like(s.t())], dim=-1).to(torch.bfloat16).contiguous()
    x16 = x.to(torch.bfloat16)
    try:
        wp = torch._convert_weight_to_int4pack(packed.contiguous(), 8)
        y = torch._weight_int4pack_mm(x16, wp, gsize, sz)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError, TypeError) as e:
        return None, f"torch._weight_int4pack_mm unavailable on CUDA here: {str(e)[:160]}"
    _, r = rel_err(y[:, :N], quant.q4_matvec_plain(x, qt, scale))
    note = f"rel err {r:.2e} vs plain, {gsize}-column groups"
    if pad:
        note += f", N padded {N} -> {N + pad}"
    return timer(lambda: torch._weight_int4pack_mm(x16, wp, gsize, sz)), note


def q4_tiled_fma(torch, x, norm_w, qt, scale, *, out_dtype=None, eps=1e-6):
    """The fp32 FMA tiles of csrc/q4_matvec.cu (q4_tiled_fma: what the q4
    wrappers launched above 16 rows before the tensor-core kernel) on these
    CUDA operands; norm_w None for no RMSNorm. -> (M, N) in out_dtype (bf16
    by default). Counts no launch: a yardstick, not the main path."""
    from spatialvla_tpu_torch.ops import _lib

    out = torch.empty(x.shape[0], qt.shape[0], dtype=out_dtype or torch.bfloat16,
                      device=x.device)
    _lib.launch("q4_tiled_fma", x.data_ptr(), _lib.dtype_code(x),
                0 if norm_w is None else norm_w.data_ptr(),
                0 if norm_w is None else _lib.dtype_code(norm_w), float(eps), qt.data_ptr(),
                scale.data_ptr(), scale.shape[1] if scale.dim() == 2 else 0, out.data_ptr(),
                _lib.dtype_code(out), x.shape[0], qt.shape[0], 2 * qt.shape[1])
    return out


def rel_err(a, b):
    a, b = a.float(), b.float()
    d = (a - b).abs().max().item()
    return d, d / (b.abs().max().item() + 1e-12)


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def kernel_phases(torch, timer, results, notes):
    from spatialvla_tpu_torch import Gemma2Config
    from spatialvla_tpu_torch.models import gemma2
    from spatialvla_tpu_torch.ops import decode_step as ds
    from spatialvla_tpu_torch.ops import quant

    g = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    def qweight(N, K, bits=8, group_size=None):
        w = randn(K, N, dtype=torch.float32, std=0.02)
        return quant.quantize_int8(w) if bits == 8 else quant.quantize_int4(w, group_size)

    def record(name, shape, err, ms, plain_ms, nbytes, ops, library_ms=None):
        record_kernel(results, name, shape, err, ms, plain_ms, nbytes=nbytes, ops=ops,
                      library_ms=library_ms)

    def check(name, shape, r, bound_rel=1e-2):
        if not r < bound_rel:
            fail(f"{name} {shape}: rel err {r} >= {bound_rel}")

    # q8_matvec: the action head (M = 1, 2304 -> 8194), the down projection
    # at batch 16 (9216 -> 2304), the decode step's o (2048 -> 2304) and
    # down (9216 -> 2304) projections at batch 1, and o at batch 16
    for M, K, N in ((1, 2304, 8194), (16, 9216, 2304), (1, 2048, 2304), (1, 9216, 2304),
                    (16, 2048, 2304)):
        x, w = randn(M, K), qweight(N, K)
        y = quant.q8_matvec(x, w["qt"], w["scale"])
        ref = quant.q8_matvec_plain(x, w["qt"], w["scale"])
        d, r = rel_err(y, ref)
        ms = timer(lambda: quant.q8_matvec(x, w["qt"], w["scale"]))
        pms = timer(lambda: quant.q8_matvec_plain(x, w["qt"], w["scale"]))
        lib, note = library_int8pack(torch, timer, x, w["qt"], w["scale"])
        notes.setdefault("q8_matvec", note)
        print(f"q8_matvec M={M} {K}->{N}: max|d|={d:.3e} rel={r:.3e} kernel {ms:.4f} ms "
              f"plain {pms:.4f} ms library {lib} ms ({note})", flush=True)
        check("q8_matvec", f"M={M}", r)
        record("q8_matvec", f"M{M}_{K}x{N}", d, ms, pms, nbytes_of(x, w["qt"], w["scale"], y),
               2 * M * N * K, lib)

    # q8_rmsnorm_matvec: input norm + qkv (2304 -> 4096) and pre-FFN norm +
    # gate|up (2304 -> 18432), on the fp32 residual stream; beside it the
    # library's int8 matmul alone on the plain normed x (not the same function)
    for M in (1, 16):
        for N in (4096, 18432):
            K = 2304
            x, nw, w = randn(M, K, dtype=torch.float32), randn(K, std=0.1), qweight(N, K)
            y = quant.q8_rmsnorm_matvec(x, nw, w["qt"], w["scale"])
            ref = quant.q8_rmsnorm_matvec_plain(x, nw, w["qt"], w["scale"])
            d, r = rel_err(y, ref)
            ms = timer(lambda: quant.q8_rmsnorm_matvec(x, nw, w["qt"], w["scale"]))
            pms = timer(lambda: quant.q8_rmsnorm_matvec_plain(x, nw, w["qt"], w["scale"]))
            lib, note = library_int8pack(torch, timer, quant._rms_bf16(x, nw, 1e-6), w["qt"],
                                         w["scale"])
            print(f"q8_rmsnorm_matvec M={M} {K}->{N}: max|d|={d:.3e} rel={r:.3e} "
                  f"kernel {ms:.4f} ms plain {pms:.4f} ms library matmul alone {lib} ms "
                  f"({note})", flush=True)
            check("q8_rmsnorm_matvec", f"M={M} N={N}", r)
            record("q8_rmsnorm_matvec", f"M{M}_{K}x{N}", d, ms, pms,
                   nbytes_of(x, nw, w["qt"], w["scale"], y), 2 * M * N * K + 4 * M * K)
    notes["q8_rmsnorm_matvec"] = ("no single PyTorch call fuses the RMSNorm with the matmul "
                                  "(the log gives _weight_int8pack_mm's matmul alone)")

    # q4_matvec / q4_rmsnorm_matvec, per channel and in 128-column groups: the
    # action head (M = 1), the decode projections at M = 1 and 16 (qkv and
    # gate|up with their norms, down and o without); the int4 prefill's
    # projections at 277 rows (qkv, gate|up, o, down, and qkv without its
    # norm); SigLIP-so400m's and the projector's at 256 rows, per channel as
    # quantize_vision_params makes them (q/k/v/o 1152->1152, fc1 1152->4304,
    # fc2 4304->1152, projector 1152->2304); qkv at 512 and 17 rows. Groups of
    # other widths (any that quantize_int4 makes) checked untimed: 16 columns
    # (one scale a half unit), 24 (not a multiple of 16; not for o, whose K =
    # 2048 no 24-column group tiles). Each call must take its kernel
    # (q4_route): the few-row kernel of q8_matvec.cu at M <= 16 per channel or
    # in groups of a multiple of 16 columns, q4_small_kernel for other groups;
    # above 16 rows the tensor-core kernel, or the FMA tiles for groups of
    # other widths. Its fp32 output within Q4_FP32_TOL of plain (the bf16
    # output may round a value a unit apart, up to 2^-7 of max|plain|: 2e-2).
    # Above 16 rows the FMA tiles (q4_tiled_fma), which took those calls
    # before the tensor-core kernel, are timed beside it
    LM, VISION = (None, 128, 16, 24), (None,)
    q4_cases = (  # name, M, K, N, scale formats (group size, None per channel)
        ("q4_matvec", 1, 2304, 8194, LM), ("q4_rmsnorm_matvec", 1, 2304, 4096, LM),
        ("q4_rmsnorm_matvec", 1, 2304, 18432, LM), ("q4_matvec", 1, 9216, 2304, LM),
        ("q4_matvec", 1, 2048, 2304, LM), ("q4_rmsnorm_matvec", 16, 2304, 4096, LM),
        ("q4_rmsnorm_matvec", 16, 2304, 18432, LM), ("q4_matvec", 16, 9216, 2304, LM),
        ("q4_matvec", 16, 2048, 2304, LM), ("q4_rmsnorm_matvec", 277, 2304, 4096, LM),
        ("q4_rmsnorm_matvec", 277, 2304, 18432, LM), ("q4_matvec", 277, 2048, 2304, LM),
        ("q4_matvec", 277, 9216, 2304, LM), ("q4_matvec", 277, 2304, 4096, LM),
        ("q4_matvec", 256, 1152, 1152, VISION), ("q4_matvec", 256, 1152, 4304, VISION),
        ("q4_matvec", 256, 4304, 1152, VISION), ("q4_matvec", 256, 1152, 2304, VISION),
        ("q4_rmsnorm_matvec", 512, 2304, 4096, LM), ("q4_rmsnorm_matvec", 17, 2304, 4096, LM),
    )
    for group_size in LM:
        tag = f"g{group_size}" if group_size else "pc"
        for name, M, K, N, formats in q4_cases:
            if group_size not in formats or (group_size and K % group_size):
                continue
            norm = name == "q4_rmsnorm_matvec"
            x = randn(M, K, dtype=torch.float32 if norm else torch.bfloat16)
            nw, w = randn(K, std=0.1), qweight(N, K, 4, group_size)
            args = (x, nw, w["qt"], w["scale"]) if norm else (x, w["qt"], w["scale"])
            kern = quant.q4_rmsnorm_matvec if norm else quant.q4_matvec
            plain = quant.q4_rmsnorm_matvec_plain if norm else quant.q4_matvec_plain
            y = kern(*args)
            d, r = rel_err(y, plain(*args))
            check(name, f"{tag} M={M} {K}->{N}", r, 2e-2)
            _, r32 = rel_err(kern(*args, out_dtype=torch.float32),
                             plain(*args, out_dtype=torch.float32))
            check(name, f"{tag} M={M} {K}->{N} fp32 out", r32, Q4_FP32_TOL)
            route = quant.q4_route(x, w["qt"], w["scale"])
            by16 = not group_size or group_size % 16 == 0
            want = ("tiled" if by16 else "tiled_fma") if M > 16 else ("rows" if by16 else "small")
            if route != want:
                fail(f"{name} {tag} M={M} {K}->{N}: took the {route} kernel, not {want}")
            shape = f"{tag}_M{M}_{K}x{N}"
            record_kernel(results, name, shape, d, None, None)
            results[name].setdefault("kernel_taken", {})[shape] = route
            if group_size not in (None, 128):
                print(f"{name} {tag} M={M} {K}->{N} ({route} kernel): max|d|={d:.3e} rel={r:.3e} "
                      f"fp32 out rel={r32:.3e}", flush=True)
                continue
            ms = timer(lambda: kern(*args))
            pms = timer(lambda: plain(*args))
            fma = ""
            if M > 16:
                fma_ms = timer(lambda: q4_tiled_fma(torch, x, nw if norm else None, w["qt"],
                                                    w["scale"]))
                results[name].setdefault("fma_tiles_ms", {})[shape] = fma_ms
                fma = f" FMA tiles {fma_ms:.4f} ms ({fma_ms / ms:.2f}x)"
            # the library's int4 matmul; for the RMSNorm variant only its
            # matmul part (on the plain normed x), which is not the same function
            xl = quant._rms_bf16(x, nw, 1e-6) if norm else x
            lib, note = library_int4pack(torch, timer, xl, w["qt"], w["scale"])
            print(f"{name} {tag} M={M} {K}->{N} ({route} kernel): max|d|={d:.3e} rel={r:.3e} "
                  f"fp32 out rel={r32:.3e} kernel {ms:.4f} ms{fma} plain {pms:.4f} ms "
                  f"library{' matmul alone' if norm else ''} {lib} ms ({note})", flush=True)
            record(name, shape, d, ms, pms, nbytes_of(*args, y),
                   2 * M * N * K + (4 * M * K if norm else 0), None if norm else lib)
            if norm:
                results[name].setdefault("library_matmul_alone_ms", {})[shape] = lib
            else:
                notes.setdefault(name, f"torch._weight_int4pack_mm: {note}")
    notes["q4_rmsnorm_matvec"] = ("no single PyTorch call fuses the RMSNorm with the matmul "
                                  "(the log gives _weight_int4pack_mm's matmul alone)")

    # decode_attention (bf16 cache) and decode_attention_kv8 (int8 codes with
    # per-slot scales) at the serving path's shapes: batch 1 at S = 278
    # (prefix 266 + 12), 2 rows at per-row positions (predict_batch), and
    # 16 rows at S = 332; then batch 1 on a 4096-slot cache (the sliding
    # window, the longest the decode step takes). The kernels get their
    # scratch as the decode step gives it, allocated once
    Nq, Nkv, D = 8, 4, 256
    for M, S, pos in ((1, 278, [270]), (2, 278, [266, 259]), (16, 332, list(range(300, 316))),
                      (1, 4096, [4000])):
        qkv = randn(M, (Nq + 2 * Nkv) * D)
        ck, cv = randn(M, Nkv, S, D, std=0.3), randn(M, Nkv, S, D, std=0.3)
        position = torch.tensor(pos, dtype=torch.int32, device=dev)
        cos, sin = ds.rope_tables(position + 1, D, 10000.0)
        ck8, ks = quant.quantize_kv(ck)
        cv8, vs = quant.quantize_kv(cv)
        flat = lambda sc: sc.permute(1, 0, 2).reshape(Nkv, 1, M * S).contiguous()  # noqa: E731
        kv8 = dict(ks=flat(ks), vs=flat(vs))
        valid = sum(pos)
        scratch = ds.attention_scratch(M, Nkv, S, D, Nq, dev)
        for name, kern, cache, extra, elem in (
                ("decode_attention", ds.decode_attention, (ck, cv), {}, 2),
                ("decode_attention_kv8", ds.decode_attention_kv8, (ck8, cv8), kv8, 1)):
            outs = {}
            for tag, fn in (("kernel", functools.partial(kern, scratch=scratch)),
                            ("plain", ds.decode_attention_plain)):
                bufs = dict(attn_out=torch.empty(M, Nq * D, dtype=torch.bfloat16, device=dev),
                            k_new=torch.empty(M, Nkv, D, dtype=torch.bfloat16, device=dev),
                            v_new=torch.empty(M, Nkv, D, dtype=torch.bfloat16, device=dev))
                call = lambda fn=fn, bufs=bufs: fn(  # noqa: E731
                    qkv, cos, sin, *cache, position, num_heads=Nq, q_scale=D ** -0.5, cap=50.0,
                    **extra, **bufs)
                call()
                outs[tag] = (bufs, timer(call))
            (kb, ms), (pb, pms) = outs["kernel"], outs["plain"]
            d, r = rel_err(kb["attn_out"], pb["attn_out"])
            dk, _ = rel_err(kb["k_new"], pb["k_new"])
            dv, _ = rel_err(kb["v_new"], pb["v_new"])
            print(f"{name} M={M} S={S}: attn max|d|={d:.3e} rel={r:.3e} k_new {dk:.3e} "
                  f"v_new {dv:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms", flush=True)
            if not (r < 1e-2 and dk < 2e-2 and dv == 0.0):
                fail(f"{name} M={M}: rel {r}, k_new {dk}, v_new {dv}")
            # bytes: qkv, RoPE tables, positions, the valid cache rows (and
            # their scales), the outputs; operations: q.k and p.v over the
            # valid slots and the new token's own
            nb = (nbytes_of(qkv, cos, sin, position, *kb.values())
                  + 2 * valid * Nkv * D * elem + (2 * valid * Nkv * 4 if extra else 0))
            record(name, f"M{M}_S{S}", max(d, dk, dv), ms, pms, nb,
                   4 * (valid + M) * Nq * D)
    notes["decode_attention"] = notes["decode_attention_kv8"] = (
        "F.scaled_dot_product_attention has no logit softcap (Gemma2's tanh cap 50)")

    # norm_residual (with the final norm, as on the last layer) and gelu_mul
    H, I = 2304, 9216
    for M in (1, 16):
        h0, upd = randn(M, H, dtype=torch.float32), randn(M, H)
        w, fw = randn(H, std=0.1), randn(H, std=0.1)
        res = {}
        for tag, fn in (("kernel", ds.norm_residual), ("plain", ds.norm_residual_plain)):
            h = h0.clone()
            out = torch.empty(M, H, dtype=torch.bfloat16, device=dev)
            fn(h, upd, w, eps=1e-6, final_w=fw, final_out=out)
            hh = h0.clone()
            t = timer(lambda fn=fn, hh=hh, out=out: (hh.copy_(h0), fn(
                hh, upd, w, eps=1e-6, final_w=fw, final_out=out)))
            res[tag] = (h, out, t)
        d1, r1 = rel_err(res["kernel"][0], res["plain"][0])
        d2, r2 = rel_err(res["kernel"][1], res["plain"][1])
        ms, pms = res["kernel"][2], res["plain"][2]
        print(f"norm_residual M={M}: h max|d|={d1:.3e} out max|d|={d2:.3e} "
              f"kernel {ms:.4f} ms plain {pms:.4f} ms (each incl. a {M}x{H} copy)", flush=True)
        if not (r1 < 1e-2 and r2 < 1e-2):
            fail(f"norm_residual M={M}: rel {r1}, {r2}")
        # h read and written, upd, both norm weights, the final output
        record("norm_residual", f"M{M}_H{H}", max(d1, d2), ms, pms,
               nbytes_of(h0, h0, upd, w, fw, res["kernel"][1]), 12 * M * H)

        gu = randn(M, 2 * I)
        ka = torch.empty(M, I, dtype=torch.bfloat16, device=dev)
        pa = torch.empty_like(ka)
        ds.gelu_mul(gu, out=ka)
        ds.gelu_mul_plain(gu, out=pa)
        d, r = rel_err(ka, pa)
        ms = timer(lambda: ds.gelu_mul(gu, out=ka))
        pms = timer(lambda: ds.gelu_mul_plain(gu, out=pa))
        print(f"gelu_mul M={M} I={I}: max|d|={d:.3e} rel={r:.3e} "
              f"kernel {ms:.4f} ms plain {pms:.4f} ms", flush=True)
        check("gelu_mul", f"M={M}", r)
        record("gelu_mul", f"M{M}_I{I}", d, ms, pms, nbytes_of(gu, ka), 12 * M * I)
    notes["norm_residual"] = "no single PyTorch call: RMSNorm, bf16 roundings and the residual add"
    notes["gelu_mul"] = "no single PyTorch call: gelu(tanh) of one half times the other"

    # q8_residual_rmsnorm_matvec / q4_residual_rmsnorm_matvec: the decode
    # step's residual update (norm_residual) folded into the RMSNorm matvec
    # that follows it, for qkv (2304 -> 4096) and gate|up (2304 -> 18432) at
    # 1 and 4 rows (the most it takes), int8, int4 per channel and in
    # 128-column groups. Held to
    # the plain version (norm_residual_plain then rmsnorm_matvec_plain): the
    # bf16 output within 1e-2 (int8) / 2e-2 (int4) of max|plain|, the fp32
    # output within Q4_FP32_TOL, h_out within 1e-2. Timed beside the pair it
    # replaces in the decode step (norm_residual + the RMSNorm matvec, both
    # launches in the CUDA-graph timer) and beside the library's int8 / int4
    # matmul alone on the plain normed x (not the same function)
    for fmt, qkw in (("int8", None), ("int4", dict(group_size=None)),
                     ("int4-g128", dict(group_size=128))):
        name = "q8_residual_rmsnorm_matvec" if qkw is None else "q4_residual_rmsnorm_matvec"
        for M in (1, 4):
            for N in (4096, 18432):
                K = 2304
                h_in, upd = randn(M, K, dtype=torch.float32, std=8.0), randn(M, K)
                post, nw = randn(K, std=0.1), randn(K, std=0.1)
                w = qweight(N, K) if qkw is None else qweight(N, K, 4, qkw["group_size"])
                args = (h_in, upd, post, nw, w["qt"], w["scale"])
                h_out, h_ref = torch.empty_like(h_in), torch.empty_like(h_in)
                errs = []
                for out_dtype, tol in ((torch.bfloat16, 1e-2 if qkw is None else 2e-2),
                                       (torch.float32, Q4_FP32_TOL)):
                    y = quant.residual_rmsnorm_matvec(*args, h_out=h_out, out_dtype=out_dtype)
                    ref = quant.residual_rmsnorm_matvec_plain(*args, h_out=h_ref,
                                                              out_dtype=out_dtype)
                    d, r = rel_err(y, ref)
                    dh, rh = rel_err(h_out, h_ref)
                    check(name, f"{fmt} M={M} N={N} {out_dtype}", r, tol)
                    check(name, f"{fmt} M={M} N={N} h_out", rh, 1e-2)
                    errs += [d, dh]
                y = quant.residual_rmsnorm_matvec(*args, h_out=h_out)
                ms = timer(lambda: quant.residual_rmsnorm_matvec(*args, h_out=h_out))
                pms = timer(lambda: quant.residual_rmsnorm_matvec_plain(*args, h_out=h_ref))
                hh = h_in.clone()
                pair = timer(lambda: (ds.norm_residual(hh, upd, post, eps=1e-6),
                                      quant.rmsnorm_matvec(hh, nw, w["qt"], w["scale"])))
                xl = quant._rms_bf16(h_ref, nw, 1e-6)
                lib_fn = library_int8pack if qkw is None else library_int4pack
                lib, note = lib_fn(torch, timer, xl, w["qt"], w["scale"])
                print(f"{name} {fmt} M={M} {K}->{N}: max|d| {max(errs):.3e} kernel {ms:.4f} ms "
                      f"(norm_residual + rmsnorm_matvec {pair:.4f} ms) plain {pms:.4f} ms "
                      f"library matmul alone {lib} ms ({note})", flush=True)
                shape = f"{fmt}_M{M}_{K}x{N}"
                # h_in, upd and h_out (M x K f32 / bf16 / f32), the norm weights,
                # the weights, the output; the matvec's and the norms' operations
                record(name, shape, max(errs), ms, pms,
                       nbytes_of(h_in, upd, post, nw, w["qt"], w["scale"], h_out, y),
                       2 * M * N * K + 16 * M * K)
                results[name].setdefault("pair_ms", {})[shape] = pair
                results[name].setdefault("library_matmul_alone_ms", {})[shape] = lib
    for name in ("q8_residual_rmsnorm_matvec", "q4_residual_rmsnorm_matvec"):
        notes[name] = ("no single PyTorch call does the residual update, the RMSNorm and the "
                       "matmul (the log gives the library's matmul alone)")

    # the whole decode step on a 2-layer cross-section of the flagship width
    tcfg = Gemma2Config(vocab_size=2048, hidden_size=2304, intermediate_size=9216,
                        num_layers=2, num_heads=8, num_kv_heads=4, head_dim=256,
                        sliding_window=4096, query_pre_attn_scalar=256.0)
    with torch.inference_mode():
        lm = gemma2.init_params(tcfg, generator=g, device=dev, dtype=torch.bfloat16)
        for k in ("input_norm", "post_attn_norm", "pre_ffn_norm", "post_ffn_norm"):
            lm["layers"][k] = randn(2, 2304, std=0.1)
        lm["final_norm"] = randn(2304, std=0.1)
        lm = quant.quantize_lm_params(lm)
    steps = {}
    for M, S, tol in ((1, 32, 0.02), (16, 332, 0.05)):
        x = randn(M, 2304, std=0.3) * torch.tensor(2304 ** 0.5, dtype=torch.bfloat16, device=dev)
        ck, cv = randn(2, M, 4, S, 256, std=0.3), randn(2, M, 4, S, 256, std=0.3)
        pos = (torch.full((M,), 20, dtype=torch.int32, device=dev) if M == 1
               else torch.arange(300 - M, 300, dtype=torch.int32, device=dev))
        hk, kk, vk = ds.fused_decode_step(lm, tcfg, x, ck, cv, pos, pos + 1)
        hp, kp, vp = ds.fused_decode_step_plain(lm, tcfg, x, ck, cv, pos, pos + 1)
        _, drift = rel_err(hk, hp)
        dk, _ = rel_err(kk, kp)
        dv, _ = rel_err(vk, vp)
        ms = timer(lambda: ds.fused_decode_step(lm, tcfg, x, ck, cv, pos, pos + 1))
        pms = timer(lambda: ds.fused_decode_step_plain(lm, tcfg, x, ck, cv, pos, pos + 1))
        t0 = time.perf_counter()
        for _ in range(20):
            ds.fused_decode_step(lm, tcfg, x, ck, cv, pos, pos + 1)
        enqueue_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        print(f"decode step (2 layers) M={M} S={S}: rel drift {drift:.4e} (bound {tol}) "
              f"k_new {dk:.3e} v_new {dv:.3e} kernels {ms:.4f} ms plain {pms:.4f} ms "
              f"host enqueue {enqueue_ms:.4f} ms", flush=True)
        if not (drift < tol and dk < 0.05 and dv < 0.05):
            fail(f"decode step M={M}: drift {drift} (bound {tol}), k {dk}, v {dv}")
        steps[f"M{M}_S{S}"] = {"rel_drift": drift, "ms": ms, "plain_ms": pms,
                               "host_enqueue_ms": enqueue_ms}
    return steps


def flash_phases(torch, timer, results, notes):
    """The flash forward, dq and dk/dv kernels against their plain versions:
    the training path's shapes (B=2, T=320, 8/4 heads, D=256, softcap 50,
    prefix 277, one row right-padded; window 4096 on even layers, none on odd
    ones) in bf16, timed, and checked again in fp32; then T=2048 with window
    4096, timed. Each backward call's route and launch plan is printed; a
    bf16 backward must take the tensor-core route and give identical bits
    when launched twice, and is timed beside the FMA kernels in bf16 (the
    route it took before, "fma_ms")."""
    from spatialvla_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(3)
    B, Nq, Nkv, D = 2, 8, 4, 256
    cases = (  # tag, T, window, prefix, valid, dtype, timed
        ("T320_window4096", 320, 4096, [277, 277], [320, 301], torch.bfloat16, True),
        ("T320_global", 320, None, [277, 277], [320, 301], torch.bfloat16, True),
        ("T320_window4096_fp32", 320, 4096, [277, 277], [320, 301], torch.float32, False),
        ("T2048_window4096", 2048, 4096, [256, 256], [2048, 1900], torch.bfloat16, True),
    )
    for tag, T, window, prefix, valid, dtype, timed in cases:
        def randn(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(dtype)

        q, do = randn(B, T, Nq, D), randn(B, T, Nq, D)
        k, v = randn(B, T, Nkv, D), randn(B, T, Nkv, D)
        lens = [torch.tensor(x, dtype=torch.int32, device="cuda") for x in (prefix, valid, [0, 0])]
        kw = dict(scale=D ** -0.5, logit_softcap=50.0, window=window, causal=True)
        if not bool(fa.allowed_rows(*lens, T, T, window=window, causal=True).all()):
            fail(f"flash {tag}: a query row has no allowed key")
        out, lse = fa.flash_attention_fwd(q, k, v, *lens, **kw)
        ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, *lens, **kw)
        delta = fa.attention_delta(ref_out, do)
        args = (q, k, v, do, ref_lse, delta, *lens)
        dq = fa.flash_attention_bwd_dq(*args, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(*args, **kw)
        ref_dq = fa.flash_attention_bwd_dq_plain(*args, **kw)
        ref_dk, ref_dv = fa.flash_attention_bwd_dkv_plain(*args, **kw)
        torch.cuda.synchronize()
        tol = FLASH_TOL[str(dtype).split(".")[-1]]
        errs = {"fwd": rel_err(out, ref_out), "dq": rel_err(dq, ref_dq),
                "dk": rel_err(dk, ref_dk), "dv": rel_err(dv, ref_dv)}
        lse_err = (lse - ref_lse).abs().max().item()
        plans = {key: fa.bwd_plan(key, q, k) for key in ("dq", "dkv")}
        want_route = "mma" if dtype == torch.bfloat16 else "fma"
        print(f"flash {tag} {str(dtype)[6:]}: " + "; ".join(
            f"{key} route {p['route']}, grid {p['grid']} x {p['threads']} threads, "
            f"{p['smem_bytes']} B shared, {p['blocks_per_sm']} blocks an SM, clusters of "
            f"{p['cluster']}"
            for key, p in plans.items()), flush=True)
        if any(p["route"] != want_route for p in plans.values()):
            fail(f"flash {tag}: backward routes {plans}, want {want_route}")
        if dtype == torch.bfloat16:  # no atomics: a second launch gives the same bits
            dq2 = fa.flash_attention_bwd_dq(*args, **kw)
            dk2, dv2 = fa.flash_attention_bwd_dkv(*args, **kw)
            if not (torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)):
                fail(f"flash {tag}: two launches of the bf16 backward differ")
        times, fma = {}, {}
        if timed:
            times = {
                "fwd": (timer(lambda: fa.flash_attention_fwd(q, k, v, *lens, **kw)),
                        timer(lambda: fa.flash_attention_fwd_plain(q, k, v, *lens, **kw))),
                "dq": (timer(lambda: fa.flash_attention_bwd_dq(*args, **kw)),
                       timer(lambda: fa.flash_attention_bwd_dq_plain(*args, **kw))),
                "dkv": (timer(lambda: fa.flash_attention_bwd_dkv(*args, **kw)),
                        timer(lambda: fa.flash_attention_bwd_dkv_plain(*args, **kw))),
            }
            fma = {"dq": timer(lambda: fa.flash_attention_bwd_fma(*args, **kw, dkv=False)),
                   "dkv": timer(lambda: fa.flash_attention_bwd_fma(*args, **kw, dq=False))}
        print(f"flash {tag}: rel err " + " ".join(f"{k} {r:.3e}" for k, (_, r) in errs.items())
              + f" lse max|d| {lse_err:.3e} (bound {tol}); "
              + " ".join(f"{k} kernel {t[0]:.4f} ms plain {t[1]:.4f} ms" for k, t in times.items()),
              flush=True)
        if not (all(r < tol for _, r in errs.values()) and lse_err < 1e-3):
            fail(f"flash {tag}: kernel vs plain {errs}, lse {lse_err}")
        # operations over the allowed (q, k) pairs of this mask, every q head:
        # fwd q.k and p.v; dq adds dO.v and dS.k; dk/dv q.k, dO.v, p.dO, dS.q
        pairs = int(fa.attention_mask(*lens, T, T, window=window, causal=True).sum()) * Nq
        io = {"fwd": (nbytes_of(q, k, v, *lens, out, lse), 4 * D * pairs),
              "dq": (nbytes_of(*args, dq), 6 * D * pairs),
              "dkv": (nbytes_of(*args, dk, dv), 8 * D * pairs)}
        for name, key, err in (("flash_attention_fwd", "fwd", errs["fwd"][0]),
                               ("flash_attention_bwd_dq", "dq", errs["dq"][0]),
                               ("flash_attention_bwd_dkv", "dkv", max(errs["dk"][0],
                                                                      errs["dv"][0]))):
            ms, pms = times.get(key, (None, None))
            shape = f"B{B}_T{T}_D{D}_{tag.split('_', 1)[1]}"
            record_kernel(results, name, shape, err, ms, pms, nbytes=io[key][0], ops=io[key][1])
            if key in fma:
                bms = results[name]["bound"][shape][0]
                print(f"flash {tag} {key}: {plans[key]['route']} {ms:.4f} ms, "
                      f"{io[key][1] / ms / 1e9:.1f} TFLOP/s, {bms / ms:.2%} of the bound "
                      f"{bms:.4f} ms; FMA kernels in bf16 (was) {fma[key]:.4f} ms, "
                      f"{fma[key] / ms:.1f} x", flush=True)
                results[name].setdefault("fma_ms", {})[shape] = fma[key]
                results[name]["cuda_route"] = plans[key]["route"]
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        notes[name] = ("F.scaled_dot_product_attention has no logit softcap (Gemma2's tanh "
                       "cap 50) and no backward entry point of its own")


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def margin_rule_ok(ids, ref_ids, ref_margins) -> bool:
    """First token equal; ids equal up to the first step whose reference
    margin is below MARGIN_BOUND (a near tie may flip under rounding)."""
    ids, ref_ids, ref_margins = np.asarray(ids), np.asarray(ref_ids), np.asarray(ref_margins)
    if ids[0] != ref_ids[0]:
        return False
    for t in range(1, len(ids)):
        if ref_margins[t] < MARGIN_BOUND:
            return True  # a near tie: this token and the rest may differ
        if ids[t] != ref_ids[t]:
            return False
    return True


def event_ms(torch, fn) -> float:
    """Device time of one run of fn between two CUDA events; the gaps where
    the card waits for the host are in it."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def request_stages(torch, policy, cfg, image, instruction):
    """The vision front and the LM prefill of one request as callables (call
    under inference_mode), with the request's merged embeddings and prefix
    length: (vision, prefill, embeds, P). prefill() -> (hidden, cache) on a
    fresh cache of P + 12 slots."""
    from spatialvla_tpu_torch.models import gemma2
    from spatialvla_tpu_torch.models import spatialvla as sv

    inputs = policy.processor(image, instruction)
    ids = torch.as_tensor(inputs["input_ids"], dtype=torch.long, device="cuda")
    px = torch.as_tensor(inputs["pixel_values"], device="cuda")
    K = torch.as_tensor(inputs["intrinsic"], device="cuda")
    lm, tcfg = policy.params["lm"], cfg.text
    P = ids.shape[1]

    def vision():
        return sv.get_image_features(policy.params, cfg, px, K, compute_dtype=torch.bfloat16)

    embeds = sv.merge_input_embeddings(policy.params, cfg, ids, vision(), dtype=torch.bfloat16)

    def prefill():
        cache = gemma2.init_cache(tcfg, 1, P + 12, device="cuda")
        pos = torch.arange(1, P + 1, device="cuda")[None]
        mask = sv.bidirectional_prefill_mask(P, P + 12, 1, device="cuda")
        return gemma2.forward(lm, tcfg, embeds, pos, mask, cache=cache, cache_position=0)

    return vision, prefill, embeds, P


@contextlib.contextmanager
def decode_loops(torch, sink):
    """Each fused greedy loop (``_generate_greedy_fused``: the first token
    and the 11 steps after it) run inside the block, timed between CUDA
    events: appends (ids, margins, ms) to ``sink`` and returns what the
    caller asked for."""
    from spatialvla_tpu_torch.models import spatialvla as sv

    orig = sv._generate_greedy_fused

    def timed(*args, return_margins=False, **kw):
        out = []
        ms = event_ms(torch, lambda: out.append(orig(*args, return_margins=True, **kw)))
        ids, margins = out[0]
        sink.append((ids.cpu().numpy(), margins.cpu().numpy(), ms))
        return (ids, margins) if return_margins else ids

    sv._generate_greedy_fused = timed
    try:
        yield sink
    finally:
        sv._generate_greedy_fused = orig


def capture_ms(policy) -> list:
    """The capture time (warm-up run included) of each of the policy's graphs."""
    return [round(loop.capture_ms, 2) for loop in policy.decode_graphs.loops.values()]


def library_kernel_names() -> set:
    """The name of every __global__ function in spatialvla_tpu_torch/csrc."""
    from spatialvla_tpu_torch.ops import _lib

    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)")
    return {n for src in _lib.sources() for n in pattern.findall(src.read_text())}


def decode_wrapper_of(kernel: str, targs: list):
    """The wrapper that launches this kernel in a decode step (at M <= 16
    each wrapper launches one kernel), from the kernel's name and template
    arguments; None for a kernel that no decode step launches."""
    if kernel == "qmatvec_kernel":  # <MR, kNorm, kInt4, kGrouped, kResid>
        _, norm, int4, _, resid = targs
        return ("q4" if int4 == "true" else "q8") + (
            "_residual_rmsnorm_matvec" if resid == "true"
            else "_rmsnorm_matvec" if norm == "true" else "_matvec")
    if kernel == "q4_small_kernel":  # <kNorm>
        return "q4_rmsnorm_matvec" if targs[0] == "true" else "q4_matvec"
    if kernel == "decode_attention_kernel":  # <KV, GM>
        return "decode_attention_kv8" if "char" in targs[0] else "decode_attention"
    return {"norm_residual_kernel": "norm_residual", "gelu_mul_kernel": "gelu_mul"}.get(kernel)


def graph_launches(torch, policy, label) -> list:
    """Each of the policy's decode graphs replayed once under torch.profiler:
    the library's kernels in the trace of the replay, each counted for the
    wrapper that launches it (``decode_wrapper_of``), must be exactly the
    launch counts that the graph credits its wrappers with per replay
    (``GreedyLoop.credits``). A library kernel that no decode wrapper
    launches, or a trace without kernels, fails. Returns one entry a graph:
    its shape key and both counts."""
    from torch.profiler import ProfilerActivity, profile

    names = library_kernel_names()
    head = re.compile(r"(?:void\s+)?(?:\(anonymous namespace\)::)?(\w+)")
    checks = []
    for key, loop in policy.decode_graphs.loops.items():
        credited = {fn.__name__ + ("" if attr == "launches" else f".{attr}"): n
                    for (fn, attr), n in loop.credits.items()}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loop.graph.replay()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "replay.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
        if not kernels:
            fail(f"{label}: the trace of a decode graph's replay holds no kernel")
        measured = collections.Counter()
        for name in kernels:
            base = head.match(name).group(1) if head.match(name) else ""
            if base not in names:
                continue  # a torch kernel (embedding, argmax, the cache writes)
            targs = re.search(re.escape(base) + r"<([^<>]*)>", name)
            wrapper = decode_wrapper_of(base, targs.group(1).split(", ") if targs else [])
            if wrapper is None:
                fail(f"{label}: kernel {name[:120]} in a decode graph is no decode wrapper's")
            measured[wrapper] += 1
        shape = f"B={key[0]} S={key[1]} n={key[2]} kv_bits={key[3]}"
        print(f"{label} decode graph {shape}: one replay traced, {len(kernels)} kernels; "
              f"library kernels by wrapper {dict(measured)}, credited {credited}", flush=True)
        if dict(measured) != credited:
            fail(f"{label} decode graph {shape}: the traced replay launched {dict(measured)}, "
                 f"the graph credits {credited}")
        checks.append({"graph": shape, "measured": dict(measured), "credited": credited})
    return checks


def instruction_stream(torch, policy, images, label):
    """A stream of 24 requests with 24 instruction lengths (prefixes of 264
    to 379 tokens, more than the 8 graphs ``DecodeGraphs`` keeps), from no
    graph at all: each request through the decode graphs (capturing where
    its cache bucket has none) and then eagerly, host clock around a
    synchronized ``predict``. Ids and margins must agree both ways. Returns
    the prefix lengths, the captures, the hit rate and both ways' times."""
    words = ("please pick up the small green block on the left side of the table and then "
             "place it carefully inside the open top drawer").split()
    instrs = [" ".join(words[:k]) for k in range(1, len(words) + 1)]
    policy.decode_graphs.clear()
    times = {True: [], False: []}
    lengths, captures = [], 0
    for i, instr in enumerate(instrs):
        img = images[i % len(images)]
        lengths.append(int(policy.processor(img, instr)["input_ids"].shape[1]))
        outs = {}
        for graph in (True, False):
            policy.use_cuda_graph = graph
            seen = {id(loop) for loop in policy.decode_graphs.loops.values()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[graph] = policy.predict(img, instr, return_margins=True)
            torch.cuda.synchronize()
            times[graph].append((time.perf_counter() - t0) * 1e3)
            captures += graph and any(id(loop) not in seen
                                      for loop in policy.decode_graphs.loops.values())
        if not (np.array_equal(outs[True]["action_ids"], outs[False]["action_ids"])
                and np.array_equal(outs[True]["margins"], outs[False]["margins"])):
            fail(f"{label} stream '{instr}': graph and eager ids / margins differ")
    policy.use_cuda_graph = None
    n = len(instrs)
    res = {"requests": n, "distinct_prefix_lengths": len(set(lengths)),
           "prefix_lengths": lengths, "captures": captures, "hit_rate": (n - captures) / n,
           "graph_ms_all": times[True], "eager_ms_all": times[False],
           "graph_ms_mean": statistics.mean(times[True]),
           "eager_ms_mean": statistics.mean(times[False]),
           "graph_ms_median": statistics.median(times[True]),
           "eager_ms_median": statistics.median(times[False])}
    print(f"{label} stream: {n} requests, {res['distinct_prefix_lengths']} prefix lengths "
          f"{min(lengths)}..{max(lengths)}, {captures} captures (hit rate {res['hit_rate']:.3f}), "
          f"{len(policy.decode_graphs)} graphs kept; predict through the graphs mean "
          f"{res['graph_ms_mean']:.2f} ms median {res['graph_ms_median']:.2f} ms, eager mean "
          f"{res['eager_ms_mean']:.2f} ms median {res['eager_ms_median']:.2f} ms; ids and "
          f"margins identical | {card_line()}", flush=True)
    return res


def graph_against_eager(torch, policy, label, fn, n=1):
    """``fn()`` (requests of the policy) through the decode loop's CUDA
    graph and through the eager loop, in turns (graph, eager, eager, graph
    for n = 2), each loop timed by CUDA events: the ids and margins of every
    loop must be identical both ways. Returns (graph loop ms, eager loop ms)
    medians and the outputs of the graph runs. A first untimed run through
    the graph captures it where its shape has none yet."""
    policy.use_cuda_graph = True
    fn()
    runs = {True: [], False: []}
    outs = []
    order = [True, False, False, True] * n
    for graph in order[: 2 * n]:
        policy.use_cuda_graph = graph
        with decode_loops(torch, []) as sink:
            out = fn()
        runs[graph].append(sink)
        if graph:
            outs.append(out)
    policy.use_cuda_graph = None
    for g_run, e_run in zip(runs[True], runs[False]):
        for (gi, gm, _), (ei, em, _) in zip(g_run, e_run):
            if not (np.array_equal(gi, ei) and np.array_equal(gm, em)):
                fail(f"{label}: the graph loop's ids / margins {gi.tolist()} {gm.tolist()} differ "
                     f"from the eager loop's {ei.tolist()} {em.tolist()}")
    ms = {g: statistics.median(t for run in runs[g] for _, _, t in run) for g in runs}
    print(f"{label}: decode loop (first token + 11 steps, CUDA events) graph {ms[True]:.3f} ms, "
          f"eager {ms[False]:.3f} ms; ids and margins identical", flush=True)
    return ms[True], ms[False], outs


def warm_medians(torch, policy, requests):
    """Warm ``predict`` latency (host clock around a synchronized call) over
    `requests` (image, instruction) pairs, through the graph and through the
    eager loop in turns, request by request; and each way's decode-loop
    times. Returns {"graph"|"eager": (median ms, all ms, loop ms median)}
    and the graph runs' outputs."""
    res = {True: ([], []), False: ([], [])}
    outs = []
    for img, instr in requests:
        for graph in (True, False):
            policy.use_cuda_graph = graph
            with decode_loops(torch, []) as sink:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = policy.predict(img, instr)
                torch.cuda.synchronize()
                res[graph][0].append((time.perf_counter() - t0) * 1e3)
            res[graph][1].append(sink[0][2])
            if graph:
                outs.append(out)
    policy.use_cuda_graph = None
    return {("graph" if g else "eager"): (statistics.median(t), t, statistics.median(lt))
            for g, (t, lt) in res.items()}, outs


def step_phase(torch, timer, lm, tcfg, x, ck, cv, pos, label, per_layer=False):
    """The 26-layer decode step at these shapes: device ms of its launches
    as one CUDA graph, the same launched eagerly (CUDA events, host gaps
    included), the host's enqueue time, and the final hidden state's drift
    to the plain step (bound 0.02); with ``per_layer`` also each layer alone
    held to its plain version on the plain run's residual (bound 0.02). Its
    bound: the layer weights and the whole cache (every slot), each read
    once, over the HBM rate."""
    from spatialvla_tpu_torch.models.gemma2 import layer_slice
    from spatialvla_tpu_torch.ops import decode_step as ds

    step = lambda: ds.fused_decode_step(lm, tcfg, x, ck, cv, pos, pos + 1)  # noqa: E731
    plain = lambda: ds.fused_decode_step_plain(lm, tcfg, x, ck, cv, pos, pos + 1)  # noqa: E731
    _, drift = rel_err(step()[0], plain()[0])
    t_graph, t_eager = timer(step), timer.eager(step)
    t_plain = Timer(torch, n=5)(plain)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    enqueue = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    layer_drift = []
    if per_layer:
        one = dataclasses.replace(tcfg, num_layers=1)
        M, S = x.shape[0], ck.shape[3]
        bk, bp = ds.step_buffers(one, M, S, "cuda"), ds.step_buffers(one, M, S, "cuda")
        r = x.float()
        for l in range(tcfg.num_layers):
            lm_l = {"layers": layer_slice(lm["layers"], slice(l, l + 1)),
                    "final_norm": lm["final_norm"]}
            c = (ck[l:l + 1], cv[l:l + 1])
            hk = ds.fused_decode_step(lm_l, one, r, *c, pos, pos + 1, buffers=bk)[0]
            hp = ds.fused_decode_step_plain(lm_l, one, r, *c, pos, pos + 1, buffers=bp)[0]
            layer_drift.append(max(rel_err(hk, hp)[1], rel_err(bk.residual, bp.residual)[1]))
            r = bp.residual.clone()
    worst = max(layer_drift) if layer_drift else None
    nbytes = tree_bytes(lm["layers"]) + tree_bytes(lm["final_norm"]) + nbytes_of(x, ck, cv)
    bound_ms = bound(nbytes, 0)[0]
    print(f"decode step {label} ({tcfg.num_layers} layers): CUDA graph {t_graph:.3f} ms, eager "
          f"launches {t_eager:.3f} ms, host enqueue {enqueue:.3f} ms, plain {t_plain:.3f} ms; "
          f"bound {bound_ms:.4f} ms ({nbytes / 1e9:.4f} GB of weights and cache); "
          f"rel drift {drift:.4e} (bound 0.02)"
          + (f"; each layer alone, worst of hidden and residual {worst:.4e} (bound 0.02): "
             f"{[round(d, 5) for d in layer_drift]}" if per_layer else ""), flush=True)
    if not drift < 0.02:
        fail(f"decode step {label}: kernel vs plain drift {drift} >= 0.02")
    if per_layer and not worst < 0.02:
        fail(f"decode step {label}: a layer alone drifts {worst} >= 0.02 from plain")
    return {"graph_ms": t_graph, "eager_ms": t_eager, "host_enqueue_ms": enqueue,
            "plain_ms": t_plain, "bound_ms": bound_ms, "rel_drift": drift,
            "layer_drift": layer_drift}


def main_path(torch, timer, counters):
    from spatialvla_tpu_torch import SpatialVLAPolicy, spatialvla_4b
    from spatialvla_tpu_torch.models import spatialvla as sv

    cfg = spatialvla_4b()
    L, steps = cfg.text.num_layers, 11
    t0 = time.perf_counter()
    policy = SpatialVLAPolicy.init_random(cfg, "cuda:0", seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    raw = policy.params  # the bf16 tree, for the re-quantize check
    t0 = time.perf_counter()
    policy.quantize(bits=8)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    print(f"main path: init_random {t_init:.2f} s, quantize(bits=8) {t_quant:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)

    rng = np.random.RandomState(7)
    size = cfg.vision.image_size
    images = [(rng.rand(size, size, 3) * 255).astype(np.uint8) for _ in range(3)]
    instructions = ["pick up the red cup", "open the top drawer",
                    "put the spoon into the pot on the left burner"]
    batch_texts = ["pick up the cup", "open the top drawer of the desk"]
    begin, n_act = cfg.action_token_begin_idx, cfg.spatial_token_num

    # the first request of each shape captures its decode graph (a warm-up
    # run of the loop, then the capture); the counted requests replay them
    t0 = time.perf_counter()
    for img, instr in zip(images, instructions):  # prefixes of 277 and 303: one bucket
        policy.predict(img, instr)
    policy.predict_batch(images[:2], batch_texts)
    torch.cuda.synchronize()
    print(f"main path: first requests (3 instructions, 2 padded rows) with their captures "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms; {len(policy.decode_graphs)} graphs, "
          f"capture ms {capture_ms(policy)}", flush=True)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    outs = []
    for img, instr in zip(images, instructions):
        t0 = time.perf_counter()
        outs.append(policy.predict(img, instr, return_margins=True))
        print(f"predict '{instr}': {1e3 * (time.perf_counter() - t0):.1f} ms "
              f"ids {outs[-1]['action_ids'].tolist()}", flush=True)
    batch = policy.predict_batch(images[:2], batch_texts)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"main path launches: {launches}", flush=True)

    for o in outs:
        a, ids = np.asarray(o["actions"]), np.asarray(o["action_ids"])
        if a.shape != (4, 7) or not np.isfinite(a).all():
            fail(f"predict actions {a.shape}, finite={np.isfinite(a).all()}")
        if not ((ids >= begin) & (ids < begin + n_act)).all():
            fail(f"predict ids outside the action block: {ids}")
    ba = np.asarray(batch["actions"])
    if ba.shape != (2, 4, 7) or not np.isfinite(ba).all():
        fail(f"predict_batch actions {ba.shape}, finite={np.isfinite(ba).all()}")
    bids = np.asarray(batch["action_ids"])
    if not ((bids >= begin) & (bids < begin + n_act)).all():
        fail(f"predict_batch ids outside the action block: {bids}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    # 4 decode loops of 11 steps (3 requests, one 2-row batch): each step
    # folds 2 L - 1 residual updates into the RMSNorm matvecs, keeps layer
    # 0's input norm and one norm_residual (the last layer's, with the final
    # norm), and runs the attention once a layer
    want = {"q8_residual_rmsnorm_matvec": 4 * steps * (2 * L - 1), "norm_residual": 4 * steps,
            "q8_rmsnorm_matvec": 4 * steps, "decode_attention": 4 * steps * L,
            "gelu_mul": 4 * steps * L}
    if any(launches[k] != v for k, v in want.items()):
        fail(f"main path launches {launches}, want {want}")
    # the decode loops' counts were credited per replay: each graph's are held
    # to the kernels of a traced replay
    graph_checks = graph_launches(torch, policy, "main path")

    # reference: the same requests through the unfused decode loop
    agree = 0
    for img, instr, o in zip(images, instructions, outs):
        inputs = policy.processor(img, instr)
        with torch.inference_mode():
            ref_ids, ref_m = sv.predict_action(
                policy.params, cfg, torch.as_tensor(inputs["input_ids"], dtype=torch.long,
                                                    device="cuda"),
                pixel_values=torch.as_tensor(inputs["pixel_values"], device="cuda"),
                intrinsic=torch.as_tensor(inputs["intrinsic"], device="cuda"),
                use_fused_decode=False, return_margins=True,
            )
        ok = margin_rule_ok(o["action_ids"], ref_ids[0].cpu().numpy(), ref_m[0].cpu().numpy())
        print(f"fused vs unfused decode '{instr}': ids {o['action_ids'].tolist()} vs "
              f"{ref_ids[0].tolist()}, unfused margins "
              f"{np.round(ref_m[0].cpu().numpy(), 3).tolist()} -> {'ok' if ok else 'DIFFER'}",
              flush=True)
        agree += ok
    if agree != len(outs):
        fail("fused decode path disagrees with the unfused path beyond the margin rule")

    # one request with the flash-attention prefill, held to the default path
    from spatialvla_tpu_torch.ops import flash_attention as fa

    inputs = policy.processor(images[0], instructions[0])
    fa.flash_attention_fwd.launches = 0
    with torch.inference_mode():
        flash_ids, _ = sv.predict_action(
            policy.params, cfg,
            torch.as_tensor(inputs["input_ids"], dtype=torch.long, device="cuda"),
            pixel_values=torch.as_tensor(inputs["pixel_values"], device="cuda"),
            intrinsic=torch.as_tensor(inputs["intrinsic"], device="cuda"),
            use_flash_prefill=True, return_margins=True,
        )
    flash_prefill_launches = fa.flash_attention_fwd.launches
    ok = margin_rule_ok(flash_ids[0].cpu().numpy(), outs[0]["action_ids"], outs[0]["margins"])
    print(f"flash prefill '{instructions[0]}': ids {flash_ids[0].tolist()} vs default "
          f"{outs[0]['action_ids'].tolist()}, {flash_prefill_launches} flash forward launches "
          f"-> {'ok' if ok else 'DIFFER'}", flush=True)
    if not ok or flash_prefill_launches != cfg.text.num_layers:
        fail(f"flash prefill: ids differ beyond the margin rule ({ok}) or "
             f"{flash_prefill_launches} launches != {cfg.text.num_layers}")

    # the decode loop through its CUDA graph and eagerly, on the same
    # requests: identical ids and margins, and each loop's time
    loop_g, loop_e, _ = graph_against_eager(
        torch, policy, "int8 request", lambda: policy.predict(images[1], instructions[1]), n=2)
    bloop_g, bloop_e, _ = graph_against_eager(
        torch, policy, "int8 2-row padded batch",
        lambda: policy.predict_batch(images[:2], batch_texts))
    # warm latency of the serving entry point, through the graph and the
    # eager loop in turns
    warm, _ = warm_medians(torch, policy,
                           [(images[i % 3], instructions[i % 3]) for i in range(10)])
    print(f"main path: warm predict median {warm['graph'][0]:.2f} ms through the decode graph, "
          f"{warm['eager'][0]:.2f} ms with use_cuda_graph=False (decode loop {warm['graph'][2]:.3f} "
          f"/ {warm['eager'][2]:.3f} ms) | {card_line()}", flush=True)
    # more instruction lengths than graphs kept: captures, hit rate, latency
    stream = instruction_stream(torch, policy, images, "main path")

    # where the time goes in one request: the vision front and the LM prefill
    # (host clock around synchronized stages), the decode step at batch 1 on
    # this request's cache and at 16 rows on a 332-slot cache, one
    # action-head matvec (CUDA events)
    from spatialvla_tpu_torch.ops.quant import qmatmul

    lm, tcfg = policy.params["lm"], cfg.text

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    g = torch.Generator(device="cuda").manual_seed(13)
    with torch.inference_mode():
        vision, prefill, embeds, P = request_stages(torch, policy, cfg, images[0], instructions[0])
        S = P + 12
        _, t_vis = timed(vision)
        (hidden, cache), t_prefill = timed(prefill)
        ck = cache["k"].permute(0, 1, 3, 2, 4).contiguous()
        cv = cache["v"].permute(0, 1, 3, 2, 4).contiguous()
        x = embeds[:, -1] * torch.tensor(tcfg.hidden_size ** 0.5, dtype=torch.bfloat16,
                                         device="cuda")
        pos = torch.tensor([P], dtype=torch.int32, device="cuda")  # on the card: capturable
        step1 = step_phase(torch, timer, lm, tcfg, x, ck, cv, pos, f"M=1 S={S}", per_layer=True)
        M16, S16 = 16, 332
        shape16 = (tcfg.num_layers, M16, tcfg.num_kv_heads, S16, tcfg.head_dim)
        ck16, cv16 = ((torch.randn(shape16, generator=g, device="cuda") * 0.3).to(torch.bfloat16)
                      for _ in range(2))
        x16 = (torch.randn(M16, tcfg.hidden_size, generator=g, device="cuda") * 0.3
               * tcfg.hidden_size ** 0.5).to(torch.bfloat16)
        pos16 = torch.arange(300, 300 + M16, dtype=torch.int32, device="cuda")
        step16 = step_phase(torch, timer, lm, tcfg, x16, ck16, cv16, pos16, f"M=16 S={S16}")
        del ck16, cv16
        head = sv._slice_head(lm, begin, n_act)
        t_head = timer(lambda: qmatmul(hidden[:, -1], head))
    print(f"breakdown (P={P}): vision front {t_vis:.2f} ms, prefill {t_prefill:.2f} ms, "
          f"decode step (M=1) {step1['graph_ms']:.3f} ms in a graph, decode loop "
          f"{loop_g:.3f} ms in a graph / {loop_e:.3f} eager, head matvec {t_head:.4f} ms",
          flush=True)

    # re-quantize: the bf16 tree back in place (quantize refuses to pack a
    # packed tree), quantize(bits=4) drops the int8 graphs, and the next
    # request captures against the int4 tree: its ids follow that tree's
    # unfused decode path under the margin rule
    policy.params, policy.quant_desc = raw, None
    del raw
    policy.quantize(bits=4)
    if len(policy.decode_graphs):
        fail(f"quantize kept {len(policy.decode_graphs)} decode graphs of the old tree")
    o4 = policy.predict(images[0], instructions[0], return_margins=True)
    inputs = policy.processor(images[0], instructions[0])
    with torch.inference_mode():
        ref_ids, ref_m = sv.predict_action(
            policy.params, cfg, torch.as_tensor(inputs["input_ids"], dtype=torch.long,
                                                device="cuda"),
            pixel_values=torch.as_tensor(inputs["pixel_values"], device="cuda"),
            intrinsic=torch.as_tensor(inputs["intrinsic"], device="cuda"),
            use_fused_decode=False, return_margins=True,
        )
    ok = margin_rule_ok(o4["action_ids"], ref_ids[0].cpu().numpy(), ref_m[0].cpu().numpy())
    print(f"re-quantize bits=8 -> bits=4: ids {o4['action_ids'].tolist()} vs the int4 tree's "
          f"unfused {ref_ids[0].tolist()} -> {'ok' if ok else 'DIFFER'}; "
          f"{len(policy.decode_graphs)} graph(s)", flush=True)
    if not ok or len(policy.decode_graphs) != 1:
        fail("re-quantize: the request after quantize(bits=4) does not follow the int4 tree")
    return {
        "warm_predict_ms_median": warm["graph"][0],
        "warm_predict_ms_all": warm["graph"][1],
        "warm_predict_eager_ms_median": warm["eager"][0],
        "warm_predict_eager_ms_all": warm["eager"][1],
        "graph_launches": graph_checks, "instruction_stream": stream,
        "decode_loop_ms": {"graph": loop_g, "eager": loop_e, "warm_graph": warm["graph"][2],
                           "warm_eager": warm["eager"][2], "batch2_graph": bloop_g,
                           "batch2_eager": bloop_e},
        "actions_per_s": 4 / (warm["graph"][0] / 1e3),
        "vision_front_ms": t_vis,
        "prefill_ms": t_prefill,
        "decode_step_ms": step1["graph_ms"],
        "decode_step_eager_ms": step1["eager_ms"],
        "decode_step_plain_ms": step1["plain_ms"],
        "decode_step_host_enqueue_ms": step1["host_enqueue_ms"],
        "decode_step_rel_drift": step1["rel_drift"],
        "decode_step_layer_drift": step1["layer_drift"],
        "decode_step_M16_S332": step16,
        "head_matvec_ms": t_head,
        "init_random_s": t_init,
        "quantize_s": t_quant,
        "peak_mem_gib": peak_gib,
        "launches": launches,
        "flash_prefill_launches": flash_prefill_launches,
    }


# ---------------------------------------------------------------------------
# the other weight and KV-cache formats: the decode-step matrix and three
# serving configurations
# ---------------------------------------------------------------------------

WEIGHT_FORMATS = (  # bench.py:111-116
    ("int8", dict(bits=8)),
    ("int4", dict(bits=4)),
    ("int4-g128", dict(bits=4, group_size=128)),
    ("int8+mlp4", dict(bits=8, mlp_bits=4)),
)
DRIFT_BOUND = {"bf16kv": 0.05, "kv8": 0.08}  # bench.py:139-142


def decode_step_matrix(torch):
    """The decode-step matrix of bench.py:111-160 at full width: Gemma2-2B's
    26 layers (random weights from a seed, a 2048-row vocabulary), M = 16
    rows at per-row positions 300..315 of a 332-slot cache. Each weight
    format x {bf16, int8} KV cache: the port's fused_decode_step (the
    kernels) against the port's masked gemma2.forward on the same quantized
    tree and the bf16 cache; relative drift max|h_fused - h_masked| /
    max|h_masked| below DRIFT_BOUND. Also the device time of each step, and
    for every format the step at batch 1 (row 0 at position 277 of a
    289-slot bf16 cache, the serving path's request), held the same way."""
    from spatialvla_tpu_torch import spatialvla_4b
    from spatialvla_tpu_torch.models import gemma2
    from spatialvla_tpu_torch.ops import decode_step as ds
    from spatialvla_tpu_torch.ops import quant

    tcfg = dataclasses.replace(spatialvla_4b().text, vocab_size=2048)
    L, H, Nkv, D = tcfg.num_layers, tcfg.hidden_size, tcfg.num_kv_heads, tcfg.head_dim
    M, S = 16, 332
    g = torch.Generator(device="cuda").manual_seed(11)
    timer = Timer(torch, n=5)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(torch.bfloat16)

    out = {}
    with torch.inference_mode():
        base = gemma2.init_params(tcfg, generator=g, device="cuda", dtype=torch.bfloat16)
        emb = randn(M, H, std=0.3)
        ck, cv = randn(L, M, Nkv, S, D, std=0.3), randn(L, M, Nkv, S, D, std=0.3)
        pos = torch.arange(300, 300 + M, dtype=torch.int32, device="cuda")
        # the masked forward writes the new token at the last slot and attends
        # to the row's valid slots [0, pos) and to that slot
        k_idx = torch.arange(S, device="cuda")
        mask = ((k_idx[None] < pos[:, None]) | (k_idx[None] == S - 1))[:, None, None, :]
        x = emb * torch.tensor(H ** 0.5, dtype=torch.bfloat16, device="cuda")
        ck8, ks = quant.quantize_kv(ck)
        cv8, vs = quant.quantize_kv(cv)
        caches = {"bf16kv": (ck, cv, {}),
                  "kv8": (ck8, cv8, dict(cache_k_scale=ds.flatten_kv_scales(ks),
                                         cache_v_scale=ds.flatten_kv_scales(vs)))}
        S1, pos1 = 289, torch.tensor([277], dtype=torch.int32, device="cuda")
        ck1, cv1 = ck[:, :1, :, :S1].contiguous(), cv[:, :1, :, :S1].contiguous()
        mask1 = ((k_idx[None, :S1] < pos1[:, None]) | (k_idx[None, :S1] == S1 - 1))[:, None, None]
        for name, qkw in WEIGHT_FORMATS:
            qp = quant.quantize_lm_params(base, **qkw)
            # batch 1
            hx, _ = gemma2.forward(qp, tcfg, emb[:1, None], (pos1 + 1)[:, None].long(), mask1,
                                   cache={"k": ck1.permute(0, 1, 3, 2, 4).contiguous(),
                                          "v": cv1.permute(0, 1, 3, 2, 4).contiguous()},
                                   cache_position=S1 - 1)
            step = lambda: ds.fused_decode_step(qp, tcfg, x[:1], ck1, cv1, pos1, pos1 + 1)  # noqa: E731
            hf = step()[0].float()
            hx = hx[:, 0].float()
            drift = ((hf - hx).abs().max() / (hx.abs().max() + 1e-6)).item()
            ms = timer(step)
            print(f"decode step {name}+bf16kv (26 layers, M=1, S={S1}): rel drift {drift:.4f} "
                  f"(bound {DRIFT_BOUND['bf16kv']}), fused step {ms:.3f} ms", flush=True)
            if not drift < DRIFT_BOUND["bf16kv"]:
                fail(f"decode step {name} M=1: drift {drift} >= {DRIFT_BOUND['bf16kv']}")
            out[f"{name}+bf16kv_M1_S{S1}"] = {"rel_drift": drift, "step_ms": ms}
            ref_cache = {"k": ck.permute(0, 1, 3, 2, 4).contiguous(),
                         "v": cv.permute(0, 1, 3, 2, 4).contiguous()}
            hx, _ = gemma2.forward(qp, tcfg, emb[:, None], (pos + 1)[:, None].long(), mask,
                                   cache=ref_cache, cache_position=S - 1)
            hx = hx[:, 0].float()
            del ref_cache
            for kv_name, (kc, vc, kw) in caches.items():
                step = lambda: ds.fused_decode_step(qp, tcfg, x, kc, vc, pos, pos + 1, **kw)  # noqa: E731
                hf = step()[0].float()
                drift = ((hf - hx).abs().max() / (hx.abs().max() + 1e-6)).item()
                ms = timer(step)
                tol = DRIFT_BOUND[kv_name]
                print(f"decode-step matrix {name}+{kv_name} (26 layers, M={M}, S={S}): rel drift "
                      f"{drift:.4f} (bound {tol}), fused step {ms:.3f} ms", flush=True)
                if not drift < tol:
                    fail(f"decode-step matrix {name}+{kv_name}: drift {drift} >= {tol}")
                out[f"{name}+{kv_name}"] = {"rel_drift": drift, "step_ms": ms}
            del qp
    torch.cuda.empty_cache()
    return out


# the references a configuration's ids are held to: (label, predict_action
# options, whether the q4 wrappers run their plain versions)
UNFUSED = ("unfused decode", dict(use_fused_decode=False), False)
PLAIN_Q4 = ("q4 plain versions", {}, True)
SERVING_CONFIGS = (  # name, quantize options, references
    ("a:int4", dict(bits=4), (UNFUSED, PLAIN_Q4)),
    ("b:int8+mlp4+kv8", dict(bits=8, mlp_bits=4, kv_bits=8),
     (("bf16 KV cache", dict(kv_bits=None), False),)),
    ("c:int4-g128+vision4", dict(bits=4, group_size=128, vision_bits=4), (UNFUSED, PLAIN_Q4)),
)


@contextlib.contextmanager
def plain_q4(torch):
    """The q4 wrappers replaced by their plain versions on any device, so a
    reference run launches no int4 kernel (the dispatch in quant.matvec /
    quant.rmsnorm_matvec looks the wrappers up at each call)."""
    from spatialvla_tpu_torch.ops import quant

    saved = quant.q4_matvec, quant.q4_rmsnorm_matvec, quant.q4_residual_rmsnorm_matvec

    def q4_matvec(x, qt, scale, *, out_dtype=torch.bfloat16, out=None):
        y = quant.q4_matvec_plain(x, qt, scale, out_dtype=out_dtype)
        return y if out is None else out.copy_(y)

    def q4_rmsnorm_matvec(x, norm_w, qt, scale, *, eps=1e-6, out_dtype=torch.bfloat16, out=None):
        y = quant.q4_rmsnorm_matvec_plain(x, norm_w, qt, scale, eps=eps, out_dtype=out_dtype)
        return y if out is None else out.copy_(y)

    (quant.q4_matvec, quant.q4_rmsnorm_matvec,
     quant.q4_residual_rmsnorm_matvec) = q4_matvec, q4_rmsnorm_matvec, \
        quant.residual_rmsnorm_matvec_plain
    try:
        yield
    finally:
        quant.q4_matvec, quant.q4_rmsnorm_matvec, quant.q4_residual_rmsnorm_matvec = saved


@contextlib.contextmanager
def fma_tiles(torch):
    """The q4 wrappers with the FMA tiles (q4_tiled_fma) on every call that
    takes the tensor-core route, so that a run shows what it took before
    that kernel; the other calls launch their kernels as before."""
    from spatialvla_tpu_torch.ops import quant

    saved = quant.q4_matvec, quant.q4_rmsnorm_matvec

    def q4_matvec(x, qt, scale, *, out_dtype=torch.bfloat16, out=None):
        if quant.q4_route(x, qt, scale) != "tiled":
            return saved[0](x, qt, scale, out_dtype=out_dtype, out=out)
        y = q4_tiled_fma(torch, x, None, qt, scale, out_dtype=out_dtype)
        return y if out is None else out.copy_(y)

    def q4_rmsnorm_matvec(x, norm_w, qt, scale, *, eps=1e-6, out_dtype=torch.bfloat16, out=None):
        if quant.q4_route(x, qt, scale) != "tiled":
            return saved[1](x, norm_w, qt, scale, eps=eps, out_dtype=out_dtype, out=out)
        y = q4_tiled_fma(torch, x, norm_w, qt, scale, out_dtype=out_dtype, eps=eps)
        return y if out is None else out.copy_(y)

    quant.q4_matvec, quant.q4_rmsnorm_matvec = q4_matvec, q4_rmsnorm_matvec
    try:
        yield
    finally:
        quant.q4_matvec, quant.q4_rmsnorm_matvec = saved


def serving_configs(torch, counters):
    """spatialvla_4b at full width (random weights from seed 0) after each of
    SERVING_CONFIGS: warm-up requests (the first captures the decode graph of
    their cache bucket), then five timed SpatialVLAPolicy.predict requests
    through the graph and five through the eager loop, in turns (medians);
    one request's decode loop both ways (identical ids and margins), and for
    (b) one predict_batch of 16 rows with mixed instruction lengths both
    ways. The launches of one request show which kernels carried it:
    q4_rmsnorm_matvec once per int4 norm + projection of every layer in the
    prefill and once per decode step where qkv is int4 (layer 0's input
    norm), q4_residual_rmsnorm_matvec for every other int4 norm + projection
    of the decode steps, norm_residual once per step, decode_attention_kv8
    once per layer and step with kv_bits=8, and the int4 calls on the
    tensor-core route (the prefill's, SigLIP's and the projector's; none
    fails). Then the device time of one request's vision
    front and prefill, with the tensor-core kernel and with the FMA tiles in
    its place (CUDA events, in turn, median of 5). Two
    requests' ids are held to references on the same tree under the margin
    rule: for (a) and (c) the unfused decode path (which also runs the int4
    kernels) and the served path with the q4 wrappers' plain versions (which
    runs none), for (b) the bf16 KV cache. Each decode graph's traced replay
    is held to its credited launch counts (``graph_launches``). Each policy
    is freed before the next starts."""
    from spatialvla_tpu_torch import SpatialVLAPolicy, spatialvla_4b
    from spatialvla_tpu_torch.models import spatialvla as sv
    from spatialvla_tpu_torch.ops import quant

    cfg = spatialvla_4b()
    L, steps = cfg.text.num_layers, 11
    begin, n_act = cfg.action_token_begin_idx, cfg.spatial_token_num
    rng = np.random.RandomState(9)
    size = cfg.vision.image_size
    images = [(rng.rand(size, size, 3) * 255).astype(np.uint8) for _ in range(3)]
    instructions = ["pick up the red cup", "open the top drawer",
                    "put the spoon into the pot on the left burner"]
    words = "move the green block to the left of the bowl and then close the drawer".split()
    batch_texts = [" ".join(words[: 1 + i % len(words)]) for i in range(16)]

    def ids_ok(ids):
        ids = np.asarray(ids)
        return bool(((ids >= begin) & (ids < begin + n_act)).all())

    out = {}
    for name, qkw, refs in SERVING_CONFIGS:
        t0 = time.perf_counter()
        policy = SpatialVLAPolicy.init_random(cfg, "cuda:0", seed=0).quantize(**qkw)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for img, instr in zip(images, instructions):  # the first captures
            policy.predict(img, instr)
        torch.cuda.synchronize()
        t_first = (time.perf_counter() - t0) * 1e3
        for c in counters:
            c.launches = 0
        quant.q4_matvec.tiled_launches = quant.q4_rmsnorm_matvec.tiled_launches = 0
        first = policy.predict(images[0], instructions[0])  # counted alone
        torch.cuda.synchronize()
        per_request = {c.__name__: c.launches for c in counters}
        tiled = quant.q4_matvec.tiled_launches + quant.q4_rmsnorm_matvec.tiled_launches
        warm_runs, timed_outs = warm_medians(torch, policy,
                                             [(images[i % 3], instructions[i % 3])
                                              for i in range(5)])
        outs = [first] + timed_outs
        loop_g, loop_e, _ = graph_against_eager(torch, policy, f"serving {name} request",
                                                lambda: policy.predict(images[1], instructions[1]))
        batch, batch_loops = None, None
        if qkw.get("kv_bits"):
            batch_loops = graph_against_eager(
                torch, policy, f"serving {name} 16-row batch",
                lambda: policy.predict_batch([images[i % 3] for i in range(16)], batch_texts))
            batch = batch_loops[2][0]
            torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        tiled_run = {c.__name__: c.tiled_launches
                     for c in (quant.q4_matvec, quant.q4_rmsnorm_matvec)}
        peak = torch.cuda.max_memory_allocated() / 2**30
        warm, times = warm_runs["graph"][:2]
        print(f"serving {name}: quantize({', '.join(f'{k}={v}' for k, v in qkw.items())}), "
              f"set-up {t_setup:.2f} s; first requests with captures {t_first:.1f} ms (capture "
              f"ms {capture_ms(policy)}); warm predict median {warm:.2f} ms over "
              f"{[round(t, 2) for t in times]} through the decode graph, "
              f"{warm_runs['eager'][0]:.2f} ms with use_cuda_graph=False; decode loop "
              f"{warm_runs['graph'][2]:.3f} / {warm_runs['eager'][2]:.3f} ms; peak {peak:.2f} GiB; "
              f"launches per request {per_request} | {card_line()}", flush=True)

        for o in outs:
            a = np.asarray(o["actions"])
            if a.shape != (4, 7) or not np.isfinite(a).all() or not ids_ok(o["action_ids"]):
                fail(f"serving {name}: actions {a.shape}, ids {o['action_ids']}")
        if batch is not None:
            ba = np.asarray(batch["actions"])
            if ba.shape != (16, 4, 7) or not np.isfinite(ba).all() or not ids_ok(batch["action_ids"]):
                fail(f"serving {name}: predict_batch actions {ba.shape}")
        # int4 norm + projections a layer: the prefill's all take
        # q4_rmsnorm_matvec; a decode step's take the residual kernel but
        # layer 0's input norm (qkv in int4 unless mlp_bits=4)
        qkv4 = qkw.get("mlp_bits") != 4
        want = {"q4_rmsnorm_matvec": (1 + qkv4) * L + qkv4 * steps,
                "q4_residual_rmsnorm_matvec": (L + qkv4 * (L - 1)) * steps,
                "norm_residual": steps}
        if qkw.get("kv_bits"):
            want.update(decode_attention_kv8=L * steps, decode_attention=0)
        if not qkv4:
            want.update(q8_rmsnorm_matvec=steps, q8_residual_rmsnorm_matvec=(L - 1) * steps)
        ran = ["q4_matvec", "q4_rmsnorm_matvec", "q4_residual_rmsnorm_matvec", "norm_residual",
               "gelu_mul", "decode_attention_kv8" if qkw.get("kv_bits") else "decode_attention"]
        if qkw.get("bits") == 8:
            ran += ["q8_matvec", "q8_rmsnorm_matvec", "q8_residual_rmsnorm_matvec"]
        if any(per_request[k] != v for k, v in want.items()) or any(per_request[k] <= 0
                                                                     for k in ran):
            fail(f"serving {name}: launches per request {per_request}, want {want} and "
                 f"every one of {ran} launched")
        # the tensor-core route in one request: the int4 projections of the
        # 277-row prefill (4 a layer, 2 with mlp_bits=4), and with
        # vision_bits=4 SigLIP's six a layer at 256 rows and the projector
        want_tiled = (4 if qkw.get("bits") == 4 else 2) * L + (
            6 * cfg.vision.num_layers + 1 if qkw.get("vision_bits") == 4 else 0)
        print(f"serving {name}: {tiled} launches of the tensor-core int4 kernel per request "
              f"(expected {want_tiled})", flush=True)
        if tiled == 0:
            fail(f"serving {name}: no launch of the tensor-core int4 kernel in a request")
        # device time of the vision front and the prefill (CUDA events), and
        # the same with the FMA tiles in place of the tensor-core kernel: 5
        # runs of each in turn after a warm-up, medians (the host's speed
        # moves these, so the two are taken side by side)
        runs = {k: [] for k in ("vision_front_ms", "prefill_ms", "vision_front_fma_tiles_ms",
                                "prefill_fma_tiles_ms")}
        with torch.inference_mode():
            vision, prefill, _, P = request_stages(torch, policy, cfg, images[0],
                                                   instructions[0])
            for i in range(6):
                for tag, ctx in (("", contextlib.nullcontext()), ("_fma_tiles", fma_tiles(torch))):
                    with ctx:
                        tv, tp = event_ms(torch, vision), event_ms(torch, prefill)
                    if i:  # the first round warms up
                        runs["vision_front" + tag + "_ms"].append(tv)
                        runs["prefill" + tag + "_ms"].append(tp)
        stages = {k: statistics.median(v) for k, v in runs.items()}
        print(f"serving {name} (P={P}, CUDA events, median of 5): vision front "
              f"{stages['vision_front_ms']:.2f} ms (FMA tiles "
              f"{stages['vision_front_fma_tiles_ms']:.2f}), prefill {stages['prefill_ms']:.2f} ms "
              f"(FMA tiles {stages['prefill_fma_tiles_ms']:.2f}) | {card_line()}", flush=True)

        agree = []
        for label, ref_kw, plain in refs:
            for img, instr, o in zip(images[:2], instructions[:2], outs[1:3]):
                inputs = policy.processor(img, instr)
                ctx = plain_q4(torch) if plain else contextlib.nullcontext()
                with torch.inference_mode(), ctx:
                    ref_ids, ref_m = sv.predict_action(
                        policy.params, cfg,
                        torch.as_tensor(inputs["input_ids"], dtype=torch.long, device="cuda"),
                        pixel_values=torch.as_tensor(inputs["pixel_values"], device="cuda"),
                        intrinsic=torch.as_tensor(inputs["intrinsic"], device="cuda"),
                        return_margins=True, **ref_kw)
                ok = margin_rule_ok(o["action_ids"], ref_ids[0].cpu().numpy(),
                                    ref_m[0].cpu().numpy())
                print(f"serving {name} vs {label} '{instr}': ids {o['action_ids'].tolist()} vs "
                      f"{ref_ids[0].tolist()}, reference margins "
                      f"{np.round(ref_m[0].cpu().numpy(), 3).tolist()} -> "
                      f"{'ok' if ok else 'DIFFER'}", flush=True)
                agree.append(ok)
        if not all(agree):
            fail(f"serving {name}: ids differ from the reference beyond the margin rule")
        checks = graph_launches(torch, policy, f"serving {name}")
        out[name] = {"quantize": qkw, "setup_s": t_setup, "warm_predict_ms_median": warm,
                     "warm_predict_ms_all": times,
                     "warm_predict_eager_ms_median": warm_runs["eager"][0],
                     "warm_predict_eager_ms_all": warm_runs["eager"][1],
                     "decode_loop_ms": {"graph": loop_g, "eager": loop_e,
                                        "warm_graph": warm_runs["graph"][2],
                                        "warm_eager": warm_runs["eager"][2],
                                        **({"batch16_graph": batch_loops[0],
                                            "batch16_eager": batch_loops[1]}
                                           if batch_loops else {})},
                     "capture_ms": capture_ms(policy), "graph_launches": checks,
                     "actions_per_s": 4 / (warm / 1e3),
                     "peak_mem_gib": peak, "launches_per_request": per_request,
                     "launches": launches, "tiled_launches_per_request": tiled,
                     "tiled_launches": tiled_run, **stages, "stage_runs_ms": runs}
        del policy, first, outs, batch
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# training path
# ---------------------------------------------------------------------------

def training_batches(processor, cfg, n, *, batch=2, seq_len=320, seed=11):
    """n batches from the port's processor: random frames and actions from a
    seed, an instruction per row, the action suffix, padded to seq_len."""
    rng = np.random.RandomState(seed)
    size = cfg.vision.image_size
    words = ["pick up the red cup", "open the top drawer", "put the spoon in the pot",
             "move the block to the left of the bowl", "close the microwave"]
    keys = ("input_ids", "attention_mask", "token_type_ids", "labels", "pixel_values", "intrinsic")
    out = []
    for i in range(n):
        frames = [(rng.rand(size, size, 3) * 255).astype(np.uint8) for _ in range(batch)]
        acts = rng.uniform(-1, 1, (batch, processor.action_chunk_size, 7))
        acts[..., 6] = rng.randint(0, 2, acts.shape[:2])
        enc = processor(frames, [words[(i + j) % len(words)] for j in range(batch)],
                        suffix_actions=acts, max_length=seq_len)
        out.append({k: enc[k] for k in keys})
    return out


def train_path(torch, counters, *, cfg=None, device="cuda", n_steps=5, warmup=2, seq_len=320):
    """Full-parameter training through train_loop (see the module docstring)."""
    from spatialvla_tpu_torch import spatialvla_4b
    from spatialvla_tpu_torch.inference import default_processor
    from spatialvla_tpu_torch.models import spatialvla as sv
    from spatialvla_tpu_torch.train import (OptimizerConfig, TrainStepConfig, build_decode_luts,
                                            init_train_state, make_loss_fn, make_optimizer,
                                            make_train_step, trainable_mask)
    from spatialvla_tpu_torch.train.optimizer import iter_leaves
    from spatialvla_tpu_torch.train.train_step import batch_to_tensors
    from spatialvla_tpu_torch.train.trainer import TrainerConfig, train_loop

    cfg = cfg or spatialvla_4b()
    processor = default_processor(cfg)
    batches = training_batches(processor, cfg, n_steps, seq_len=seq_len)
    t0 = time.perf_counter()
    params = sv.init_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                            device=device, dtype=torch.float32)
    mask = trainable_mask(params, freeze_llm_embed=cfg.use_spatial_token, freeze_zoe=True)
    tx = make_optimizer(OptimizerConfig(), params, mask)  # the pretrain CLI's defaults
    luts = {k: torch.as_tensor(v, device=device)
            for k, v in build_decode_luts(processor.action_tokenizer).items()}
    step_cfg = TrainStepConfig(use_remat=True, compute_dtype=torch.bfloat16, attn_backend="flash",
                               loss_chunk_size=256)
    state = init_train_state(params, tx)
    if device == "cuda":
        torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for _, p in iter_leaves(params))
    flags = dict(iter_leaves(mask))
    n_train = sum(p.numel() for path, p in iter_leaves(params) if flags[path])
    print(f"train: {n_params / 1e9:.3f} B parameters ({n_train / 1e9:.3f} B trainable), "
          f"init {t_init:.2f} s", flush=True)

    # flash vs xla: loss and gradient norm of the same batch and weights, no update
    def loss_and_grad_norm(backend):
        loss_fn = make_loss_fn(cfg, dataclasses.replace(step_cfg, attn_backend=backend), luts=luts)
        loss, _ = loss_fn(params, batch_to_tensors(batches[0], device))
        loss.backward()
        grads = [p.grad for _, p in iter_leaves(params) if p.grad is not None]
        norm = torch.sqrt(torch.stack([g.float().pow(2).sum() for g in grads]).sum())
        for _, p in iter_leaves(params):
            p.grad = None
        return float(loss.detach()), float(norm)

    (lf, gf), (lx, gx) = loss_and_grad_norm("flash"), loss_and_grad_norm("xla")
    d_loss, d_gn = abs(lf - lx) / abs(lx), abs(gf - gx) / gx
    print(f"train flash vs xla (one batch, same weights): loss {lf:.6f} vs {lx:.6f} "
          f"(rel {d_loss:.3e}, bound {LOSS_BOUND}), grad_norm {gf:.6f} vs {gx:.6f} "
          f"(rel {d_gn:.3e}, bound {GRAD_NORM_BOUND})", flush=True)
    if not (d_loss < LOSS_BOUND and d_gn < GRAD_NORM_BOUND):
        fail(f"train: flash vs xla loss rel {d_loss}, grad_norm rel {d_gn}")

    frozen = {path: p.detach().cpu().clone() for path, p in iter_leaves(params) if not flags[path]}
    probe = "lm/layers/attn/q"
    probe_before = params["lm"]["layers"]["attn"]["q"].detach().cpu().clone()
    step = make_train_step(cfg, tx, step_cfg, luts=luts)
    times, logged = [], []

    def timed_step(state, batch):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        if device == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return state, metrics

    for c in counters:
        c.launches = 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out_dir:
        state = train_loop(state=state, train_step=timed_step, batches=iter(batches),
                           config=TrainerConfig(output_dir=out_dir, max_steps=n_steps,
                                                log_every=1, tensorboard=False),
                           on_metrics=lambda s, m: logged.append(m))
    launches = {c.__name__: c.launches for c in counters}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else float("nan")

    L = cfg.text.num_layers
    want = {"flash_attention_fwd": 2 * L * n_steps, "flash_attention_bwd_dq": L * n_steps,
            "flash_attention_bwd_dkv": L * n_steps}
    print(f"train launches over {n_steps} steps: {launches} (want {want})", flush=True)
    if launches != want:
        fail(f"train: kernel launches {launches}, want {want}")
    if len(logged) != n_steps or not all(np.isfinite(v) for m in logged for v in m.values()):
        fail(f"train: {len(logged)} logged steps, metrics {logged}")
    for path, before in frozen.items():
        if not torch.equal(before, dict(iter_leaves(params))[path].detach().cpu()):
            fail(f"train: frozen leaf {path} changed")
    if torch.equal(probe_before, params["lm"]["layers"]["attn"]["q"].detach().cpu()):
        fail(f"train: trainable leaf {probe} did not change")
    steady = times[warmup:]
    step_s = statistics.median(steady)
    tokens = batches[0]["input_ids"].size
    valid = statistics.mean(float(b["attention_mask"].sum()) for b in batches)
    print(f"train: step times {[round(t * 1e3, 2) for t in times]} ms; median after {warmup} "
          f"warm-up steps {step_s * 1e3:.2f} ms, {tokens / step_s:.1f} tokens/s "
          f"({valid / step_s:.1f} non-pad tokens/s), peak {peak_gib:.2f} GiB; losses "
          f"{[round(m['loss'], 4) for m in logged]}, grad_norm "
          f"{[round(m['grad_norm'], 4) for m in logged]}", flush=True)
    return {
        "n_params": n_params, "n_trainable": n_train, "init_s": t_init,
        "step_ms_all": [t * 1e3 for t in times], "step_ms_median": step_s * 1e3,
        "tokens_per_s": tokens / step_s, "nonpad_tokens_per_s": valid / step_s,
        "peak_mem_gib": peak_gib, "launches": launches, "metrics": logged,
        "flash_vs_xla": {"loss": [lf, lx], "grad_norm": [gf, gx], "loss_rel": d_loss,
                         "grad_norm_rel": d_gn},
    }


def tiny_overfit(torch, counters, device="cuda"):
    """spatialvla_tiny(use_vision_zoe=True) overfits one batch through the
    flash kernels, as tests/test_train.py:67-87 asks of the JAX package."""
    from spatialvla_tpu_torch import spatialvla_tiny
    from spatialvla_tpu_torch.models import spatialvla as sv
    from spatialvla_tpu_torch.train import (OptimizerConfig, TrainStepConfig, init_train_state,
                                            make_optimizer, make_train_step, trainable_mask)

    cfg = spatialvla_tiny(use_vision_zoe=True)
    rng = np.random.RandomState(0)
    B, N, begin = 2, cfg.num_image_tokens, cfg.action_token_begin_idx
    ids = np.concatenate([np.full((B, N), cfg.image_token_index), rng.randint(0, 1000, (B, 4)),
                          rng.randint(begin, begin + cfg.spatial_token_num, (B, 6))], axis=1)
    tt = np.zeros(ids.shape, np.int32)
    tt[:, N + 4:] = 1
    size = cfg.vision.image_size
    batch = {"input_ids": ids, "attention_mask": np.ones(ids.shape, np.int32),
             "token_type_ids": tt, "labels": np.where(tt == 0, -100, ids),
             "pixel_values": rng.rand(B, size, size, 3).astype(np.float32),
             "intrinsic": np.array([[60.0, 0, 28], [0, 55.0, 27], [0, 0, 1]],
                                   np.float32)[None].repeat(B, 0)}
    params = sv.init_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                            device=device, dtype=torch.float32)
    tx = make_optimizer(OptimizerConfig(learning_rate=5e-3, total_steps=50, schedule="constant",
                                        warmup_ratio=0.02), params,
                        trainable_mask(params, freeze_llm_embed=True))
    step = make_train_step(cfg, tx, TrainStepConfig(use_remat=True, compute_dtype=torch.float32,
                                                    attn_backend="flash"))
    state = init_train_state(params, tx)
    for c in counters:
        c.launches = 0
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    launches = {c.__name__: c.launches for c in counters}
    print(f"tiny overfit (8 steps, lr 5e-3): losses {[round(x, 4) for x in losses]}, "
          f"launches {launches}", flush=True)
    if not losses[-1] < losses[0] - 0.5:
        fail(f"tiny overfit: loss {losses[0]} -> {losses[-1]}, not lower by more than 0.5")
    if device == "cuda" and not all(n > 0 for n in launches.values()):
        fail(f"tiny overfit: a flash kernel was not launched ({launches})")
    return {"losses": losses, "launches": launches}


KERNEL_SOURCES = {  # name: (source of its C entry point, the TPU kernel it replaces)
    "q8_matvec": ("q8_matvec.cu", "spatialvla_tpu/ops/quant.py:297"),
    "q8_rmsnorm_matvec": ("q8_matvec.cu", "spatialvla_tpu/ops/quant.py:336"),
    "q4_matvec": ("q4_matvec.cu", "spatialvla_tpu/ops/quant.py:297"),
    "q4_rmsnorm_matvec": ("q4_matvec.cu", "spatialvla_tpu/ops/quant.py:336"),
    "decode_attention": ("decode.cu", "spatialvla_tpu/ops/decode_step.py:375"),
    "decode_attention_kv8": ("decode.cu", "spatialvla_tpu/ops/decode_step.py:375"),
    "norm_residual": ("decode.cu", "spatialvla_tpu/ops/decode_step.py:375"),
    "gelu_mul": ("decode.cu", "spatialvla_tpu/ops/decode_step.py:375"),
    # the residual update folded into the next RMSNorm matvec: the JAX decode
    # kernel's _post_attn (:335) and _post_ffn + _input_norm phases
    "q8_residual_rmsnorm_matvec": ("q8_matvec.cu", "spatialvla_tpu/ops/decode_step.py:335"),
    "q4_residual_rmsnorm_matvec": ("q4_matvec.cu", "spatialvla_tpu/ops/decode_step.py:335"),
    "flash_attention_fwd": ("flash_attention.cu", "spatialvla_tpu/ops/flash_attention.py:188"),
    "flash_attention_bwd_dq": ("flash_attention.cu", "spatialvla_tpu/ops/flash_attention.py:340"),
    "flash_attention_bwd_dkv": ("flash_attention.cu",
                                "spatialvla_tpu/ops/flash_attention.py:390"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's kernels run on an NVIDIA GPU only")
    try:
        from spatialvla_tpu_torch.ops import _lib
        from spatialvla_tpu_torch.ops import decode_step as ds
        from spatialvla_tpu_torch.ops import flash_attention as fa
        from spatialvla_tpu_torch.ops import quant
    except ImportError as e:
        fail(f"cannot import spatialvla_tpu_torch ({e}); run from the repository root")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib_path = _lib.build()
    _lib.library()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s -> {lib_path.name}", flush=True)

    timer = Timer(torch)
    results, notes = {}, {}
    steps = kernel_phases(torch, timer, results, notes)
    flash_phases(torch, timer, results, notes)
    matrix = decode_step_matrix(torch)

    serving_counters = [quant.q8_matvec, quant.q8_rmsnorm_matvec,
                        quant.q8_residual_rmsnorm_matvec, quant.q4_matvec,
                        quant.q4_rmsnorm_matvec, quant.q4_residual_rmsnorm_matvec,
                        ds.decode_attention, ds.decode_attention_kv8, ds.norm_residual,
                        ds.gelu_mul]
    path = main_path(torch, timer, [quant.q8_matvec, quant.q8_rmsnorm_matvec,
                                    quant.q8_residual_rmsnorm_matvec, ds.decode_attention,
                                    ds.norm_residual, ds.gelu_mul])
    print(f"main path: warm predict median {path['warm_predict_ms_median']:.2f} ms "
          f"({path['actions_per_s']:.2f} actions/s) through the decode graph, "
          f"{path['warm_predict_eager_ms_median']:.2f} ms eager, "
          f"peak {path['peak_mem_gib']:.2f} GiB | {card}", flush=True)
    torch.cuda.empty_cache()
    serving = serving_configs(torch, serving_counters)

    flash = [fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv]
    train = train_path(torch, flash)
    torch.cuda.empty_cache()
    overfit = tiny_overfit(torch, flash)
    print(f"train path: median step {train['step_ms_median']:.2f} ms, "
          f"{train['tokens_per_s']:.1f} tokens/s, peak {train['peak_mem_gib']:.2f} GiB | {card}",
          flush=True)
    print("detail: " + json.dumps({"build_s": build_s, "decode_step_2_layers": steps,
                                   "decode_step_matrix": matrix, "main_path": path,
                                   "serving_configs": serving, "train_path": train,
                                   "tiny_overfit": overfit, "kernel_times": results,
                                   "card": card}), flush=True)

    # launches on each kernel's path: the int8 serving path (q8, bf16-cache
    # attention, norm_residual, gelu_mul), the serving configurations (q4,
    # int8-cache attention), the training path (flash)
    def launches(name, tiled=False):
        if name.startswith("flash"):
            return train["launches"][name], "train_path (5 steps)"
        if name.startswith("q4") or name.endswith("kv8"):
            key = "tiled_launches" if tiled else "launches"
            return (sum(c[key][name] for c in serving.values()),
                    "serving_configs (a), (b), (c): 6 requests each, + a 16-row batch in (b)"
                    + (", on the tensor-core route" if tiled else ""))
        return path["launches"][name], "main_path (3 requests + a 2-row batch)"

    # the q4 wrappers' tensor-core route above 16 rows gets an entry of its
    # own, at its first timed shape (the 277-row prefill's)
    # each kernel's launches in one replay of the decode graphs checked
    # (graph_launches): counted in the traced replay, and credited
    graph_checks = path["graph_launches"] + [c for v in serving.values()
                                             for c in v["graph_launches"]]

    def per_replay(name):
        if not any(name in c["credited"] or name in c["measured"] for c in graph_checks):
            return None
        return {"measured": sum(c["measured"].get(name, 0) for c in graph_checks),
                "credited": sum(c["credited"].get(name, 0) for c in graph_checks),
                "graphs": len(graph_checks)}

    entries = [(name, name, False) for name in KERNEL_SOURCES]
    entries[4:4] = [(name + "_tiled", name, True) for name in ("q4_matvec", "q4_rmsnorm_matvec")]
    kernels = []
    for label, name, tiled in entries:
        source, replaces = KERNEL_SOURCES[name]
        r = results[name]
        first = next(iter(r["ms"]))  # the path's own shape comes first
        if tiled:
            first = next(k for k in r["ms"] if int(k.split("_M")[1].split("_")[0]) > 16)
        tol = ("max|kernel - plain| / max|plain| < 2e-2 (bf16), < 1e-4 (fp32)"
               if name.startswith("flash") else
               f"max|kernel - plain| / max|plain| < {'2e-2' if name.startswith('q4') else '1e-2'} "
               f"(bf16 out), < {Q4_FP32_TOL} (fp32 out), h_out < 1e-2"
               if "residual_rmsnorm" in name else
               f"max|kernel - plain| / max|plain| < 2e-2 (bf16 out), < {Q4_FP32_TOL} (fp32 out)"
               if name.startswith("q4") else "max|kernel - plain| / max|plain| < 1e-2")
        n, run = launches(name, tiled)
        bound_ms, bound_by = r["bound"][first]
        # the q4 entry points send calls of M <= 16, per channel or in groups
        # of a multiple of 16 columns, to the int4 instances of q8_matvec.cu's
        # kernel
        sources = [source] + (["q8_matvec.cu"] if name.startswith("q4") and not tiled else [])
        extra = {"fma_tiles_ms": r["fma_tiles_ms"][first]} if tiled else {}
        if "residual_rmsnorm" in name:  # what one launch replaces, and the library's matmul
            extra = {"pair_ms": r["pair_ms"][first],
                     "library_matmul_alone_ms": r["library_matmul_alone_ms"][first]}
        if "fma_ms" in r:  # the flash backward: its CUDA route, and the FMA kernels' time
            extra = {"cuda_route": r["cuda_route"], "fma_ms": r["fma_ms"][first]}
        kernels.append({
            "name": label, "route": "cuda", "source": f"spatialvla_tpu_torch/csrc/{source}",
            "kernel_sources": [f"spatialvla_tpu_torch/csrc/{s}" for s in sources],
            "replaces": replaces, "launches": n, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"][first], "plain_ms": r["plain_ms"][first], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": r["library_ms"][first], "shape": first,
            "tolerance": tol, "launches_on": run, "library_note": notes.get(name),
            "decode_graph_launches_per_replay": None if tiled else per_replay(name), **extra,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
