#!/usr/bin/env python3
"""Start the PyTorch port (spatialvla_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

1. Builds the CUDA kernels from spatialvla_tpu_torch/csrc (nvcc, sm_90a).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it, and times both, beside
   the least time the card could take (bytes over 3.35 TB/s or operations
   over 989 TFLOP/s) and one PyTorch call computing the same function where
   there is one (torch._weight_int8pack_mm, torch._weight_int4pack_mm,
   torch.compile(flex_attention); for the RMSNorm variants their matmul
   alone, in the log): the int8 and int4
   matvecs (int8 also at the whole-vocabulary head, 2304 -> 265346 at 1 and
   2 rows) (per channel and in 128-column groups, 1 and 16 rows; int4 also
   the prefill's projections at 277 rows, SigLIP's and the projector's at
   256, qkv at 512 and 17, beside the FMA tiles that took those rows before
   the tensor-core kernel; 16- and 24-column groups checked untimed; each
   int4 call's kernel printed and held to its route, its fp32 output to
   plain within 5e-3 and its bf16 output within 2e-2), the bf16- and
   int8-cache decode attention (also on a 4096-slot cache), norm_residual
   (one row a block in registers, 1 and 16 rows, alone and after a copy of
   h), gelu_mul, the residual kernels (norm_residual folded into the next
   RMSNorm matvec: int8, int4, int4-g128 at 1 and 4 rows, qkv and gate|up,
   bf16 and fp32 out, timed beside the pair the step runs where they are
   not taken: norm_residual writing the next norm's x', the plain matvec),
   gate|up with gelu(gate) * up in its epilogue (the
   residual kernel at 1 and 4 rows, the plain matvec at 16; the bits of
   the gate|up kernel followed by gelu_mul, timed beside that pair), a
   2-layer decode step, the flash kernels (the bf16
   forward and backward on their tensor-core routes, each call's route and
   grid printed, the forward's registers and spills, two launches
   bit-identical, and timed beside the FMA kernels they replace, with their
   TFLOP/s and share of the bound).
3. The decode-step matrix of bench.py:111-160 at full width (26 layers,
   M = 16, S = 332, per-row positions): {int8, int4, int4-g128, int8+mlp4}
   x {bf16, int8} KV cache, the fused step against the masked forward on the
   same tree (relative drift below 0.05 / 0.08); and the step of every
   format at batch 1 (S = 289, bf16 cache); each step's launches exact (131
   at one row, 182 at 16: 5 a layer + 1, 7 a layer less 1). Then the path
   that still launches gelu_mul: the 26-layer step with an int4 MLP in
   24-column groups, which no gelu epilogue takes (refused_shape_step).
4. Drives the serving path: SpatialVLAPolicy.predict on full-width
   spatialvla_4b() (SigLIP-so400m, ZoeDepth BEiT-L, Gemma2-2B with 26 layers)
   with random weights from a seed, after quantize(bits=8): first requests
   that capture the decode loop's CUDA graphs (one per batch size and
   64-slot cache bucket; capture times printed), then three requests and
   one right-padded predict_batch of two rows through them. The kernels'
   launch counts over that run must all be positive and those of the decode
   steps exact: per step 2 L - 1 residual kernels, L of them with gelu(gate)
   * up in their epilogue (no gelu_mul), one norm_residual. The
   wrappers' counts are credited per graph replay, so each graph is replayed
   once under torch.profiler and the library's kernels in the trace, by
   wrapper, must equal its credits (also in (5) and (6) below). The
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
   Then the serving engines on the seed's int8 tree (serving_engines): the
   dynamic batcher after warmup_buckets (12 decode graphs) with 8
   closed-loop clients x 3 requests of 24 instruction lengths, and the
   split-phase engine (16 slots, its decode batch one CUDA graph) with 16
   clients x 2 requests: every result held to predict under the margin
   rule, no capture inside either timed window, the split engine's ids of
   4 requests alone and inside a burst of 16 identical, its decode graph's
   traced replay held to its credits; each engine's actions/s and p50 /
   p95 latency printed with the card.
5. The checkpoint entry points at the same width (checkpoint_path): the
   seed's bf16 tree exported as a reference-format HF checkpoint and loaded
   back with from_hf_checkpoint (bit-identical), quantize(bits=8) and the
   three requests (ids and margins those of (4)), a serving checkpoint
   written and loaded back (save_serving / load_serving: bit-identical,
   knobs restored, the same ids and margins through the decode graph), one
   request with the argmax over the whole vocabulary through its own decode
   graph (held to the eager unfused loop under the margin rule, its graph's
   replay traced) and one on the unfused int8 tree (fuse=False), held to the
   fused tree. The seconds and bytes of each write and load, each load's
   peak host RSS and the free disk are printed; too little disk fails.
6. The same entry point after quantize(bits=4), quantize(bits=8, mlp_bits=4,
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
7. Drives the training path: full-parameter training of full-width
   spatialvla_4b() (fp32 masters, bf16 compute, remat, flash attention,
   256-token loss chunks, AdamW with clipping, batch 2 x 320 built by the
   port's processor) through train_loop for 5 steps. The flash kernels must
   launch 2 x 26 (forward, with remat) and 26 (dq, dk/dv) times per step;
   the metrics must be finite; the frozen LM embedding and ZoeDepth must be
   bit-identical afterwards. Before that, one loss and gradient of the same
   batch and weights with attn_backend="xla" is held to the flash one
   (LOSS_BOUND, GRAD_NORM_BOUND). Then spatialvla_tiny(use_vision_zoe=True)
   must overfit one batch through the kernels (loss down by more than 0.5 in
   8 steps at lr 5e-3). Between the two, the parallel phase
   (parallel_path) on the same weights and batches: ring attention alone at
   the training shape with n = 4 and 2 shards held by this process, against
   the unsharded flash kernel and plain (prefix and causal); one loss and
   gradient through the ring (LocalMesh sp=4, sp=2) and the pipe (pipe=2,
   7+6 layer pairs, 2 microbatches) within LOSS_BOUND / GRAD_NORM_BOUND of
   flash, with exact flash launches (2 L n^2 / L n^2 for the ring, 2 L m /
   L m for the pipe); a one-rank NCCL process group (initialize_distributed,
   make_mesh) and the sharded step over its sp group, whose loss and
   grad_norm must equal the flash step's bit for bit; three timed steps of
   each through train_loop with their peak memory. After it, the model-axis
   phase (model_parallel_training) on the same weights and batches:
   LocalMesh(model=2) and (model=4), every shard on this card, the state cut
   over model in place, then the model axis with the ring (model=2, sp=2)
   and with the pipe (model=2, pipe=2: 7+6 layer pairs, 2 microbatches);
   the first sharded step's loss and grad_norm within LOSS_BOUND /
   GRAD_NORM_BOUND of the flash step's on the same weights, exact flash
   launches a step (2 L v forward, L v of each backward, v = n, 8 and 4
   calls a layer: 416 / 208 / 208 over the ring, 208 / 104 / 104 over the
   pipe), three timed steps through train_loop with the peak memory, the
   state joined back; then two LoRA steps at n = 2 and at (model=2, sp=2)
   against two unsharded ones from the same factors (LOSS_BOUND), launches
   exact, timed with the peak memory. The flash kernels are held to plain
   at those shards' heads, and at a ring visit over them, in (2).
8. LoRA fine-tuning as train/finetune.py runs it (finetune_path): the
   seed's fp32 spatialvla_4b() tree written as a pretrained directory
   (save_params, config.json, the processor) and read back with
   finetune.load_pretrained; scripts/finetune_lora.sh's settings (rank 32,
   alpha 32, the 'linear' targets, lr 5e-4, flash attention, remat,
   256-token loss chunks) on batch 2 x 320 for 6 steps of train_loop with a
   CheckpointManager that saves every 2 steps and keeps 2. One batch's loss
   and trainable-gradient norm with flash against xla attention (LOSS_BOUND,
   GRAD_NORM_BOUND); the flash kernels launched 2 x 26, 26 and 26 times a
   step; the metrics finite; every base leaf bit-identical afterwards and
   every B factor and the spatial embedding changed. A fresh state restored
   from the step-4 checkpoint is bit-identical to the state saved there, and
   steps 5-6 from it give the uninterrupted run's losses (bit-exact, or
   within RESUME_LOSS_BOUND; which of the two is printed). A LoRA-factored
   int8 projection (the trained q factors of layer 0 over the int8 base) at
   1 and 16 rows against its plain version (1e-2). Then insert_saved,
   lora_fold, bf16 and quantize(bits=8): the policy served next.
9. Evaluation of that policy through the eval driver (eval_path): a task
   that succeeds at the first step and one that never does, 8 episodes
   each, serially and with 4 envs whose queries the driver's ServingEngine
   batches; equal rows, every episode counted, finite actions, the int8
   kernels and the decode kernels launched in both runs, a mean batch above
   1, the decode-graph captures during each run counted.
10. The training CLIs over RLDS records from disk (data_cli_path), after
   (9): the port's native RLDS reader built (its nvJPEG route where the
   machine has no libjpeg; the phase fails, printing the compiler's error,
   when it did not build) and named; the committed fixture
   (tests/fixtures_rlds, bridge_orig at 256 x 256) through the source layer,
   its trajectories' actions and statistics equal to golden.npz (the JAX
   package's) and their first and last primary frames decoded at 224 x 224
   within GOLDEN_MAX_ABS / GOLDEN_MEAN_ABS of it; then pretrain.main in this
   process at full width with the LM cut to 6 layers (--per_device_batch_size
   2 --seq_len 320 --no_augment --loader_workers 1 --freeze_vision_tower,
   3 steps, a step checkpoint every 2, kept 1) and finetune.main with LoRA
   (scripts/finetune_lora.sh's rank, alpha, targets and lr) from its export,
   3 steps, a save every step, the runs' directories in /dev/shm (the
   machine takes at most 45 GiB of disk writes a call; CHIP_SMOKE_WORK_ROOT
   names another directory): finite losses, exact flash
   launches (2 L / L / L a step), at least one step run while a background
   checkpoint write was in flight, and each run's last step checkpoint
   restored bit-identical to the state main returned; each save's seconds
   blocked and written and its bytes, the steps during and without a write
   with the stepping thread's user and system CPU time, the peak device
   memory, host RSS and the host memory left after the phase printed.
11. Tensor-parallel serving (tensor_parallel_path), after (10): the int8 and
   the int4-g128 (vision_bits=4) trees sharded over n_model = 2 and 4 with
   every shard on this card (SpatialVLAPolicy.shard), the lm_head times 8:
   the main path's three requests held to the unsharded policy's (the
   first step's action logits within 1/32 of their largest, the fused
   path's ids under the margin rule from the first token, a tie within
   that difference apart), each request's launches of kernels #1 and #2
   exact and no other kernel launched (the unfused loop, no decode graph),
   n_model=2 x n_data=2 over a 2-row batch held the same way, both engines over shard(n_model=2) (the
   split one with kv_bits=8) serving 8 requests from 4 clients, kernels #1
   and #2 at every new shard shape against their plain versions, and warm
   predict ms at n_model = 1 (unfused), 2 and 4.
12. Prints the card, the kernels' JSON line (with each decode kernel's
   launches in one replay of the graphs checked, traced and credited, the
   launches of the LoRA, eval, model-axis and data CLI runs, and an entry
   "<name>_tp" for each of kernels #1 and #2 at the shard shapes), and last
   {"ok": true, ...}.

Needs CUDA; there is no CPU path. Imports nothing of jax.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
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


def flex_call(torch, q, k, v, lens, *, scale, logit_softcap, window, causal):
    """torch.nn.attention.flex_attention.flex_attention on the flash kernels'
    function, compiled by torch.compile (Triton): Gemma2's softcap as a
    score_mod, the prefix / causal / window / right-padding mask as a block
    mask, the kv heads shared by enable_gqa, and the LSE. q (B, Tq, Nq, D), k / v (B, Tk, Nkv, D) go in as (B, heads,
    T, D) views. Returns fn(q, k, v) -> (out (B, Tq, Nq, D), lse (B, Nq, Tq,
    1)), or raises where this torch has no flex_attention."""
    from torch.nn.attention import flex_attention as fx

    prefix, valid, qoff = lens
    B, Tq, _, _ = q.shape
    Tk = k.shape[1]

    def mask_mod(b, h, q_idx, kv_idx):
        qpos = q_idx + qoff[b]
        ok = kv_idx < valid[b]
        if causal:
            ok = ok & ((kv_idx <= qpos) | (kv_idx < prefix[b]))
        if window is not None:
            ok = ok & (qpos - kv_idx < window)
        return ok

    def score_mod(score, b, h, q_idx, kv_idx):
        return logit_softcap * torch.tanh(score / logit_softcap)

    block_mask = fx.create_block_mask(mask_mod, B, None, Tq, Tk, device=q.device)
    flex = torch.compile(fx.flex_attention, dynamic=False)
    aux = fx.AuxRequest(lse=True) if hasattr(fx, "AuxRequest") else None

    def fn(q, k, v):
        args = [t.transpose(1, 2) for t in (q, k, v)]
        kw = dict(score_mod=score_mod if logit_softcap else None, block_mask=block_mask,
                  scale=scale, enable_gqa=True)
        if aux is not None:
            out, extra = flex(*args, **kw, return_aux=aux)
            lse = extra.lse
        else:
            out, lse = flex(*args, **kw, return_lse=True)
        return out.transpose(1, 2), lse.unsqueeze(-1)

    return fn


def library_flex(torch, timer, q, k, v, do, lens, kw, ref):
    """flex_attention (flex_call) as the flash kernels' library yardstick:
    its forward (out and LSE, under no_grad), and its backward (dq, dk and
    dv in one autograd call) as the time of forward + backward less that of
    the same forward with grad enabled (the graph that saves what the
    backward reads), on the same inputs, each held to the plain versions
    first (``ref``: out, lse, dq, dk, dv). Returns ({"fwd": ms or None,
    "bwd": ms or None}, a note with the errors and any reason it could not
    run)."""
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       "spatialvla_tpu_torch", "_build", "inductor"))
    # every timed shape compiles flex_attention anew (with and without
    # grad): past dynamo's default limit of 8 it would fall back to eager,
    # whose dense path cannot be captured into the timer's graph
    import importlib

    dynamo = importlib.import_module("torch._dynamo").config
    for key in ("recompile_limit", "cache_size_limit", "accumulated_recompile_limit",
                "accumulated_cache_size_limit"):
        if hasattr(dynamo, key):
            setattr(dynamo, key, max(getattr(dynamo, key), 256))
    times = {"fwd": None, "bwd": None}
    try:
        fn = flex_call(torch, q, k, v, lens, **kw)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out, lse = fn(*leaves)
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
    except Exception as e:  # no flex_attention, or it does not compile at this head dim
        return times, f"flex_attention did not run: {type(e).__name__}: {str(e)[:300]}"
    tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
    errs = [rel_err(a, b)[1] for a, b in zip((out, *grads), (ref[0], *ref[2:]))]
    lse_err = (lse.float() - ref[1]).abs().max().item()
    # the checked graph goes: its leaves' grad accumulators would tie the
    # timer's captures to this stream
    del out, lse, grads, leaves
    note = (f"torch.compile(flex_attention), softcap score_mod, block mask, enable_gqa: rel err "
            f"out {errs[0]:.2e} dq {errs[1]:.2e} dk {errs[2]:.2e} dv {errs[3]:.2e}, lse max|d| "
            f"{lse_err:.2e} vs plain")
    if not (errs[0] < tol and lse_err < 1e-3):
        return times, note + f"; over the bound {tol} / 1e-3: not timed"
    try:
        with torch.no_grad():
            times["fwd"] = timer(lambda: fn(q, k, v))
    except Exception as e:  # a capture the library's forward refuses
        torch.cuda.synchronize()
        return times, note + f"; forward not timed: {type(e).__name__}: {str(e)[:200]}"
    if not all(e < tol for e in errs[1:]):
        return times, note + f"; gradients over the bound {tol}: backward not timed"
    fresh = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    try:
        fwd_grad = timer(lambda: fn(*fresh))
        both = timer(lambda: torch.autograd.grad(fn(*fresh)[0], fresh, do))
    except Exception as e:  # a capture the library's backward refuses
        torch.cuda.synchronize()
        return times, note + f"; backward not timed: {type(e).__name__}: {str(e)[:200]}"
    times["bwd"] = both - fwd_grad
    return times, note + f"; forward with grad {fwd_grad:.4f} ms"


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

def zero_counts(counters):
    """Every launch count of these wrappers (``launches`` and, where a
    wrapper has it, ``gelu_launches``) set to 0."""
    for c in counters:
        c.launches = 0
        if hasattr(c, "gelu_launches"):
            c.gelu_launches = 0


def launch_counts(torch, fn) -> dict:
    """The kernel launches that one call of ``fn`` makes, by wrapper (and
    "wrapper.attr" for the counts of a kind of launch, as
    GreedyLoop.credits names them); counts that did not move are left out."""
    from spatialvla_tpu_torch.ops import _lib

    before = {(f, a): getattr(f, a) for f, names in _lib.COUNTED for a in names}
    fn()
    if torch.cuda.is_available():  # off the card the wrappers launch nothing
        torch.cuda.synchronize()
    return {f.__name__ + ("" if a == "launches" else f".{a}"): getattr(f, a) - n
            for (f, a), n in before.items() if getattr(f, a) != n}


def check_step_launches(label, counts, M, L):
    """The launches of one decode step of L layers at M rows whose weights
    every route takes (aligned, per channel or in groups of a multiple of 16
    columns): up to 4 rows 5 a layer and one at the end (the residual
    kernels 2 L - 1 times, gate|up's with the gelu epilogue, one
    norm_residual), above 4 rows 7 a layer less one (norm_residual with the
    next norm's x' 2 L times, the plain matvec with the gelu epilogue for
    gate|up); gelu_mul never."""
    launches = {k: n for k, n in counts.items() if "." not in k}
    gelu = sum(n for k, n in counts.items() if k.endswith(".gelu_launches"))
    total, want = sum(launches.values()), (5 * L + 1 if M <= 4 else 7 * L)
    n_norm = launches.get("norm_residual", 0)
    print(f"{label}: {total} launches a step (want {want}), norm_residual {n_norm}, "
          f"gelu epilogues {gelu}: {counts}", flush=True)
    if (total != want or gelu != L or launches.get("gelu_mul", 0)
            or n_norm != (1 if M <= 4 else 2 * L)):
        fail(f"{label}: launches {counts}; want {want} in all, {L} gelu epilogues, no gelu_mul")


def gelu_epilogue_phase(torch, timer, results, randn, qweight):
    """The gate|up matvec (2304 -> 2 x 9216) with gelu(gate) * up in its
    epilogue (gelu=True), int8, int4 per channel and in 128-column groups,
    as the decode step runs it: the residual kernel at 1 and 4 rows, the
    plain matvec on bf16 x' at 16 rows. It must give the bits of the pair
    it replaces (the same kernel's bf16 gate | up, then gelu_mul), and hold
    to the plain version (then gelu_mul_plain) within 1e-2 (int8) / 2e-2
    (int4) of max|plain|. Timed beside the pair and plain; recorded under
    the wrapper that launches it ("gelu_epilogue")."""
    from spatialvla_tpu_torch.ops import decode_step as ds
    from spatialvla_tpu_torch.ops import quant

    K, I = 2304, 9216
    for fmt, group in (("int8", None), ("int4", 0), ("int4-g128", 128)):
        w = qweight(2 * I, K) if group is None else qweight(2 * I, K, 4, group or None)
        qt, scale = w["qt"], w["scale"]
        for kind, M in (("residual", 1), ("residual", 4), ("plain", 16)):
            if kind == "plain":
                x = randn(M, K)
                name = "q8_matvec" if group is None else "q4_matvec"
                call = lambda gelu, x=x: quant.matvec(x, qt, scale, gelu=gelu)  # noqa: E731
                plain = lambda x=x: quant.matvec_plain(x, qt, scale, gelu=True)  # noqa: E731
                nbytes = nbytes_of(x, qt, scale) + 2 * M * I
            else:
                h_in, upd = randn(M, K, dtype=torch.float32, std=8.0), randn(M, K)
                post, nw = randn(K, std=0.1), randn(K, std=0.1)
                h_out, h_ref = torch.empty_like(h_in), torch.empty_like(h_in)
                name = ("q8_residual_rmsnorm_matvec" if group is None
                        else "q4_residual_rmsnorm_matvec")
                call = lambda gelu, a=(h_in, upd, post, nw), h_out=h_out: (  # noqa: E731
                    quant.residual_rmsnorm_matvec(*a, qt, scale, h_out=h_out, gelu=gelu))
                plain = lambda a=(h_in, upd, post, nw), h_ref=h_ref: (  # noqa: E731
                    quant.residual_rmsnorm_matvec_plain(*a, qt, scale, h_out=h_ref, gelu=True))
                nbytes = nbytes_of(h_in, upd, post, nw, qt, scale, h_out) + 2 * M * I
            act = call(True)
            pair_out = torch.empty_like(act)

            def pair(call=call, pair_out=pair_out):
                ds.gelu_mul(call(False), out=pair_out)
            pair()
            ref = plain()
            d_pair, _ = rel_err(act, pair_out)
            d, r = rel_err(act, ref)
            ms, pair_ms, pms = timer(lambda call=call: call(True)), timer(pair), timer(plain)
            gate_up_ms = timer(lambda call=call: call(False))
            print(f"{name} gelu epilogue {fmt} M={M} {K}->2x{I}: max|d| against the pair "
                  f"(gate|up kernel, gelu_mul) {d_pair:.3e}, against plain {d:.3e} (rel {r:.3e}); "
                  f"kernel {ms:.4f} ms, pair {pair_ms:.4f} ms (gate|up alone {gate_up_ms:.4f}), "
                  f"plain {pms:.4f} ms", flush=True)
            if d_pair != 0.0:
                fail(f"{name} gelu epilogue {fmt} M={M}: differs from the pair by {d_pair}")
            if not r < (1e-2 if group is None else 2e-2):
                fail(f"{name} gelu epilogue {fmt} M={M}: rel err {r} against plain")
            shape = f"{fmt}_M{M}_{K}x2x{I}"
            results[name].setdefault("gelu_epilogue", {})[shape] = {
                "ms": ms, "pair_ms": pair_ms, "gate_up_ms": gate_up_ms, "plain_ms": pms,
                "max_abs_err_vs_pair": d_pair, "max_abs_err_vs_plain": d,
                "bound_ms": bound(nbytes, 2 * M * 2 * I * K)[0]}


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

    # q8_matvec: the action head (M = 1, 2304 -> 8194), the whole-vocabulary
    # head (M = 1 and 2, 2304 -> 265346: greedy with
    # restrict_to_action_tokens=False, 611 MB of codes), the down projection
    # at batch 16 (9216 -> 2304), the decode step's o (2048 -> 2304) and
    # down (9216 -> 2304) projections at batch 1, and o at batch 16
    for M, K, N in ((1, 2304, 8194), (1, 2304, 265346), (2, 2304, 265346), (16, 9216, 2304),
                    (1, 2048, 2304), (1, 9216, 2304), (16, 2048, 2304)):
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

    # norm_residual with the next norm's x' (the final norm on the last
    # layer; above 4 rows every residual update of the step): one row a
    # block in registers. Timed alone, on an h that each run updates again,
    # and with a copy of h0 in front of each run (as PRs 1-14 timed it)
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
            t = timer(lambda fn=fn, hh=hh, out=out: fn(hh, upd, w, eps=1e-6, final_w=fw,
                                                     final_out=out))
            t_copy = timer(lambda fn=fn, hh=hh, out=out: (hh.copy_(h0), fn(
                hh, upd, w, eps=1e-6, final_w=fw, final_out=out)))
            res[tag] = (h, out, t, t_copy)
        d1, r1 = rel_err(res["kernel"][0], res["plain"][0])
        d2, r2 = rel_err(res["kernel"][1], res["plain"][1])
        ms, pms = res["kernel"][2], res["plain"][2]
        print(f"norm_residual M={M} H={H}: h max|d|={d1:.3e} out max|d|={d2:.3e} "
              f"kernel {ms:.4f} ms plain {pms:.4f} ms; each with a {M}x{H} copy of h in "
              f"front: kernel {res['kernel'][3]:.4f} ms plain {res['plain'][3]:.4f} ms",
              flush=True)
        if not (r1 < 1e-2 and r2 < 1e-2):
            fail(f"norm_residual M={M}: rel {r1}, {r2}")
        # h read and written, upd, both norm weights, the final output
        record("norm_residual", f"M{M}_H{H}", max(d1, d2), ms, pms,
               nbytes_of(h0, h0, upd, w, fw, res["kernel"][1]), 12 * M * H)
        results["norm_residual"].setdefault("with_copy_ms", {})[f"M{M}_H{H}"] = res["kernel"][3]

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
    # output within Q4_FP32_TOL, h_out within 1e-2. Timed beside the pair
    # the step runs where it is not taken (norm_residual writing the next
    # norm's x', then the plain matvec; both launches in the CUDA-graph
    # timer) and beside the library's int8 / int4 matmul alone on the plain
    # normed x (not the same function)
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
                # the step's route where the fold is not taken (above 4 rows):
                # norm_residual writes the next norm's x', the plain matvec reads it
                hh, xn = h_in.clone(), torch.empty(M, K, dtype=torch.bfloat16, device=dev)
                pair = timer(lambda: (
                    ds.norm_residual(hh, upd, post, eps=1e-6, final_w=nw, final_out=xn),
                    quant.matvec(xn, w["qt"], w["scale"])))
                xl = quant._rms_bf16(h_ref, nw, 1e-6)
                lib_fn = library_int8pack if qkw is None else library_int4pack
                lib, note = lib_fn(torch, timer, xl, w["qt"], w["scale"])
                print(f"{name} {fmt} M={M} {K}->{N}: max|d| {max(errs):.3e} kernel {ms:.4f} ms "
                      f"(norm_residual with x' + matvec {pair:.4f} ms) plain {pms:.4f} ms "
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

    gelu_epilogue_phase(torch, timer, results, randn, qweight)

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
    ones) in bf16, timed, and checked again in fp32; T=2048 with window
    4096, timed; the flash prefill's (B=1, 277 tokens, all of them prefix,
    window 4096), timed; and a ring visit of the training batch at sp=4 and
    sp=2 (Tq = Tk = 80 and 160, q_offset 160 and the prefix and lengths in
    the visiting shard's frame), timed; and the training shapes at the heads
    of one shard of the model axis (model_parallel_training: 4/2 heads at
    n = 2, 2/1 at n = 4), windowed and global, and the sp=2 ring visit at
    the 4/2 heads of one of 2 model shards, timed. Each call's route and launch plan is
    printed (the forward's with its registers and spills); a bf16 call must
    take the tensor-core route and give identical bits when launched twice,
    and is timed beside the FMA kernels in bf16 (the route it took before,
    "fma_ms"). flex_attention, compiled, is each timed shape's library call
    (library_flex): its forward is the forward's library_ms; its backward
    computes dq, dk and dv in one call, so it is held against the port's
    whole backward (flash_attention_bwd: delta, dq, dk/dv) in "backward",
    and the dq and dk/dv rows' library_ms stay None."""
    from spatialvla_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(3)
    D = 256
    cases = (  # tag, B, T, window, prefix, valid, dtype, timed, q_offset[, (Nq, Nkv)]
        ("T320_window4096", 2, 320, 4096, [277, 277], [320, 301], torch.bfloat16, True, 0),
        ("T320_global", 2, 320, None, [277, 277], [320, 301], torch.bfloat16, True, 0),
        ("T320_window4096_fp32", 2, 320, 4096, [277, 277], [320, 301], torch.float32, False, 0),
        ("T2048_window4096", 2, 2048, 4096, [256, 256], [2048, 1900], torch.bfloat16, True, 0),
        ("prefill_T277", 1, 277, 4096, [277], [277], torch.bfloat16, True, 0),
        # a ring visit of the training batch (parallel_path), in the visiting
        # shard's key frame: sp=4, q shard 3 over K/V shard 1 (Tq = Tk = 80,
        # k_start 80); sp=2, q shard 1 over K/V shard 0 (160, k_start 0)
        ("ring4_T80_visit", 2, 80, 4096, [197, 197], [240, 221], torch.bfloat16, True, 160),
        ("ring2_T160_visit", 2, 160, 4096, [277, 277], [320, 301], torch.bfloat16, True, 160),
        # one model shard's heads of the training batch: n = 2 and n = 4
        *((f"T320_{w}_h{nq}x{nkv}", 2, 320, window, [277, 277], [320, 301], torch.bfloat16, True,
           0, (nq, nkv)) for nq, nkv in ((4, 2), (2, 1))
          for w, window in (("window4096", 4096), ("global", None))),
        # a ring visit over one model shard's heads (model 2 x sp 2)
        ("ring2_T160_visit_h4x2", 2, 160, 4096, [277, 277], [320, 301], torch.bfloat16, True, 160,
         (4, 2)),
    )
    flex_notes = {}  # tag: what library_flex found
    for tag, B, T, window, prefix, valid, dtype, timed, qoff, *heads in cases:
        Nq, Nkv = heads[0] if heads else (8, 4)
        def randn(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(dtype)

        q, do = randn(B, T, Nq, D), randn(B, T, Nq, D)
        k, v = randn(B, T, Nkv, D), randn(B, T, Nkv, D)
        lens = [torch.tensor(x, dtype=torch.int32, device="cuda")
                for x in (prefix, valid, [qoff] * B)]
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
        fplan = fa.fwd_plan(q, k)
        plans = {"fwd": fplan, **{key: fa.bwd_plan(key, q, k) for key in ("dq", "dkv")}}
        want_route = "mma" if dtype == torch.bfloat16 else "fma"
        print(f"flash {tag} {str(dtype)[6:]}: fwd route {fplan['route']}, grid {fplan['grid']} x "
              f"{fplan['threads']} threads ({fplan['rows']} q rows), clusters of "
              f"{fplan['cluster']}, {fplan['smem_bytes']} B shared, {fplan['blocks_per_sm']} "
              f"blocks an SM, {fplan['registers']} registers, {fplan['local_bytes']} B local; "
              + "; ".join(
            f"{key} route {p['route']}, grid {p['grid']} x {p['threads']} threads, "
            f"{p['smem_bytes']} B shared, {p['blocks_per_sm']} blocks an SM, clusters of "
            f"{p['cluster']}"
            for key, p in plans.items() if key != "fwd"), flush=True)
        if any(p["route"] != want_route for p in plans.values()):
            fail(f"flash {tag}: routes {plans}, want {want_route}")
        if fplan["route"] == "mma" and fplan["local_bytes"]:
            fail(f"flash {tag}: the forward spills ({fplan['local_bytes']} B local a thread)")
        if fplan["route"] == "mma" and (fplan["grid"] != (-(-T // fa.FWD_ROWS), Nq, B)
                                        or fplan["cluster"] != 1):
            fail(f"flash {tag}: forward plan {fplan}, want one block a 64-row q tile and head")
        if dtype == torch.bfloat16:  # no atomics: a second launch gives the same bits
            out2, lse2 = fa.flash_attention_fwd(q, k, v, *lens, **kw)
            dq2 = fa.flash_attention_bwd_dq(*args, **kw)
            dk2, dv2 = fa.flash_attention_bwd_dkv(*args, **kw)
            if not (torch.equal(out, out2) and torch.equal(lse, lse2) and torch.equal(dq, dq2)
                    and torch.equal(dk, dk2) and torch.equal(dv, dv2)):
                fail(f"flash {tag}: two launches of a bf16 kernel differ")
        times, fma, lib, backward = {}, {}, {}, None
        if timed:
            times = {
                "fwd": (timer(lambda: fa.flash_attention_fwd(q, k, v, *lens, **kw)),
                        timer(lambda: fa.flash_attention_fwd_plain(q, k, v, *lens, **kw))),
                "dq": (timer(lambda: fa.flash_attention_bwd_dq(*args, **kw)),
                       timer(lambda: fa.flash_attention_bwd_dq_plain(*args, **kw))),
                "dkv": (timer(lambda: fa.flash_attention_bwd_dkv(*args, **kw)),
                        timer(lambda: fa.flash_attention_bwd_dkv_plain(*args, **kw))),
            }
            fma = {"fwd": timer(lambda: fa.flash_attention_fwd_fma(q, k, v, *lens, **kw)),
                   "dq": timer(lambda: fa.flash_attention_bwd_fma(*args, **kw, dkv=False)),
                   "dkv": timer(lambda: fa.flash_attention_bwd_fma(*args, **kw, dq=False))}
            ref = (ref_out, ref_lse, *fa.flash_attention_bwd_plain(q, k, v, ref_out, ref_lse, do,
                                                                   *lens, **kw))
            flex, flex_notes[tag] = library_flex(torch, timer, q, k, v, do, lens, kw, ref)
            lib = {"fwd": flex["fwd"]}
            backward = {"port_ms": timer(lambda: fa.flash_attention_bwd(
                q, k, v, ref_out, ref_lse, do, *lens, **kw)), "library_ms": flex["bwd"]}
            ratio = (f", the library {flex['bwd'] / backward['port_ms']:.2f} x the port's"
                     if flex["bwd"] else "")
            print(f"flash {tag}: library flex_attention forward {flex['fwd']} ms, backward "
                  f"(dq, dk, dv) {flex['bwd']} ms against the port's flash_attention_bwd "
                  f"(delta, dq, dk/dv) {backward['port_ms']:.4f} ms{ratio}; {flex_notes[tag]}",
                  flush=True)
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
            shape = (f"B{B}_T{T}_D{D}_" + (f"window{window}" if window else "global")
                     + (f"_h{Nq}x{Nkv}" if heads else "")
                     + ("_fp32" if dtype == torch.float32 else "")
                     + (f"_qoff{qoff}_prefix{prefix[0]}" if qoff else ""))
            record_kernel(results, name, shape, err, ms, pms, nbytes=io[key][0], ops=io[key][1],
                          library_ms=lib.get(key))
            if key in fma:
                bms = results[name]["bound"][shape][0]
                print(f"flash {tag} {key}: {plans[key]['route']} {ms:.4f} ms, "
                      f"{io[key][1] / ms / 1e9:.1f} TFLOP/s, {bms / ms:.2%} of the bound "
                      f"{bms:.4f} ms; FMA kernels in bf16 (was) {fma[key]:.4f} ms, "
                      f"{fma[key] / ms:.1f} x", flush=True)
                results[name].setdefault("fma_ms", {})[shape] = fma[key]
                results[name]["cuda_route"] = plans[key]["route"]
            if backward is not None and key != "fwd":
                results[name].setdefault("backward", {})[shape] = backward
    bwd_what = ("its backward computes dq, dk and dv in one call, so library_ms is None and "
                "\"backward\" holds it against the port's whole backward")
    for name, what in (("flash_attention_fwd", "its forward (out and LSE) is library_ms"),
                       ("flash_attention_bwd_dq", bwd_what),
                       ("flash_attention_bwd_dkv", bwd_what)):
        notes[name] = (f"torch.compile(flex_attention) with the softcap as a score_mod, the mask "
                       f"as a block mask and enable_gqa: {what} (F.scaled_dot_product_attention "
                       f"has no softcap): "
                       + "; ".join(f"{t}: {n}" for t, n in flex_notes.items()))


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


def decode_wrapper_of(kernel: str, targs: list) -> list:
    """The launch counts that this kernel's launch in a decode step adds one
    to (at M <= 16 each wrapper launches one kernel): its wrapper's, and for
    the gelu epilogue also "wrapper.gelu_launches", from the kernel's name
    and template arguments; [] for a kernel that no decode step launches."""
    if kernel == "qmatvec_kernel":  # <MR, kNorm, kInt4, kGrouped, kResid, kGelu>
        _, norm, int4, _, resid, gelu = targs
        wrapper = ("q4" if int4 == "true" else "q8") + (
            "_residual_rmsnorm_matvec" if resid == "true"
            else "_rmsnorm_matvec" if norm == "true" else "_matvec")
        return [wrapper] + ([wrapper + ".gelu_launches"] if gelu == "true" else [])
    if kernel == "q4_small_kernel":  # <kNorm>
        return ["q4_rmsnorm_matvec" if targs[0] == "true" else "q4_matvec"]
    if kernel == "decode_attention_kernel":  # <KV, GM>
        return ["decode_attention_kv8" if "char" in targs[0] else "decode_attention"]
    return {"norm_residual_kernel": ["norm_residual"],
            "gelu_mul_kernel": ["gelu_mul"]}.get(kernel, [])


def graph_launches(torch, policy, label) -> list:
    """Each of the policy's decode graphs replayed once under torch.profiler
    and held to its credits (``graph_check``). Returns one entry a graph:
    its shape key and both counts."""
    return [graph_check(torch, loop.graph, loop.credits, label,
                        f"B={key[0]} S={key[1]} n={key[2]} kv_bits={key[3]}")
            for key, loop in policy.decode_graphs.loops.items()]


def graph_check(torch, graph, credits, label, shape, attempts: int = 3) -> dict:
    """One decode graph replayed under torch.profiler: the library's kernels
    in the trace of the replay, each counted for the wrapper that launches it
    (``decode_wrapper_of``), must be exactly the launch counts that the graph
    credits its wrappers with per replay (``GreedyLoop`` /
    ``ServingLoop.credits``). A library kernel that no decode wrapper
    launches, or a trace without kernels, fails. The profiler can drop a
    replay's activity records (a trace of 1781 kernels where the same graph
    traced 2029 in another run, torch kernels among the missing), so a
    trace that falls short is taken again, up to ``attempts`` traces; a
    graph that launches too few kernels falls short in every one, and
    fails."""
    from torch.profiler import ProfilerActivity, profile

    names = library_kernel_names()
    head = re.compile(r"(?:void\s+)?(?:\(anonymous namespace\)::)?(\w+)")
    credited = {fn.__name__ + ("" if attr == "launches" else f".{attr}"): n
                for (fn, attr), n in credits.items()}
    traces = []
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            graph.replay()
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
            counts = decode_wrapper_of(base, targs.group(1).split(", ") if targs else [])
            if not counts:
                fail(f"{label}: kernel {name[:120]} in a decode graph is no decode wrapper's")
            measured.update(counts)
        traces.append((len(kernels), dict(measured)))
        print(f"{label} decode graph {shape}: one replay traced, {len(kernels)} kernels; "
              f"library kernels by wrapper {dict(measured)}, credited {credited}", flush=True)
        if dict(measured) == credited:
            break
    else:
        fail(f"{label} decode graph {shape}: no traced replay of {attempts} launched what the "
             f"graph credits {credited}: (kernels, by wrapper) {traces}")
    return {"graph": shape, "measured": dict(measured), "credited": credited,
            "traces": len(traces), "kernels_traced": [n for n, _ in traces]}


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
    counts = launch_counts(torch, step)
    check_step_launches(f"decode step {label}", counts, x.shape[0], tcfg.num_layers)
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
            "layer_drift": layer_drift, "launches": counts}


def main_requests(cfg):
    """The main path's three requests: (frames, instructions)."""
    rng = np.random.RandomState(7)
    size = cfg.vision.image_size
    images = [(rng.rand(size, size, 3) * 255).astype(np.uint8) for _ in range(3)]
    instructions = ["pick up the red cup", "open the top drawer",
                    "put the spoon into the pot on the left burner"]
    return images, instructions


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

    images, instructions = main_requests(cfg)
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
    zero_counts(counters)
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
    gelu_launches = {c.__name__: c.gelu_launches for c in counters if hasattr(c, "gelu_launches")}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"main path launches: {launches}; of them with the gelu epilogue {gelu_launches}",
          flush=True)

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
    # folds 2 L - 1 residual updates into the RMSNorm matvecs, gate|up's with
    # gelu(gate) * up in its epilogue (no gelu_mul: refused_shape_step
    # launches it), keeps layer 0's input norm and one norm_residual (the last
    # layer's, with the final norm), and runs the attention once a layer
    want = {"q8_residual_rmsnorm_matvec": 4 * steps * (2 * L - 1), "norm_residual": 4 * steps,
            "q8_rmsnorm_matvec": 4 * steps, "decode_attention": 4 * steps * L}
    if (any(launches[k] != v for k, v in want.items())
            or gelu_launches != {"q8_matvec": 0, "q8_residual_rmsnorm_matvec": 4 * steps * L}):
        fail(f"main path launches {launches}, gelu epilogues {gelu_launches}, want {want} and "
             f"{4 * steps * L} gelu epilogues of q8_residual_rmsnorm_matvec")
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
        "gelu_launches": gelu_launches,
        "flash_prefill_launches": flash_prefill_launches,
        "requests": [{"ids": o["action_ids"].tolist(), "margins": o["margins"].tolist()}
                     for o in outs],
    }


# ---------------------------------------------------------------------------
# the serving engines: the dynamic batcher and the split-phase engine
# ---------------------------------------------------------------------------

ENGINE_WAIT_S = 300  # a request of the engines' phase that takes longer fails it


def engine_clients(engine, requests, n_clients, per_client, label):
    """``n_clients`` closed-loop client threads: client i submits requests
    ``requests[(per_client * i + j) % len(requests)]`` (image, instruction)
    for j < per_client, each after the last one's result, waiting at most
    ENGINE_WAIT_S for it. Returns (results by request number, latencies ms
    sorted, wall s); an exception, a timeout or a stuck client fails."""
    results, lat, errors = {}, [], []
    lock = threading.Lock()

    def client(i):
        for j in range(per_client):
            r = per_client * i + j
            img, instr = requests[r % len(requests)]
            t0 = time.monotonic()
            try:
                out = engine.submit(img, instr).result(timeout=ENGINE_WAIT_S)
            except Exception as e:  # noqa: BLE001 - failed on the main thread below
                with lock:
                    errors.append(f"request {r}: {type(e).__name__}: {e}")
                return
            with lock:
                results[r] = out
                lat.append((time.monotonic() - t0) * 1e3)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=ENGINE_WAIT_S * per_client)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        fail(f"{label}: {errors or 'a client thread did not finish'}")
    return results, sorted(lat), wall


def engine_rule_ok(ids, ref_ids, ref_margins) -> bool:
    """The margin rule from the first token on: ids equal up to the first
    step whose reference margin is below MARGIN_BOUND. An engine's prefill
    pads the prompt and runs several rows where ``predict``'s runs one
    unpadded row, so a near tie may round the other way at the first token
    too (``margin_rule_ok`` holds the first token exactly, for paths that
    share the prefill)."""
    for t in range(len(ids)):
        if ref_margins[t] < MARGIN_BOUND:
            return True
        if ids[t] != ref_ids[t]:
            return False
    return True


def check_engine_results(results, requests, refs, cfg, label):
    """Each result finite, (4, 7), its ids in the action block and following
    ``policy.predict``'s on the same observation under ``engine_rule_ok``.
    Returns how many equal predict's ids exactly and how many first tokens
    do."""
    begin, n_act = cfg.action_token_begin_idx, cfg.spatial_token_num
    exact = first = 0
    for r, out in sorted(results.items()):
        a, ids = np.asarray(out["actions"]), np.asarray(out["action_ids"])
        ref = refs[r % len(requests)]
        if a.shape != (4, 7) or not np.isfinite(a).all():
            fail(f"{label} request {r}: actions {a.shape}, finite={np.isfinite(a).all()}")
        if not ((ids >= begin) & (ids < begin + n_act)).all():
            fail(f"{label} request {r}: ids outside the action block: {ids}")
        if not engine_rule_ok(ids, ref["action_ids"], ref["margins"]):
            fail(f"{label} request {r} '{requests[r % len(requests)][1]}': ids {ids.tolist()} "
                 f"vs predict's {ref['action_ids'].tolist()}, predict margins "
                 f"{np.round(ref['margins'], 3).tolist()}: beyond the margin rule")
        exact += bool(np.array_equal(ids, ref["action_ids"]))
        first += bool(ids[0] == ref["action_ids"][0])
    return exact, first


def engine_summary(lat, wall, n):
    return {"requests": n, "wall_s": wall, "actions_per_s": 4 * n / wall,
            "latency_ms_p50": lat[len(lat) // 2],
            "latency_ms_p95": lat[min(len(lat) - 1, int(0.95 * len(lat)))],
            "latency_ms_all": lat}


def serving_engines(torch, counters, *, cfg=None, device="cuda"):
    """The serving engines (serve/engine.py, serve/split_engine.py) on
    spatialvla_4b() after quantize(bits=8), seed 0, the main path's frames.
    References: ``policy.predict`` (ids, margins) on 24 requests whose
    instructions are the prefixes of one long instruction (24 prompt
    lengths, as ``instruction_stream``).

    Monolithic (``ServingEngine``, batches of up to 8 rows, buckets 1, 2, 4,
    8): ``warmup_buckets`` over the 24 instructions (8 prompt buckets of 16
    tokens, 3 cache-slot buckets: 12 decode graphs, more than the policy's
    default 8), then 8 closed-loop clients x 3 requests, the 24. Split
    (``SplitServingEngine``, 16 slots, 4 decode steps a dispatch, prompts
    of up to 320 tokens, every prefill 16 rows so that its shape is the same
    whatever the group): 16 clients x 2 requests over the instructions whose
    prompts pad to one 64-token bucket; then 4 of them submitted alone, one
    after another, and the same 4 inside a burst of 16: identical ids
    (exact scheduling invariance), and the burst's first tokens exactly
    those of ``prefill_for_serving`` on the same 16 rows. Every result must
    follow predict's under ``engine_rule_ok``, and no graph may be captured
    inside a timed window;
    each window's kernel launches by wrapper are read (the decode wrappers
    must all launch), and the split engine's decode graph is replayed under
    torch.profiler and held to its credited launches."""
    from spatialvla_tpu_torch import SpatialVLAPolicy, spatialvla_4b
    from spatialvla_tpu_torch.serve import ServingEngine, SplitServingEngine, warmup_buckets
    from spatialvla_tpu_torch.serve import split_engine as split_engine_mod

    cfg = cfg or spatialvla_4b()
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card = card_line() if on_card else "cpu"
    t_phase = time.perf_counter()
    policy = SpatialVLAPolicy.init_random(cfg, device, seed=0).quantize(bits=8)
    images, _ = main_requests(cfg)
    words = ("please pick up the small green block on the left side of the table and then "
             "place it carefully inside the open top drawer").split()
    requests = [(images[k % 3], " ".join(words[:k + 1])) for k in range(len(words))]
    refs = [policy.predict(img, instr, return_margins=True) for img, instr in requests]
    lengths = [int(policy.processor(img, instr)["input_ids"].shape[1]) for img, instr in requests]

    def window_counts():
        return {c.__name__: c.launches for c in counters}

    # --- the monolithic engine -------------------------------------------
    buckets = (1, 2, 4, 8)
    policy.decode_graphs.clear()
    t0 = time.perf_counter()
    warmup_buckets(policy, sample_image=images[0], instructions=[q[1] for q in requests],
                   prompt_pad_multiple=16, batch_buckets=buckets)
    sync()
    t_warm = time.perf_counter() - t0
    warm = {id(loop) for loop in policy.decode_graphs.loops.values()}
    with ServingEngine(policy, max_batch_size=8, batch_buckets=buckets) as engine:
        zero_counts(counters)
        results, lat, wall = engine_clients(engine, requests, 8, 3, "monolithic engine")
        sync()
        mono_counts = window_counts()
        stats = engine.stats()
    after = {id(loop) for loop in policy.decode_graphs.loops.values()}
    mono = {**engine_summary(lat, wall, len(results)), "stats": stats,
            "warm_graphs": len(warm), "graph_limit": policy.decode_graphs.limit,
            "warmup_s": t_warm, "captures_in_window": len(after - warm),
            "graphs_dropped_in_window": len(warm - after), "launches": mono_counts,
            "exact_and_first": check_engine_results(results, requests, refs, cfg,
                                                    "monolithic engine")}
    print(f"serving engines: monolithic, 8 closed-loop clients x 3 requests (prompts "
          f"{min(lengths)}..{max(lengths)} tokens): {mono['actions_per_s']:.2f} actions/s, p50 "
          f"{mono['latency_ms_p50']:.1f} ms, p95 {mono['latency_ms_p95']:.1f} ms; stats {stats}; "
          f"{len(warm)} decode graphs warmed in {t_warm:.1f} s (limit "
          f"{policy.decode_graphs.limit}), {mono['captures_in_window']} captured and "
          f"{mono['graphs_dropped_in_window']} dropped in the timed window; "
          f"of {len(results)} results {mono['exact_and_first'][0]} equal predict's ids, "
          f"{mono['exact_and_first'][1]} its first token, all within the margin rule; "
          f"launches {mono_counts} | {card}", flush=True)
    if mono["captures_in_window"] or mono["graphs_dropped_in_window"]:
        fail("monolithic engine: decode graphs captured or dropped inside the timed window")
    policy.decode_graphs.clear()

    # --- the split engine ------------------------------------------------
    T = -(-lengths[0] // 64) * 64  # the shortest prompt's 64-token bucket
    split_idx = [k for k, n in enumerate(lengths) if -(-n // 64) * 64 == T]
    split_reqs = [requests[k] for k in split_idx]
    split_refs = [refs[k] for k in split_idx]
    t0 = time.perf_counter()
    engine = SplitServingEngine(policy, n_slots=16, decode_block=4, max_prompt_len=T,
                                prefill_buckets=(16,))
    try:
        t_build = time.perf_counter() - t0
        loop = engine._programs.loop
        graph = loop.graph
        engine.warmup(images[0], [q[1] for q in split_reqs])
        engine.reset_stats()
        zero_counts(counters)
        results, lat, wall = engine_clients(engine, split_reqs, 16, 2, "split engine")
        sync()
        split_counts = window_counts()
        stats = engine.stats()
        alone = [engine.submit(img, instr).result(timeout=ENGINE_WAIT_S)
                 for img, instr in split_reqs[:4]]
        burst_reqs = (split_reqs * 16)[:16]
        futs = [engine.submit(img, instr) for img, instr in burst_reqs]
        burst = [f.result(timeout=ENGINE_WAIT_S) for f in futs]
        burst_stats = engine.stats()
        recaptured = loop.graph is not graph
    finally:
        engine.shutdown()
    # the burst's first tokens against prefill_for_serving on the same 16 rows
    # (each row's result depends on its own inputs alone)
    pad_id = policy.processor.text_tokenizer.pad_id
    ins = [policy.processor(img, instr) for img, instr in burst_reqs]
    ids = np.full((16, T), pad_id, np.int32)
    attn = np.zeros((16, T), np.int32)
    for i, x in enumerate(ins):
        ids[i, : x["input_ids"].shape[1]] = x["input_ids"][0]
        attn[i, : x["input_ids"].shape[1]] = 1
    with torch.inference_mode():
        px = torch.cat([split_engine_mod._put_pixels(np.asarray(x["pixel_values"]),
                                                     x.get("pixel_values_u8"), device=device)
                        for x in ins])
        rows = engine._programs.prefill(ids, px, np.concatenate([x["intrinsic"] for x in ins]),
                                        attn)
    prefill_first = rows["tok"].cpu().numpy()
    burst_first = np.array([b["action_ids"][0] for b in burst])
    split = {**engine_summary(lat, wall, len(results)), "stats": stats, "build_s": t_build,
             "capture_ms": loop.capture_ms, "prompt_tokens": T, "captures_in_window": int(recaptured),
             "launches": split_counts,
             "exact_and_first": check_engine_results(results, split_reqs, split_refs, cfg,
                                                     "split engine"),
             "burst_first_tokens": burst_first.tolist(),
             "prefill_first_tokens": prefill_first.tolist()}
    check_engine_results(dict(enumerate(alone)), split_reqs, split_refs, cfg, "split alone")
    invariant = [np.array_equal(a["action_ids"], b["action_ids"]) for a, b in zip(alone, burst)]
    split["invariance"] = {"alone": [a["action_ids"].tolist() for a in alone],
                           "in_burst": [b["action_ids"].tolist() for b in burst[:4]],
                           "burst_prefill_batches": burst_stats["prefill_batches"]
                           - stats["prefill_batches"], "identical": invariant}
    print(f"serving engines: split, 16 slots, 4 steps a dispatch, 16 closed-loop clients x 2 "
          f"requests ({len(split_reqs)} instructions, prompts padded to {T}): "
          f"{split['actions_per_s']:.2f} actions/s, p50 {split['latency_ms_p50']:.1f} ms, p95 "
          f"{split['latency_ms_p95']:.1f} ms; stats {stats}; engine built (decode graph "
          f"captured) in {t_build:.2f} s, {split['captures_in_window']} captures in the timed "
          f"window; of {len(results)} results {split['exact_and_first'][0]} equal predict's "
          f"ids, {split['exact_and_first'][1]} its first token, all within the margin rule; "
          f"alone vs in a burst of 16: identical {invariant}; the burst's first tokens those of "
          f"prefill_for_serving on its 16 rows: "
          f"{bool(np.array_equal(burst_first, prefill_first))}; launches {split_counts} | {card}",
          flush=True)
    if recaptured:
        fail("split engine: its decode graph was captured again while serving")
    if not np.array_equal(burst_first, prefill_first):
        fail(f"split engine: the burst's first tokens {burst_first.tolist()} are not those of "
             f"prefill_for_serving on the same rows {prefill_first.tolist()}")
    if not all(invariant):
        fail(f"split engine: ids alone {split['invariance']['alone']} differ from the same "
             f"requests' in a burst {split['invariance']['in_burst']}")
    if on_card:
        for label, counts in (("monolithic engine", mono_counts), ("split engine", split_counts)):
            for name, n in counts.items():
                if n <= 0 and name != "q8_residual_rmsnorm_matvec":  # only batches of <= 4 rows
                    fail(f"{label}: kernel {name} was not launched in the timed window")
        if loop.graph is None:
            fail("split engine: no decode graph on the card")
        shape = f"n_slots=16 S={T + 12} steps=4"
        split["graph_launches"] = graph_check(torch, loop.graph, loop.credits,
                                              "split engine", shape)
    print(f"serving engines: the phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"monolithic": mono, "split": split}


# ---------------------------------------------------------------------------
# checkpoints: an HF checkpoint in and out, a serving checkpoint in and out
# ---------------------------------------------------------------------------

def host_available() -> int:
    """The host memory the kernel can still give (MemAvailable), bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable")


def host_rss() -> int:
    """This process's resident host memory (VmRSS), bytes."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/self/status has no VmRSS")


@contextlib.contextmanager
def rss_peak(out: dict, period_s: float = 0.002):
    """The largest VmRSS while the block runs, sampled on a thread every
    ``period_s`` (the card's machine reports no VmHWM): out["rss_before"],
    out["rss_peak"], out["rss_after"]."""
    import threading

    out["rss_before"] = peak = host_rss()
    done = threading.Event()

    def sample():
        nonlocal peak
        while not done.is_set():
            peak = max(peak, host_rss())
            done.wait(period_s)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        done.set()
        thread.join()
        out["rss_after"] = host_rss()
        out["rss_peak"] = max(peak, out["rss_after"])


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, fn))
               for root, _, files in os.walk(path) for fn in files)


def bit_identical(torch, a, b, label):
    """Fail unless trees a and b have the same leaves, dtypes, shapes and bits."""
    from spatialvla_tpu_torch.utils.tree import iter_leaves

    la, lb = dict(iter_leaves(a)), dict(iter_leaves(b))
    if sorted(la) != sorted(lb):
        fail(f"{label}: leaves differ: {sorted(set(la) ^ set(lb))[:8]}")
    for k, x in la.items():
        y = lb[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            fail(f"{label}: {k} is {x.dtype} {tuple(x.shape)}, not {y.dtype} {tuple(y.shape)}")
        if x.numel() and not torch.equal(x.contiguous().reshape(-1).view(torch.uint8),
                                         y.contiguous().reshape(-1).view(torch.uint8)):
            fail(f"{label}: {k} differs in its bits")
    return len(la)


def checkpoint_path(torch, reference, *, cfg=None, device="cuda"):
    """Full-width spatialvla_4b() through the checkpoint entry points:
    init_random(seed=0) exported in bf16 as a reference-format HF checkpoint
    (export_hf_checkpoint) and loaded back (from_hf_checkpoint, onto the
    card): every leaf bit-identical. quantize(bits=8), then the main path's
    three requests: ids and margins equal to the main path's (the same seed's
    tree quantized in memory, ``reference``). The HF directory removed, the
    tree saved as a serving checkpoint and loaded back (save_serving /
    load_serving): bit-identical, kv_bits / depth_image_size / quant_desc
    restored, the three requests' ids and margins identical through the
    decode graph. One request with the argmax over the whole vocabulary
    (restrict_to_action_tokens=False) through its own decode graph, held to
    the eager unfused loop under the margin rule, its graph's launches
    traced; one request on the unfused int8 tree (quantize_lm_params
    fuse=False, the unfused loop on separate q / k / v / gate / up), held to
    the fused tree. Prints the seconds and bytes of each write and load, the
    host RSS peak of each load and the free disk before the phase.

    ``cfg`` and ``device="cpu"`` rehearse the phase on the CPU at a small
    size: everything but the decode graphs and the launch counts (the
    wrappers count nothing there)."""
    import shutil

    from spatialvla_tpu_torch import SpatialVLAPolicy, spatialvla_4b
    from spatialvla_tpu_torch.convert import export_hf_checkpoint
    from spatialvla_tpu_torch.convert.hf_checkpoint import processor_from_hf
    from spatialvla_tpu_torch.models import spatialvla as sv
    from spatialvla_tpu_torch.ops import quant

    cfg = cfg or spatialvla_4b()
    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    images, instructions = main_requests(cfg)
    work = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    res = {"dir": work}

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def timed_load(fn):
        mem = {}
        with rss_peak(mem):
            out, sec = timed(fn)
        return out, sec, mem

    def requests(policy, label):
        outs = [policy.predict(img, instr, return_margins=True)
                for img, instr in zip(images, instructions)]
        for o, ref in zip(outs, reference):
            same = (o["action_ids"].tolist() == ref["ids"]
                    and o["margins"].tolist() == ref["margins"])
            print(f"checkpoint path, {label}: ids {o['action_ids'].tolist()} "
                  f"-> {'identical' if same else 'DIFFER from ' + str(ref['ids'])}", flush=True)
            if not same:
                fail(f"checkpoint path, {label}: ids / margins differ from the tree quantized "
                     "in memory")
        return outs

    try:
        free = shutil.disk_usage(work).free
        original = SpatialVLAPolicy.init_random(cfg, device, seed=0)
        need = tree_bytes(original.params)
        print(f"checkpoint path: {free} bytes free in {work} before the phase; the bf16 HF "
              f"checkpoint needs {need} bytes | {card_line()}", flush=True)
        if free < need * 1.02:
            fail(f"checkpoint path: {free} bytes free in {work}, the HF checkpoint needs "
                 f"{need} bytes (about 8.1 GB) and the serving checkpoint after it about 4.7 GB")
        res["disk_free_bytes"] = free

        hf_dir = os.path.join(work, "hf")
        _, sec = timed(lambda: export_hf_checkpoint(original.params, cfg, hf_dir,
                                                    processor=original.processor))
        res["hf_write"] = {"s": sec, "bytes": dir_bytes(hf_dir)}
        # the processor files alone first: where transformers is installed,
        # processor_from_hf's first tokenizer attempt imports it (seconds)
        _, res["hf_processor_s"] = timed(lambda: processor_from_hf(hf_dir, cfg))
        loaded, sec, mem = timed_load(lambda: SpatialVLAPolicy.from_hf_checkpoint(
            hf_dir, device=device))
        res["hf_load"] = {"s": sec, "bytes": res["hf_write"]["bytes"], **mem}
        n = bit_identical(torch, loaded.params, original.params, "HF round trip")
        print(f"checkpoint path: export_hf_checkpoint {res['hf_write']['s']:.2f} s, "
              f"{res['hf_write']['bytes']} bytes; processor files {res['hf_processor_s']:.2f} s; "
              f"from_hf_checkpoint {sec:.2f} s, host RSS "
              f"{mem['rss_before'] / 2**30:.2f} GiB before, peak {mem['rss_peak'] / 2**30:.2f} "
              f"GiB, after {mem['rss_after'] / 2**30:.2f} GiB; {n} leaves bit-identical | "
              f"{card_line()}", flush=True)
        del original
        raw = loaded.params  # the bf16 tree, for the unfused tree below
        loaded.quantize(bits=8)
        outs = requests(loaded, "loaded HF checkpoint, quantize(bits=8)")
        shutil.rmtree(hf_dir)

        serving_dir = os.path.join(work, "serving")
        _, sec = timed(lambda: loaded.save_serving(serving_dir))
        res["serving_write"] = {"s": sec, "bytes": dir_bytes(serving_dir)}
        reloaded, sec, mem = timed_load(lambda: SpatialVLAPolicy.load_serving(
            serving_dir, device=device))
        res["serving_load"] = {"s": sec, "bytes": res["serving_write"]["bytes"], **mem}
        n = bit_identical(torch, reloaded.params, loaded.params, "serving round trip")
        knobs = (reloaded.kv_bits, reloaded.depth_image_size, reloaded.quant_desc)
        if knobs != (loaded.kv_bits, loaded.depth_image_size, loaded.quant_desc):
            fail(f"serving round trip: knobs {knobs} not restored")
        print(f"checkpoint path: save_serving {res['serving_write']['s']:.2f} s, "
              f"{res['serving_write']['bytes']} bytes; load_serving {sec:.2f} s, host RSS "
              f"{mem['rss_before'] / 2**30:.2f} GiB before, peak {mem['rss_peak'] / 2**30:.2f} "
              f"GiB, after {mem['rss_after'] / 2**30:.2f} GiB; {n} leaves bit-identical, knobs "
              f"{knobs} | {card_line()}", flush=True)
        del loaded
        reference = [{"ids": o["action_ids"].tolist(), "margins": o["margins"].tolist()}
                     for o in outs]
        requests(reloaded, "serving checkpoint")
        if on_card and not len(reloaded.decode_graphs):
            fail("checkpoint path: the serving checkpoint's requests captured no decode graph")

        # the argmax over the whole vocabulary, through a decode graph of its own
        inputs = reloaded.processor(images[0], instructions[0])
        args = (torch.as_tensor(inputs["input_ids"], dtype=torch.long, device=device),)
        kw = dict(pixel_values=torch.as_tensor(inputs["pixel_values"], device=device),
                  intrinsic=torch.as_tensor(inputs["intrinsic"], device=device),
                  restrict_to_action_tokens=False, return_margins=True)
        graphs_before = set(reloaded.decode_graphs.loops)
        out = []

        def whole_vocabulary():
            out[:] = sv.predict_action(reloaded.params, cfg, *args, use_cuda_graph=on_card,
                                       decode_graphs=reloaded.decode_graphs, **kw)

        loop_ms = {}

        def loop_timed(label, fn):  # the decode loop of the request, CUDA events
            with decode_loops(torch, []) as sink:
                fn()
            loop_ms[label] = sink[0][2] if sink else None

        with torch.inference_mode():
            whole_vocabulary()  # captures its graph
            # a request's launches, by wrapper, and its decode loop's time:
            # the action block's, then the whole vocabulary's, both replaying
            # their graphs
            block = launch_counts(torch, lambda: loop_timed(
                "block", lambda: reloaded.predict(images[0], instructions[0])))
            whole = launch_counts(torch, lambda: loop_timed("whole", whole_vocabulary))
            ids, margins = out
            ref_ids, ref_m = sv.predict_action(reloaded.params, cfg, *args,
                                               use_fused_decode=False, **kw)
        added = [key for key in reloaded.decode_graphs.loops if key not in graphs_before]
        head = reloaded.decode_graphs.loops[added[0]].head if len(added) == 1 else None
        ok = margin_rule_ok(ids[0].cpu().numpy(), ref_ids[0].cpu().numpy(),
                            ref_m[0].cpu().numpy())
        print(f"checkpoint path, whole vocabulary: ids {ids[0].tolist()} through the graph "
              f"(margins {np.round(margins[0].cpu().numpy(), 3).tolist()}), eager unfused "
              f"{ref_ids[0].tolist()} (margins {np.round(ref_m[0].cpu().numpy(), 3).tolist()}) "
              f"-> {'ok' if ok else 'DIFFER'}; graphs added {added}, head "
              f"{None if head is None else tuple(head['qt'].shape)}; launches {whole} (the "
              f"action block's request: {block}); decode loop {loop_ms['whole']} ms (the "
              f"action block's {loop_ms['block']} ms)", flush=True)
        if not ok:
            fail("whole-vocabulary greedy through the decode graph disagrees with the eager "
                 "unfused loop beyond the margin rule")
        if on_card and (head is None or head["qt"].shape[0] != cfg.text.vocab_size
                        or whole != block):
            fail(f"whole-vocabulary greedy: graphs added {added}, launches {whole} against the "
                 f"action block's {block}")
        res["whole_vocabulary"] = {
            "ids": ids[0].tolist(), "reference_ids": ref_ids[0].tolist(), "launches": whole,
            "decode_loop_ms": loop_ms["whole"], "block_decode_loop_ms": loop_ms["block"],
            "graph_launches": graph_launches(torch, reloaded, "checkpoint path") if on_card
            else None}

        # the unfused int8 tree (separate q / k / v / gate / up) on the unfused loop
        with torch.inference_mode():
            unfused = dict(reloaded.params,
                           lm=quant.quantize_lm_params(raw["lm"], bits=8, fuse=False))
            del raw
            kw["restrict_to_action_tokens"] = True
            launches = launch_counts(torch, lambda: out.__setitem__(
                slice(None), sv.predict_action(unfused, cfg, *args, **kw)))
            u_ids = out[0]
        ok = margin_rule_ok(u_ids[0].cpu().numpy(), reference[0]["ids"], reference[0]["margins"])
        print(f"checkpoint path, unfused int8 tree (fuse=False): ids {u_ids[0].tolist()} vs "
              f"the fused tree's {reference[0]['ids']} -> {'ok' if ok else 'DIFFER'}; "
              f"launches {launches}", flush=True)
        # the first token's head, then 11 steps of q, k, v, o, gate, up and
        # down in each layer and the head, all on q8_matvec (the 277-row
        # prefill and the vision front dequantize above 16 rows)
        want = {"q8_matvec": 1 + 11 * (7 * cfg.text.num_layers + 1)} if on_card else {}
        if not ok or launches != want:
            fail(f"unfused int8 tree: ids differ beyond the margin rule ({ok}) or launches "
                 f"{launches} (want {want})")
        res["unfused"] = {"ids": u_ids[0].tolist(), "launches": launches}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res


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
    289-slot bf16 cache, the serving path's request), held the same way;
    each step's launches are held to check_step_launches (131 at one row,
    182 at 16)."""
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
            check_step_launches(f"decode step {name} M=1", launch_counts(torch, step), 1, L)
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
                check_step_launches(f"decode-step matrix {name}+{kv_name}",
                                    launch_counts(torch, step), M, L)
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


def refused_shape_step(torch, timer, counters):
    """The path that still launches gelu_mul: the 26-layer decode step of
    spatialvla_4b's LM (random weights from a seed, a 2048-row vocabulary)
    after quantize_lm_params(bits=8, mlp_bits=4, group_size=24), int8
    attention and an int4 MLP in 24-column groups, at one row (position 277
    of a 289-slot bf16 cache). 24 is not a multiple of 16, so neither the
    residual kernels nor the gelu epilogue take the MLP's weights: each
    layer runs norm_residual with the pre-FFN norm's x', gate|up on
    q4_small_kernel into gate | up, gelu_mul, and down. The counts are set
    to 0 just before the step and read just after: L gelu_mul launches, L +
    1 norm_residual, 2 L q4_matvec, L - 1 residual kernels for qkv, no gelu
    epilogue, 7 L + 1 in all; the hidden state within 0.02 of the plain
    step's (relative to its max); timed as a CUDA graph."""
    from spatialvla_tpu_torch import spatialvla_4b
    from spatialvla_tpu_torch.models import gemma2
    from spatialvla_tpu_torch.ops import decode_step as ds
    from spatialvla_tpu_torch.ops import quant

    tcfg = dataclasses.replace(spatialvla_4b().text, vocab_size=2048)
    L, H, Nkv, D = tcfg.num_layers, tcfg.hidden_size, tcfg.num_kv_heads, tcfg.head_dim
    S, pos = 289, torch.tensor([277], dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(17)
    with torch.inference_mode():
        base = gemma2.init_params(tcfg, generator=g, device="cuda", dtype=torch.bfloat16)
        for k in ("input_norm", "post_attn_norm", "pre_ffn_norm", "post_ffn_norm"):
            base["layers"][k] = (torch.randn(L, H, generator=g, device="cuda") * 0.1).to(
                torch.bfloat16)
        qp = quant.quantize_lm_params(base, bits=8, mlp_bits=4, group_size=24)
        del base
        ck, cv = ((torch.randn(L, 1, Nkv, S, D, generator=g, device="cuda") * 0.3)
                  .to(torch.bfloat16) for _ in range(2))
        x = (torch.randn(1, H, generator=g, device="cuda") * 0.3 * H ** 0.5).to(torch.bfloat16)
        step = lambda: ds.fused_decode_step(qp, tcfg, x, ck, cv, pos, pos + 1)  # noqa: E731
        zero_counts(counters)
        hk = step()[0]
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        gelu = sum(getattr(c, "gelu_launches", 0) for c in counters)
        hp = ds.fused_decode_step_plain(qp, tcfg, x, ck, cv, pos, pos + 1)[0]
        _, drift = rel_err(hk, hp)
        ms = timer(step)
    want = {"gelu_mul": L, "norm_residual": L + 1, "q4_matvec": 2 * L,
            "q8_residual_rmsnorm_matvec": L - 1, "q8_rmsnorm_matvec": 1, "q8_matvec": L,
            "decode_attention": L}
    print(f"refused-shape decode step (int8 + int4 MLP in 24-column groups, 26 layers, M=1, "
          f"S={S}): launches {launches}, gelu epilogues {gelu}; rel drift {drift:.4e} (bound "
          f"0.02); CUDA graph {ms:.3f} ms", flush=True)
    if any(launches.get(k, 0) != v for k, v in want.items()) or gelu or sum(
            launches.values()) != 7 * L + 1:
        fail(f"refused-shape decode step: launches {launches}, {gelu} gelu epilogues; want {want}")
    if not drift < 0.02:
        fail(f"refused-shape decode step: drift {drift} >= 0.02 from plain")
    return {"launches": launches, "rel_drift": drift, "graph_ms": ms}


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
    (quant.q4_matvec, quant.q4_rmsnorm_matvec, quant.q4_residual_rmsnorm_matvec) = (
        quant.matvec_plain, quant.rmsnorm_matvec_plain, quant.residual_rmsnorm_matvec_plain)
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

    def q4_matvec(x, qt, scale, *, out_dtype=torch.bfloat16, out=None, gelu=False):
        if gelu or quant.q4_route(x, qt, scale) != "tiled":  # the gelu epilogue is not tiled
            return saved[0](x, qt, scale, out_dtype=out_dtype, out=out, gelu=gelu)
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
        zero_counts(counters)
        quant.q4_matvec.tiled_launches = quant.q4_rmsnorm_matvec.tiled_launches = 0
        first = policy.predict(images[0], instructions[0])  # counted alone
        torch.cuda.synchronize()
        per_request = {c.__name__: c.launches for c in counters}
        gelu_per_request = {c.__name__: c.gelu_launches for c in counters
                            if hasattr(c, "gelu_launches")}
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
              f"launches per request {per_request}, of them with the gelu epilogue "
              f"{gelu_per_request} | {card_line()}", flush=True)

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
                "norm_residual": steps, "gelu_mul": 0}
        if qkw.get("kv_bits"):
            want.update(decode_attention_kv8=L * steps, decode_attention=0)
        if not qkv4:
            want.update(q8_rmsnorm_matvec=steps, q8_residual_rmsnorm_matvec=(L - 1) * steps)
        ran = ["q4_matvec", "q4_rmsnorm_matvec", "q4_residual_rmsnorm_matvec", "norm_residual",
               "decode_attention_kv8" if qkw.get("kv_bits") else "decode_attention"]
        if qkw.get("bits") == 8:
            ran += ["q8_matvec", "q8_rmsnorm_matvec", "q8_residual_rmsnorm_matvec"]
        # gate|up (int4 in every configuration) with gelu(gate) * up in the
        # residual kernel's epilogue in every decode step, never in the prefill
        want_gelu = {k: (L * steps if k == "q4_residual_rmsnorm_matvec" else 0)
                     for k in gelu_per_request}
        if (any(per_request[k] != v for k, v in want.items())
                or any(per_request[k] <= 0 for k in ran) or gelu_per_request != want_gelu):
            fail(f"serving {name}: launches per request {per_request}, gelu epilogues "
                 f"{gelu_per_request}; want {want}, {want_gelu} and every one of {ran} launched")
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
                     "gelu_launches_per_request": gelu_per_request,
                     "launches": launches, "tiled_launches_per_request": tiled,
                     "tiled_launches": tiled_run, **stages, "stage_runs_ms": runs}
        del policy, first, outs, batch
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# tensor-parallel serving: SpatialVLAPolicy.shard, every shard on this card
# ---------------------------------------------------------------------------

TP_FORMATS = (("int8", dict(bits=8)), ("int4_g128", dict(bits=4, group_size=128, vision_bits=4)))
# the few-row kernels that a shard's matmuls take at decode (and, int4, in the
# prefill, SigLIP and the projector): each at the shard shapes has a kernels
# entry of its own, "<name>_tp"
TP_KERNELS = ("q8_matvec", "q8_rmsnorm_matvec", "q4_matvec", "q4_rmsnorm_matvec")
# The phase's lm_head is seed 0's times this power of two before quantize():
# every action logit is exactly 8 times the seed's, so the ids are the
# seed's and the margins 8 times theirs. Seed 0's margins at full width run
# 0.016-0.66 (a few bf16 steps of logits near 2-4), all but a few below
# MARGIN_BOUND, which would leave the margin rule nothing to hold after the
# first token; times 8 MARGIN_BOUND is 4 bf16 steps of the largest logits.
TP_HEAD_SCALE = 8
# The sharded first-step action logits may differ from the unsharded by this
# fraction of their largest magnitude (4-8 bf16 steps there): the shards'
# partial products round and sum in another order from the prefill on.
TP_LOGIT_TOL = 1 / 32


def tp_launches_want(cfg, cut, n, fmt) -> dict:
    """The kernel launches of one request through the sharded path, from the
    unfused decode loop (a prefill, then 11 steps; the first token's head
    after the prefill), n and the blocks the cut keeps whole: a cut block
    runs once a shard, a whole block once. The head runs on each shard whose
    vocabulary rows meet the action block (one at n = 2: the block lies in
    shard 1). int8: the prefill's, SigLIP's and the projector's rows exceed
    the kernels' 16, so only the decode steps and heads launch. int4: the
    prefill (under 512 rows), SigLIP's 27 layers and the projector (256 rows)
    launch q4_matvec too; ZoeDepth's 577 rows do not."""
    L, Lv, steps = cfg.text.num_layers, cfg.vision.num_layers, 11
    k = lambda block: n if cut.blocks.get(block) else 1  # noqa: E731
    A, F = k("lm_attn"), k("lm_mlp")
    begin, size = cfg.action_token_begin_idx, cfg.spatial_token_num
    h = 1
    if cut.blocks.get("vocab"):
        w = cfg.text.vocab_size // n
        h = sum(max(begin, s * w) < min(begin + size, (s + 1) * w) for s in range(n))
    if fmt == "int8":
        return {"q8_matvec": h + steps * (L * (A + F) + h),
                "q8_rmsnorm_matvec": steps * L * (A + F)}
    fwd = steps + 1
    return {"q4_matvec": (Lv * (4 * k("vision_attn") + 2 * k("vision_mlp")) + k("projector")
                          + fwd * (L * (A + F) + h)),
            "q4_rmsnorm_matvec": fwd * L * (A + F)}


def tp_kernel_checks(torch, timer, results, notes, tree, fmt, n):
    """Kernels #1 and #2 at shard s = 0's shapes at one row (layer 0 of its
    tree: qkv and gate|up with their norms, o and down), against their plain
    versions: rel err below 1e-2 (int8) or 2e-2 (int4, bf16 out), int4 on
    its few-row route; timed beside plain and the library's matmul
    (record_kernel, as "<name>_tp"). Only the blocks the cut splits have new
    shapes. int4 also: SigLIP's fc2 shard at 256 rows (K = 4304 / n, packed
    rows of K / 2 bytes) on the tensor-core route against plain, untimed."""
    from spatialvla_tpu_torch.ops import quant

    g = torch.Generator(device="cuda").manual_seed(21 + n)
    int4 = fmt != "int8"
    lp = {k: v for k, v in tree["lm"]["layers"].items()}
    cases = (("rmsnorm", lp["attn"]["qkv"], lp["input_norm"]), ("matvec", lp["attn"]["o"], None),
             ("rmsnorm", lp["mlp"]["gate_up"], lp["pre_ffn_norm"]),
             ("matvec", lp["mlp"]["down"], None))
    tol = 2e-2 if int4 else 1e-2
    for kind, w, norm in cases:
        qt, scale = w["qt"][0], w["scale"][0]
        N, K = qt.shape[0], qt.shape[1] * (2 if int4 else 1)
        name = ("q4_" if int4 else "q8_") + ("rmsnorm_matvec" if norm is not None else "matvec")
        x = (torch.randn(1, K, generator=g, device="cuda")
             * (1.0 if norm is not None else 0.3)).to(torch.float32 if norm is not None
                                                       else torch.bfloat16)
        args = (x, norm[0], qt, scale) if norm is not None else (x, qt, scale)
        kern, plain = getattr(quant, name), getattr(quant, name + "_plain")
        y = kern(*args)
        d, r = rel_err(y, plain(*args))
        if not r < tol:
            fail(f"{name} n={n} M=1 {K}->{N} ({fmt} shard): rel err {r} >= {tol}")
        if int4 and quant.q4_route(x, qt, scale) != "rows":
            fail(f"{name} n={n} M=1 {K}->{N}: took the {quant.q4_route(x, qt, scale)} kernel, "
                 "not the few-row kernel")
        ms, pms = timer(lambda: kern(*args)), timer(lambda: plain(*args))
        library = library_int4pack if int4 else library_int8pack
        lib = alone = None
        if norm is None:
            lib, note = library(torch, timer, x, qt, scale)
            notes.setdefault(name + "_tp", note)
        else:  # the library's matmul alone on the plain normed x (not the same function)
            alone, _ = library(torch, timer, quant._rms_bf16(x, norm[0], 1e-6), qt, scale)
        shape = f"n{n}_{fmt}_M1_{K}x{N}"
        print(f"{name} shard n={n} ({fmt}) M=1 {K}->{N}: max|d|={d:.3e} rel={r:.3e} kernel "
              f"{ms:.4f} ms plain {pms:.4f} ms library {lib} ms"
              + (f", library matmul alone {alone} ms" if norm is not None else ""), flush=True)
        record_kernel(results, name + "_tp", shape, d, ms, pms,
                      nbytes=nbytes_of(*args, y),
                      ops=2 * N * K + (4 * K if norm is not None else 0),
                      library_ms=lib)
        if norm is not None:
            results[name + "_tp"].setdefault("library_matmul_alone_ms", {})[shape] = alone
    notes.setdefault("q8_rmsnorm_matvec_tp", "no single PyTorch call fuses the RMSNorm with "
                                             "the matmul (library_matmul_alone_ms: the "
                                             "library's matmul alone)")
    notes.setdefault("q4_rmsnorm_matvec_tp", notes["q8_rmsnorm_matvec_tp"])
    if int4 and "fc2" in tree["vision"]["layers"]["mlp"]:
        w = tree["vision"]["layers"]["mlp"]["fc2"]["w"]
        qt, scale = w["qt"][0], w["scale"][0]
        x = (torch.randn(256, 2 * qt.shape[1], generator=g, device="cuda") * 0.3).to(
            torch.bfloat16)
        route = quant.q4_route(x, qt, scale)
        d, r = rel_err(quant.q4_matvec(x, qt, scale), quant.q4_matvec_plain(x, qt, scale))
        print(f"q4_matvec SigLIP fc2 shard n={n} M=256 {x.shape[1]}->{qt.shape[0]}: {route} "
              f"kernel, rel={r:.3e}", flush=True)
        if route != "tiled" or not r < 2e-2:
            fail(f"SigLIP fc2 shard n={n}: {route} kernel, rel err {r}")
        record_kernel(results, "q4_matvec_tp", f"n{n}_vision_fc2_M256", d, None, None)


def head_trace(fn):
    """(fn(), the logits of every greedy head that fn computed, fp32 on the
    host, in order): a spy on ``spatialvla._head_logits``, which the unfused
    decode loop calls once a token (a sharded batch's data groups in turn)."""
    from spatialvla_tpu_torch.models import spatialvla as sv

    real, seen = sv._head_logits, []

    def spy(*args, **kw):
        offset, logits = real(*args, **kw)
        seen.append(logits.float().cpu())
        return offset, logits

    sv._head_logits = spy
    try:
        return fn(), seen
    finally:
        sv._head_logits = real


def tp_rule_ok(ids, ref_ids, ref_margins, d0) -> bool:
    """The sharded path against the unsharded one: ``margin_rule_ok``, but
    the first token may differ where the unsharded first margin is at most
    2 * d0, the largest difference of the two first-step logit vectors
    (held under TP_LOGIT_TOL apart): the shards sum in another order from
    the prefill on, so a tie that close may fall either way, and then the
    tokens after it may differ too."""
    if ids[0] != ref_ids[0]:
        return bool(ref_margins[0] <= 2 * d0)
    return margin_rule_ok(ids, ref_ids, ref_margins)


def tp_compare(label, ids, margins, logits, ref, unfused):
    """One sharded row against the unsharded: its first-step action logits
    within TP_LOGIT_TOL of the largest unsharded |logit| (the whole 8194-id
    vector: a wrong cut of heads, columns, vocabulary or sums moves them by
    about their own size), its first margin within twice that, and its ids
    under ``tp_rule_ok``. ``ref`` holds the unsharded fused path's ids and
    margins, ``unfused`` the unsharded unfused loop's ids and logits a step,
    whose first step is the fused path's (checked). Returns the first-step
    difference and its bound, the differences of the later steps while the
    ids equal the unfused loop's (recorded, unbounded), and whether the ids
    equal the fused path's."""
    ids, margins, ref_ids, ref_m = (np.asarray(v) for v in (ids, margins, ref["action_ids"],
                                                            ref["margins"]))
    diffs = [float((a - b).abs().max()) for a, b in zip(logits, unfused["logits"])]
    d0, tol = diffs[0], TP_LOGIT_TOL * float(unfused["logits"][0].abs().max())
    if not d0 <= tol:
        fail(f"{label}: first-step action logits differ from the unsharded by up to {d0:.4g}, "
             f"beyond {tol:.4g} (TP_LOGIT_TOL of their largest magnitude)")
    if not abs(margins[0] - ref_m[0]) <= 2 * tol:
        fail(f"{label}: first margin {margins[0]:.4g} against the unsharded {ref_m[0]:.4g}")
    if not tp_rule_ok(ids, ref_ids, ref_m, d0):
        fail(f"{label}: ids {ids.tolist()} vs the unsharded {ref_ids.tolist()} (margins "
             f"{np.round(ref_m, 3).tolist()}, first-step logit difference {d0:.4g}): beyond the "
             "margin rule")
    u_ids = unfused["ids"]
    agree = next((t for t in range(len(ids)) if ids[t] != u_ids[t]), len(ids))
    return {"first_step_diff": d0, "bound": tol, "diffs_while_equal": diffs[:agree],
            "exact": bool(np.array_equal(ids, ref_ids)), "first_margin": float(ref_m[0])}


def tensor_parallel_path(torch, timer, results, notes, *, cfg=None, device="cuda"):
    """Tensor-parallel serving (SpatialVLAPolicy.shard) at full width: the
    int8 tree (quantize(bits=8)) and the int4-g128 tree with an int4 vision
    front, on seed 0's weights with the lm_head times TP_HEAD_SCALE, each
    sharded over n_model = 2 and 4 with every shard on this card. The
    unsharded policy's ids and margins (its fused path through the decode
    graph) and the logits of its unfused loop on the main path's three
    requests are taken before shard(); each sharded request is held to them
    by ``tp_compare`` (first-step logits within TP_LOGIT_TOL, ids under the
    margin rule from the first token, a first-token tie apart), its actions
    equal theirs wherever the chunk step's three ids agree. Each request's
    launches of kernels #1 and #2 must be exactly tp_launches_want's, and
    no other kernel may launch (the path is the unfused loop: no decode
    graph, no decode attention). The int8 tree also runs n_model=2 x
    n_data=2 over a 2-row predict_batch of two instruction lengths (each
    data group a row: twice one request's launches), each row held the same
    way to the unsharded policy on that padded row alone, and serves 8
    requests from 4 closed-loop clients through ServingEngine and
    SplitServingEngine(kv_bits=8) over shard(n_model=2), each result held
    to the sharded predict under engine_rule_ok. Kernels #1 and #2 at every
    new shard shape at one row (tp_kernel_checks). Warm predict ms at
    n_model = 1 (the unfused loop), 2 and 4: slower than the fused path,
    and one card gives the shards no more bandwidth; recorded, no claim."""
    from spatialvla_tpu_torch import SpatialVLAPolicy, spatialvla_4b
    from spatialvla_tpu_torch.models import spatialvla as sv
    from spatialvla_tpu_torch.serve import ServingEngine, SplitServingEngine

    cfg = cfg or spatialvla_4b()
    on_card = torch.device(device).type == "cuda"
    card = card_line() if on_card else "cpu"
    t_phase = time.perf_counter()
    allocated = torch.cuda.memory_allocated() if on_card else 0
    images, instructions = main_requests(cfg)
    requests = list(zip(images, instructions))
    batch_texts = ["pick up the cup", "open the top drawer of the desk"]
    begin, n_act = cfg.action_token_begin_idx, cfg.spatial_token_num
    out = {"formats": {}, "launches": collections.Counter(), "head_scale": TP_HEAD_SCALE,
           "logit_tol": TP_LOGIT_TOL}

    def check_actions(label, o, ref):
        ids, a = np.asarray(o["action_ids"]), np.asarray(o["actions"])
        if a.shape != (4, 7) or not np.isfinite(a).all():
            fail(f"{label}: actions {a.shape}, finite={np.isfinite(a).all()}")
        if not ((ids >= begin) & (ids < begin + n_act)).all():
            fail(f"{label}: ids outside the action block: {ids}")
        same = (ids.reshape(4, 3) == np.asarray(ref["action_ids"]).reshape(4, 3)).all(1)
        if not np.array_equal(a[same], np.asarray(ref["actions"])[same]):
            fail(f"{label}: actions differ on chunk steps whose ids agree")

    def warm_ms(fn):
        times = []
        for img, instr in requests:
            t0 = time.perf_counter()
            fn(img, instr)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), times

    for fmt, qkw in TP_FORMATS:
        t0 = time.perf_counter()
        base = SpatialVLAPolicy.init_random(cfg, device, seed=0)
        with torch.inference_mode():  # exact: a power of two, far from bf16's range
            base.params["lm"]["lm_head"].mul_(TP_HEAD_SCALE)
        base.quantize(**qkw)
        tree, proc = base.params, base.processor
        refs = [base.predict(img, instr, return_margins=True) for img, instr in requests]
        rec = {"setup_s": time.perf_counter() - t0, "fused_ms": warm_ms(base.predict)[0]}

        def unfused(inputs, mask=None, margins=False):
            with torch.inference_mode():
                return sv.predict_action(
                    base.params, cfg,
                    torch.as_tensor(inputs["input_ids"], dtype=torch.long, device=device),
                    pixel_values=torch.as_tensor(inputs["pixel_values"], device=device),
                    intrinsic=torch.as_tensor(inputs["intrinsic"], device=device),
                    attention_mask=mask, action_chunk_size=proc.action_chunk_size,
                    compute_dtype=base.compute_dtype, depth_image_size=base.depth_image_size,
                    use_fused_decode=False, return_margins=margins)

        def unfused_logits(inputs, ref, label, mask=None):
            """The unsharded unfused loop's ids and logits a step; its first
            token and margin are the fused path's (one prefill, one head)."""
            (ids, margins), logits = head_trace(lambda: unfused(inputs, mask, True))
            if (int(ids[0, 0]) != int(ref["action_ids"][0])
                    or float(margins[0, 0]) != float(ref["margins"][0])):
                fail(f"{label}: the unfused loop's first token {int(ids[0, 0])} (margin "
                     f"{float(margins[0, 0])}) is not the fused path's {ref['action_ids'][0]} "
                     f"({ref['margins'][0]})")
            return {"ids": ids[0].cpu().numpy(), "logits": logits}

        ref_logits = [unfused_logits(proc(img, instr), r, f"tensor parallel {fmt} '{instr}'")
                      for (img, instr), r in zip(requests, refs)]
        rec["n1_unfused_ms"], rec["n1_unfused_ms_all"] = warm_ms(
            lambda img, instr: unfused(proc(img, instr)))
        if fmt == "int8":
            # the 2 x 2 mesh's reference: each padded row alone through the
            # unsharded policy, as each data group runs it
            binputs = proc(images[:2], batch_texts)
            bmask = torch.as_tensor(np.asarray(binputs["attention_mask"]), device=device)
            rows = [{k: np.asarray(binputs[k])[i:i + 1]
                     for k in ("input_ids", "pixel_values", "intrinsic")} for i in range(2)]
            brefs, blogits = [], []
            for i, row in enumerate(rows):
                with torch.inference_mode():
                    ids, m = base._generate(row, attention_mask=bmask[i:i + 1],
                                            return_margins=True)
                brefs.append({"action_ids": ids[0].cpu().numpy(), "margins": m[0].cpu().numpy()})
                blogits.append(unfused_logits(row, brefs[-1], f"tensor parallel batch row {i}",
                                              bmask[i:i + 1]))
        base.decode_graphs.clear()
        for n in (2, 4):
            tp = SpatialVLAPolicy(tree, cfg, proc, device=device).shard(n_model=n)
            cut = tp.params.cut
            whole = sorted(b for b, c in cut.blocks.items() if not c)
            want = tp_launches_want(cfg, cut, n, fmt)
            outs, checks, held = [], [], {}
            for (img, instr), r, rl in zip(requests, refs, ref_logits):
                label = f"tensor parallel {fmt} n={n} '{instr}'"
                counts = launch_counts(torch, lambda: held.__setitem__("out", head_trace(
                    lambda: tp.predict(img, instr, return_margins=True))))
                got = {k: v for k, v in counts.items() if "." not in k}
                if on_card and got != want:
                    fail(f"{label}: launched {counts}, want {want} (blocks kept whole: {whole})")
                out["launches"].update(got)
                o, logits = held["out"]
                check_actions(label, o, r)
                checks.append(tp_compare(label, o["action_ids"], o["margins"], logits, r, rl))
                outs.append(o)
            rec[f"n{n}"] = {"blocks_whole": whole, "launches_per_request": counts,
                            "checks": checks, "graphs": len(tp.decode_graphs)}
            rec[f"n{n}"]["warm_ms"], rec[f"n{n}"]["warm_ms_all"] = warm_ms(tp.predict)
            if len(tp.decode_graphs):
                fail(f"tensor parallel {fmt} n={n}: a decode graph was captured under a mesh")
            print(f"tensor parallel {fmt} n_model={n}: blocks kept whole {whole}; one request's "
                  f"launches {counts} (want {want}); against the unsharded: first-step logit "
                  f"differences {[round(c['first_step_diff'], 4) for c in checks]} (bounds "
                  f"{[round(c['bound'], 4) for c in checks]}), first margins "
                  f"{[round(c['first_margin'], 4) for c in checks]}, ids equal "
                  f"{[c['exact'] for c in checks]}, later steps' differences while equal "
                  f"{[[round(d, 4) for d in c['diffs_while_equal'][1:]] for c in checks]}; "
                  f"warm predict median {rec[f'n{n}']['warm_ms']:.1f} ms | {card}", flush=True)
            if on_card:
                tp_kernel_checks(torch, timer, results, notes, tp.params.groups[0].trees[0],
                                 fmt, n)
            if fmt == "int8" and n == 2:
                # n_model=2 x n_data=2: each data group one row of the batch
                dp = SpatialVLAPolicy(tree, cfg, proc, device=device).shard(n_model=2, n_data=2)
                held = {}

                def batch():
                    with torch.inference_mode():
                        held["out"] = head_trace(lambda: dp._generate(
                            binputs, attention_mask=bmask, return_margins=True))

                bcounts = launch_counts(torch, batch)
                (bids, bm), blog = held["out"]
                bgot = {k: v for k, v in bcounts.items() if "." not in k}
                if on_card and bgot != {k: 2 * v for k, v in want.items()}:
                    fail(f"tensor parallel int8 n_model=2 x n_data=2: the 2-row batch launched "
                         f"{bcounts}, want twice {want}")
                out["launches"].update(bgot)
                steps = len(blog) // 2  # the groups ran in turn, one row each
                bchecks = [tp_compare(f"tensor parallel n_model=2 x n_data=2 row {i}",
                                      bids[i].cpu().numpy(), bm[i].cpu().numpy(),
                                      blog[i * steps:(i + 1) * steps], brefs[i], blogits[i])
                           for i in range(2)]
                print(f"tensor parallel int8 n_model=2 x n_data=2, 2 rows of prompt lengths "
                      f"{[int(v) for v in binputs['attention_mask'].sum(1)]}: ids "
                      f"{bids.tolist()} vs the unsharded rows {[r['action_ids'].tolist() for r in brefs]}; "
                      f"first-step logit differences "
                      f"{[round(c['first_step_diff'], 4) for c in bchecks]}, ids equal "
                      f"{[c['exact'] for c in bchecks]}; launches {bcounts}", flush=True)
                rec["n2_data2"] = {"launches": bcounts, "ids": bids.tolist(), "checks": bchecks,
                                   "unsharded_ids": [r["action_ids"].tolist() for r in brefs]}
                del dp
                rec["engines"] = tp_engines(torch, tp, requests, outs, cfg, card,
                                            ServingEngine, SplitServingEngine)
            del tp
            if on_card:
                torch.cuda.empty_cache()
        print(f"tensor parallel {fmt}: warm predict median unsharded fused {rec['fused_ms']:.1f} "
              f"ms, n_model=1 unfused {rec['n1_unfused_ms']:.1f} ms, n_model=2 "
              f"{rec['n2']['warm_ms']:.1f} ms, n_model=4 {rec['n4']['warm_ms']:.1f} ms | {card}",
              flush=True)
        out["formats"][fmt] = rec
        del base, tree, refs, ref_logits
        if on_card:
            torch.cuda.empty_cache()
    if on_card:
        # the engines' threads each took a cuBLAS handle, whose workspace the
        # allocator keeps after the thread ends
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
    out["allocated_gib"] = {"before": allocated / 2**30,
                            "after": (torch.cuda.memory_allocated() if on_card else 0) / 2**30}
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = dict(out["launches"])
    print(f"tensor parallel: the phase took {out['phase_s']:.1f} s; device memory allocated "
          f"{out['allocated_gib']['before']:.3f} GiB before it, {out['allocated_gib']['after']:.3f} "
          "after", flush=True)
    return out


def tp_engines(torch, tp, requests, refs, cfg, card, ServingEngine, SplitServingEngine):
    """Both engines over the sharded policy ``tp``: 4 closed-loop clients x 2
    requests each, every result held to ``refs`` (the sharded predict's ids
    and margins) under engine_rule_ok; the kernel launches of each window."""
    res = {}
    for label, make in (
            ("monolithic", lambda: ServingEngine(tp, max_batch_size=4, batch_buckets=(1, 2, 4))),
            ("split_kv8", lambda: SplitServingEngine(tp, n_slots=4, decode_block=4,
                                                     max_prompt_len=320, kv_bits=8))):
        t0 = time.perf_counter()
        with make() as engine:
            if label.startswith("split"):
                engine.warmup(requests[0][0], [r[1] for r in requests])
                engine.reset_stats()
            held = {}
            counts = launch_counts(torch, lambda: held.__setitem__("out", engine_clients(
                engine, requests, 4, 2, f"{label} engine over shard(n_model=2)")))
            results, lat, wall = held["out"]
            stats = engine.stats()
        exact, first = check_engine_results(results, requests, refs, cfg,
                                            f"{label} engine over shard(n_model=2)")
        if torch.cuda.is_available() and not all(
                counts.get(k, 0) > 0 for k in ("q8_matvec", "q8_rmsnorm_matvec")):
            fail(f"{label} engine over shard(n_model=2): kernels #1 and #2 not launched "
                 f"({counts})")
        res[label] = {**engine_summary(lat, wall, len(results)), "stats": stats,
                      "launches": counts, "exact_and_first": (exact, first),
                      "s": time.perf_counter() - t0}
        print(f"tensor parallel engines: {label} over shard(n_model=2), 4 clients x 2 "
              f"requests: {res[label]['actions_per_s']:.2f} actions/s, p50 "
              f"{res[label]['latency_ms_p50']:.1f} ms; of {len(results)} results {exact} equal "
              f"the sharded predict's ids, {first} its first token, all within the margin rule; "
              f"launches {counts} | {card}", flush=True)
    return res


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
        # for parallel_path: the trained state and its batches (not printed)
        "reuse": dict(cfg=cfg, state=state, batches=batches, luts=luts, step_cfg=step_cfg,
                      tx=tx),
    }


# ---------------------------------------------------------------------------
# training parallelism on one card: the ring and the pipe held by one
# process, and the process-group path on a one-rank NCCL group
# ---------------------------------------------------------------------------

def ring_alone(torch, fa, device):
    """ring_flash_attention of random bf16 q / k / v at the training shape
    (B=2, T=320, 8/4 heads, D=256, softcap 50, window 4096, one row
    right-padded to 301), n = 4 and 2 shards, with the 277-token prefix
    across the shards and causal (where whole visits are dead and rows of a
    visit have no allowed key), against the unsharded flash kernel and the
    plain version on the rows with an allowed key: out, dq, dk, dv."""
    from spatialvla_tpu_torch.parallel import LocalMesh, ring_flash_attention

    g = torch.Generator(device=device).manual_seed(5)
    B, T, Nq, Nkv, D = 2, 320, 8, 4, 256
    randn = lambda *shape: torch.randn(shape, generator=g, device=device).to(torch.bfloat16)  # noqa: E731
    q, do = randn(B, T, Nq, D), randn(B, T, Nq, D)
    k, v = randn(B, T, Nkv, D), randn(B, T, Nkv, D)
    kw = dict(scale=D ** -0.5, logit_softcap=50.0, window=4096, causal=True)
    out = {}
    for tag, prefix in (("prefix277", 277), ("causal", 0)):
        lens = [torch.tensor(x, dtype=torch.int32, device=device)
                for x in ([prefix] * B, [320, 301], [0] * B)]
        rows = fa.allowed_rows(*lens, T, T, window=4096, causal=True)
        dom = do * rows[..., None, None]

        def grads(fn):
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            o = fn(*leaves)
            return [o.detach()] + list(torch.autograd.grad(o, leaves, dom))

        flash = grads(lambda q, k, v: fa.flash_attention(q, k, v, *lens, **kw))
        ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, *lens, **kw)
        plain = [ref_out, *fa.flash_attention_bwd_plain(q, k, v, ref_out, ref_lse, dom, *lens,
                                                        **kw)]
        for n in (4, 2):
            ring = grads(lambda q, k, v: ring_flash_attention(
                q, k, v, lens[0], lens[1], mesh=LocalMesh(sp=n), **kw))
            errs = {}
            for name, a, b, c in zip(("out", "dq", "dk", "dv"), ring, flash, plain):
                if name == "out":
                    a, b, c = a[rows], b[rows], c[rows]
                errs[name] = {"vs_flash": rel_err(a, b)[1], "vs_plain": rel_err(a, c)[1]}
            worst = max(max(e.values()) for e in errs.values())
            print(f"parallel: ring_flash_attention n={n} {tag}: rel err "
                  + " ".join(f"{k} {e['vs_flash']:.2e} / {e['vs_plain']:.2e}"
                             for k, e in errs.items())
                  + f" (vs the flash kernel / plain; bound {FLASH_TOL['bfloat16']})", flush=True)
            if not worst < FLASH_TOL["bfloat16"]:
                fail(f"parallel: ring n={n} {tag} against flash and plain: {errs}")
            out[f"n{n}_{tag}"] = errs
    return out


def parallel_path(torch, counters, reuse, *, device="cuda", n_steps=3):
    """Training parallelism (spatialvla_tpu_torch/parallel) on the training
    path's full-width weights and batches (train_path's ``reuse``):

    1. ring attention alone at the training shape (ring_alone);
    2. one loss and gradient of batch 0 through the ring held by this
       process (LocalMesh sp=4, sp=2) and the pipe (pipe=2: 7+6 layer
       pairs, 2 microbatches), each against the flash backend's within
       LOSS_BOUND / GRAD_NORM_BOUND, with exact flash launches: with remat
       2 L n^2 forward and L n^2 of each backward kernel for the ring (every
       visit launches, as JAX's does), 2 L m and L m for the pipe;
    3. a process group of one rank (NCCL on the card): initialize_distributed,
       make_mesh, and the sharded step (shard_train_step) of the "ring"
       backend over the sp group; its loss and grad_norm on batch 0 must
       equal the flash step's bit for bit (the ring of one shard is one
       flash call; the collectives of one rank copy);
    4. n_steps timed steps of each through train_loop, with the peak memory.
    Returns what it measured; the weights are updated by step 4."""
    import socket

    from spatialvla_tpu_torch.ops import flash_attention as fa
    from spatialvla_tpu_torch.parallel import (LocalMesh, MeshConfig, initialize_distributed,
                                               make_mesh)
    from spatialvla_tpu_torch.train import make_loss_fn, make_train_step, shard_train_step
    from spatialvla_tpu_torch.train.optimizer import iter_leaves
    from spatialvla_tpu_torch.train.train_step import batch_to_tensors
    from spatialvla_tpu_torch.train.trainer import TrainerConfig, train_loop

    cfg, state, batches = reuse["cfg"], reuse["state"], reuse["batches"]
    luts, step_cfg, tx = reuse["luts"], reuse["step_cfg"], reuse["tx"]
    params = state["params"]
    L = cfg.text.num_layers
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    result = {"ring_alone": ring_alone(torch, fa, device)}

    def loss_and_grad_norm(backend, mesh, **kw):
        zero_counts(counters)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss_fn = make_loss_fn(cfg, dataclasses.replace(step_cfg, attn_backend=backend, **kw),
                               luts=luts, mesh=mesh)
        loss, _ = loss_fn(params, batch_to_tensors(batches[0], device))
        loss.backward()
        grads = [p.grad for _, p in iter_leaves(params) if p.grad is not None]
        norm = torch.sqrt(torch.stack([g.float().pow(2).sum() for g in grads]).sum())
        for _, p in iter_leaves(params):
            p.grad = None
        sync()
        return {"loss": float(loss.detach()), "grad_norm": float(norm),
                "s": time.perf_counter() - t0,
                "launches": {c.__name__: c.launches for c in counters},
                "peak_gib": (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
                             else float("nan"))}

    def want(n_fwd, n_bwd):
        return {"flash_attention_fwd": n_fwd, "flash_attention_bwd_dq": n_bwd,
                "flash_attention_bwd_dkv": n_bwd}

    ref = loss_and_grad_norm("flash", None)
    runs = {"flash": (ref, want(2 * L, L))}
    for n in (4, 2):
        runs[f"ring_n{n}"] = (loss_and_grad_norm("ring", LocalMesh(sp=n)),
                              want(2 * L * n * n, L * n * n))
    m = 2
    runs["pipeline_S2_m2"] = (loss_and_grad_norm("pipeline", LocalMesh(pipe=2),
                                                 pp_microbatches=m), want(2 * L * m, L * m))
    for name, (r, launches) in runs.items():
        d_loss = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
        d_gn = abs(r["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
        r.update(loss_rel=d_loss, grad_norm_rel=d_gn, want_launches=launches)
        print(f"parallel: {name}: loss {r['loss']:.6f} (rel {d_loss:.3e}, bound {LOSS_BOUND}), "
              f"grad_norm {r['grad_norm']:.6f} (rel {d_gn:.3e}, bound {GRAD_NORM_BOUND}) "
              f"against flash; one loss and gradient {r['s']:.2f} s, peak {r['peak_gib']:.2f} "
              f"GiB; launches {r['launches']} (want {launches})", flush=True)
        if not (d_loss < LOSS_BOUND and d_gn < GRAD_NORM_BOUND):
            fail(f"parallel: {name} against flash: loss rel {d_loss}, grad_norm rel {d_gn}")
        if device == "cuda" and r["launches"] != launches:
            fail(f"parallel: {name} launches {r['launches']}, want {launches}")
    result["loss_and_grad"] = {name: r for name, (r, _) in runs.items()}

    # a process group of one rank: the process-group transports and the
    # sharded step's collectives
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"localhost:{port}", 1, 0, device_type=device)
    mesh = make_mesh(MeshConfig(), device)
    backend = torch.distributed.get_backend()
    ring_cfg = dataclasses.replace(step_cfg, attn_backend="ring")
    sharded, state = shard_train_step(make_train_step(cfg, tx, ring_cfg, luts=luts, mesh=mesh),
                                      mesh, state)
    zero_counts(counters)
    state, metrics = sharded(state, batches[0])
    sync()
    group = {"backend": backend, "mesh": mesh.shape, "loss": float(metrics["loss"]),
             "grad_norm": float(metrics["grad_norm"]),
             "launches": {c.__name__: c.launches for c in counters}}
    group["loss_diff"] = group["loss"] - ref["loss"]
    group["grad_norm_diff"] = group["grad_norm"] - ref["grad_norm"]
    print(f"parallel: one-rank {backend} group, mesh {mesh.shape}: the sharded ring step's loss "
          f"{group['loss']!r} grad_norm {group['grad_norm']!r}; minus the flash step's: "
          f"{group['loss_diff']!r} / {group['grad_norm_diff']!r} (bit-identical expected); "
          f"launches {group['launches']}", flush=True)
    if group["loss_diff"] != 0.0 or group["grad_norm_diff"] != 0.0:
        fail(f"parallel: the one-rank sharded step differs from the flash step: {group}")
    if device == "cuda" and group["launches"] != want(2 * L, L):
        fail(f"parallel: the one-rank sharded step launched {group['launches']}")
    result["process_group"] = group

    # timed steps through train_loop
    timed = {}
    steps = {f"ring_n{n}": make_train_step(cfg, tx, ring_cfg, luts=luts, mesh=LocalMesh(sp=n))
             for n in (4, 2)}
    steps["pipeline_S2_m2"] = make_train_step(
        cfg, tx, dataclasses.replace(step_cfg, attn_backend="pipeline", pp_microbatches=m),
        luts=luts, mesh=LocalMesh(pipe=2))
    steps["process_group_ring"] = sharded
    for name, step in steps.items():
        times, logged = [], []

        def timed_step(state, batch):
            sync()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            sync()
            times.append(time.perf_counter() - t0)
            return state, metrics

        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        start = int(state["step"])
        with tempfile.TemporaryDirectory() as out_dir:
            state = train_loop(state=state, train_step=timed_step,
                               batches=iter(batches[:n_steps]),
                               config=TrainerConfig(output_dir=out_dir, max_steps=start + n_steps,
                                                    log_every=1, tensorboard=False),
                               on_metrics=lambda s, mm: logged.append(mm))
        peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else float("nan")
        if len(logged) != n_steps or not all(np.isfinite(v) for mm in logged for v in mm.values()):
            fail(f"parallel: {name} steps: {logged}")
        timed[name] = {"step_ms": [t * 1e3 for t in times], "peak_gib": peak,
                       "losses": [mm["loss"] for mm in logged]}
        print(f"parallel: {name}: {n_steps} steps of train_loop "
              f"{[round(t * 1e3, 2) for t in times]} ms, peak {peak:.2f} GiB, losses "
              f"{[round(mm['loss'], 4) for mm in logged]}", flush=True)
    torch.distributed.destroy_process_group()
    result["steps"] = timed
    result["phase_s"] = time.perf_counter() - t_phase
    print(f"parallel: the phase took {result['phase_s']:.1f} s", flush=True)
    return result, state


# ---------------------------------------------------------------------------
# the model axis in training on one card: n tensor-parallel shards held by
# one process (LocalMesh(model=n)), full-parameter and LoRA
# ---------------------------------------------------------------------------

MP_LORA_OPT = dict(learning_rate=5e-4, schedule="constant")  # the factors move from step 1


def mp_timed_steps(torch, counters, step, state, batches, *, device, step_args=()):
    """The steps of ``batches`` through train_loop: (state, their ms, the
    peak GiB, the metrics, the flash launches)."""
    from spatialvla_tpu_torch.train.trainer import TrainerConfig, train_loop

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    times, logged = [], []

    def timed_step(state, *args):
        sync()
        t0 = time.perf_counter()
        out = step(state, *args)
        sync()
        times.append(time.perf_counter() - t0)
        return out

    zero_counts(counters)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    start = int(state["step"])
    with tempfile.TemporaryDirectory() as out_dir:
        state = train_loop(state=state, train_step=timed_step, batches=iter(batches),
                           config=TrainerConfig(output_dir=out_dir, max_steps=start + len(batches),
                                                log_every=1, tensorboard=False),
                           step_args=step_args, on_metrics=lambda s, m: logged.append(m))
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else float("nan")
    launches = {c.__name__: c.launches for c in counters}
    if len(logged) != len(batches) or not all(np.isfinite(v) for m in logged for v in m.values()):
        fail(f"model parallel: steps {logged}")
    return state, [t * 1e3 for t in times], peak, logged, launches


def model_parallel_training(torch, counters, reuse, *, device="cuda", n_steps=3, lora_steps=2):
    """The model axis in training (parallel/partitioning.py:TrainShards) on
    the training path's full-width weights and batches (train_path's
    ``reuse``, B=2, T=320, bf16, remat, flash), every shard on this card:

    1. for each mesh, LocalMesh(model=2), (model=4), then the model axis
       with the ring, (model=2, sp=2), and with the pipe, (model=2, pipe=2:
       7+6 layer pairs, 2 microbatches): the flash step's loss and grad_norm
       of batch 0 on the whole weights (no update); the state cut over
       model IN PLACE (each whole leaf freed as it is cut); the first
       sharded step on batch 0, whose loss and grad_norm (of the weights
       before its update) must be within LOSS_BOUND / GRAD_NORM_BOUND of
       those, with exact flash launches: 2 L v forward and L v of each
       backward kernel, v the flash calls a layer takes (n model shards, n
       k^2 ring visits over k sequence shards, n m pipeline microbatches);
       n_steps timed steps through train_loop with the peak memory; the
       state joined back IN PLACE;
    2. the moments freed, LoRA (rank 32, "linear", factors b drawn non-zero)
       on the weights as base: lora_steps unsharded steps, then the same
       from the same factors at (model=2) and at (model=2, sp=2) (the base
       cut in place, then joined back) through train_loop, each step's loss
       within LOSS_BOUND of the unsharded one's, with exact launches and the
       peak memory.
    Frees the state. Returns what it measured."""
    from spatialvla_tpu_torch.parallel import LocalMesh
    from spatialvla_tpu_torch.train import (OptimizerConfig, init_lora_train_state, make_loss_fn,
                                            make_lora_train_step, make_optimizer, make_train_step,
                                            shard_lora_train_step, shard_train_step)
    from spatialvla_tpu_torch.train.lora import TARGET_PRESETS
    from spatialvla_tpu_torch.train.optimizer import iter_leaves
    from spatialvla_tpu_torch.train.train_step import batch_to_tensors

    cfg, state, batches = reuse["cfg"], reuse["state"], reuse["batches"]
    luts, step_cfg, tx = reuse["luts"], reuse["step_cfg"], reuse["tx"]
    L = cfg.text.num_layers
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    result = {}
    ring_cfg = dataclasses.replace(step_cfg, attn_backend="ring")
    pipe_cfg = dataclasses.replace(step_cfg, attn_backend="pipeline", pp_microbatches=2)

    def want(visits, steps=1):
        """Exact flash launches of ``steps`` steps that call the kernels
        ``visits`` times a layer (twice the forward under remat)."""
        return {"flash_attention_fwd": 2 * L * visits * steps,
                "flash_attention_bwd_dq": L * visits * steps,
                "flash_attention_bwd_dkv": L * visits * steps}

    def check_launches(label, got, wanted):
        print(f"model parallel: {label} launches {got} (want {wanted})", flush=True)
        if device == "cuda" and got != wanted:
            fail(f"model parallel: {label} launches {got}, want {wanted}")

    def sharded_run(state, label, mesh, run_cfg, visits):
        params = state["params"]
        for _, p in iter_leaves(params):  # the joined leaves are new tensors
            if p.is_floating_point():
                p.requires_grad_(True)
        loss_fn = make_loss_fn(cfg, step_cfg, luts=luts)
        loss, _ = loss_fn(params, batch_to_tensors(batches[0], device))
        loss.backward()
        ref_gn = float(torch.sqrt(torch.stack([p.grad.float().pow(2).sum()
                                               for _, p in iter_leaves(params)
                                               if p.grad is not None]).sum()))
        ref_loss = float(loss.detach())
        del loss
        for _, p in iter_leaves(params):
            p.grad = None
        t0 = time.perf_counter()
        step, state = shard_train_step(make_train_step(cfg, tx, run_cfg, luts=luts, mesh=mesh),
                                       mesh, state)
        sync()
        cut_s = time.perf_counter() - t0
        blocks = {k: v for k, v in step.shards.cut.blocks.items()}
        zero_counts(counters)
        t0 = time.perf_counter()
        state, metrics = step(state, batches[0])
        sync()
        first_s = time.perf_counter() - t0
        first = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}
        first_launches = {c.__name__: c.launches for c in counters}
        check_launches(f"{label} first step", first_launches, want(visits))
        d_loss = abs(first["loss"] - ref_loss) / abs(ref_loss)
        d_gn = abs(first["grad_norm"] - ref_gn) / ref_gn
        print(f"model parallel: {label} {mesh} {run_cfg.attn_backend} (blocks cut {blocks}): "
              f"the first step's loss {first['loss']:.6f} vs the flash step's {ref_loss:.6f} "
              f"(rel {d_loss:.3e}, bound {LOSS_BOUND}), grad_norm {first['grad_norm']:.6f} vs "
              f"{ref_gn:.6f} (rel {d_gn:.3e}, bound {GRAD_NORM_BOUND}); the cut {cut_s:.2f} s, "
              f"the step {first_s:.2f} s", flush=True)
        if not (d_loss < LOSS_BOUND and d_gn < GRAD_NORM_BOUND):
            fail(f"model parallel: {label} against flash: loss rel {d_loss}, grad_norm rel {d_gn}")
        state, ms, peak, logged, launches = mp_timed_steps(
            torch, counters, step, state, batches[:n_steps], device=device)
        check_launches(f"{label} {n_steps} timed steps", launches, want(visits, n_steps))
        print(f"model parallel: {label}: {n_steps} steps of train_loop "
              f"{[round(t, 2) for t in ms]} ms, peak {peak:.2f} GiB, losses "
              f"{[round(m['loss'], 4) for m in logged]}", flush=True)
        t0 = time.perf_counter()
        state = step.shards.gather_state(state, in_place=True)
        sync()
        result[label] = {"mesh": mesh.shape, "backend": run_cfg.attn_backend,
                         "ref": {"loss": ref_loss, "grad_norm": ref_gn}, "first": first,
                         "loss_rel": d_loss, "grad_norm_rel": d_gn, "blocks": blocks,
                         "first_launches": first_launches, "launches": launches, "step_ms": ms,
                         "peak_gib": peak, "losses": [m["loss"] for m in logged],
                         "cut_s": cut_s, "join_s": time.perf_counter() - t0}
        return state

    runs = (("n2", LocalMesh(model=2), step_cfg, 2), ("n4", LocalMesh(model=4), step_cfg, 4),
            ("model2_sp2", LocalMesh(model=2, sp=2), ring_cfg, 2 * 2 * 2),
            ("model2_pipe2", LocalMesh(model=2, pipe=2), pipe_cfg, 2 * 2))
    for label, mesh, run_cfg, visits in runs:
        state = sharded_run(state, label, mesh, run_cfg, visits)
        if device == "cuda":
            torch.cuda.empty_cache()

    # LoRA on the trained weights as the base: unsharded, then over model
    # shards, alone and with the ring
    base = state["params"]
    del state, reuse["state"]
    for _, p in iter_leaves(base):
        p.requires_grad_(False)
    if device == "cuda":
        torch.cuda.empty_cache()
    lora_kw = dict(alpha=LORA["alpha"], rank=LORA["rank"], luts=luts)

    def lora_state():
        ltx = make_optimizer(OptimizerConfig(**MP_LORA_OPT), None, None)
        gen = torch.Generator(device=device).manual_seed(1)
        lstate = init_lora_train_state(gen, base, ltx, target_patterns=TARGET_PRESETS[
            LORA["target"]], rank=LORA["rank"])
        draw = torch.Generator(device=device).manual_seed(2)
        with torch.no_grad():
            for f in lstate["trainable"]["lora"].values():
                f["b"].copy_(torch.randn(f["b"].shape, generator=draw, device=device) * 0.01)
        return ltx, lstate

    ltx, lstate = lora_state()
    step = make_lora_train_step(cfg, ltx, step_cfg, **lora_kw)
    _, ms_ref, peak_ref, ref_logged, _ = mp_timed_steps(
        torch, counters, step, lstate, batches[:lora_steps], device=device, step_args=(base,))
    del lstate, step
    for label, mesh, run_cfg, visits in (("lora_n2", LocalMesh(model=2), step_cfg, 2),
                                         ("lora_model2_sp2", LocalMesh(model=2, sp=2), ring_cfg,
                                          2 * 2 * 2)):
        ltx, lstate = lora_state()
        step, base = shard_lora_train_step(make_lora_train_step(cfg, ltx, run_cfg, mesh=mesh,
                                                                **lora_kw), mesh, base)
        lstate, ms, peak, logged, launches = mp_timed_steps(
            torch, counters, step, lstate, batches[:lora_steps], device=device, step_args=(base,))
        check_launches(f"{label} {lora_steps} steps", launches, want(visits, lora_steps))
        rels = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(logged, ref_logged)]
        print(f"model parallel: {label} {mesh} {run_cfg.attn_backend}: {lora_steps} steps of "
              f"train_loop {[round(t, 2) for t in ms]} ms (unsharded "
              f"{[round(t, 2) for t in ms_ref]} ms), peak {peak:.2f} GiB (unsharded "
              f"{peak_ref:.2f}), losses "
              f"{[m['loss'] for m in logged]} vs unsharded {[m['loss'] for m in ref_logged]} (rel "
              f"{rels}, bound {LOSS_BOUND})", flush=True)
        if not all(r < LOSS_BOUND for r in rels):
            fail(f"model parallel: {label} losses {logged} against unsharded {ref_logged}")
        result[label] = {"mesh": mesh.shape, "backend": run_cfg.attn_backend, "step_ms": ms,
                         "peak_gib": peak, "losses": [m["loss"] for m in logged],
                         "unsharded_step_ms": ms_ref, "unsharded_peak_gib": peak_ref,
                         "unsharded_losses": [m["loss"] for m in ref_logged],
                         "loss_rel": rels, "launches": launches}
        shards = step.keywords["shards"]
        del lstate, step
        base = shards.gather_state({"params": base}, in_place=True)["params"]  # whole again
    del base
    if device == "cuda":
        torch.cuda.empty_cache()
    result["phase_s"] = time.perf_counter() - t_phase
    print(f"model parallel: the phase took {result['phase_s']:.1f} s", flush=True)
    return result


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


# ---------------------------------------------------------------------------
# LoRA fine-tuning with checkpoints and resume, then evaluation through the
# eval driver
# ---------------------------------------------------------------------------

LORA = dict(rank=32, alpha=32.0, target="linear")  # scripts/finetune_lora.sh
RESUME_LOSS_BOUND = 1e-4  # |loss_resumed - loss_uninterrupted| / loss, if not bit-exact


def finetune_path(torch, counters, *, cfg=None, device="cuda", n_steps=6, save_every=2,
                  seq_len=320):
    """LoRA fine-tuning of full-width spatialvla_4b() as train/finetune.py
    runs it (see the module docstring), then the folded, quantized policy.

    Returns (result dict, the policy). ``cfg`` and ``device="cpu"``
    rehearse the phase on the CPU at a small size: everything but the
    launch counts (the wrappers count nothing there)."""
    import shutil

    from spatialvla_tpu_torch import SpatialVLAPolicy, spatialvla_4b
    from spatialvla_tpu_torch.convert.bridge import map_tree
    from spatialvla_tpu_torch.inference import default_processor
    from spatialvla_tpu_torch.models import spatialvla as sv
    from spatialvla_tpu_torch.ops import quant
    from spatialvla_tpu_torch.train import (OptimizerConfig, TrainStepConfig, build_decode_luts,
                                            init_lora_train_state, make_loss_fn,
                                            make_lora_train_step, make_optimizer)
    from spatialvla_tpu_torch.train.checkpoints import CheckpointManager, save_params
    from spatialvla_tpu_torch.train.finetune import load_pretrained
    from spatialvla_tpu_torch.train.lora import (TARGET_PRESETS, insert_saved, lora_apply_tree,
                                                 lora_fold)
    from spatialvla_tpu_torch.train.train_step import batch_to_tensors
    from spatialvla_tpu_torch.train.trainer import TrainerConfig, train_loop
    from spatialvla_tpu_torch.utils.tree import count_params, iter_leaves, map_with_paths

    cfg = cfg or spatialvla_4b()
    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rank, alpha = LORA["rank"], LORA["alpha"]
    work = tempfile.mkdtemp(prefix="chip_smoke_finetune_")
    res = {"dir": work}

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def clone(tree):
        return {p: t.detach().clone() for p, t in iter_leaves(tree) if torch.is_tensor(t)}

    try:
        # a pretrained directory as the pretrain CLI writes one: fp32 params,
        # config.json and the processor
        free = shutil.disk_usage(work).free
        params = sv.init_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                                device=device, dtype=torch.float32)
        need = tree_bytes(params)
        print(f"finetune path: {free} bytes free in {work}; the fp32 pretrained tree needs "
              f"{need} bytes | {card_line() if on_card else 'cpu'}", flush=True)
        if free < need * 1.1:
            fail(f"finetune path: {free} bytes free in {work}, the fp32 pretrained tree needs "
                 f"{need} bytes and the LoRA checkpoints about a tenth more")
        pre_dir = os.path.join(work, "pretrained")
        nbytes, sec = timed(lambda: save_params(pre_dir, params, config_json=cfg.to_json()))
        default_processor(cfg).save(pre_dir)
        res["pretrained_write"] = {"s": sec, "bytes": nbytes}
        del params
        if on_card:
            torch.cuda.empty_cache()
        (base, processor), sec = timed(lambda: load_pretrained(pre_dir, device=device))
        res["pretrained_load"] = {"s": sec, "bytes": nbytes}
        print(f"finetune path: pretrained tree written in {res['pretrained_write']['s']:.2f} s "
              f"and loaded with finetune.load_pretrained in {sec:.2f} s ({nbytes} bytes, "
              f"{count_params(base) / 1e9:.3f} B parameters)", flush=True)

        batches = training_batches(processor, cfg, n_steps, seq_len=seq_len)
        luts = {k: torch.as_tensor(v, device=device)
                for k, v in build_decode_luts(processor.action_tokenizer).items()}
        # the fine-tuning CLI's optimizer for finetune_lora.sh (lr 5e-4, 10000 steps)
        tx = make_optimizer(OptimizerConfig(learning_rate=5e-4, warmup_ratio=0.005,
                                            total_steps=10_000), None, None)
        step_cfg = TrainStepConfig(use_remat=True, compute_dtype=torch.bfloat16,
                                   attn_backend="flash", loss_chunk_size=256)

        def new_state(seed):
            return init_lora_train_state(torch.Generator(device=device).manual_seed(seed), base,
                                         tx, target_patterns=TARGET_PRESETS[LORA["target"]],
                                         rank=rank)

        state = new_state(1)
        n_train = count_params(state["trainable"])
        print(f"finetune path: LoRA rank {rank}, alpha {alpha}, {len(state['trainable']['lora'])} "
              f"adapted leaves, {n_train / 1e6:.2f} M trainable parameters", flush=True)

        # flash vs xla: loss and trainable-gradient norm of one batch, no update
        def loss_and_grad_norm(backend):
            loss_fn = make_loss_fn(cfg, dataclasses.replace(step_cfg, attn_backend=backend),
                                   luts=luts)
            frozen = map_with_paths(lambda _, t: t.detach(), base)
            p = lora_apply_tree(insert_saved(frozen, state["trainable"]["saved"]),
                                state["trainable"]["lora"], alpha=alpha, rank=rank)
            loss, _ = loss_fn(p, batch_to_tensors(batches[0], device))
            loss.backward()
            leaves = [t for _, t in iter_leaves(state["trainable"])]
            norm = torch.sqrt(torch.stack([t.grad.float().pow(2).sum() for t in leaves
                                           if t.grad is not None]).sum())
            for t in leaves:
                t.grad = None
            return float(loss.detach()), float(norm)

        (lf, gf), (lx, gx) = loss_and_grad_norm("flash"), loss_and_grad_norm("xla")
        d_loss, d_gn = abs(lf - lx) / abs(lx), abs(gf - gx) / gx
        print(f"finetune flash vs xla (one batch): loss {lf:.6f} vs {lx:.6f} (rel {d_loss:.3e}, "
              f"bound {LOSS_BOUND}), trainable grad_norm {gf:.6f} vs {gx:.6f} (rel {d_gn:.3e}, "
              f"bound {GRAD_NORM_BOUND})", flush=True)
        if not (d_loss < LOSS_BOUND and d_gn < GRAD_NORM_BOUND):
            fail(f"finetune: flash vs xla loss rel {d_loss}, grad_norm rel {d_gn}")
        res["flash_vs_xla"] = {"loss": [lf, lx], "grad_norm": [gf, gx], "loss_rel": d_loss,
                               "grad_norm_rel": d_gn}

        base_before = clone(base)  # on the device: bit-identical afterwards
        trainable_before = clone(state["trainable"])
        step = make_lora_train_step(cfg, tx, step_cfg, alpha=alpha, rank=rank, luts=luts)
        times, logged, saves, snapshots = [], [], {}, {}

        def timed_step(state, base_params, batch):
            out, sec = timed(lambda: step(state, base_params, batch))
            times.append(sec)
            return out

        class Manager(CheckpointManager):
            """Keeps a copy of the state each save wrote (the seconds each save
            blocked, and each write's seconds and bytes, are in ``writes``)."""

            def save(self, step, state, **kw):
                done = super(Manager, self).save(step, state, **kw)
                if done:
                    snapshots[step] = clone(state) | {
                        "step": state["step"], "count": state["opt_state"]["count"]}
                return done

        mgr = Manager(os.path.join(work, "checkpoints"), save_interval_steps=save_every,
                      max_to_keep=2)
        zero_counts(counters)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        state = train_loop(state=state, train_step=timed_step, batches=iter(batches),
                           config=TrainerConfig(output_dir=os.path.join(work, "run"),
                                                max_steps=n_steps, log_every=1,
                                                save_every=save_every, tensorboard=False),
                           checkpoint_manager=mgr, step_args=(base,),
                           on_metrics=lambda s, m: logged.append(m))
        launches = {c.__name__: c.launches for c in counters}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
        # the loop's last wait joined the writer: every write's record is whole
        saves.update({w["step"]: {"s": w["write_s"], "blocked_s": w["blocked_s"],
                                  "bytes": w["bytes"]} for w in mgr.writes})
        L = cfg.text.num_layers
        want = ({"flash_attention_fwd": 2 * L * n_steps, "flash_attention_bwd_dq": L * n_steps,
                 "flash_attention_bwd_dkv": L * n_steps} if on_card
                else {c.__name__: 0 for c in counters})
        print(f"finetune launches over {n_steps} steps: {launches} (want {want})", flush=True)
        if launches != want:
            fail(f"finetune: kernel launches {launches}, want {want}")
        if len(logged) != n_steps or not all(np.isfinite(v) for m in logged for v in m.values()):
            fail(f"finetune: {len(logged)} logged steps, metrics {logged}")
        for path, before in base_before.items():
            if not torch.equal(before, dict(iter_leaves(base))[path]):
                fail(f"finetune: base leaf {path} changed")
        after = clone(state["trainable"])
        unchanged = [p for p in after if (p.endswith("/b") or p == "saved/spatial_embed")
                     and torch.equal(after[p], trainable_before[p])]
        if unchanged:
            fail(f"finetune: trainable leaves did not change: {unchanged[:6]}")
        kept = [s for s in range(save_every, n_steps + 1, save_every)][-2:]
        if mgr.all_steps() != kept or sorted(saves) != list(range(save_every, n_steps + 1,
                                                                      save_every)):
            fail(f"finetune: checkpoints {mgr.all_steps()} kept, {sorted(saves)} written; want "
                 f"{kept} kept")
        del base_before
        steady = times[2:]
        step_s = statistics.median(steady)
        tokens = batches[0]["input_ids"].size
        res.update({
            "n_trainable": n_train, "step_ms_all": [t * 1e3 for t in times],
            "step_ms_median": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "peak_mem_gib": peak_gib, "launches": launches, "metrics": logged, "saves": saves})
        print(f"finetune: step times {[round(t * 1e3, 2) for t in times]} ms; median after 2 "
              f"warm-up steps {step_s * 1e3:.2f} ms, {tokens / step_s:.1f} tokens/s, peak "
              f"{peak_gib:.2f} GiB; losses {[round(m['loss'], 4) for m in logged]}; checkpoint "
              f"writes {[(s, round(v['blocked_s'], 3), round(v['s'], 3), v['bytes']) for s, v in sorted(saves.items())]} "
              f"(step, s save blocked, s written in the background, bytes), kept "
              f"{mgr.all_steps()} | "
              f"{card_line() if on_card else 'cpu'}", flush=True)

        # resume: a fresh state restored from the middle checkpoint, bit for
        # bit, then the rest of the run against the uninterrupted one
        mid = kept[0]
        fresh = new_state(2)
        restored, sec = timed(lambda: mgr.restore(fresh, step=mid))
        res["restore"] = {"s": sec, "bytes": saves[mid]["bytes"], "step": mid}
        snap = snapshots[mid]
        got = clone(restored)
        differ = [p for p in got if not torch.equal(got[p], snap[p])]
        if differ or restored["step"] != mid or restored["opt_state"]["count"] != snap["count"]:
            fail(f"finetune resume: the restored state differs from the one saved at step {mid}: "
                 f"{differ[:6]}, step {restored['step']}, count {restored['opt_state']['count']}")
        cont = []
        restored = train_loop(state=restored, train_step=step, batches=iter(batches[mid:]),
                              config=TrainerConfig(output_dir=os.path.join(work, "resumed"),
                                                   max_steps=n_steps, log_every=1,
                                                   tensorboard=False),
                              step_args=(base,), on_metrics=lambda s, m: cont.append(m))
        straight = [m["loss"] for m in logged[mid:]]
        resumed = [m["loss"] for m in cont]
        final, resumed_final = clone(state["trainable"]), clone(restored["trainable"])
        exact = resumed == straight and all(torch.equal(final[p], resumed_final[p])
                                            for p in final)
        worst_loss = max(abs(a - b) / abs(b) for a, b in zip(resumed, straight))
        worst_param = max(float((final[p] - resumed_final[p]).abs().max()) for p in final)
        print(f"finetune resume from step {mid}: restore {sec:.3f} s ({saves[mid]['bytes']} "
              f"bytes), {len(got)} tensors bit-identical to the state saved; losses "
              f"{resumed} resumed vs {straight} uninterrupted -> "
              f"{'bit-exact' if exact else 'NOT bit-exact'} (worst loss rel {worst_loss:.3e}, "
              f"worst trainable |diff| {worst_param:.3e})", flush=True)
        if not worst_loss <= RESUME_LOSS_BOUND:
            fail(f"finetune resume: losses {resumed} vs {straight} (rel {worst_loss})")
        res["resume"] = {"losses": resumed, "uninterrupted": straight, "bit_exact": exact,
                         "worst_loss_rel": worst_loss, "worst_trainable_abs": worst_param}
        del fresh, restored, snapshots

        # a LoRA-factored int8 projection: the trained q factors of layer 0
        # over the int8 base, at 1 and 16 rows, against its plain version
        fac = state["trainable"]["lora"]["lm/layers/attn/q"]
        a, b = fac["a"][0].detach() * (alpha / rank), fac["b"][0].detach()
        wq = quant.quantize_int8(base["lm"]["layers"]["attn"]["q"][0].detach().to(torch.bfloat16))
        g = torch.Generator(device=device).manual_seed(21)
        res["lora_int8_projection"] = {}
        for M in (1, 16):
            x = torch.randn(M, a.shape[0], generator=g, device=device).to(torch.bfloat16)
            n0 = quant.q8_matvec.launches
            got = quant.qmatmul(x, {"w": wq, "a": a, "b": b})
            plain = (quant.q8_matvec_plain(x, wq["qt"], wq["scale"], out_dtype=x.dtype)
                     + (x @ a.to(x.dtype)) @ b.to(x.dtype))
            err = rel_err(got, plain)[1]
            n = quant.q8_matvec.launches - n0
            res["lora_int8_projection"][M] = {"rel_err": err, "q8_matvec_launches": n}
            print(f"finetune: LoRA-factored int8 q projection, M={M}: rel err {err:.3e} vs "
                  f"plain (bound 1e-2), q8_matvec launches {n}", flush=True)
            if not err < 1e-2 or n != (1 if on_card else 0):
                fail(f"LoRA-factored int8 projection at M={M}: rel err {err}, {n} launches")

        # fold, then serve: insert_saved, lora_fold, bf16, quantize(bits=8)
        with torch.no_grad():
            merged = insert_saved(base, {k: v.detach() for k, v in
                                         state["trainable"]["saved"].items()})
            folded = map_tree(lambda t: t.to(torch.bfloat16),
                              lora_fold(merged, state["trainable"]["lora"], alpha=alpha,
                                        rank=rank))
        del merged, base, state
        if on_card:
            torch.cuda.empty_cache()
        policy = SpatialVLAPolicy(folded, cfg, processor, device=device).quantize(bits=8)
        res["policy"] = policy.quant_desc
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res, policy


class EvalEnv:
    """A SimplerEnv-shaped gym env (tests/test_eval_driver.py's FakeEnv): an
    episode succeeds once the summed |dx| of its actions reaches
    ``threshold`` (0: at the first step; inf: never, so it runs max_steps);
    frames come from a seed at the model's image size; every action taken is
    kept."""

    def __init__(self, env_id, threshold, size, seed):
        self.env_id, self.threshold, self.size = env_id, threshold, size
        self.rng = np.random.RandomState(seed)
        self.n_resets, self.actions = 0, []

    def reset(self):
        self.n_resets += 1
        self.t, self.travel = 0, 0.0
        return {"image": self._img()}, {}

    def _img(self):
        return (self.rng.rand(self.size, self.size, 3) * 255).astype(np.uint8)

    def get_language_instruction(self):
        return f"do the {self.env_id} task"

    def step(self, action):
        action = np.asarray(action, dtype=np.float64)
        self.actions.append(action)
        self.t += 1
        self.travel += float(np.abs(action[0]))
        info = {"success": self.travel >= self.threshold,
                "moved_correct_obj": self.travel >= self.threshold / 2}
        done = info["success"] or self.t >= 8
        return {"image": self._img()}, float(info["success"]), done, False, info


def eval_path(torch, counters, policy, *, episodes=8, parallel_envs=4):
    """The fine-tuned, quantized policy through the eval driver
    (spatialvla_tpu_torch/eval, see the module docstring): two tasks, one
    that succeeds at the first step and one that never does, ``episodes``
    each, serially (policy.predict) and with ``parallel_envs`` envs (their
    queries through one ServingEngine, which the driver builds). Both runs'
    rows must be equal, every episode counted, every action finite, the
    kernels #1-#3 launched in each run, and the parallel run's engine must
    batch (mean batch above 1)."""
    from spatialvla_tpu_torch import serve
    from spatialvla_tpu_torch.eval.driver import EvalTask, evaluate

    size = policy.config.vision.image_size
    unnorm = next(iter(policy.processor.statistics))
    tasks = [EvalTask("first step", "eval_at_once", "chip_smoke", "widowx_bridge", unnorm,
                      episodes=episodes, max_steps=8, partial_key="moved_correct_obj"),
             EvalTask("never", "eval_never", "chip_smoke", "widowx_bridge", unnorm,
                      episodes=episodes, max_steps=8, partial_key="moved_correct_obj")]
    thresholds = {"eval_at_once": 0.0, "eval_never": float("inf")}
    on_card = policy.device.type == "cuda"
    engine_cls = serve.ServingEngine

    class Recording(engine_cls):
        """The driver's engine, kept for its stats."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    res = {}
    for label, n_envs in (("serial", 1), ("parallel", parallel_envs)):
        envs = []

        def factory(task):
            envs.append(EvalEnv(task.env_id, thresholds[task.env_id], size, seed=len(envs)))
            return envs[-1]

        graphs_before = set(policy.decode_graphs.loops)
        engines = []
        zero_counts(counters)
        serve.ServingEngine = Recording
        try:
            t0 = time.perf_counter()
            results = evaluate(policy, tasks, env_factory=factory,
                               image_getter=lambda env, obs: obs["image"], parallel_envs=n_envs)
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            serve.ServingEngine = engine_cls
        launches = {c.__name__: c.launches for c in counters}
        added = [k for k in policy.decode_graphs.loops if k not in graphs_before]
        actions = np.stack([a for env in envs for a in env.actions])
        n_ep = sum(env.n_resets for env in envs)
        stats = None
        if engines:  # one engine a task: their requests and batches summed
            each = [e.stats() for e in engines]
            batches = sum(st["batches"] for st in each)
            stats = {"engines": len(each), "requests": sum(st["requests"] for st in each),
                     "batches": batches,
                     "mean_batch_occupancy": sum(st["mean_batch_occupancy"] * st["batches"]
                                                 for st in each) / max(batches, 1)}
        res[label] = {"rows": results["rows"], "suites": results["suites"], "wall_s": wall,
                      "episodes": n_ep, "episodes_per_s": n_ep / wall, "steps": len(actions),
                      "launches": launches, "graph_captures": len(added),
                      "capture_ms": [round(policy.decode_graphs.loops[k].capture_ms, 2)
                                     for k in added],
                      "engine": stats}
        print(f"eval path, {label} ({n_envs} env{'s' if n_envs > 1 else ''}): {n_ep} episodes, "
              f"{len(actions)} steps in {wall:.2f} s ({n_ep / wall:.3f} episodes/s); rows "
              f"{[(r['label'], r['episodes'], r['success_rate'], r['mean_steps']) for r in results['rows']]}; "
              f"launches {launches}; {len(added)} decode-graph captures during the run "
              f"({res[label]['capture_ms']} ms)"
              + (f"; engine {stats['requests']} requests in {stats['batches']} batches, mean "
                 f"batch {stats['mean_batch_occupancy']:.2f}" if stats else "")
              + f" | {card_line() if on_card else 'cpu'}", flush=True)
        if n_ep != 2 * episodes or any(r["episodes"] != episodes for r in results["rows"]):
            fail(f"eval path, {label}: {n_ep} episodes run, rows {results['rows']}")
        if not np.isfinite(actions).all() or actions.shape[1] != 7:
            fail(f"eval path, {label}: actions of shape {actions.shape}, finite "
                 f"{np.isfinite(actions).all()}")
        if on_card and not all(n > 0 for n in launches.values()):
            fail(f"eval path, {label}: a kernel was not launched ({launches})")
        if (n_envs > 1) != bool(engines) or (stats and not stats["mean_batch_occupancy"] > 1):
            fail(f"eval path, parallel: the engine did not batch ({stats})")
    if res["parallel"]["rows"] != res["serial"]["rows"]:
        fail(f"eval path: parallel rows {res['parallel']['rows']} differ from the serial "
             f"{res['serial']['rows']}")
    return res


# ---------------------------------------------------------------------------
# the training CLIs over RLDS records from disk (data_cli_path)
# ---------------------------------------------------------------------------

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures_rlds")
# the card's decoded frames against golden.npz (libjpeg's decode, in the JAX
# package's frame transform): the nvJPEG route upsamples and converts the
# chroma as libjpeg does and resizes with the same code, so only the IDCT
# differs (max 3, mean 0.0218 on an H100); nvJPEG's own RGB output, which
# upsamples the chroma otherwise, read max 95, mean 0.8776, outside both
GOLDEN_MAX_ABS, GOLDEN_MEAN_ABS = 6, 0.1
# where data_cli_path puts its runs on the card unless CHIP_SMOKE_WORK_ROOT
# names a directory (see data_cli_work_root)
DATA_CLI_WORK_ROOT = "/dev/shm"


def flat_statistics(stats, prefix="statistics") -> dict:
    """Dataset statistics as golden.npz stores them: one array a leaf, keys
    joined with "/"."""
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out.update(flat_statistics(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def golden_frames(root, *, size=224):
    """The fixture's trajectories through the port's source layer, in a
    fixed order (by their actions: the shard reader runs on threads), and
    the primary frame of each one's first and last step decoded at
    size x size by the frame transform's decode. Returns (trajectories,
    first frames, last frames, decode seconds)."""
    from spatialvla_tpu_torch.data import native
    from spatialvla_tpu_torch.data.pipeline import RLDSDataSource

    src = RLDSDataSource("bridge_orig/1.0.0", root, seed=0)
    trajs = sorted(src.iter_canonical(), key=lambda t: t["action"].tobytes())
    native.decode_jpeg_resize(trajs[0]["observation"]["image_primary"][0], size, size)  # warm
    t0 = time.perf_counter()
    first = np.stack([native.decode_jpeg_resize(t["observation"]["image_primary"][0], size, size)
                      for t in trajs])
    last = np.stack([native.decode_jpeg_resize(t["observation"]["image_primary"][-1], size, size)
                     for t in trajs])
    return src, trajs, first, last, time.perf_counter() - t0


class CliSpy:
    """Wraps train/trainer.train_loop while a training CLI runs: times each
    step (synchronized), notes whether a checkpoint write was in flight when
    it began, reads the stepping thread's user and system CPU time, context
    switches and page faults over it (getrusage of the thread), and keeps
    the loop's CheckpointManager. With ``trace_dir``, the steps numbered in
    ``trace_steps`` (0 the first) run under ``utils.profiling.trace``, each
    written to ``<trace_dir>/step<i>/trace.json`` and summed up in its
    record's "trace"."""

    def __init__(self, torch, trainer, *, trace_dir=None, trace_steps=()):
        self.torch, self.trainer, self.loop = torch, trainer, trainer.train_loop
        self.steps, self.manager = [], None
        self.trace_dir, self.trace_steps = trace_dir, set(trace_steps)

    def __enter__(self):
        spy = self

        def train_loop(*, train_step, checkpoint_manager=None, **kw):
            spy.manager = checkpoint_manager

            def step(*args):
                import resource

                from spatialvla_tpu_torch.utils import profiling

                writing = checkpoint_manager is not None and checkpoint_manager.writing()
                n = len(spy.steps)
                traced = spy.trace_dir is not None and n in spy.trace_steps
                tracer = (profiling.trace(os.path.join(spy.trace_dir, f"step{n}")) if traced
                          else contextlib.nullcontext())
                if spy.torch.cuda.is_available():
                    spy.torch.cuda.synchronize()
                with tracer as prof:
                    ru0 = resource.getrusage(resource.RUSAGE_THREAD)
                    t0 = time.perf_counter()
                    out = train_step(*args)
                    if spy.torch.cuda.is_available():
                        spy.torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                    ru1 = resource.getrusage(resource.RUSAGE_THREAD)
                record = {"t0": t0, "ms": ms, "during_write": writing,
                          "user_ms": (ru1.ru_utime - ru0.ru_utime) * 1e3,
                          "sys_ms": (ru1.ru_stime - ru0.ru_stime) * 1e3,
                          "minflt": ru1.ru_minflt - ru0.ru_minflt,
                          "nvcsw": ru1.ru_nvcsw - ru0.ru_nvcsw,
                          "nivcsw": ru1.ru_nivcsw - ru0.ru_nivcsw}
                if traced:
                    record["trace"] = trace_summary(prof)
                spy.steps.append(record)
                return out

            return spy.loop(train_step=step, checkpoint_manager=checkpoint_manager, **kw)

        self.trainer.train_loop = train_loop
        return self

    def __exit__(self, *exc):
        self.trainer.train_loop = self.loop


def trace_summary(prof, top=12) -> dict:
    """A traced step in numbers: the kernels' count and summed device ms, the
    CPU ms of the ops the step ran from Python (their outermost events), and
    the ``top`` ops by their own CPU time (ms, calls)."""
    events = prof.events()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    outer = [e for e in events if e.device_type.name == "CPU" and e.cpu_parent is None]
    ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:top]
    return {"kernels": len(kernels),
            "kernel_ms": sum(e.device_time_total for e in kernels) / 1e3,
            "outer_ops": len(outer),
            "outer_cpu_ms": sum(e.cpu_time_total for e in outer) / 1e3,
            "top_self_cpu": [[a.key, a.self_cpu_time_total / 1e3, a.count] for a in ops]}


def restored_bit_identical(torch, ckpt_dir, state, label) -> dict:
    """Restore the latest step of ``ckpt_dir`` into fresh CPU tensors and
    hold every leaf to ``state``'s, bit for bit; (seconds, tensors, step)."""
    from spatialvla_tpu_torch.train.checkpoints import CheckpointManager
    from spatialvla_tpu_torch.utils.tree import iter_leaves, map_with_paths

    like = map_with_paths(lambda _, t: torch.empty(t.shape, dtype=t.dtype)
                          if torch.is_tensor(t) else t, state)
    mgr = CheckpointManager(ckpt_dir)
    t0 = time.perf_counter()
    restored = mgr.restore(like)
    sec = time.perf_counter() - t0
    live = dict(iter_leaves(state))
    n = 0
    for path, t in iter_leaves(restored):
        want = live[path]
        if torch.is_tensor(t):
            n += 1
            got, ref = t.reshape(-1), want.detach().cpu().reshape(-1)
            if got.dtype != ref.dtype or not torch.equal(got.view(torch.uint8),
                                                         ref.view(torch.uint8)):
                fail(f"{label}: the restored {path} differs from the state main returned")
        elif t != want:
            fail(f"{label}: the restored {path} is {t!r}, the state's {want!r}")
    return {"s": sec, "tensors": n, "step": mgr.latest_step()}


def data_cli_work_root():
    """The directory data_cli_path puts its runs under on the card:
    CHIP_SMOKE_WORK_ROOT where set (empty: TMPDIR), else DATA_CLI_WORK_ROOT
    (/dev/shm). The card's machine ends a call past 45 GiB of disk writes,
    the earlier phases write about 30 of them (into TMPDIR), and the phase's
    two step checkpoints pass 37 GB even with the LM cut to 6 layers, so
    they go to memory. The phase makes a directory of its own there
    (mkdtemp), checks the room for both checkpoints and the host memory for
    them beside the host copy a save takes, and removes it at the end, also
    when it fails."""
    root = os.environ.get("CHIP_SMOKE_WORK_ROOT", DATA_CLI_WORK_ROOT)
    return root or None


def data_cli_path(torch, counters, *, device="cuda", preset="spatialvla_4b", text_layers=6,
                  image_size=224, seq_len=320, root=FIXTURE, work_root=None, steps=3,
                  trace_dir=None):
    """Both training CLIs over the committed RLDS fixture, in this process
    (see the module docstring): the native reader built (its build error
    printed and failed on otherwise) and its frames held to golden.npz,
    pretrain.main at full width for ``steps`` steps with a step checkpoint
    every 2 (step 3 runs while step 2's is written), its last checkpoint
    restored bit for bit, then finetune.main with LoRA from its export for
    3 steps, a save every step.

    The preset runs at full width with its LM cut to ``text_layers`` layers
    (``None`` keeps them all), and the runs' directories live under
    ``work_root`` (``None``: TMPDIR; main passes data_cli_work_root()): two
    full-width step checkpoints (the kept one and the one being written,
    each the fp32 masters and the moments, which the untied 265,346-row head
    and the embedding alone make about 13 GB) take more than the disk
    writes the card's machine allows a call after the earlier phases.
    ``trace_dir`` traces the pretrain run's second step, its third (beside
    the step-2 checkpoint's write, into host buffers that save made) and
    its fifth (beside the next write, into the same buffers) with
    ``torch.profiler``.
    ``device="cpu"`` with ``preset="spatialvla_tiny"`` rehearses it on the
    CPU (the wrappers count nothing there)."""
    import shutil

    from spatialvla_tpu_torch.data import native
    from spatialvla_tpu_torch.models import spatialvla as sv
    from spatialvla_tpu_torch.train import finetune, pretrain, trainable_mask
    from spatialvla_tpu_torch.train import trainer as trainer_mod
    from spatialvla_tpu_torch import config as config_mod
    from spatialvla_tpu_torch.utils.tree import iter_leaves

    on_card = device != "cpu"
    card = card_line() if on_card else "cpu"
    res = {}
    t0 = time.perf_counter()
    route = native.decode_path()
    res["reader"] = {"decode_path": route, "build_s": time.perf_counter() - t0,
                     "build_error": native.build_error()}
    print(f"data cli path: native reader {route} (built and loaded in "
          f"{res['reader']['build_s']:.2f} s) | {card}", flush=True)
    if route == "python" and on_card:
        fail(f"data cli path: the native RLDS reader did not build, so the pure-Python reader "
             f"and PIL would run: {native.build_error()}")

    # the source layer and the frames' decode against the JAX package's golden
    golden = np.load(os.path.join(root, "bridge_orig", "1.0.0", "golden.npz"))
    src, trajs, first, last, dec_s = golden_frames(root)
    actions = np.stack([t["action"] for t in trajs])
    if not np.array_equal(actions, golden["actions"]):
        fail("data cli path: the trajectories' actions differ from golden.npz")
    with tempfile.TemporaryDirectory() as cache:
        stats = flat_statistics(src.statistics(force=True, cache_dir=cache))
    keys = sorted(k for k in golden.files if k.startswith("statistics/"))
    if sorted(stats) != keys or not all(np.allclose(stats[k], golden[k], rtol=1e-6, atol=1e-9)
                                        for k in keys):
        fail(f"data cli path: the dataset statistics differ from golden.npz ({sorted(stats)})")
    diffs = [np.abs(a.astype(np.int16) - golden[k].astype(np.int16))
             for a, k in ((first, "first_frames"), (last, "last_frames"))]
    max_abs, mean_abs = max(int(d.max()) for d in diffs), float(np.mean(np.stack(diffs)))
    exact = max_abs == 0
    res["golden"] = {"trajectories": len(trajs), "max_abs": max_abs, "mean_abs": mean_abs,
                     "exact": exact, "decode_s": dec_s,
                     "frames_per_s": 2 * len(trajs) / dec_s}
    print(f"data cli path: {len(trajs)} trajectories, actions and statistics equal to "
          f"golden.npz; {2 * len(trajs)} frames decoded at 224 x 224 by {route}: max |diff| "
          f"{max_abs}, mean {mean_abs:.4f} uint8 steps (bound {GOLDEN_MAX_ABS} / "
          f"{GOLDEN_MEAN_ABS}), {2 * len(trajs) / dec_s:.1f} frames/s one at a time | {card}",
          flush=True)
    if not (max_abs <= GOLDEN_MAX_ABS and mean_abs <= GOLDEN_MEAN_ABS):
        fail(f"data cli path: decoded frames differ from golden.npz by {max_abs} at most, "
             f"{mean_abs} on average")

    full = getattr(config_mod, preset)
    cfg = full()
    if text_layers is not None:
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_layers=text_layers))
    if work_root is not None and not os.path.isdir(work_root):
        fail(f"data cli path: {work_root} is not a directory")
    work = tempfile.mkdtemp(prefix="chip_smoke_data_cli_", dir=work_root)
    setattr(config_mod, preset, lambda: cfg)  # what the CLIs build for --model_preset
    try:
        # room: the step checkpoint kept, the one being written and the host
        # copy of the state a save takes, each the fp32 masters and the AdamW
        # moments of the trainable leaves (the vision tower frozen, as
        # --freeze_vision_tower does)
        meta = sv.init_params(cfg, generator=None, device="meta")
        mask = dict(iter_leaves(trainable_mask(meta, freeze_llm_embed=cfg.use_spatial_token,
                                               freeze_vision=True, freeze_zoe=True)))
        n_all = sum(t.numel() for _, t in iter_leaves(meta))
        n_train = sum(t.numel() for p, t in iter_leaves(meta) if mask[p])
        state_bytes = 4 * n_all + 8 * n_train
        free = shutil.disk_usage(work).free
        avail = host_available()
        res["room"] = {"dir": work, "free": free, "host_available": avail,
                       "state_bytes": state_bytes, "text_layers": cfg.text.num_layers}
        print(f"data cli path: {preset} with {cfg.text.num_layers} of "
              f"{full().text.num_layers} LM layers; a step checkpoint is {state_bytes} bytes "
              f"({n_all} parameters, {n_train} trainable); {free} bytes free in {work}, "
              f"{avail} bytes of host memory available", flush=True)
        need = 3 * state_bytes + (8 << 30)
        if free < 2 * state_bytes or (on_card and avail < need):
            fail(f"data cli path: {free} bytes free in {work} and {avail} of host memory; two "
                 f"step checkpoints need {2 * state_bytes}, and with the host copy and the "
                 f"process {need} of host memory")
        common = ["--data_root_dir", root, "--mixture", "bridge", "--model_preset", preset,
                  "--per_device_batch_size", "2", "--seq_len", str(seq_len), "--image_size",
                  str(image_size), "--logging_steps", "1", "--device", device]
        pre_dir, ft_dir = os.path.join(work, "pretrain"), os.path.join(work, "finetune")
        runs = {}
        for label, main, argv in (
                ("pretrain", pretrain.main,
                 ["--output_dir", pre_dir, "--max_steps", str(steps), "--save_steps", "2",
                  "--save_total_limit", "1", "--no_augment", "--loader_workers", "1",
                  "--freeze_vision_tower", "--shuffle_buffer_size", "16"]),
                ("finetune", finetune.main,
                 ["--pretrained_dir", pre_dir, "--output_dir", ft_dir, "--use_lora",
                  "--lora_rank", str(LORA["rank"]), "--lora_alpha", str(LORA["alpha"]),
                  "--lora_target", LORA["target"], "--learning_rate", "5e-4",
                  "--max_steps", "3", "--save_steps", "1", "--shuffle_buffer_size", "16"])):
            out_dir = pre_dir if label == "pretrain" else ft_dir
            zero_counts(counters)
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            rss = {}
            t0 = time.perf_counter()
            traced = trace_dir is not None and label == "pretrain"
            with rss_peak(rss), CliSpy(torch, trainer_mod,
                                       trace_dir=trace_dir if traced else None,
                                       trace_steps=(1, 2, 4)) as spy:
                state = main(argv + common)
            wall = time.perf_counter() - t0
            launches = {c.__name__: c.launches for c in counters}
            peak_gib = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
            rows = [json.loads(line) for line in open(os.path.join(out_dir, "metrics.jsonl"))]
            writes = spy.manager.writes
            restore = restored_bit_identical(torch, os.path.join(out_dir, "checkpoints"), state,
                                             f"data cli path, {label}")
            L = cfg.text.num_layers
            n = steps if label == "pretrain" else 3
            want = ({"flash_attention_fwd": 2 * L * n, "flash_attention_bwd_dq": L * n,
                     "flash_attention_bwd_dkv": L * n} if on_card
                    else {c.__name__: 0 for c in counters})
            during = [s["ms"] for s in spy.steps if s["during_write"]]
            alone = [s["ms"] for s in spy.steps if not s["during_write"]]
            runs[label] = {
                "wall_s": wall, "step_ms": [s["ms"] for s in spy.steps], "steps": spy.steps,
                "step_ms_during_write": during, "step_ms_no_write": alone,
                "losses": [r["loss"] for r in rows], "launches": launches,
                "writes": writes, "restore": restore, "peak_mem_gib": peak_gib,
                "host_rss_peak_gib": rss["rss_peak"] / 2**30, "state_step": int(state["step"])}
            print(f"data cli path, {label}.main: {len(spy.steps)} steps in {wall:.1f} s; step ms "
                  f"{[round(s['ms'], 2) for s in spy.steps]} ({len(during)} during a checkpoint "
                  f"write; the stepping thread's user / system CPU ms "
                  f"{[(round(s['user_ms'], 1), round(s['sys_ms'], 1)) for s in spy.steps]}, "
                  f"page faults {[s['minflt'] for s in spy.steps]}); losses {[round(r['loss'], 4) for r in rows]}; saves "
                  f"{[(w['step'], round(w['blocked_s'], 3), round(w['write_s'], 3), w['bytes']) for w in writes]} "
                  f"(step, s save blocked, s written in the background, bytes); last step "
                  f"{restore['step']} restored in {restore['s']:.2f} s, {restore['tensors']} "
                  f"tensors bit-identical; flash launches {launches} (want {want}); peak "
                  f"{peak_gib:.2f} GiB, host RSS peak {rss['rss_peak'] / 2**30:.2f} GiB | {card}",
                  flush=True)
            if launches != want:
                fail(f"data cli path, {label}: flash launches {launches}, want {want}")
            if len(rows) != n or not all(np.isfinite(r["loss"]) for r in rows):
                fail(f"data cli path, {label}: metrics {rows}")
            if on_card and not during:  # (a tiny state on the CPU is written at once)
                fail(f"data cli path, {label}: no step ran while a checkpoint was written")
            if restore["step"] != n or int(state["step"]) != n:
                fail(f"data cli path, {label}: last checkpoint {restore['step']}, state step "
                     f"{state['step']}")
            del state
            gc.collect()
            if label == "pretrain":  # room for the fine-tuning run
                shutil.rmtree(os.path.join(pre_dir, "checkpoints"))
        res.update(runs)
    finally:
        setattr(config_mod, preset, full)
        shutil.rmtree(work, ignore_errors=True)
    res["host_available_after"] = host_available()
    print(f"data cli path: {res['host_available_after']} bytes of host memory available after "
          f"the phase ({res['room']['host_available']} before)", flush=True)
    return res


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

    t_start = time.perf_counter()
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
    # the int8 main path launches no gelu_mul (gate|up's epilogue does its
    # work); the refused-shape step (int4 in 24-column groups) does
    refused = refused_shape_step(torch, timer, serving_counters)
    path = main_path(torch, timer, [quant.q8_matvec, quant.q8_rmsnorm_matvec,
                                    quant.q8_residual_rmsnorm_matvec, ds.decode_attention,
                                    ds.norm_residual])
    print(f"main path: warm predict median {path['warm_predict_ms_median']:.2f} ms "
          f"({path['actions_per_s']:.2f} actions/s) through the decode graph, "
          f"{path['warm_predict_eager_ms_median']:.2f} ms eager, "
          f"peak {path['peak_mem_gib']:.2f} GiB | {card}", flush=True)
    torch.cuda.empty_cache()
    engines = serving_engines(torch, [quant.q8_matvec, quant.q8_rmsnorm_matvec,
                                      quant.q8_residual_rmsnorm_matvec, ds.decode_attention,
                                      ds.norm_residual])
    print(f"serving engines: monolithic {engines['monolithic']['actions_per_s']:.2f} actions/s "
          f"(p50 {engines['monolithic']['latency_ms_p50']:.1f} / p95 "
          f"{engines['monolithic']['latency_ms_p95']:.1f} ms, 8 clients), split "
          f"{engines['split']['actions_per_s']:.2f} actions/s (p50 "
          f"{engines['split']['latency_ms_p50']:.1f} / p95 "
          f"{engines['split']['latency_ms_p95']:.1f} ms, 16 clients) | {card}", flush=True)
    torch.cuda.empty_cache()
    ckpt = checkpoint_path(torch, path["requests"])
    print(f"checkpoint path: HF write {ckpt['hf_write']['s']:.2f} s / load "
          f"{ckpt['hf_load']['s']:.2f} s ({ckpt['hf_write']['bytes']} bytes), serving write "
          f"{ckpt['serving_write']['s']:.2f} s / load {ckpt['serving_load']['s']:.2f} s "
          f"({ckpt['serving_write']['bytes']} bytes), peak host RSS of the loads "
          f"{ckpt['hf_load']['rss_peak'] / 2**30:.2f} / {ckpt['serving_load']['rss_peak'] / 2**30:.2f} "
          f"GiB | {card}", flush=True)
    torch.cuda.empty_cache()
    serving = serving_configs(torch, serving_counters)

    flash = [fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv]
    train = train_path(torch, flash)
    reuse = train.pop("reuse")
    par, reuse["state"] = parallel_path(torch, flash, reuse)
    torch.cuda.empty_cache()
    model_par = model_parallel_training(torch, flash, reuse)
    del reuse
    torch.cuda.empty_cache()
    overfit = tiny_overfit(torch, flash)
    print(f"train path: median step {train['step_ms_median']:.2f} ms, "
          f"{train['tokens_per_s']:.1f} tokens/s, peak {train['peak_mem_gib']:.2f} GiB | {card}",
          flush=True)
    print("parallel path: median step ms " + ", ".join(
        f"{k} {statistics.median(v['step_ms']):.2f} (peak {v['peak_gib']:.2f} GiB)"
        for k, v in par["steps"].items()) + f"; the phase {par['phase_s']:.1f} s | {card}",
        flush=True)
    print("model parallel training: median step ms " + ", ".join(
        f"{k} {statistics.median(v['step_ms']):.2f} (peak {v['peak_gib']:.2f} GiB)"
        for k, v in model_par.items() if isinstance(v, dict))
        + f"; the phase {model_par['phase_s']:.1f} s | {card}", flush=True)
    torch.cuda.empty_cache()
    t_earlier = time.perf_counter() - t_start  # the build and every phase before LoRA
    lora, tuned = finetune_path(torch, flash)
    torch.cuda.empty_cache()
    t_lora = time.perf_counter() - t_start - t_earlier
    evals = eval_path(torch, [quant.q8_matvec, quant.q8_rmsnorm_matvec,
                              quant.q8_residual_rmsnorm_matvec, ds.decode_attention,
                              ds.norm_residual], tuned)
    del tuned
    t_eval = time.perf_counter() - t_start - t_earlier - t_lora
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    data_cli = data_cli_path(torch, flash, work_root=data_cli_work_root())
    t_data_cli = time.perf_counter() - t0
    torch.cuda.empty_cache()
    tensor = tensor_parallel_path(torch, timer, results, notes)
    print(f"finetune path: LoRA step median {lora['step_ms_median']:.2f} ms, "
          f"{lora['tokens_per_s']:.1f} tokens/s, peak {lora['peak_mem_gib']:.2f} GiB; checkpoint "
          f"write {lora['saves'][lora['restore']['step']]['s']:.3f} s / restore "
          f"{lora['restore']['s']:.3f} s ({lora['restore']['bytes']} bytes); resume "
          f"{'bit-exact' if lora['resume']['bit_exact'] else 'not bit-exact'} | {card}",
          flush=True)
    pre, ft = data_cli["pretrain"], data_cli["finetune"]
    print(f"data cli path: reader {data_cli['reader']['decode_path']} (build "
          f"{data_cli['reader']['build_s']:.2f} s), golden max |diff| "
          f"{data_cli['golden']['max_abs']} / mean {data_cli['golden']['mean_abs']:.4f}; pretrain "
          f"({data_cli['room']['text_layers']} LM layers) steps {[round(t, 1) for t in pre['step_ms']]} "
          f"ms ({len(pre['step_ms_during_write'])} during a write), saves blocked "
          f"{[round(w['blocked_s'], 2) for w in pre['writes']]} s, written "
          f"{[round(w['write_s'], 2) for w in pre['writes']]} s, "
          f"{[w['bytes'] for w in pre['writes']]} bytes, peak {pre['peak_mem_gib']:.2f} GiB, host "
          f"RSS {pre['host_rss_peak_gib']:.2f} GiB; LoRA steps "
          f"{[round(t, 1) for t in ft['step_ms']]} ms, saves blocked "
          f"{[round(w['blocked_s'], 3) for w in ft['writes']]} s, written "
          f"{[round(w['write_s'], 3) for w in ft['writes']]} s; the phase {t_data_cli:.1f} s | "
          f"{card}", flush=True)
    print(f"eval path: {evals['serial']['episodes_per_s']:.3f} episodes/s serially, "
          f"{evals['parallel']['episodes_per_s']:.3f} with 4 envs through the engine (mean batch "
          f"{evals['parallel']['engine']['mean_batch_occupancy']:.2f}) | {card}", flush=True)
    wall = {"before_finetune_s": t_earlier, "finetune_path_s": t_lora, "eval_path_s": t_eval,
            "data_cli_path_s": t_data_cli, "tensor_parallel_s": tensor["phase_s"],
            "model_parallel_training_s": model_par["phase_s"]}
    print(f"wall time: {t_earlier:.1f} s to the end of the training phase (build included), "
          f"finetune path {t_lora:.1f} s, eval path {t_eval:.1f} s, data cli path "
          f"{t_data_cli:.1f} s, tensor parallel {tensor['phase_s']:.1f} s; in all "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print("detail: " + json.dumps({"build_s": build_s, "decode_step_2_layers": steps,
                                   "decode_step_matrix": matrix, "refused_shape_step": refused,
                                   "main_path": path, "serving_engines": engines,
                                   "checkpoint_path": ckpt,
                                   "serving_configs": serving, "tensor_parallel": tensor,
                                   "train_path": train,
                                   "parallel_path": par,
                                   "model_parallel_training": model_par,
                                   "tiny_overfit": overfit, "finetune_path": lora,
                                   "eval_path": evals, "data_cli_path": data_cli,
                                   "wall_s": wall,
                                   "kernel_times": results, "card": card}), flush=True)

    # launches on each kernel's path: the int8 serving path (q8, bf16-cache
    # attention, norm_residual), the refused-shape decode step (gelu_mul),
    # the serving configurations (q4, int8-cache attention), the training
    # path (flash)
    def launches(name, tiled=False):
        if name.startswith("flash"):
            return train["launches"][name], "train_path (5 steps)"
        if name == "gelu_mul":
            return (refused["launches"][name],
                    "refused_shape_step (one 26-layer step, int8 + int4 MLP in 24-column groups: "
                    "the gate|up kernel takes no gelu epilogue there)")
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
        if "gelu_epilogue" in r and not tiled:  # gate|up with gelu(gate) * up, beside its pair
            extra["gelu_epilogue"] = r["gelu_epilogue"]
        if "with_copy_ms" in r:
            extra["with_copy_ms"] = r["with_copy_ms"]
        head = [sh for sh in r["ms"] if sh.endswith("x265346")]
        if head and not tiled:  # the whole-vocabulary head (restrict_to_action_tokens=False)
            extra["whole_vocabulary_head"] = {
                sh: {"ms": r["ms"][sh], "plain_ms": r["plain_ms"][sh],
                     "bound_ms": r["bound"][sh][0], "bound_by": r["bound"][sh][1],
                     "library_ms": r["library_ms"][sh]} for sh in head}
        if "fma_ms" in r:  # the flash kernels: the CUDA route, the FMA kernels' time
            extra = {"cuda_route": r["cuda_route"], "fma_ms": r["fma_ms"][first],
                     "other_shapes": {
                         s: {"ms": r["ms"][s], "plain_ms": r["plain_ms"][s],
                             "bound_ms": r["bound"][s][0], "library_ms": r["library_ms"][s],
                             "fma_ms": r["fma_ms"].get(s)} for s in r["ms"] if s != first}}
            if "backward" in r:  # flex_attention's backward against the port's whole one
                extra["backward"] = r["backward"][first]
            # one loss and gradient of the training batch through each
            # parallel layout (parallel_path), and the one-rank group's step
            extra["parallel_path_launches"] = {
                **{run: v["launches"][name] for run, v in par["loss_and_grad"].items()},
                "process_group_ring_step": par["process_group"]["launches"][name]}
            # the model-axis phase: the first step of each mesh (n = 2, 4,
            # model 2 x sp 2, model 2 x pipe 2), then its three timed steps,
            # and the LoRA steps at n = 2 and model 2 x sp 2
            runs = {run: v for run, v in model_par.items() if isinstance(v, dict)}
            extra["model_parallel_training_launches"] = {
                **{f"{run}_first_step": v["first_launches"][name]
                   for run, v in runs.items() if "first_launches" in v},
                **{f"{run}_timed_steps": v["launches"][name] for run, v in runs.items()}}
            # both training CLIs over the RLDS fixture (3 steps each)
            extra["data_cli_path_launches"] = {run: data_cli[run]["launches"][name]
                                               for run in ("pretrain", "finetune")}
        kernels.append({
            "name": label, "route": "cuda", "source": f"spatialvla_tpu_torch/csrc/{source}",
            "kernel_sources": [f"spatialvla_tpu_torch/csrc/{s}" for s in sources],
            "replaces": replaces, "launches": n, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"][first], "plain_ms": r["plain_ms"][first], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": r["library_ms"][first], "shape": first,
            "tolerance": tol, "launches_on": run, "library_note": notes.get(name),
            "decode_graph_launches_per_replay": None if tiled else per_replay(name),
            "serving_engines_launches": None if tiled else {
                e: engines[e]["launches"][name] for e in engines
                if name in engines[e]["launches"]} or None,
            # the LoRA run's launches (6 steps) and the eval driver's (serial,
            # then 4 envs through its ServingEngine)
            "finetune_path_launches": None if tiled else lora["launches"].get(name),
            "eval_path_launches": None if tiled or name not in evals["serial"]["launches"]
            else {run: evals[run]["launches"][name] for run in ("serial", "parallel")},
            **extra,
        })
    # kernels #1 and #2 at the shard shapes of the tensor-parallel phase: one
    # entry a wrapper, its first shape (n = 2, o or qkv) in front and every
    # shard shape under "shard_shapes"; launches those of the phase's counted
    # requests (three a format and n, and the 2-row batch over data x model)
    for name in TP_KERNELS:
        source, replaces = KERNEL_SOURCES[name]
        r = results[name + "_tp"]
        first = next(iter(r["ms"]))
        bound_ms, bound_by = r["bound"][first]
        kernels.append({
            "name": name + "_tp", "route": "cuda", "source": f"spatialvla_tpu_torch/csrc/{source}",
            "kernel_sources": [f"spatialvla_tpu_torch/csrc/{source}"]
            + (["spatialvla_tpu_torch/csrc/q8_matvec.cu"] if name.startswith("q4") else []),
            "replaces": replaces, "launches": tensor["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"][first], "plain_ms": r["plain_ms"][first],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": r["library_ms"][first],
            "shape": first, "launches_on": "tensor_parallel (three requests a format and n_model, "
            "and the n_model=2 x n_data=2 batch)", "library_note": notes.get(name + "_tp"),
            "tolerance": "max|kernel - plain| / max|plain| < "
            + ("2e-2 (bf16 out)" if name.startswith("q4") else "1e-2"),
            "shard_shapes": {sh: {"ms": r["ms"][sh], "plain_ms": r["plain_ms"][sh],
                                  "bound_ms": r["bound"][sh][0], "bound_by": r["bound"][sh][1],
                                  "library_ms": r["library_ms"][sh],
                                  **({"library_matmul_alone_ms":
                                      r["library_matmul_alone_ms"][sh]}
                                     if "library_matmul_alone_ms" in r else {})}
                             for sh in r["ms"]},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
