"""Gemma2 decoder (port of spatialvla_tpu/models/gemma2.py).

Layers are stacked along a leading axis as in the JAX tree and run as a
Python loop over per-layer views (``unstack_layers``: one ``torch.unbind``
per stacked tensor, whose backward stacks the 26 layer gradients once; the
JAX package scans them). The KV cache is a static (L, B, S_max, Nkv, D)
buffer; ``forward`` writes the new rows into it IN PLACE and returns the
same dict (the JAX version returns a new cache). Sandwich RMSNorm, attention
softcap, query_pre_attn_scalar scaling, sqrt(hidden) embedding scale in the
activation dtype and fp32 RoPE follow the JAX module. Quantized serving trees
(fused ``qkv`` / ``gate_up``) take the same branches (gemma2.py:111-116,
:143-146). ``forward``, ``forward_flash``, ``forward_ring``,
``forward_pipeline``, ``embed_tokens`` and ``head_logits`` also take one
data group of a model-sharded tree
(``parallel/partitioning.py`` ShardGroup: ``SpatialVLAPolicy.shard`` for
serving, ``TrainShards.group`` for training, where gradients flow through
the model axis' collectives): a whole tree runs as a group of one, through
the same loop (``decoder_layer``).

``forward_flash`` (training) and ``prefill_flash`` (serving prefill) run
attention through the flash-attention kernels (ops/flash_attention.py).
With ``use_remat`` each window/global layer pair is recomputed in the
backward pass (``torch.utils.checkpoint``), as ``jax.checkpoint`` wraps the
JAX package's pair step. ``forward_ring`` (sequence parallelism) and
``forward_pipeline`` (GPipe stages) run the same pairs, through the same
``decoder_layer``, over a mesh's ``sp`` and ``pipe`` axes
(spatialvla_tpu_torch/parallel).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
from ..ops.quant import qmatmul, qnorm_matmul
from ..parallel.partitioning import as_group
from .attention import multi_head_attention
from .layers import gelu_tanh, normal_init, rms_norm, softcap, zeros
from .rope import apply_rope, rope_cos_sin

Params = Dict[str, Any]


def init_params(cfg, *, generator, device, dtype=torch.float32) -> Params:
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    Nq, Nkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(device=device, dtype=dtype)
    n = lambda shape: normal_init(generator, shape, **kw)  # noqa: E731
    params = {
        "embed": n((cfg.vocab_size, H)),
        "layers": {
            "attn": {
                "q": n((L, H, Nq * D)),
                "k": n((L, H, Nkv * D)),
                "v": n((L, H, Nkv * D)),
                "o": n((L, Nq * D, H)),
            },
            "mlp": {"gate": n((L, H, I)), "up": n((L, H, I)), "down": n((L, I, H))},
            "input_norm": zeros((L, H), **kw),
            "post_attn_norm": zeros((L, H), **kw),
            "pre_ffn_norm": zeros((L, H), **kw),
            "post_ffn_norm": zeros((L, H), **kw),
        },
        "final_norm": zeros((H,), **kw),
    }
    if not cfg.tie_lm_head:
        params["lm_head"] = n((H, cfg.vocab_size))
    return params


def init_cache(cfg, batch: int, max_len: int, *, device, dtype=torch.bfloat16) -> Params:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def layer_slice(tree, l: int):
    """Layer l of a stacked (L, ...) parameter tree."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, l) for k, v in tree.items()}
    return tree[l]


def unstack_layers(tree, L: int) -> List[Params]:
    """The L per-layer views of a stacked (L, ...) tree, from one
    ``torch.unbind`` per tensor: its backward stacks the layer gradients
    once, where indexing each layer would add L full-size gradients."""
    if isinstance(tree, dict):
        parts = {k: unstack_layers(v, L) for k, v in tree.items()}
        return [{k: v[l] for k, v in parts.items()} for l in range(L)]
    return list(torch.unbind(tree, 0))


def remat(fn, use_remat: bool):
    """fn, recomputed in the backward pass when use_remat (jax.checkpoint)."""
    if not use_remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# layer body
# ---------------------------------------------------------------------------

def _qkv(lp, cfg, h, norm_w):
    """q (B, T, Nq, D), k and v (B, T, Nkv, D), before RoPE, from the
    pre-norm residual, for the plain and the fused-quantized trees (from
    the normed residual where ``norm_w`` is None)."""
    B, T, H = h.shape
    Nq, Nkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "qkv" in lp:  # fused quantized serving tree (norm fused into the kernel)
        qkv = qnorm_matmul(h, norm_w, lp["qkv"], eps=cfg.rms_norm_eps)
        q, k, v = torch.split(qkv, [Nq * D, Nkv * D, Nkv * D], dim=-1)
    else:
        x = h if norm_w is None else rms_norm(norm_w, h, cfg.rms_norm_eps)
        q, k, v = qmatmul(x, lp["q"]), qmatmul(x, lp["k"]), qmatmul(x, lp["v"])
    return q.reshape(B, T, Nq, D), k.reshape(B, T, Nkv, D), v.reshape(B, T, Nkv, D)


def _attention_block(lp, cfg, h, norm_w, cos, sin, mask, cache_kv, cache_position):
    B, T, H = h.shape
    q, k, v = _qkv(lp, cfg, h, norm_w)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)

    if cache_kv is not None:  # write the new rows in place, attend over the cache
        ck, cv = cache_kv
        ck[:, cache_position : cache_position + T] = k.to(ck.dtype)
        cv[:, cache_position : cache_position + T] = v.to(cv.dtype)
        k, v = ck.to(h.dtype), cv.to(h.dtype)

    out = multi_head_attention(
        q, k, v, mask, scale=cfg.query_pre_attn_scalar ** -0.5,
        logit_softcap=cfg.attn_logit_softcap,
    )
    return qmatmul(out.reshape(B, T, -1).to(h.dtype), lp["o"])


def _mlp_block(lp, h, norm_w, eps):
    """The MLP from the pre-norm residual (from the normed residual where
    ``norm_w`` is None, the plain tree only)."""
    if "gate_up" in lp:  # fused quantized serving tree (norm fused)
        gu = qnorm_matmul(h, norm_w, lp["gate_up"], eps=eps)
        gate, up = torch.chunk(gu, 2, dim=-1)
        return qmatmul(gelu_tanh(gate) * up, lp["down"])
    x = h if norm_w is None else rms_norm(norm_w, h, eps)
    gate = gelu_tanh(qmatmul(x, lp["gate"]))
    up = qmatmul(x, lp["up"])
    return qmatmul(gate * up, lp["down"])


def decoder_layer(tp, l: int, cfg, h, attend, *aux):
    """Layer l over the model shards of ``tp`` (``parallel/partitioning.py``
    ShardGroup; a whole tree's is a group of one): each shard of the
    attention runs ``attend(s, l, lp, tcfg, h, *aux)`` (shard s's attention
    output before the ``o`` sum, from its layer tree ``lp`` and its q and kv
    heads ``tcfg``; ``input_norm_of(lp)`` is the norm it applies, None
    where it is given the normed residual), each shard of the MLP ``_mlp_block``
    over its hidden columns, and their partial ``o`` / ``down`` products are
    summed (``ShardSum``). The residual stream and the norms stay on the
    group's home device, where the plain tree's pre-norms run once, before
    the shards (so a norm's gradient is whole on every shard); the fused
    quantized tree's run in each shard's kernel. ``aux`` goes to each
    shard's device."""
    lps = tp.layers("lm", cfg.num_layers)
    lp = lps[0][l]
    tcfg, eps = tp.text_cfg(cfg), cfg.rms_norm_eps
    x = h if "qkv" in lp["attn"] else rms_norm(lp["input_norm"], h, eps)
    attn_out = tp.reduce("lm_attn", lambda s, tree, x, *aux: attend(s, l, lps[s][l], tcfg, x, *aux),
                         x, *aux)
    h = h + rms_norm(lp["post_attn_norm"], attn_out, eps)
    fused = "gate_up" in lp["mlp"]
    x = h if fused else rms_norm(lp["pre_ffn_norm"], h, eps)
    mlp_out = tp.reduce("lm_mlp", lambda s, tree, x: _mlp_block(
        lps[s][l]["mlp"], x, lps[s][l]["pre_ffn_norm"] if fused else None, eps), x)
    return h + rms_norm(lp["post_ffn_norm"], mlp_out, eps)


def input_norm_of(lp):
    """The input norm weight a shard's attention applies: the fused
    quantized tree's (inside its kernel), None for the plain tree, whose
    norm ``decoder_layer`` applies before the shards."""
    return lp["input_norm"] if "qkv" in lp["attn"] else None


def _scaled(cfg, inputs_embeds):
    """The embeddings times sqrt(hidden), in their dtype."""
    normalizer = torch.tensor(cfg.hidden_size ** 0.5, dtype=inputs_embeds.dtype,
                              device=inputs_embeds.device)
    return inputs_embeds * normalizer


def make_masks(cfg, base_mask, q_positions, k_positions):
    """(global_mask, sliding_mask): the sliding mask additionally requires
    q_pos - k_pos < window. k_positions is (S,) or per-row (B, S)."""
    if k_positions.dim() == 1:
        k_positions = k_positions[None, :]
    delta = q_positions[:, :, None] - k_positions[:, None, :]
    within = (delta < cfg.sliding_window)[:, None]
    return base_mask, base_mask & within


def _prepare(cfg, inputs_embeds, position_ids, base_mask, cache_len, cache_position,
             window_positions):
    """The scaled embeddings, RoPE tables and (global, sliding) masks of a
    masked forward over ``cache_len`` key slots."""
    B, T, H = inputs_embeds.shape
    dev = inputs_embeds.device
    h = _scaled(cfg, inputs_embeds)
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)
    start = cache_position if cache_position is not None else 0
    k_positions = torch.arange(cache_len, device=dev)
    q_positions = (torch.arange(T, device=dev)[None, :] + start).expand(B, T)
    if window_positions is not None:
        q_positions, k_positions = window_positions
    return (h, cos, sin) + make_masks(cfg, base_mask, q_positions, k_positions)


def forward(
    params,  # the LM tree, or a ShardGroup of model shards
    cfg,
    inputs_embeds: torch.Tensor,  # (B, T, H), unscaled
    position_ids: torch.Tensor,  # (B, T) 1-indexed RoPE positions
    base_mask: torch.Tensor,  # (B, 1, T, S) bool
    *,
    cache=None,  # a whole tree's cache dict, or a list of one a shard (init_caches)
    cache_position: Optional[int] = None,  # first cache slot to write
    window_positions: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    use_remat: bool = False,
):
    """Runs the decoder stack; returns (final_norm(h), cache). With a cache,
    the rows are written into it in place and the same cache is returned.
    ``params`` is the LM tree or one data group of a sharded serving tree
    (``decoder_layer``), whose caches ``init_caches`` makes. use_remat
    recomputes each layer in the backward pass (training, no cache)."""
    tp = as_group(params, "lm")
    caches = [cache] if isinstance(cache, dict) else cache
    if use_remat and caches is not None:
        raise ValueError("use_remat is for training; it takes no cache")
    T = inputs_embeds.shape[1]
    start = cache_position if cache_position is not None else 0
    S = caches[0]["k"].shape[2] if caches is not None else T
    h, cos, sin, mask_global, mask_sliding = _prepare(
        cfg, inputs_embeds, position_ids, base_mask, S, cache_position, window_positions)

    def attend(s, l, lp, tcfg, h, mask, cos, sin):
        cache_kv = None if caches is None else (caches[s]["k"][l], caches[s]["v"][l])
        return _attention_block(lp["attn"], tcfg, h, input_norm_of(lp), cos, sin, mask, cache_kv,
                                start)

    tp.layers("lm", cfg.num_layers)  # the per-layer views, outside any recomputation
    layer = remat(lambda h, l, mask: decoder_layer(tp, l, cfg, h, attend, mask, cos, sin),
                  use_remat)
    for l in range(cfg.num_layers):
        h = layer(h, l, mask_sliding if l % 2 == 0 else mask_global)  # even layers slide
    return rms_norm(tp.trees[0]["lm"]["final_norm"], h, cfg.rms_norm_eps), cache


# ---------------------------------------------------------------------------
# the caches, the embedding and the greedy head over the model shards
# ---------------------------------------------------------------------------

def init_caches(params, cfg, batch: int, max_len: int, *, device=None,
                dtype=torch.bfloat16) -> List[Params]:
    """One cache a shard of the attention of ``params`` (the LM tree: one
    cache, on ``device``; a ShardGroup: over each shard's kv heads, on its
    device)."""
    tp = as_group(params, "lm")
    tcfg = tp.text_cfg(cfg)
    return [init_cache(tcfg, batch, max_len, dtype=dtype,
                       device=device if tp.devices[s] is None else tp.devices[s])
            for s in tp.shards("lm_attn")]


def _embed_rows(s, tree, ids):
    """Shard s's rows of a vocabulary cut for ``ids``, the ids outside them zero."""
    table = tree["lm"]["embed"]
    rows = table.shape[0]
    local = ids - s * rows
    ok = (local >= 0) & (local < rows)
    emb = table[local.clamp(0, rows - 1)]
    return torch.where(ok[..., None], emb, torch.zeros_like(emb))


def embed_tokens(params, input_ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """The embedding rows of ``input_ids`` from the LM tree or a ShardGroup.
    Over a vocabulary cut each shard looks up the ids of its rows (the others
    masked to zero) and ``sum_shards`` adds them, so every row is the
    table's own (the gradient reaches each row's shard). Gathered first,
    then cast: the same values as casting the table first."""
    tp = as_group(params, "lm")
    if tp.is_cut("vocab"):
        emb = tp.reduce("vocab", lambda s, tree, ids: _embed_rows(tp.ids[s], tree, ids),
                        input_ids)
    else:
        emb = tp.trees[0]["lm"]["embed"][input_ids]
    return emb if dtype is None else emb.to(dtype)


def _head_of(lm: Params):
    return lm["lm_head"] if "lm_head" in lm else lm["embed"].t()


def head_logits(params, cfg, hidden: torch.Tensor, token_range=None, *,
                full_logits: bool = False) -> torch.Tensor:
    """The logits of the greedy head of the LM tree or a ShardGroup, in id
    order: the head's rows [begin, begin + size) of ``token_range`` (None:
    every id) as ``qmatmul`` gives them, or with ``full_logits``
    ``compute_logits``' softcapped fp32 ones. Over a vocabulary cut each
    shard computes the rows it holds inside the range (a shard holding none
    computes nothing) and the blocks are joined in order on the home device,
    so argmax and margins over them are those of the whole vector."""
    from ..ops.quant import is_quantized

    tp = as_group(params, "lm")
    V = cfg.vocab_size
    lo, hi = (0, V) if token_range is None else (token_range[0], token_range[0] + token_range[1])
    width = V // tp.n if tp.is_cut("vocab") else V
    parts = []
    for s in tp.shards("vocab"):
        first = tp.ids[s] * width
        a, b = max(lo, first), min(hi, first + width)
        if a >= b:
            continue
        head = _head_of(tp.trees[s]["lm"])
        i, j = a - first, b - first
        head = ({"qt": head["qt"][i:j], "scale": head["scale"][i:j]} if is_quantized(head)
                else head[:, i:j])
        x = hidden if tp.devices[s] is None else hidden.to(tp.devices[s])
        if full_logits:
            parts.append(compute_logits({"lm_head": head}, cfg, x))
        else:
            parts.append(qmatmul(x, head))
    parts = [tp.to_home(p) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


# ---------------------------------------------------------------------------
# flash-attention forward (training) and serving prefill
# ---------------------------------------------------------------------------

def _flash(q, k, v, prefix_lens, valid_lens, cfg, window):
    """Unsharded flash attention over q's whole sequence (q_offset 0)."""
    return flash_attention(q, k, v, prefix_lens, valid_lens, torch.zeros_like(prefix_lens),
                           cfg.query_pre_attn_scalar ** -0.5, cfg.attn_logit_softcap, window, True)


def _attention_block_flash(lp, cfg, h, norm_w, cos, sin, prefix_lens, valid_lens, window,
                           attention=_flash):
    """Attention through the flash kernels from the pre-norm residual, for
    the plain (training, gemma2.py:202) and the fused-quantized (serving
    prefill, :291) trees; returns (attn_out, k, v), k roped. ``attention``
    is ``_flash`` or a ring's (``forward_ring``)."""
    B, T, H = h.shape
    q, k, v = _qkv(lp, cfg, h, norm_w)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    out = attention(q, k, v, prefix_lens, valid_lens, cfg, window)
    return qmatmul(out.reshape(B, T, -1).to(h.dtype), lp["o"]), k, v


def _decoder_layer_flash(cfg, h, lp, cos, sin, prefix_lens, valid_lens, window):
    """One decoder layer through the flash kernels; returns (h, k, v)."""
    attn_out, k, v = _attention_block_flash(lp["attn"], cfg, h, lp["input_norm"], cos, sin,
                                            prefix_lens, valid_lens, window)
    h = h + rms_norm(lp["post_attn_norm"], attn_out, cfg.rms_norm_eps)
    mlp_out = _mlp_block(lp["mlp"], h, lp["pre_ffn_norm"], cfg.rms_norm_eps)
    return h + rms_norm(lp["post_ffn_norm"], mlp_out, cfg.rms_norm_eps), k, v


def _flash_pairs(tp, cfg, h, cos, sin, prefix_lens, valid_lens, pairs, *, use_remat: bool,
                 attention=_flash):
    """The window/global layer pairs ``pairs`` (pair i: layers 2i, 2i + 1)
    of the ShardGroup ``tp`` through ``decoder_layer``, each shard's
    attention through ``attention`` over its own heads; each pair one
    checkpoint under use_remat."""
    def attend(s, l, lp, tcfg, h, cos, sin, prefix_lens, valid_lens):
        window = cfg.sliding_window if l % 2 == 0 else None  # even layers slide
        return _attention_block_flash(lp["attn"], tcfg, h, input_norm_of(lp), cos, sin,
                                      prefix_lens, valid_lens, window, attention)[0]

    def pair(h, l):
        h = decoder_layer(tp, l, cfg, h, attend, cos, sin, prefix_lens, valid_lens)
        return decoder_layer(tp, l + 1, cfg, h, attend, cos, sin, prefix_lens, valid_lens)

    tp.layers("lm", cfg.num_layers)  # the per-layer views, outside any recomputation
    pair = remat(pair, use_remat)
    for i in pairs:
        h = pair(h, 2 * i)
    return h


def _even_layers(cfg, what: str):
    if cfg.num_layers % 2:
        raise ValueError(f"{what} runs window/global layer pairs: num_layers must be even")


def forward_flash(params, cfg, inputs_embeds: torch.Tensor, position_ids: torch.Tensor,
                  prefix_lens: torch.Tensor, valid_lens: torch.Tensor, *,
                  use_remat: bool = False) -> torch.Tensor:
    """Full-sequence forward through the flash kernels (gemma2.py:247), from
    the LM tree or over the model shards of a ShardGroup (``decoder_layer``:
    each shard's attention calls the kernels over its own heads): layer
    pairs (even layer windowed, odd global), each pair one checkpoint under
    use_remat. prefix_lens (B,) is the bidirectional-prefix boundary (0 =
    causal), valid_lens (B,) the right-pad boundary."""
    tp = as_group(params, "lm")
    _even_layers(cfg, "forward_flash")
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)
    h = _flash_pairs(tp, cfg, _scaled(cfg, inputs_embeds), cos, sin, prefix_lens.to(torch.int32),
                     valid_lens.to(torch.int32), range(cfg.num_layers // 2),
                     use_remat=use_remat)
    return rms_norm(tp.trees[0]["lm"]["final_norm"], h, cfg.rms_norm_eps)


def forward_ring(params, cfg, inputs_embeds: torch.Tensor, position_ids: torch.Tensor,
                 prefix_lens: torch.Tensor, valid_lens: torch.Tensor, *, mesh,
                 axis_name: str = "sp", use_remat: bool = False) -> torch.Tensor:
    """Sequence-parallel forward (gemma2.py:390-458): forward_flash's layer
    pairs with attention through ring attention over ``axis_name``
    (parallel/ring_attention.py), from the LM tree or over the model shards
    of a ShardGroup, each shard running its own ring over its own q and kv
    heads (on a ``Mesh`` over the sp group of its model rank).
    ``inputs_embeds`` / ``position_ids`` span the whole sequence; the QKV and
    MLP matmuls run on the positions this process holds (``seq_shard``: all
    of them on a ``LocalMesh``, this rank's 1/n on a ``Mesh``), and so does
    the result. ``prefix_lens`` / ``valid_lens`` (B,) are global."""
    from ..parallel.ring_attention import ring_flash_attention, seq_shard

    tp = as_group(params, "lm")
    _even_layers(cfg, "forward_ring")
    start, stop = seq_shard(mesh, inputs_embeds.shape[1], axis_name)
    cos, sin = rope_cos_sin(position_ids[:, start:stop], cfg.head_dim, cfg.rope_theta)

    def ring(q, k, v, prefix_lens, valid_lens, tcfg, window):
        return ring_flash_attention(q, k, v, prefix_lens, valid_lens, mesh=mesh,
                                    axis_name=axis_name, scale=tcfg.query_pre_attn_scalar ** -0.5,
                                    logit_softcap=tcfg.attn_logit_softcap, window=window)

    h = _flash_pairs(tp, cfg, _scaled(cfg, inputs_embeds[:, start:stop]), cos, sin,
                     prefix_lens.to(torch.int32), valid_lens.to(torch.int32),
                     range(cfg.num_layers // 2), use_remat=use_remat, attention=ring)
    return rms_norm(tp.trees[0]["lm"]["final_norm"], h, cfg.rms_norm_eps)


def stage_pairs(n_pairs: int, S: int) -> List[Tuple[int, int]]:
    """[start, stop) of each stage's window/global layer pairs: the balanced
    partition of gemma2.py:497-505 (13 pairs: 7+6 at S=2, 4+3+3+3 at S=4)."""
    base, rem = divmod(n_pairs, S)
    counts = [base + (s < rem) for s in range(S)]
    starts = [sum(counts[:s]) for s in range(S)]
    return [(a, a + c) for a, c in zip(starts, counts)]


def forward_pipeline(params, cfg, inputs_embeds: torch.Tensor,
                     position_ids: torch.Tensor, prefix_lens: torch.Tensor,
                     valid_lens: torch.Tensor, *, mesh, axis_name: str = "pipe",
                     n_microbatches: int = 0, use_remat: bool = False) -> torch.Tensor:
    """Pipeline-parallel forward (gemma2.py:461-555): the layer pairs split
    into S = ``mesh.shape[axis_name]`` stages by ``stage_pairs`` under GPipe
    microbatching (parallel/pipeline.py); each stage runs forward_flash's
    pairs, from the LM tree or over the model shards of a ShardGroup, each
    pair one checkpoint under ``use_remat``. A stage's weights are its
    layers' views in every shard this process holds ({layer: tree} a
    shard), which the pipeline hands to ``stage_fn`` as leaves of their own
    graph and ``ShardGroup.with_layers`` makes a group of again. A short
    stage runs its own pairs and none padded (JAX pads to the longest stage
    and masks the padded pairs to identity). The default microbatch count is
    the largest divisor of B that is at most S."""
    from ..parallel.pipeline import pipeline_apply

    tp = as_group(params, "lm")
    L = cfg.num_layers
    _even_layers(cfg, "forward_pipeline")
    S = mesh.shape[axis_name]
    if S > L // 2:
        raise ValueError(f"{S} stages exceed the {L // 2} layer pairs")
    B = inputs_embeds.shape[0]
    m = n_microbatches or max(d for d in range(1, min(S, B) + 1) if B % d == 0)
    views = tp.layers("lm", L)
    stages = [[{l: shard[l] for l in range(2 * a, 2 * b)} for shard in views]
              for a, b in stage_pairs(L // 2, S)]

    def stage_fn(stage, x, aux):
        layers = sorted(stage[0])
        cos, sin = rope_cos_sin(aux["position_ids"], cfg.head_dim, cfg.rope_theta)
        return _flash_pairs(tp.with_layers("lm", stage), cfg, x, cos, sin, aux["prefix_lens"],
                            aux["valid_lens"], range(layers[0] // 2, layers[-1] // 2 + 1),
                            use_remat=use_remat)

    aux = {"position_ids": position_ids, "prefix_lens": prefix_lens.to(torch.int32),
           "valid_lens": valid_lens.to(torch.int32)}
    out = pipeline_apply(stage_fn, stages, _scaled(cfg, inputs_embeds), aux, mesh=mesh,
                         n_microbatches=m, axis_name=axis_name)
    return rms_norm(tp.trees[0]["lm"]["final_norm"], out, cfg.rms_norm_eps)


def prefill_flash(params: Params, cfg, inputs_embeds: torch.Tensor, position_ids: torch.Tensor,
                  cache_len: int, cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Params]:
    """Serving prefill over an unpadded, fully bidirectional prefix through
    the flash forward kernel (gemma2.py:331): returns (final-normed hidden,
    cache in ``cache_dtype``) with the roped k / v rows in cache slots
    [0, P) and zeros after."""
    B, P, H = inputs_embeds.shape
    dev = inputs_embeds.device
    h = _scaled(cfg, inputs_embeds)
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)
    lens = torch.full((B,), P, dtype=torch.int32, device=dev)
    cache = init_cache(cfg, B, cache_len, device=dev, dtype=cache_dtype)
    for l, lp in enumerate(unstack_layers(params["layers"], cfg.num_layers)):
        window = cfg.sliding_window if l % 2 == 0 else None  # even layers slide
        h, k, v = _decoder_layer_flash(cfg, h, lp, cos, sin, lens, lens, window)
        cache["k"][l, :, :P] = k.to(cache_dtype)
        cache["v"][l, :, :P] = v.to(cache_dtype)
    return rms_norm(params["final_norm"], h, cfg.rms_norm_eps), cache


def compute_logits(params: Params, cfg, hidden: torch.Tensor, dtype=torch.float32):
    """lm_head + final logit softcap, fp32 accumulation."""
    head = params["lm_head"] if "lm_head" in params else params["embed"].t()
    if isinstance(head, dict):
        logits = qmatmul(hidden, head).to(dtype)
    else:
        logits = (hidden.float() @ head.to(hidden.dtype).float()).to(dtype)
    return softcap(logits, cfg.final_logit_softcap)


def causal_base_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, T) padding mask -> (B, 1, T, T) causal bool mask."""
    B, T = attention_mask.shape
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=attention_mask.device))
    return causal[None, None] & attention_mask.bool()[:, None, None, :]
