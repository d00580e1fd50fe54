"""SpatialVLA fusion model (port of spatialvla_tpu/models/spatialvla.py):
SigLIP + ZoeDepth -> Ego3D -> projector image features, the spatial-token
embedding override, the training forward and loss, a masked or flash Gemma2
prefill over the prefix, and greedy decoding restricted to the action-token
block.

Training: ``forward`` (spatialvla.py:195) with ``attn_backend`` "xla" (the
masked forward) or "flash" (``gemma2.forward_flash`` through the
flash-attention kernels); the ZoeDepth branch runs under ``torch.no_grad``
(``jax.lax.stop_gradient`` at :139). "ring" and "pipeline" run the sp ring
and the GPipe stages of ``parallel/``.

Decoding keeps the two JAX paths and the JAX rule for choosing between them
(spatialvla.py:474-481): the fused path (one ``fused_decode_step`` per token,
ops/decode_step.py) for the fused-quantized tree with B <= 16 and
S <= sliding window on CUDA tensors, else the unfused loop through
``gemma2.forward``. Cache writes go in place. Where JAX compiles the fused
loop's ``scan`` into one program per shape, the port replays it as one CUDA
graph per shape (``GreedyLoop``, ``DecodeGraphs``; ``use_cuda_graph``).
``kv_bits=8`` serves the fused path from an int8 KV cache with per-slot
scales. ``use_flash_prefill`` (off by default, as in JAX) runs the prefill
through ``gemma2.prefill_flash``.

Split-phase serving (``serve/split_engine.py``): ``prefill_for_serving``,
``init_serving_state``, ``admit_rows_serving``, ``decode_steps_serving``
(the fused step, or ``xla_decode_step`` in plain torch ops) on a state
written in place, replayed as one CUDA graph by ``ServingLoop``.

Over the model axis the serving functions (``SpatialVLAPolicy.shard``) and
``forward`` (training, "xla" and "flash": ``parallel.TrainShards.group``)
take one data group of the sharded tree (``parallel/partitioning.py:
ShardGroup``) in place of ``params``: SigLIP, the projector, the LM's attention and MLP,
the embedding and the greedy head run over the model shards, ZoeDepth and
Ego3D once on the group's home device. A whole tree runs through the same
code as a group of one (``as_group``). As in JAX, the decode loop over a
mesh is the unfused one (``use_fused_decode`` is refused) and the
split-phase decode is ``xla_decode_step`` over each shard's kv heads.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import torch

from . import ego3d as ego3d_mod
from . import gemma2 as gemma2_mod
from . import siglip as siglip_mod
from . import zoe as zoe_mod
from .layers import normal_init, zeros
from ..parallel.mesh import LocalMesh
from ..parallel.partitioning import as_group
from ..ops.quant import is_quantized, qmatmul

Params = Dict[str, Any]

SIGLIP_MEAN = 0.5
SIGLIP_STD = 0.5


def init_params(cfg, *, generator: torch.Generator, device, dtype=torch.float32) -> Params:
    """Random init with the JAX tree's keys and shapes (spatialvla.py:47)."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    params = {
        "vision": siglip_mod.init_params(cfg.vision, **kw),
        "projector": {
            "w": normal_init(generator, (cfg.vision.hidden_size, cfg.text.hidden_size),
                             device=device, dtype=dtype),
            "b": zeros((cfg.text.hidden_size,), device=device, dtype=dtype),
        },
        "lm": gemma2_mod.init_params(cfg.text, **kw),
    }
    if cfg.use_spatial_token:
        params["spatial_embed"] = normal_init(
            generator, (cfg.spatial_token_num, cfg.text.hidden_size), device=device, dtype=dtype
        )
    if cfg.use_vision_zoe:
        params["ego3d"] = ego3d_mod.init_params(cfg.ego3d, **kw)
        if cfg.zoe is not None:
            params["zoe"] = zoe_mod.init_params(cfg.zoe, **kw)
    return params


def prefix_lm_mask(attention_mask: torch.Tensor, token_type_ids: torch.Tensor) -> torch.Tensor:
    """(B, T) pad mask + (B, T) token types (0 = prefix) -> (B, 1, T, T)
    bool: allowed(q, k) = pad[k] & (k <= q | is_prefix[k]) (spatialvla.py:74)."""
    T = attention_mask.shape[1]
    pad = attention_mask.bool()
    prefix = (token_type_ids == 0) & pad
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=pad.device))
    allowed = causal[None] | prefix[:, None, :]
    return (allowed & pad[:, None, :])[:, None]


def bidirectional_prefill_mask(prefix_len: int, cache_len: int, batch: int, device=None):
    """Fully bidirectional over an unpadded prefix; keys limited to written slots."""
    k_ok = torch.arange(cache_len, device=device) < prefix_len
    return k_ok.expand(batch, 1, prefix_len, cache_len)


def get_image_features(params: Params, cfg, pixel_values: torch.Tensor,
                       intrinsic: Optional[torch.Tensor], *,
                       depth: Optional[torch.Tensor] = None, use_remat: bool = False,
                       compute_dtype=None,
                       depth_image_size: Optional[int] = None) -> torch.Tensor:
    """(B, H, W, 3) raw [0, 1] NHWC pixels (or (B, k, H, W, 3)) -> (B, k*N,
    lm_hidden) projected features, scaled by hidden**-0.5. ``depth`` (B, H, W)
    overrides the ZoeDepth estimate; either way no gradient flows into it."""
    if compute_dtype is not None:
        pixel_values = pixel_values.to(compute_dtype)
    multi_obs = pixel_values.dim() == 5
    if multi_obs:
        B, k = pixel_values.shape[:2]
        pixel_values = pixel_values.reshape((B * k,) + tuple(pixel_values.shape[2:]))
        if intrinsic is not None:
            intrinsic = intrinsic.repeat_interleave(k, dim=0)
        if depth is not None:
            depth = depth.reshape((B * k,) + tuple(depth.shape[2:]))
    tp = as_group(params)
    params = tp.trees[0]  # the replicated leaves, on the group's home device
    normed = (pixel_values - SIGLIP_MEAN) / SIGLIP_STD
    feats = siglip_mod.forward(tp, cfg.vision, normed, use_remat=use_remat)
    if cfg.use_vision_zoe:
        with torch.no_grad():  # frozen depth branch (stop_gradient, spatialvla.py:139)
            if depth is None:
                depth = zoe_mod.predict_depth(
                    params["zoe"], cfg.zoe, pixel_values,
                    target_hw=tuple(pixel_values.shape[1:3]), image_size=depth_image_size,
                )
        xyz = ego3d_mod.backproject_patch(
            intrinsic, depth, image_size=cfg.vision.image_size,
            patch_size=cfg.vision.patch_size, reso=cfg.ego3d.patch_reso,
        )
        feats = feats + ego3d_mod.forward(params["ego3d"], cfg.ego3d, xyz, dtype=feats.dtype)
    # the output columns over the model shards, joined before the scale
    feats = tp.gather("projector", lambda s, tree, f: _project(tree["projector"], f), feats)
    feats = feats / (cfg.text.hidden_size ** 0.5)
    if multi_obs:
        feats = feats.reshape(B, -1, feats.shape[-1])
    return feats


def _project(proj: Params, feats: torch.Tensor) -> torch.Tensor:
    return qmatmul(feats, proj["w"]) + proj["b"].to(feats.dtype)


def merge_input_embeddings(params: Params, cfg, input_ids: torch.Tensor,
                           image_features: Optional[torch.Tensor], dtype=None):
    """Token embeddings with the spatial-token table overriding the action
    ids, and image features scattered into the <image> positions."""
    tp = as_group(params)
    embeds = gemma2_mod.embed_tokens(tp, input_ids, dtype=dtype)
    params = tp.trees[0]
    if cfg.use_spatial_token and "spatial_embed" in params:
        begin = cfg.action_token_begin_idx
        is_spatial = (input_ids >= begin) & (input_ids < begin + cfg.spatial_token_num)
        local = torch.clamp(input_ids - begin, 0, cfg.spatial_token_num - 1)
        spatial = params["spatial_embed"][local].to(embeds.dtype)
        embeds = torch.where(is_spatial[..., None], spatial, embeds)
    if image_features is not None:
        is_image = input_ids == cfg.image_token_index
        slot = torch.clamp(torch.cumsum(is_image.long(), dim=1) - 1, 0,
                           image_features.shape[1] - 1)
        gathered = torch.gather(
            image_features.to(embeds.dtype), 1,
            slot[..., None].expand(*slot.shape, image_features.shape[-1]),
        )
        embeds = torch.where(is_image[..., None], gathered, embeds)
    return embeds


# ---------------------------------------------------------------------------
# training / full forward
# ---------------------------------------------------------------------------

def forward(
    params: Params,
    cfg,
    input_ids: torch.Tensor,  # (B, T)
    *,
    pixel_values: Optional[torch.Tensor] = None,
    intrinsic: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    depth: Optional[torch.Tensor] = None,
    use_remat: bool = False,
    compute_dtype=None,
    attn_backend: str = "xla",  # "xla" | "flash" | "ring" (SP) | "pipeline" (PP)
    mesh=None,  # "ring" / "pipeline": a parallel.Mesh or LocalMesh
    pp_microbatches: int = 0,  # "pipeline": GPipe microbatches (0: one a stage)
    with_logits: bool = True,
) -> Dict[str, torch.Tensor]:
    """Full forward without a cache (spatialvla.py:195). Returns {'hidden'}
    and, with_logits, 'logits' (and 'loss' with labels). "flash", "ring" and
    "pipeline" derive the bidirectional-prefix length from token_type_ids
    (the first suffix token, or the valid length) as spatialvla.py:232-239
    does. "ring" runs ``gemma2.forward_ring`` over the mesh's sp axis: on a
    process-group ``Mesh`` 'hidden' (and 'logits') hold this rank's
    sequence shard only, and labels are refused (the train step takes each
    rank's part of the loss); "pipeline" runs ``gemma2.forward_pipeline``
    over its pipe axis, every stage ending with the whole hidden. ``params``
    may be a ShardGroup of model shards, with any backend (with_logits=False:
    the train step's loss reduces over the vocabulary cut)."""
    if attn_backend not in ("xla", "flash", "ring", "pipeline"):
        raise ValueError(f"unknown attn_backend {attn_backend!r}")
    if attn_backend == "ring" and mesh is None:
        raise ValueError("attn_backend='ring' requires a mesh with an 'sp' axis")
    if attn_backend == "pipeline" and mesh is None:
        raise ValueError("attn_backend='pipeline' requires a mesh with a 'pipe' axis")
    if attn_backend == "ring" and labels is not None and not isinstance(mesh, LocalMesh):
        raise ValueError("attn_backend='ring' on a process-group mesh returns this rank's "
                         "sequence shard: pass labels=None and take the loss per shard")
    tp = as_group(params)
    if tp.sharded and with_logits:
        raise ValueError("over model shards no shard holds the whole logits: pass "
                         "with_logits=False and take the loss from the hidden states "
                         "(train.loss.position_loss, which reduces over the vocabulary cut)")
    B, T = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((B, T), dtype=torch.int32, device=input_ids.device)

    image_features = None
    if pixel_values is not None:
        image_features = get_image_features(
            tp, cfg, pixel_values, intrinsic, depth=depth, use_remat=use_remat,
            compute_dtype=compute_dtype,
        )
    embeds = merge_input_embeddings(tp, cfg, input_ids, image_features, dtype=compute_dtype)
    position_ids = torch.cumsum(attention_mask, dim=1)  # 1-indexed (PaliGemma)

    if attn_backend in ("flash", "ring", "pipeline"):
        valid_lens = attention_mask.sum(dim=1).to(torch.int32)
        if token_type_ids is not None:
            is_suffix = token_type_ids == 1
            first_suffix = torch.argmax(is_suffix.to(torch.int32), dim=1).to(torch.int32)
            prefix_lens = torch.where(is_suffix.any(dim=1), first_suffix, valid_lens)
        else:
            prefix_lens = torch.zeros((B,), dtype=torch.int32, device=input_ids.device)
        args = (cfg.text, embeds, position_ids, prefix_lens, valid_lens)
        if attn_backend == "ring":
            hidden = gemma2_mod.forward_ring(tp, *args, mesh=mesh, use_remat=use_remat)
        elif attn_backend == "pipeline":
            hidden = gemma2_mod.forward_pipeline(tp, *args, mesh=mesh,
                                                 n_microbatches=pp_microbatches,
                                                 use_remat=use_remat)
        else:
            hidden = gemma2_mod.forward_flash(tp, *args, use_remat=use_remat)
    else:
        if token_type_ids is not None:
            base_mask = prefix_lm_mask(attention_mask, token_type_ids)
        else:
            base_mask = gemma2_mod.causal_base_mask(attention_mask)
        hidden, _ = gemma2_mod.forward(tp, cfg.text, embeds, position_ids, base_mask,
                                       use_remat=use_remat)
    out = {"hidden": hidden}
    if with_logits:
        logits = gemma2_mod.compute_logits(tp.trees[0]["lm"], cfg.text, hidden)
        out["logits"] = logits
        if labels is not None:
            out["loss"] = cross_entropy_loss(logits, labels, attention_mask,
                                             ignore_index=cfg.ignore_index)
    return out


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       attention_mask: torch.Tensor, ignore_index: int = -100) -> torch.Tensor:
    """Next-token CE, mean over valid targets (spatialvla.py:283): shift,
    drop positions whose shifted attention mask is 0, ignore ignore_index."""
    shift_labels = labels[:, 1:]
    valid = (shift_labels != ignore_index) & (attention_mask[:, 1:] != 0)
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels)).long()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp_min(1)


# ---------------------------------------------------------------------------
# greedy generation
# ---------------------------------------------------------------------------

def _slice_head(lm_params: Params, begin: int, size: int):
    """Output channels [begin, begin + size) of the lm_head, plain or int8
    (the int8 rows are a contiguous view, no copy)."""
    head = lm_params["lm_head"] if "lm_head" in lm_params else lm_params["embed"].t()
    if is_quantized(head):
        return {"qt": head["qt"][begin : begin + size],
                "scale": head["scale"][begin : begin + size]}
    return head[:, begin : begin + size]


def _greedy_head(lm_params: Params, token_range: Optional[Tuple[int, int]]):
    """(id offset, head) of the greedy argmax: the rows of ``token_range``,
    or the whole lm_head (``embed.T`` without one) for token_range None
    (spatialvla.py:603-609)."""
    if token_range is None:
        head = lm_params["lm_head"] if "lm_head" in lm_params else lm_params["embed"].t()
        return 0, head
    return token_range[0], _slice_head(lm_params, *token_range)


def _head_logits(params, cfg, h: torch.Tensor, token_range, *, full_logits: bool = False):
    """(id offset, logits) of the greedy head for h (..., H), from a tree or
    over the model shards of a ShardGroup (``gemma2.head_logits``): the rows
    of ``token_range`` (None: the whole head) as ``qmatmul`` gives them, or
    with ``full_logits`` (and token_range None) the softcapped fp32 logits."""
    offset = 0 if token_range is None else token_range[0]
    return offset, gemma2_mod.head_logits(params, cfg.text, h, token_range,
                                          full_logits=full_logits and token_range is None)


def _argmax_margin(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) -> (...,) fp32 top1 - top2 logit."""
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def generate_greedy(
    params: Params,
    cfg,
    input_ids: torch.Tensor,  # (B, P) prefix [+ right pad]
    *,
    pixel_values: Optional[torch.Tensor] = None,
    intrinsic: Optional[torch.Tensor] = None,
    depth: Optional[torch.Tensor] = None,  # (B, H, W) metric depth in place of ZoeDepth's
    attention_mask: Optional[torch.Tensor] = None,  # (B, P) 1 = valid; None = unpadded
    max_new_tokens: int = 12,
    cache_dtype=torch.bfloat16,
    compute_dtype=None,
    token_range: Optional[Tuple[int, int]] = None,  # (begin, size); None: the whole vocabulary
    use_fused_decode: Optional[bool] = None,
    use_flash_prefill: Optional[bool] = None,
    depth_image_size: Optional[int] = None,
    kv_bits: Optional[int] = None,
    return_margins: bool = False,
    use_cuda_graph: Optional[bool] = None,
    decode_graphs: Optional["DecodeGraphs"] = None,
):
    """(B, max_new_tokens) greedy ids (with return_margins: (ids, margins)).

    The masked prefill of spatialvla.py:404-436: bidirectional over an
    unpadded prefix, or pad-aware (mask-cumsum positions, pad keys masked,
    true positions for the sliding window) with ``attention_mask``; with
    ``use_flash_prefill`` (unpadded rows only; off by default as in JAX,
    spatialvla.py:387-391) the prefill runs through the flash kernel.

    ``token_range=(begin, size)`` restricts the argmax to the lm_head rows
    of that id block (the action block on the serving path: a 265k-row head
    streams 32 times the bytes of the 8194-row block); None takes the whole
    vocabulary, through the unfused loop's softcapped logits
    (``gemma2.compute_logits``) or the fused loop's head matvec, as in JAX.
    ``depth`` (B, H, W) replaces ZoeDepth's estimate. ``cache_dtype`` is the
    prefill cache's dtype, which the unfused loop keeps; the fused loop
    decodes from a bf16 cache (or, with ``kv_bits=8``, from the prefill
    cache quantized to int8) and refuses another. On the fused decode path
    ``use_cuda_graph`` (None: where ``decode_graphs`` is given) replays the
    loop after the first token as one CUDA graph, kept in ``decode_graphs``
    (``_generate_greedy_fused``)."""
    graph_kw = dict(use_cuda_graph=use_cuda_graph, decode_graphs=decode_graphs)
    if use_flash_prefill and attention_mask is not None:
        raise ValueError("use_flash_prefill assumes unpadded rows (attention_mask=None)")
    tp = as_group(params)
    if tp.sharded and (use_flash_prefill or use_fused_decode or kv_bits):
        raise ValueError("over the model axis the prefill is the masked one and the decode loop "
                         "the unfused one (use_flash_prefill, use_fused_decode and kv_bits off), "
                         "as in JAX")
    B, P = input_ids.shape
    S = P + max_new_tokens
    dev = input_ids.device

    image_features = None
    if pixel_values is not None:
        image_features = get_image_features(
            tp, cfg, pixel_values, intrinsic, depth=depth,
            compute_dtype=compute_dtype, depth_image_size=depth_image_size,
        )
    embeds = merge_input_embeddings(tp, cfg, input_ids, image_features, dtype=compute_dtype)

    if use_flash_prefill:
        position_ids = torch.arange(1, P + 1, device=dev)[None].expand(B, P)
        hidden, cache = gemma2_mod.prefill_flash(tp.trees[0]["lm"], cfg.text, embeds,
                                                 position_ids, S, cache_dtype=cache_dtype)
        return _decode_after_prefill(
            tp, cfg, [cache], hidden, P, S, max_new_tokens, token_range, use_fused_decode,
            compute_dtype, valid=None, key_valid=None, k_pos_true=None, kv_bits=kv_bits,
            return_margins=return_margins, **graph_kw,
        )
    caches = gemma2_mod.init_caches(tp, cfg.text, B, S, device=dev, dtype=cache_dtype)
    if attention_mask is None:
        position_ids = torch.arange(1, P + 1, device=dev)[None].expand(B, P)
        mask = bidirectional_prefill_mask(P, S, B, device=dev)
        valid = key_valid = k_pos_true = None
    else:
        am = attention_mask.to(device=dev, dtype=torch.int32)
        valid = am.sum(dim=-1)
        position_ids = torch.cumsum(am, dim=-1) * am
        key_valid = torch.cat([am.bool(), torch.zeros((B, S - P), dtype=torch.bool, device=dev)], -1)
        mask = key_valid[:, None, None, :].expand(B, 1, P, S)
        k_pos_true = torch.cat(
            [position_ids, valid[:, None] + torch.arange(1, S - P + 1, device=dev)[None]], dim=-1
        )
    hidden, _ = gemma2_mod.forward(tp, cfg.text, embeds, position_ids, mask, cache=caches,
                                   cache_position=0,
                                   window_positions=None if valid is None
                                   else (position_ids, k_pos_true))
    return _decode_after_prefill(
        tp, cfg, caches, hidden, P, S, max_new_tokens, token_range, use_fused_decode,
        compute_dtype, valid=valid, key_valid=key_valid, k_pos_true=k_pos_true, kv_bits=kv_bits,
        return_margins=return_margins, **graph_kw,
    )


def _stack_steps(toks, margs, return_margins):
    out = torch.stack(toks, dim=1)
    return (out, torch.stack(margs, dim=1)) if return_margins else out


def _decode_after_prefill(tp, cfg, caches, hidden, P, S, max_new_tokens, token_range,
                          use_fused_decode, compute_dtype, *, valid, key_valid, k_pos_true,
                          kv_bits=None, return_margins=False, use_cuda_graph=None,
                          decode_graphs=None):
    """The greedy decode loop after the prefill (spatialvla.py:439), over
    ``tp`` (a whole tree's group of one or a ShardGroup) and its caches
    (``gemma2.init_caches``)."""
    B = hidden.shape[0]
    use_fused = (
        not tp.sharded
        and "qkv" in tp.trees[0]["lm"]["layers"]["attn"]
        and B <= 16
        and S <= cfg.text.sliding_window
        and hidden.is_cuda
        if use_fused_decode is None
        else use_fused_decode
    )
    if use_fused:
        return _generate_greedy_fused(
            tp.trees[0], cfg, caches[0], hidden, P, max_new_tokens, token_range,
            compute_dtype=compute_dtype, valid=valid, kv_bits=kv_bits,
            return_margins=return_margins, use_cuda_graph=use_cuda_graph,
            decode_graphs=decode_graphs,
        )
    if kv_bits:
        raise ValueError("kv_bits requires the fused decode path (use_fused_decode)")

    def next_from(hidden_last):
        # the action block's rows as qmatmul gives them, or the whole
        # vocabulary's softcapped logits
        begin, logits = _head_logits(tp, cfg, hidden_last[:, 0], token_range,
                                     full_logits=True)
        return torch.argmax(logits, dim=-1) + begin, _argmax_margin(logits)

    dev = hidden.device
    if valid is None:
        last_hidden = hidden[:, -1:]
    else:  # each row's last valid token
        last_hidden = torch.gather(
            hidden, 1, (valid - 1).long()[:, None, None].expand(B, 1, hidden.shape[-1])
        )
    tok, marg = next_from(last_hidden)
    toks, margs = [tok], [marg]
    k_idx = torch.arange(S, device=dev)
    for t in range(max_new_tokens - 1):
        embeds = merge_input_embeddings(tp, cfg, tok[:, None], None, dtype=compute_dtype)
        if valid is None:
            pos = torch.full((B, 1), P + t + 1, dtype=torch.int32, device=dev)
            step_mask = (k_idx <= P + t).expand(B, 1, 1, S)
            wpos = None
        else:
            pos = (valid + t + 1)[:, None].to(torch.int32)
            gen = (k_idx >= P) & (k_idx <= P + t)
            step_mask = (key_valid | gen[None, :])[:, None, None, :]
            wpos = (pos, k_pos_true)
        hidden, _ = gemma2_mod.forward(tp, cfg.text, embeds, pos, step_mask, cache=caches,
                                       cache_position=P + t, window_positions=wpos)
        tok, marg = next_from(hidden)
        toks.append(tok)
        margs.append(marg)
    return _stack_steps(toks, margs, return_margins)


def _scatter_rows(c, new, slots):
    """In-place per-row cache write: c (L, B, Nkv, S, D), new (L, B, Nkv, D),
    slots (B,) -- row m's vectors land at cache slot slots[m]."""
    rows = torch.arange(c.shape[1], device=c.device)
    c[:, rows, :, slots.long()] = new.transpose(0, 1)
    return c


def _scatter_scale(sc, new, slots, S):
    """In-place per-row KV-scale write into the flat layout (spatialvla.py:563):
    sc (L, Nkv, 1, B*S), new (L, B, Nkv), slots (B,) or an int -- row m's
    scale lands at flattened key column m*S + slots[m]. The columns are
    computed on sc's device (no host-to-device copy, so a CUDA graph can
    capture the write)."""
    B = new.shape[1]
    cols = torch.arange(B, device=sc.device) * S
    cols = cols + (slots if isinstance(slots, int) else slots.to(sc.device).long())
    sc[:, :, 0, cols] = new.float().transpose(1, 2)
    return sc


# Cache slots of a GreedyLoop come in multiples of this, so that requests
# whose prefixes differ by up to this many tokens share one loop (and one
# CUDA graph): the decode attention reads only the slots below each row's
# position (csrc/decode.cu; a chunk past it exits at once).
SLOT_BUCKET = 64


def loop_slots(S: int, cfg) -> int:
    """The cache slots of the GreedyLoop that serves a request needing S
    slots: S rounded up to ``SLOT_BUCKET``, but not past the sliding window
    (nor below S)."""
    return max(S, min(-(-S // SLOT_BUCKET) * SLOT_BUCKET, cfg.text.sliding_window))


def _kernel_counters():
    """(wrapper, attribute) of every kernel launch count (``ops/_lib.COUNTED``)."""
    from ..ops import _lib, decode_step, quant  # noqa: F401 -- registers their wrappers

    return [(fn, a) for fn, names in _lib.COUNTED for a in names]


class GreedyLoop:
    """Steps 1 .. n-1 of the fused greedy loop on buffers of its own, for one
    shape: B rows, an S-slot cache (S a multiple of ``SLOT_BUCKET``, or the
    sliding window), n tokens, a bf16 or int8 cache, the argmax over the ids
    of ``token_range`` (None: the whole vocabulary). Nothing in it depends on
    a request's prefix length P: ``load`` copies a request's prefill cache
    (slots [0, P), permuted to the serving layout, quantized for kv_bits=8),
    its first token and each row's start slot (P, or the row's valid length
    when right-padded) into the buffers, and row m decodes at slots start[m],
    start[m] + 1, ... from a device tensor. ``run`` decodes through them and
    returns (ids, margins), each (B, n-1). Every step's buffers
    (``step_buffers``, the attention scratch among them) are allocated once,
    here.

    On the card ``capture`` records ``run`` into one CUDA graph (after one
    warm-up run on a side stream, which also makes the kernels'
    shared-memory opt-in outside the capture) and ``replay`` replays it: one
    launch from the host for the whole loop, where ``run`` enqueues 157
    kernels and a dozen torch ops a step. A graph holds the addresses of the
    weights it was captured with; ``DecodeGraphs`` ties it to one tree. The
    wrappers' launch counts move during the capture but nothing runs then:
    the capture's counts are taken back and credited on every replay
    instead (chip_smoke.py holds them to the kernels of a traced replay)."""

    def __init__(self, params, cfg, *, B, S, n, kv_bits, token_range, compute_dtype, dtype,
                 device):
        from ..ops.decode_step import step_buffers

        tcfg = cfg.text
        L, Nkv, D = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
        self.params, self.cfg, self.S, self.n = params, cfg, S, n
        self.kv_bits, self.compute_dtype = kv_bits, compute_dtype
        cache_dtype = torch.int8 if kv_bits == 8 else torch.bfloat16
        # zeroed: the slots no request has written yet hold finite values
        self.ck, self.cv = (torch.zeros((L, B, Nkv, S, D), dtype=cache_dtype, device=device)
                            for _ in range(2))
        self.kscale = self.vscale = None
        if kv_bits == 8:  # per-slot scales in the flat (L, Nkv, 1, B*S) layout
            self.kscale, self.vscale = (torch.zeros((L, Nkv, 1, B * S), dtype=torch.float32,
                                                    device=device) for _ in range(2))
        self.tok = torch.empty((B,), dtype=torch.long, device=device)
        self.start = torch.empty((B,), dtype=torch.int32, device=device)
        self.normalizer = torch.tensor(tcfg.hidden_size ** 0.5, dtype=dtype, device=device)
        self.buffers = step_buffers(tcfg, B, S, device)
        self.begin, self.head = _greedy_head(params["lm"], token_range)
        self.graph, self.out, self.credits, self.capture_ms = None, None, {}, None

    def next_from(self, h):
        logits = qmatmul(h, self.head)
        return torch.argmax(logits, dim=-1) + self.begin, _argmax_margin(logits)

    def load(self, cache, tok, P, valid=None):
        """A request's prefill cache (L, B, S', Nkv, D) with P prefix slots,
        its first token (B,) and, for right-padded rows, valid (B,)."""
        from ..ops.quant import quantize_kv

        if P + self.n > self.S:
            raise ValueError(f"a {P}-token prefix and {self.n} tokens exceed the loop's "
                             f"{self.S} cache slots")
        k, v = (cache[n][:, :, :P].permute(0, 1, 3, 2, 4) for n in ("k", "v"))
        if self.kv_bits == 8:
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
            L, B, Nkv = ks.shape[:3]
            for flat, sc in ((self.kscale, ks), (self.vscale, vs)):
                flat.view(L, Nkv, B, self.S)[..., :P].copy_(sc.permute(0, 2, 1, 3))
        self.ck[:, :, :, :P].copy_(k)
        self.cv[:, :, :, :P].copy_(v)
        self.tok.copy_(tok)
        if valid is None:
            self.start.fill_(P)
        else:
            self.start.copy_(valid)

    def _token(self, tok, slot):
        """One step (spatialvla.py:659-688): embed tok (B,) with the
        spatial-token override, run ``fused_decode_step`` with row m at
        position slot[m], write the new K / V rows (quantized, with their
        scales, for an int8 cache) into the cache at slot[m] in place, and
        return the next token and its argmax margin."""
        from ..ops.decode_step import fused_decode_step
        from ..ops.quant import quantize_kv

        embeds = merge_input_embeddings(self.params, self.cfg, tok[:, None], None,
                                        dtype=self.compute_dtype)
        x = embeds[:, 0] * self.normalizer
        hidden, k_new, v_new = fused_decode_step(
            self.params["lm"], self.cfg.text, x, self.ck, self.cv, slot, slot + 1,
            cache_k_scale=self.kscale, cache_v_scale=self.vscale, buffers=self.buffers)
        if self.kv_bits == 8:  # quantize the new rows before writing them
            k_new, ks_new = quantize_kv(k_new)
            v_new, vs_new = quantize_kv(v_new)
            _scatter_scale(self.kscale, ks_new, slot, self.S)
            _scatter_scale(self.vscale, vs_new, slot, self.S)
        _scatter_rows(self.ck, k_new, slot)
        _scatter_rows(self.cv, v_new, slot)
        return self.next_from(hidden.to(self.normalizer.dtype))

    def run(self):
        tok, toks, margs = self.tok, [], []
        for t in range(self.n - 1):
            tok, marg = self._token(tok, self.start + t)
            toks.append(tok)
            margs.append(marg)
        return torch.stack(toks, dim=1), torch.stack(margs, dim=1)

    def capture(self):
        """Warm up once on a side stream, then capture ``run`` into a CUDA
        graph; the buffers hold a loaded request. A failed capture raises."""
        self.graph, self.out, self.credits, self.capture_ms = _capture_graph(self.run)

    def replay(self):
        _replay_graph(self.graph, self.credits)
        return self.out[0].clone(), self.out[1].clone()


def _capture_graph(run):
    """``run()`` once on a side stream (a warm-up, which also makes the
    kernels' shared-memory opt-in outside the capture), then captured into a
    CUDA graph. The capture's error mode is thread-local: a serving engine's
    other threads may use CUDA meanwhile (copy pixels to the card, wait for a
    result), which the global mode would turn into a failed capture. Returns
    (graph, what the captured run returned, the launch counts the capture
    moved, taken back since nothing ran, ms)."""
    t0 = time.perf_counter()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    before = {c: getattr(*c) for c in _kernel_counters()}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = run()
    torch.cuda.synchronize()
    credits = {c: getattr(*c) - n for c, n in before.items() if getattr(*c) != n}
    for (fn, attr), n in credits.items():  # nothing ran during the capture
        setattr(fn, attr, getattr(fn, attr) - n)
    return graph, out, credits, (time.perf_counter() - t0) * 1e3


def _replay_graph(graph, credits):
    """Replay a captured graph and credit its wrappers with its launches."""
    graph.replay()
    for (fn, attr), n in credits.items():
        setattr(fn, attr, getattr(fn, attr) + n)


class DecodeGraphs:
    """The captured greedy loops (``GreedyLoop``) of one parameter tree, one
    per shape key (B, cache slots, tokens, kv_bits, token range, compute
    dtype), as JAX's jit compiles one program per shape; the prefix length
    is not part of the key (``SLOT_BUCKET``). At most ``limit``, the least
    recently used dropped first. A graph holds the addresses of the weights
    it was captured with, so a lookup with another tree (another ``params``
    or ``params["lm"]`` object) drops every graph first, and
    ``SpatialVLAPolicy.quantize`` / ``.to`` call ``clear`` when they replace
    the tree. ``SpatialVLAPolicy`` keeps one and passes it to
    ``predict_action``."""

    def __init__(self, limit: int = 8):
        self.limit = limit
        self.loops: "OrderedDict[tuple, GreedyLoop]" = OrderedDict()  # oldest use first
        self._tree = None

    def __len__(self) -> int:
        return len(self.loops)

    def clear(self) -> None:
        self.loops.clear()
        self._tree = None

    def get(self, params, key, build) -> GreedyLoop:
        """The loop of ``key`` for this tree; ``build()`` makes (and
        captures) one where there is none."""
        if self._tree is None or self._tree[0] is not params or self._tree[1] is not params["lm"]:
            self.clear()
            self._tree = (params, params["lm"])
        loop = self.loops.pop(key, None) or build()
        self.loops[key] = loop
        while len(self.loops) > self.limit:
            self.loops.popitem(last=False)
        return loop


def _generate_greedy_fused(params, cfg, cache, prefill_hidden, P, max_new_tokens, token_range,
                           *, compute_dtype=None, valid=None, kv_bits=None, return_margins=False,
                           use_cuda_graph=None, decode_graphs=None):
    """Decode loop over ``fused_decode_step`` (spatialvla.py:576), on the
    buffers of a ``GreedyLoop``.

    Unpadded rows start at cache slot P; right-padded rows decode at their
    own slots valid[m] + t, overwriting the pad slots. With kv_bits=8 the
    prefill cache is quantized (``quantize_kv``), its scales carried in the
    flat layout, and each step's new rows are quantized before they are
    written.

    ``use_cuda_graph``: whether the steps after the first token replay as
    one CUDA graph (CUDA tensors only), taken from ``decode_graphs`` or
    captured for this call where none is given; None: where
    ``decode_graphs`` is given. Otherwise the loop runs eagerly, one
    ``fused_decode_step`` enqueued after another."""
    if kv_bits not in (None, 8):
        raise ValueError(f"kv_bits={kv_bits}: only 8 (or None) is supported")
    if kv_bits is None and cache["k"].dtype != torch.bfloat16:
        raise ValueError(f"the fused decode path decodes from a bf16 (or, with kv_bits=8, int8) "
                         f"cache, not {cache['k'].dtype}: use cache_dtype=torch.bfloat16 or "
                         "use_fused_decode=False")
    if use_cuda_graph is None:
        use_cuda_graph = decode_graphs is not None and prefill_hidden.is_cuda
    elif use_cuda_graph and not prefill_hidden.is_cuda:
        raise ValueError("use_cuda_graph: a CUDA graph needs CUDA tensors")
    B = prefill_hidden.shape[0]
    begin, head = _greedy_head(params["lm"], token_range)
    if valid is None:
        last_hidden = prefill_hidden[:, -1]
    else:
        last_hidden = torch.gather(
            prefill_hidden, 1,
            (valid - 1).long()[:, None, None].expand(B, 1, prefill_hidden.shape[-1]),
        )[:, 0]
    dtype = compute_dtype or prefill_hidden.dtype
    logits = qmatmul(last_hidden.to(dtype), head)
    tok, marg = torch.argmax(logits, dim=-1) + begin, _argmax_margin(logits)
    if max_new_tokens == 1:
        return _stack_steps([tok], [marg], return_margins)
    shape = dict(B=B, S=loop_slots(P + max_new_tokens, cfg), n=max_new_tokens, kv_bits=kv_bits,
                 token_range=None if token_range is None else tuple(token_range),
                 compute_dtype=compute_dtype, dtype=dtype)

    def build():
        return GreedyLoop(params, cfg, device=prefill_hidden.device, **shape)

    if not use_cuda_graph:
        loop = build()
        loop.load(cache, tok, P, valid)
        toks, margs = loop.run()
    else:
        loop = (build() if decode_graphs is None
                else decode_graphs.get(params, tuple(shape.values()), build))
        loop.load(cache, tok, P, valid)
        if loop.graph is None:
            loop.capture()
            loop.load(cache, tok, P, valid)  # the warm-up wrote into the buffers
        toks, margs = loop.replay()
    ids = torch.cat([tok[:, None], toks], dim=1)
    return (ids, torch.cat([marg[:, None], margs], dim=1)) if return_margins else ids


def predict_action(
    params: Params,
    cfg,
    input_ids: torch.Tensor,
    *,
    pixel_values: Optional[torch.Tensor] = None,
    intrinsic: Optional[torch.Tensor] = None,
    depth: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    action_chunk_size: int = 4,
    compute_dtype=torch.bfloat16,
    restrict_to_action_tokens: bool = True,
    use_fused_decode: Optional[bool] = None,
    use_flash_prefill: Optional[bool] = None,
    depth_image_size: Optional[int] = None,
    kv_bits: Optional[int] = None,
    return_margins: bool = False,
    use_cuda_graph: Optional[bool] = None,
    decode_graphs: Optional[DecodeGraphs] = None,
):
    """Greedy-decode exactly 3 * chunk spatial action token ids (3 tokens an
    action step: translation, rotation, gripper). restrict_to_action_tokens
    slices the lm_head to the action block (decode_actions only reads action
    ids); False takes the argmax over the whole vocabulary."""
    token_range = ((cfg.action_token_begin_idx, cfg.spatial_token_num)
                   if restrict_to_action_tokens else None)
    return generate_greedy(
        params, cfg, input_ids, token_range=token_range,
        pixel_values=pixel_values, intrinsic=intrinsic, depth=depth,
        attention_mask=attention_mask,
        max_new_tokens=3 * action_chunk_size, compute_dtype=compute_dtype,
        use_fused_decode=use_fused_decode, use_flash_prefill=use_flash_prefill,
        depth_image_size=depth_image_size, kv_bits=kv_bits, return_margins=return_margins,
        use_cuda_graph=use_cuda_graph, decode_graphs=decode_graphs,
    )


# ---------------------------------------------------------------------------
# split-phase serving: a prefill per arrival group, a persistent decode batch
# ---------------------------------------------------------------------------
# Continuous batching (spatialvla.py:700-727) splits the two phases that
# predict_action runs back to back: ``prefill_for_serving`` runs the vision
# front, the prefix and the first token of an arrival group, and
# ``decode_steps_serving`` advances a persistent batch of n_slots rows, each
# at its own cache position, a few steps at a time. ``admit_rows_serving``
# moves an arrival group's rows into free slots between two decode
# dispatches, and a row retires after 3 * chunk tokens, so the decode step's
# weight stream is shared by up to n_slots rows whatever the groups' sizes.
# Where JAX returns new arrays from each program, the state here is a dict of
# tensors allocated once and written in place: the decode program is one
# CUDA graph (``ServingLoop``), which holds their addresses.

def prefill_for_serving(
    params: Params,
    cfg,
    input_ids: torch.Tensor,  # (Bp, P) right-padded prompt ids
    *,
    pixel_values: torch.Tensor,
    intrinsic: Optional[torch.Tensor],
    attention_mask: torch.Tensor,  # (Bp, P) 1 = valid
    cache_len: int,  # the persistent decode state's cache slots
    compute_dtype=torch.bfloat16,
    token_range: Optional[Tuple[int, int]] = None,
    depth_image_size: Optional[int] = None,
    kv_bits: Optional[int] = None,
    cache_dtype=torch.bfloat16,
) -> Dict[str, torch.Tensor]:
    """The vision front and the pad-aware prefix of an arrival group
    (spatialvla.py:730), as the rows that ``admit_rows_serving`` writes into
    the first P cache slots of free decode slots: {"k", "v" (L, Bp, Nkv, P,
    D) in the serving layout [, "k_scale", "v_scale" (L, Bp, Nkv, P) with
    kv_bits=8], "tok" (Bp,) the first generated token, "valid" (Bp,) the
    prefix lengths}, int32 where JAX's are. The prefill is
    ``generate_greedy``'s pad-aware one over P slots only: the slots past P
    would be masked keys. ``cache_len`` only bounds the prompt. Over the
    model shards (a ``ShardGroup``) the K / V rows are one dict a shard of
    the attention, over its kv heads, under "shards"."""
    from ..ops.quant import quantize_kv

    B, P = input_ids.shape
    if P > cache_len:
        raise ValueError(f"prompt P={P} exceeds cache_len={cache_len}")
    if kv_bits not in (None, 8):
        raise ValueError(f"kv_bits={kv_bits}: only 8 (or None) is supported")
    dev = input_ids.device
    tp = as_group(params)
    image_features = get_image_features(tp, cfg, pixel_values, intrinsic,
                                        compute_dtype=compute_dtype,
                                        depth_image_size=depth_image_size)
    embeds = merge_input_embeddings(tp, cfg, input_ids, image_features, dtype=compute_dtype)
    caches = gemma2_mod.init_caches(tp, cfg.text, B, P, device=dev, dtype=cache_dtype)
    am = attention_mask.to(device=dev, dtype=torch.int32)
    valid = am.sum(dim=-1)  # each row's prefix length
    position_ids = torch.cumsum(am, dim=-1) * am  # 1-indexed at the valid slots
    mask = am.bool()[:, None, None, :].expand(B, 1, P, P)
    hidden, _ = gemma2_mod.forward(tp, cfg.text, embeds, position_ids, mask, cache=caches,
                                   cache_position=0,
                                   window_positions=(position_ids, position_ids))  # true slots
    last = torch.gather(hidden, 1, (valid - 1).long()[:, None, None].expand(B, 1, hidden.shape[-1]))
    offset, logits = _head_logits(tp, cfg, last[:, 0].to(compute_dtype or hidden.dtype),
                                  token_range)
    tok = torch.argmax(logits, dim=-1) + offset

    def kv_rows(c):
        ck, cv = (c[n].permute(0, 1, 3, 2, 4).contiguous() for n in ("k", "v"))
        if kv_bits == 8:
            (k, ks), (v, vs) = quantize_kv(ck), quantize_kv(cv)
            return {"k": k, "k_scale": ks, "v": v, "v_scale": vs}
        return {"k": ck, "v": cv}

    out = {"tok": tok.to(torch.int32), "valid": valid.to(torch.int32)}
    rows = [kv_rows(c) for c in caches]
    if tp.sharded:
        out["shards"] = rows
    else:
        out.update(rows[0])
    return out


def init_serving_state(cfg, n_slots: int, cache_len: int, n_tokens: int, *,
                       kv_bits: Optional[int] = None, cache_dtype=torch.bfloat16,
                       device=None) -> Dict[str, torch.Tensor]:
    """The persistent decode batch (spatialvla.py:810): n_slots rows, each
    with its KV cache (L, n_slots, Nkv, cache_len, D), last token, cache
    position, emitted-token count and output buffer (n_slots, n_tokens),
    int32 as in JAX. A new slot is inactive: steps = n_tokens, past the
    output buffer, so a decode step writes none of its tokens. With
    kv_bits=8 the cache holds int8 codes and its per-slot scales live in the
    flat (L, Nkv, 1, n_slots * cache_len) layout that the decode step reads
    (``ops/decode_step.flatten_kv_scales``), written there directly."""
    tcfg = cfg.text
    L, Nkv, D = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    shape = (L, n_slots, Nkv, cache_len, D)
    i32 = dict(dtype=torch.int32, device=device)
    state = {
        "tok": torch.zeros((n_slots,), **i32),
        "pos": torch.zeros((n_slots,), **i32),
        "steps": torch.full((n_slots,), n_tokens, **i32),
        "out": torch.zeros((n_slots, n_tokens), **i32),
    }
    if kv_bits == 8:
        state["k"], state["v"] = (torch.zeros(shape, dtype=torch.int8, device=device)
                                  for _ in range(2))
        sshape = (L, Nkv, 1, n_slots * cache_len)
        state["k_scale"], state["v_scale"] = (torch.zeros(sshape, dtype=torch.float32,
                                                          device=device) for _ in range(2))
    else:
        state["k"], state["v"] = (torch.zeros(shape, dtype=cache_dtype, device=device)
                                  for _ in range(2))
    return state


def admit_rows_serving(state: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor],
                       slots) -> Dict[str, torch.Tensor]:
    """An arrival group's prefill rows (``prefill_for_serving``) written in
    place into the decode slots ``slots`` (Bp,) (spatialvla.py:848): cache
    slots [0, P) of each, its scales at flat columns slot * S + [0, P), its
    first token in ``tok`` and ``out[:, 0]``, its position the prefix length
    and steps = 1. Slots [P, S) keep what the slot's last occupant left: the
    decode step attends only below a row's position and writes each slot
    before the position passes it. A state over the model shards
    (``TensorShards.cut_state``) takes each shard's rows into its own K / V.
    Returns ``state``."""
    sl = torch.as_tensor(slots, device=state["tok"].device).long()
    pairs = (zip(state["shards"], rows["shards"]) if "shards" in state
             else [(state, rows)])
    for kv, kv_rows in pairs:
        P = kv_rows["k"].shape[3]
        slk = sl.to(kv["k"].device)
        kv["k"][:, slk, :, :P] = kv_rows["k"]
        kv["v"][:, slk, :, :P] = kv_rows["v"]
        if "k_scale" in kv:
            S = kv["k"].shape[3]
            cols = slk[:, None] * S + torch.arange(P, device=slk.device)[None, :]  # (Bp, P)
            for name in ("k_scale", "v_scale"):
                kv[name][:, :, 0][:, :, cols] = kv_rows[name].float().permute(0, 2, 1, 3)
    tok = rows["tok"].to(torch.int32)
    state["tok"][sl] = tok
    state["pos"][sl] = rows["valid"].to(torch.int32)
    state["steps"][sl] = 1
    state["out"][sl, 0] = tok
    return state


def _check_step_cache(tcfg, cache_k, cache_k_scale, cache_v_scale):
    L, M, Nkv, S, D = cache_k.shape
    if cache_k.dtype == torch.int8:
        flat = (L, Nkv, 1, M * S)
        if (cache_k_scale is None or cache_v_scale is None
                or tuple(cache_k_scale.shape) != flat or tuple(cache_v_scale.shape) != flat):
            raise ValueError("an int8 KV cache needs per-slot scales in the flat "
                             f"{flat} layout (ops/decode_step.flatten_kv_scales)")
    if S > tcfg.sliding_window:
        raise ValueError("serving cache exceeds the sliding window; this step treats window "
                         "and global layers identically")


def _step_attention(la, norm_w, tcfg, h, ck, cv, ks, vs, position, cos, sin, compute_dtype):
    """One layer's attention of ``xla_decode_step`` for h (M, H) over a cache
    ck / cv (M, Nkv, S, D) of ``tcfg``'s heads (with an int8 cache, ks / vs
    the layer's flat scales (Nkv, 1, M*S)): returns (o's product (M, 1, H),
    k_new, v_new)."""
    from ..ops.quant import qnorm_matmul
    from .attention import multi_head_attention
    from .layers import rms_norm
    from .rope import apply_rope

    M, Nkv, S, D = ck.shape
    Nq, eps = tcfg.num_heads, tcfg.rms_norm_eps
    dev = h.device
    kiota = torch.arange(S, device=dev)
    scale = tcfg.query_pre_attn_scalar ** -0.5
    cap = tcfg.attn_logit_softcap
    hT = h[:, None, :]
    if "qkv" in la:  # the fused-quantized serving tree
        qkv = qnorm_matmul(hT, norm_w, la["qkv"], eps=eps)
        q, k, v = torch.split(qkv, [Nq * D, Nkv * D, Nkv * D], dim=-1)
    else:
        xn = rms_norm(norm_w, hT, eps)
        q, k, v = (qmatmul(xn, la[n]) for n in ("q", "k", "v"))
    q = apply_rope(q.reshape(M, 1, Nq, D), cos, sin)
    k = apply_rope(k.reshape(M, 1, Nkv, D), cos, sin)
    v = v.reshape(M, 1, Nkv, D)
    if ck.dtype == torch.int8:
        k_new, v_new = k[:, 0].to(torch.bfloat16), v[:, 0].to(torch.bfloat16)
        G = Nq // Nkv
        qf = q[:, 0].reshape(M, Nkv, G, D).float() * scale
        ks, vs = (sc.reshape(Nkv, M, S).permute(1, 0, 2)[:, :, None, :] for sc in (ks, vs))
        logits = torch.einsum("mhgd,mhsd->mhgs", qf, ck.float()) * ks
        self_l = (qf * k_new.float()[:, :, None, :]).sum(-1)[..., None]  # (M, Nkv, G, 1)
        if cap:
            logits = torch.tanh(logits / cap) * cap
            self_l = torch.tanh(self_l / cap) * cap
        col_ok = (kiota[None, :] < position[:, None])[:, None, None, :]  # the self term: pos
        logits = torch.where(col_ok, logits, torch.full_like(logits, -1e30))
        mx = torch.maximum(logits.amax(-1, keepdim=True), self_l)
        e, e_self = torch.exp(logits - mx), torch.exp(self_l - mx)
        denom = e.sum(-1, keepdim=True) + e_self
        out = (torch.einsum("mhgs,mhsd->mhgd", (e / denom) * vs, cv.float())
               + (e_self / denom) * v_new.float()[:, :, None, :])
        out = out.reshape(M, 1, Nq * D)
    else:
        k_new, v_new = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype)
        # the cache in (M, S, Nkv, D) with the current token at each row's
        # slot (the caller writes it into the persistent cache)
        rows = torch.arange(M, device=dev)
        kk, vv = (c.permute(0, 2, 1, 3).clone() for c in (ck, cv))
        kk[rows, position.long()] = k_new
        vv[rows, position.long()] = v_new
        mask = (kiota[None, :] <= position[:, None])[:, None, None, :]  # the valid cache and itself
        out = multi_head_attention(q, kk.to(compute_dtype), vv.to(compute_dtype), mask,
                                   scale=scale, logit_softcap=cap).reshape(M, 1, Nq * D)
    return qmatmul(out.to(compute_dtype), la["o"]), k_new, v_new


def _step_positions(tcfg, x, position, rope_position):
    from .rope import rope_cos_sin

    M = x.shape[0]
    position = torch.as_tensor(position, dtype=torch.int32, device=x.device).reshape(-1).expand(M)
    rope_position = torch.as_tensor(rope_position, dtype=torch.int32,
                                    device=x.device).reshape(-1).expand(M)
    cos, sin = rope_cos_sin(rope_position[:, None], tcfg.head_dim, tcfg.rope_theta)
    return position, cos, sin


def xla_decode_step(lm_params: Params, tcfg, x: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, position, rope_position, *, cache_k_scale=None,
                    cache_v_scale=None, compute_dtype=torch.bfloat16):
    """The decode step of ``ops/decode_step.fused_decode_step`` in plain
    torch ops, layer by layer as ``gemma2``'s attention and MLP blocks do it
    for one query token (spatialvla.py:889, XLA math in JAX): the same
    contract (x (M, H) embeddings * sqrt(H), a read-only (L, M, Nkv, S, D)
    cache, per-row positions; returns (hidden bf16, k_new, v_new) for the
    caller to write). An int8 cache stays codes: its per-slot scales (flat
    (L, Nkv, 1, M*S) layout) multiply the logits after q . K and the
    probabilities before p @ V, and the current token attends unquantized
    through a separate self term, as the kernel does; k_new / v_new come back
    bf16 for the caller to quantize. ``decode_steps_serving(use_fused=False)``
    runs it (``_decode_step``, over the model shards too)."""
    kv = {"k": cache_k, "v": cache_v}
    if cache_k_scale is not None or cache_v_scale is not None:
        kv.update(k_scale=cache_k_scale, v_scale=cache_v_scale)
    hidden, k_news, v_news = _decode_step(as_group(lm_params, "lm"), tcfg, x, [kv], position,
                                          rope_position, compute_dtype=compute_dtype)
    return hidden, k_news[0], v_news[0]


def _decode_step(tp, tcfg, x: torch.Tensor, kv: list, position, rope_position, *,
                 compute_dtype=torch.bfloat16):
    """``xla_decode_step`` over the model shards of ``tp`` (a whole tree's
    group of one, or a ShardGroup): each shard of the attention attends over
    its kv heads in ``kv`` (one dict a shard: "k" / "v" (L, M, Nkv_s, S, D)
    [, "k_scale" / "v_scale" flat]), each shard of the MLP over its hidden
    columns, their partial products summed (``sum_shards``). Returns
    (hidden bf16, [k_new a shard], [v_new a shard])."""
    from .layers import rms_norm

    scfg, eps = tp.text_cfg(tcfg), tcfg.rms_norm_eps
    for c in kv:
        _check_step_cache(scfg, c["k"], c.get("k_scale"), c.get("v_scale"))
    position, cos, sin = _step_positions(tcfg, x, position, rope_position)
    L = kv[0]["k"].shape[0]
    lps = tp.layers("lm", L)
    h = x.to(compute_dtype)
    news = [([], []) for _ in kv]
    for l in range(L):
        def attn(s, tree, h, position, cos, sin):
            c = kv[s]
            ks, vs = (None, None) if c.get("k_scale") is None else (c["k_scale"][l],
                                                                      c["v_scale"][l])
            out, k_new, v_new = _step_attention(lps[s][l]["attn"], lps[s][l]["input_norm"], scfg,
                                                h, c["k"][l], c["v"][l], ks, vs, position, cos,
                                                sin, compute_dtype)
            news[s][0].append(k_new)
            news[s][1].append(v_new)
            return out

        attn_out = tp.reduce("lm_attn", attn, h, position, cos, sin)
        lp = lps[0][l]
        h = h + rms_norm(lp["post_attn_norm"], attn_out[:, 0], eps)
        mlp = tp.reduce("lm_mlp", lambda s, tree, h: gemma2_mod._mlp_block(
            lps[s][l]["mlp"], h[:, None, :], lps[s][l]["pre_ffn_norm"], eps), h)
        h = h + rms_norm(lp["post_ffn_norm"], mlp[:, 0], eps)
    hidden = rms_norm(tp.trees[0]["lm"]["final_norm"], h, eps)
    return (hidden.to(torch.bfloat16), [torch.stack(k) for k, _ in news],
            [torch.stack(v) for _, v in news])


def decode_steps_serving(params: Params, cfg, state: Dict[str, torch.Tensor], *, n_steps: int,
                         n_tokens: int, token_range: Optional[Tuple[int, int]] = None,
                         compute_dtype=torch.bfloat16, use_fused: bool = True,
                         buffers=None) -> Dict[str, torch.Tensor]:
    """Every slot of the persistent decode batch advanced by n_steps decode
    steps at its own cache position (spatialvla.py:1051), in place.

    Free and finished slots (steps >= n_tokens) decode too, into their own
    row: their output writes are masked, their position stops at S - 1 and
    their step count at n_tokens, and admission overwrites what they wrote,
    so the step needs no mask of active rows and its shape never changes.
    Each step: embed the last token (spatial-token override), one
    ``fused_decode_step`` (``buffers``: its ``step_buffers``) or, with
    use_fused=False, ``xla_decode_step``; the argmax over ``token_range``'s
    head rows; the new K / V rows (quantized, with their scales, for an int8
    cache) written at each row's position. Over the model shards (a
    ``ShardGroup`` and a state cut by ``TensorShards.cut_state``) the step
    is ``xla_decode_step`` over each shard's heads, each shard's rows written
    into its own K / V.
    Returns ``state``."""
    from ..ops.decode_step import fused_decode_step
    from ..ops.quant import quantize_kv

    tcfg = cfg.text
    tp = as_group(params)
    if tp.sharded and use_fused:
        raise ValueError("over the model axis the decode step is xla_decode_step "
                         "(use_fused=False), as in JAX")
    kv = state["shards"] if "shards" in state else [state]
    B, S = state["tok"].shape[0], kv[0]["k"].shape[3]
    tok, pos, steps, out = (state[n] for n in ("tok", "pos", "steps", "out"))
    # sqrt(H) rounded to the compute dtype (JAX's jnp.asarray(.., compute_dtype)),
    # as a number: a tensor made from it would be a host-to-card copy, which
    # a CUDA graph cannot capture
    normalizer = float(torch.tensor(tcfg.hidden_size ** 0.5, dtype=compute_dtype))
    rows = torch.arange(B, device=tok.device)
    for _ in range(n_steps):
        embeds = merge_input_embeddings(tp, cfg, tok[:, None].long(), None,
                                        dtype=compute_dtype)
        x = embeds[:, 0] * normalizer
        if use_fused:
            hidden, k_new, v_new = fused_decode_step(
                tp.trees[0]["lm"], tcfg, x, state["k"], state["v"], pos, pos + 1,
                buffers=buffers, cache_k_scale=state.get("k_scale"),
                cache_v_scale=state.get("v_scale"))
            k_news, v_news = [k_new], [v_new]
        else:
            hidden, k_news, v_news = _decode_step(tp, tcfg, x, kv, pos, pos + 1,
                                                  compute_dtype=compute_dtype)
        offset, logits = _head_logits(tp, cfg, hidden.to(compute_dtype), token_range)
        nxt = (torch.argmax(logits, dim=-1) + offset).to(torch.int32)
        for c, k_new, v_new in zip(kv, k_news, v_news):
            slots = pos.to(c["k"].device)
            if "k_scale" in c:
                k_new, ks_new = quantize_kv(k_new)
                v_new, vs_new = quantize_kv(v_new)
                _scatter_scale(c["k_scale"], ks_new, slots, S)
                _scatter_scale(c["v_scale"], vs_new, slots, S)
            _scatter_rows(c["k"], k_new, slots)
            _scatter_rows(c["v"], v_new, slots)
        # the token's write, masked for free and finished slots (a retired
        # row's last token must stay)
        idx = steps.clamp(0, n_tokens - 1).long()
        out[rows, idx] = torch.where(steps < n_tokens, nxt, out[rows, idx])
        tok.copy_(nxt)
        pos.copy_(torch.clamp(pos + 1, max=S - 1))
        steps.copy_(torch.clamp(steps + 1, max=n_tokens))
    return state


class ServingLoop:
    """The persistent decode batch of a split-phase serving engine, for one
    fixed shape: ``n_slots`` rows, ``cache_len`` cache slots, ``n_tokens``
    tokens a request, ``decode_block`` steps a dispatch, a bf16 or int8
    cache, the argmax over ``token_range``, the compute dtype. ``state`` is
    ``init_serving_state``'s dict, allocated once with the decode step's
    buffers; ``admit_rows_serving`` writes arrival groups into it between
    dispatches and ``step`` advances it by ``decode_block`` steps
    (``decode_steps_serving``).

    On the card ``capture`` records the decode_block steps as one CUDA graph
    (as ``GreedyLoop.capture``: a warm-up run on a side stream, the launch
    counts credited per replay in ``credits``); the shape never changes, so
    one capture serves the engine's life. Capture it before the first
    admission: the warm-up run advances every slot. Without a graph (the
    CPU) ``step`` runs the steps eagerly.

    Over the model shards (``params`` a ``ShardGroup``) the state's K / V
    are cut over the attention's kv heads (``TensorShards.cut_state``), the
    steps are ``xla_decode_step`` over the shards, and they run eagerly: capturing them
    as a CUDA graph is later work (ROADMAP.md)."""

    def __init__(self, params, cfg, *, n_slots, cache_len, n_tokens, decode_block, kv_bits,
                 token_range, compute_dtype, device):
        from ..ops.decode_step import step_buffers

        self.params, self.cfg = params, cfg
        self.n_tokens, self.decode_block = n_tokens, decode_block
        self.token_range, self.compute_dtype = token_range, compute_dtype
        self.sharded = as_group(params).sharded
        self.state = init_serving_state(cfg, n_slots, cache_len, n_tokens, kv_bits=kv_bits,
                                        device=device)
        self.buffers = None
        if self.sharded:
            self.state = params.cut.cut_state(self.state, params.devices)
        else:
            self.buffers = step_buffers(cfg.text, n_slots, cache_len, device)
        self.graph, self.credits, self.capture_ms = None, {}, None

    def run(self):
        decode_steps_serving(self.params, self.cfg, self.state, n_steps=self.decode_block,
                             n_tokens=self.n_tokens, token_range=self.token_range,
                             compute_dtype=self.compute_dtype, use_fused=not self.sharded,
                             buffers=self.buffers)

    def capture(self):
        self.graph, _, self.credits, self.capture_ms = _capture_graph(self.run)

    def step(self):
        if self.graph is None:
            self.run()
        else:
            _replay_graph(self.graph, self.credits)
