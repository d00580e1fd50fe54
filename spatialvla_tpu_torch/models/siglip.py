"""SigLIP ViT encoder, so400m-14/224 topology (port of
spatialvla_tpu/models/siglip.py): the patch conv as an unfold (reshape) and
one matmul, pre-LN blocks with biased q/k/v, gelu-tanh MLP, a final
post-LayerNorm; the encoder matmuls go through ``qmatmul`` so the int8
serving tree works unchanged. ``use_remat`` recomputes each layer in the
backward pass (the JAX scan step under ``jax.checkpoint``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..ops.quant import qmatmul
from ..parallel.partitioning import as_group
from .attention import multi_head_attention
from .gemma2 import remat
from .layers import gelu_tanh, layer_norm, layer_norm_init, normal_init, ones, zeros

Params = Dict[str, Any]


def init_params(cfg, *, generator, device, dtype=torch.float32) -> Params:
    L, H, I, P = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
    kw = dict(device=device, dtype=dtype)

    def wb(din, dout):
        return {"w": normal_init(generator, (L, din, dout), **kw), "b": zeros((L, dout), **kw)}

    def ln_stack():
        return {"scale": ones((L, H), **kw), "bias": zeros((L, H), **kw)}

    return {
        "patch_embed": {"w": normal_init(generator, (P, P, 3, H), **kw), "b": zeros((H,), **kw)},
        "pos_embed": normal_init(generator, (cfg.num_patches, H), **kw),
        "layers": {
            "attn": {"q": wb(H, H), "k": wb(H, H), "v": wb(H, H), "o": wb(H, H)},
            "ln1": ln_stack(),
            "ln2": ln_stack(),
            "mlp": {"fc1": wb(H, I), "fc2": wb(I, H)},
        },
        "post_ln": layer_norm_init(H, **kw),
    }


def _patchify(params: Params, cfg, pixel_values: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) NHWC -> (B, N, hidden): non-overlapping patches flattened
    (row, col, channel), times the (P*P*3, hidden) conv weight."""
    B, Himg, Wimg, C = pixel_values.shape
    P = cfg.patch_size
    hp, wp = Himg // P, Wimg // P
    x = pixel_values.reshape(B, hp, P, wp, P, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, hp * wp, P * P * C)
    w = params["patch_embed"]["w"].to(x.dtype).reshape(P * P * C, -1)
    return x @ w + params["patch_embed"]["b"].to(x.dtype)


def _linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    return _bias(qmatmul(x, p["w"]), p)


def _bias(y: torch.Tensor, p: Params) -> torch.Tensor:
    return y + p["b"].to(y.dtype)


def _attention(cfg, x: torch.Tensor, p: Params, nh: int) -> torch.Tensor:
    """Self-attention of x over ``nh`` heads through p's q / k / v and o's
    weight; o's bias is the caller's."""
    B, N, _ = x.shape
    hd = cfg.head_dim
    q = _linear(x, p["q"]).reshape(B, N, nh, hd)
    k = _linear(x, p["k"]).reshape(B, N, nh, hd)
    v = _linear(x, p["v"]).reshape(B, N, nh, hd)
    attn = multi_head_attention(q, k, v, None, scale=hd ** -0.5).reshape(B, N, nh * hd)
    return qmatmul(attn, p["o"]["w"])


def _mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    """fc2's weight after gelu(fc1); fc2's bias is the caller's."""
    return qmatmul(gelu_tanh(_linear(x, p["fc1"])), p["fc2"]["w"])


def _encoder_layer(tp, l: int, cfg, h: torch.Tensor) -> torch.Tensor:
    """Layer l over the model shards of ``tp`` (a whole tree's group of one,
    or a ShardGroup): the attention over each shard's heads and the MLP over
    its hidden columns, their partial o / fc2 products summed
    (``sum_shards``) before their bias, which is added once. The residual
    stream and the LayerNorms run on the group's home device."""
    lps = tp.layers("vision", cfg.num_layers)
    lp = lps[0][l]
    nh = cfg.num_heads // tp.n if tp.is_cut("vision_attn") else cfg.num_heads
    eps = cfg.layer_norm_eps
    x = layer_norm(lp["ln1"], h, eps)
    attn = tp.reduce("vision_attn", lambda s, tree, x: _attention(cfg, x, lps[s][l]["attn"], nh), x)
    h = h + _bias(attn, lp["attn"]["o"])
    x2 = layer_norm(lp["ln2"], h, eps)
    mlp = tp.reduce("vision_mlp", lambda s, tree, x: _mlp(x, lps[s][l]["mlp"]), x2)
    return h + _bias(mlp, lp["mlp"]["fc2"])


def forward(params, cfg, pixel_values: torch.Tensor, *, use_remat: bool = False) -> torch.Tensor:
    """(B, H, W, 3) NHWC, already SigLIP-normalized -> (B, N, hidden), from
    the vision tree or over the model shards of a ShardGroup
    (parallel/partitioning.py), the patch conv's output channels joined in
    order before pos_embed."""
    tp = as_group(params, "vision")
    h = tp.gather("patch", lambda s, tree, px: _patchify(tree["vision"], cfg, px), pixel_values)
    home = tp.trees[0]["vision"]
    h = h + home["pos_embed"].to(h.dtype)[None]
    tp.layers("vision", cfg.num_layers)  # the per-layer views, outside any recomputation
    layer = remat(lambda h, l: _encoder_layer(tp, l, cfg, h), use_remat)
    for l in range(cfg.num_layers):
        h = layer(h, l)
    return layer_norm(home["post_ln"], h, cfg.layer_norm_eps)
