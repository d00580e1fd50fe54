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
from .attention import multi_head_attention
from .gemma2 import remat, unstack_layers
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
    y = qmatmul(x, p["w"])
    return y + p["b"].to(y.dtype)


def _encoder_layer(cfg, h: torch.Tensor, lp: Params) -> torch.Tensor:
    B, N, H = h.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    x = layer_norm(lp["ln1"], h, cfg.layer_norm_eps)
    q = _linear(x, lp["attn"]["q"]).reshape(B, N, nh, hd)
    k = _linear(x, lp["attn"]["k"]).reshape(B, N, nh, hd)
    v = _linear(x, lp["attn"]["v"]).reshape(B, N, nh, hd)
    attn = multi_head_attention(q, k, v, None, scale=hd ** -0.5).reshape(B, N, H)
    h = h + _linear(attn, lp["attn"]["o"])
    x2 = layer_norm(lp["ln2"], h, cfg.layer_norm_eps)
    return h + _linear(gelu_tanh(_linear(x2, lp["mlp"]["fc1"])), lp["mlp"]["fc2"])


def forward(params: Params, cfg, pixel_values: torch.Tensor, *,
            use_remat: bool = False) -> torch.Tensor:
    """(B, H, W, 3) NHWC, already SigLIP-normalized -> (B, N, hidden)."""
    h = _patchify(params, cfg, pixel_values)
    h = h + params["pos_embed"].to(h.dtype)[None]
    layer = remat(lambda h, lp: _encoder_layer(cfg, h, lp), use_remat)
    for lp in unstack_layers(params["layers"], cfg.num_layers):
        h = layer(h, lp)
    return layer_norm(params["post_ln"], h, cfg.layer_norm_eps)
