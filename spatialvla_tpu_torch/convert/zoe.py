"""HF ZoeDepthForDepthEstimation state dict -> the port's zoe tree (port of
spatialvla_tpu/convert/zoe.py).

Layout conversions: torch Conv2d (O, I, kH, kW) -> HWIO; ConvTranspose2d
(I, O, kH, kW) -> (kH, kW, O, I); Linear (O, I) -> (I, O); per-layer
tensors stacked along the layer axis. Each tensor goes to ``device`` in
``dtype`` as it is read (``convert/params.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from ..config import ZoeDepthConfig
from ..models.zoe import REASSEMBLE_FACTORS
from .params import put, target_device


def zoe_from_state_dict(sd: Mapping[str, Any], cfg: ZoeDepthConfig, prefix: str = "",
                        dtype=None, device="cuda") -> Dict[str, Any]:
    p, L, dev = prefix, cfg.num_layers, target_device(device)

    def _t(name, transpose=False):
        return put(sd[name], dev, dtype, transpose)

    def _conv(name):  # OIHW and ConvTranspose2d's IOHW both -> (kH, kW, ., .)
        out = {"w": _t(f"{name}.weight").permute(2, 3, 1, 0).contiguous()}
        if f"{name}.bias" in sd:
            out["b"] = _t(f"{name}.bias")
        return out

    _convT = _conv

    def _lin(name, bias=True):
        out = {"w": _t(f"{name}.weight", transpose=True)}
        if bias and f"{name}.bias" in sd:
            out["b"] = _t(f"{name}.bias")
        return out

    def _ln(name):
        return {"scale": _t(f"{name}.weight"), "bias": _t(f"{name}.bias")}

    def _stack(items):
        if isinstance(items[0], dict):
            return {k: _stack([it[k] for it in items]) for k in items[0]}
        return torch.stack(items)

    # backbone
    layers = []
    for i in range(L):
        b = f"{p}backbone.encoder.layer.{i}"
        layers.append({
            "ln1": _ln(f"{b}.layernorm_before"),
            "ln2": _ln(f"{b}.layernorm_after"),
            "q": _lin(f"{b}.attention.attention.query"),
            "k": _lin(f"{b}.attention.attention.key", bias=False),
            "v": _lin(f"{b}.attention.attention.value"),
            "proj": _lin(f"{b}.attention.output.dense"),
            "rel_pos_table": _t(
                f"{b}.attention.attention.relative_position_bias.relative_position_bias_table"),
            "lambda1": _t(f"{b}.lambda_1"),
            "lambda2": _t(f"{b}.lambda_2"),
            "fc1": _lin(f"{b}.intermediate.dense"),
            "fc2": _lin(f"{b}.output.dense"),
        })
    backbone = {
        "patch_embed": _conv(f"{p}backbone.embeddings.patch_embeddings.projection"),
        "cls_token": _t(f"{p}backbone.embeddings.cls_token"),
        "layers": _stack(layers),
    }
    del layers

    # neck
    reassemble = []
    for i, factor in enumerate(REASSEMBLE_FACTORS):
        entry = {
            "readout": _lin(f"{p}neck.reassemble_stage.readout_projects.{i}.0"),
            "projection": _conv(f"{p}neck.reassemble_stage.layers.{i}.projection"),
        }
        if factor > 1:
            entry["resize"] = _convT(f"{p}neck.reassemble_stage.layers.{i}.resize")
        elif factor < 1:
            entry["resize"] = _conv(f"{p}neck.reassemble_stage.layers.{i}.resize")
        reassemble.append(entry)

    def residual(name):
        return {"conv1": _conv(f"{name}.convolution1"), "conv2": _conv(f"{name}.convolution2")}

    fusion = [
        {
            "projection": _conv(f"{p}neck.fusion_stage.layers.{i}.projection"),
            "res1": residual(f"{p}neck.fusion_stage.layers.{i}.residual_layer1"),
            "res2": residual(f"{p}neck.fusion_stage.layers.{i}.residual_layer2"),
        }
        for i in range(4)
    ]
    neck = {
        "reassemble": reassemble,
        "convs": [_conv(f"{p}neck.convs.{i}") for i in range(4)],
        "fusion": fusion,
    }

    relative_head = {c: _conv(f"{p}relative_head.{c}") for c in ("conv1", "conv2", "conv3")}

    # metric head
    pt_layers = []
    for i in range(cfg.num_patch_transformer_layers):
        b = f"{p}metric_head.patch_transformer.transformer_encoder.{i}"
        pt_layers.append({
            "q": _lin(f"{b}.self_attn.query"),
            "k": _lin(f"{b}.self_attn.key"),
            "v": _lin(f"{b}.self_attn.value"),
            "out": _lin(f"{b}.self_attn.out_proj"),
            "fc1": _lin(f"{b}.linear1"),
            "fc2": _lin(f"{b}.linear2"),
            "ln1": _ln(f"{b}.norm1"),
            "ln2": _ln(f"{b}.norm2"),
        })

    def projector(name):
        return {"conv1": _conv(f"{name}.conv1"), "conv2": _conv(f"{name}.conv2")}

    experts = {}
    for name in ("nyu", "kitti"):
        experts[name] = {
            "seed_bin_regressor": projector(f"{p}metric_head.seed_bin_regressors.{name}"),
            "attractors": [projector(f"{p}metric_head.attractors.{name}.{i}") for i in range(4)],
            "log_binomial": {
                "conv1": _conv(f"{p}metric_head.conditional_log_binomial.{name}.mlp.0"),
                "conv2": _conv(f"{p}metric_head.conditional_log_binomial.{name}.mlp.2"),
            },
        }

    metric_head = {
        "conv2": _conv(f"{p}metric_head.conv2"),
        "patch_transformer": {
            "embed_conv": _conv(f"{p}metric_head.patch_transformer.embedding_convPxP"),
            "layers": _stack(pt_layers),
        },
        "mlp_classifier": {
            "fc1": _lin(f"{p}metric_head.mlp_classifier.linear1"),
            "fc2": _lin(f"{p}metric_head.mlp_classifier.linear2"),
        },
        "seed_projector": projector(f"{p}metric_head.seed_projector"),
        "projectors": [projector(f"{p}metric_head.projectors.{i}") for i in range(4)],
        "experts": experts,
    }
    return {
        "backbone": backbone,
        "neck": neck,
        "relative_head": relative_head,
        "metric_head": metric_head,
    }
