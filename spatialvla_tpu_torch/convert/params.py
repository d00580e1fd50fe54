"""HF-layout state dict -> the port's parameter tree (port of
spatialvla_tpu/convert/params.py).

Works on any Mapping[str, tensor] (``safetensors_io.LazySafetensorsDict``,
a torch state dict). Torch Linear weights are (out, in) and are transposed
to the tree's (in, out) layout; per-layer tensors are stacked along a
leading layer axis, as the JAX pytree has them. Each tensor goes to
``device`` as it is read, each stack is built there in ``dtype`` (None
keeps the stored dtype; the JAX package, whose numpy has no bf16, gives
float32 for a bf16 file), so host memory holds about one tensor at a time.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from ..config import Gemma2Config, SiglipVisionConfig, SpatialVLAConfig


def target_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} but torch.cuda.is_available() is False: "
                           "no card to load onto; pass device='cpu' to load on the CPU")
    return device


def put(x, device, dtype=None, transpose=False) -> torch.Tensor:
    """One tensor on ``device`` in ``dtype`` (moved first, then transposed and
    cast there), contiguous."""
    t = torch.as_tensor(x).to(device)
    if transpose:
        t = t.t()
    return t.to(dtype).contiguous() if dtype is not None else t.contiguous()


def stack(sd: Mapping, fmt: str, L: int, device, dtype=None, transpose=True) -> torch.Tensor:
    return torch.stack([put(sd[fmt.format(i)], device, dtype, transpose) for i in range(L)])


def gemma2_from_state_dict(sd: Mapping[str, Any], cfg: Gemma2Config, prefix: str = "",
                           dtype=None, device="cuda") -> Dict[str, Any]:
    """An HF Gemma2ForCausalLM state dict (keys like
    ``model.layers.0.self_attn.q_proj.weight``) -> the LM tree."""
    p, L, dev = prefix, cfg.num_layers, target_device(device)

    def st(name, transpose=True):
        return stack(sd, f"{p}model.layers.{{}}.{name}.weight", L, dev, dtype, transpose)

    params = {
        "embed": put(sd[f"{p}model.embed_tokens.weight"], dev, dtype),
        "layers": {
            "attn": {k: st(f"self_attn.{k}_proj") for k in ("q", "k", "v", "o")},
            "mlp": {k: st(f"mlp.{k}_proj") for k in ("gate", "up", "down")},
            "input_norm": st("input_layernorm", False),
            "post_attn_norm": st("post_attention_layernorm", False),
            "pre_ffn_norm": st("pre_feedforward_layernorm", False),
            "post_ffn_norm": st("post_feedforward_layernorm", False),
        },
        "final_norm": put(sd[f"{p}model.norm.weight"], dev, dtype),
    }
    if f"{p}lm_head.weight" in sd:
        params["lm_head"] = put(sd[f"{p}lm_head.weight"], dev, dtype, transpose=True)
    elif not cfg.tie_lm_head:
        # tied checkpoint but untied config: clone the embedding
        params["lm_head"] = params["embed"].t().contiguous()
    return params


def siglip_from_state_dict(sd: Mapping[str, Any], cfg: SiglipVisionConfig, prefix: str = "",
                           dtype=None, device="cuda") -> Dict[str, Any]:
    """An HF SiglipVisionModel state dict (keys like
    ``vision_model.encoder.layers.0.self_attn.q_proj.weight``) -> the tree."""
    p, L, dev = prefix, cfg.num_layers, target_device(device)
    lay = f"{p}vision_model.encoder.layers.{{}}"

    def stack_wb(name):
        return {"w": stack(sd, f"{lay}.{name}.weight", L, dev, dtype),
                "b": stack(sd, f"{lay}.{name}.bias", L, dev, dtype, transpose=False)}

    def ln(name):
        return {"scale": stack(sd, f"{lay}.{name}.weight", L, dev, dtype, transpose=False),
                "bias": stack(sd, f"{lay}.{name}.bias", L, dev, dtype, transpose=False)}

    # conv patch embed: torch conv weight (H, 3, P, P) -> (P, P, 3, H) HWIO
    conv_w = put(sd[f"{p}vision_model.embeddings.patch_embedding.weight"], dev, dtype)
    return {
        "patch_embed": {
            "w": conv_w.permute(2, 3, 1, 0).contiguous(),
            "b": put(sd[f"{p}vision_model.embeddings.patch_embedding.bias"], dev, dtype),
        },
        "pos_embed": put(sd[f"{p}vision_model.embeddings.position_embedding.weight"], dev, dtype),
        "layers": {
            "attn": {"q": stack_wb("self_attn.q_proj"), "k": stack_wb("self_attn.k_proj"),
                     "v": stack_wb("self_attn.v_proj"), "o": stack_wb("self_attn.out_proj")},
            "ln1": ln("layer_norm1"),
            "ln2": ln("layer_norm2"),
            "mlp": {"fc1": stack_wb("mlp.fc1"), "fc2": stack_wb("mlp.fc2")},
        },
        "post_ln": {
            "scale": put(sd[f"{p}vision_model.post_layernorm.weight"], dev, dtype),
            "bias": put(sd[f"{p}vision_model.post_layernorm.bias"], dev, dtype),
        },
    }


def ego3d_from_state_dict(sd: Mapping[str, Any], prefix: str = "", dtype=None, device="cuda"):
    """Ego3DPositionEmbeddingMLP: Sequential(Linear, LayerNorm, ReLU, Linear)
    under ``position_embedding_head.{0,1,3}`` (modeling_spatialvla.py:59-64)."""
    p, dev = f"{prefix}position_embedding_head", target_device(device)
    return {
        "fc1": {"w": put(sd[f"{p}.0.weight"], dev, dtype, transpose=True),
                "b": put(sd[f"{p}.0.bias"], dev, dtype)},
        "ln": {"scale": put(sd[f"{p}.1.weight"], dev, dtype),
               "bias": put(sd[f"{p}.1.bias"], dev, dtype)},
        "fc2": {"w": put(sd[f"{p}.3.weight"], dev, dtype, transpose=True),
                "b": put(sd[f"{p}.3.bias"], dev, dtype)},
    }


def spatialvla_from_state_dict(sd: Mapping[str, Any], cfg: SpatialVLAConfig, dtype=None,
                               device="cuda") -> Dict[str, Any]:
    """A SpatialVLAForConditionalGeneration state dict -> the fusion tree
    (vision / projector / lm / spatial_embed / [ego3d, zoe])."""
    dev = target_device(device)
    params = {
        "vision": siglip_from_state_dict(sd, cfg.vision, prefix="vision_tower.", dtype=dtype,
                                         device=dev),
        "projector": {
            "w": put(sd["multi_modal_projector.linear.weight"], dev, dtype, transpose=True),
            "b": put(sd["multi_modal_projector.linear.bias"], dev, dtype),
        },
        "lm": gemma2_from_state_dict(sd, cfg.text, prefix="language_model.", dtype=dtype,
                                     device=dev),
    }
    if cfg.use_spatial_token:
        params["spatial_embed"] = put(sd["spatial_embed_tokens.weight"], dev, dtype)
    if cfg.use_vision_zoe and any(k.startswith("position_embedding_3d.") for k in sd):
        params["ego3d"] = ego3d_from_state_dict(sd, prefix="position_embedding_3d.", dtype=dtype,
                                                device=dev)
    if cfg.use_vision_zoe and any(k.startswith("vision_zoe_model.") for k in sd):
        from .zoe import zoe_from_state_dict

        params["zoe"] = zoe_from_state_dict(sd, cfg.zoe, prefix="vision_zoe_model.", dtype=dtype,
                                            device=dev)
    return params
