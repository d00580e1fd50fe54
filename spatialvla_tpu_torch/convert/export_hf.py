"""The port's parameter trees -> reference-format HF checkpoints (port of
spatialvla_tpu/convert/export_hf.py).

The inverse of convert/params.py + convert/zoe.py: unstacks the layer
tensors, transposes Linear weights back to torch (out, in), restores torch
Conv2d OIHW / ConvTranspose2d IOHW layouts, and writes a checkpoint
directory (model.safetensors + config.json + processor artifacts) in the
reference's on-disk format (test/test_huggingface.py:12-17,
modeling_spatialvla.py:494-526). The state dict holds views of the tree's
tensors, on their device and in their dtype (a bf16 tree exports bf16, where
the JAX package's numpy exports float32); ``safetensors_io.save_file``
copies one tensor at a time to the host as it writes.

Loading the export in the reference stack: instantiate the reference's own
model classes on it --

    SpatialVLAForConditionalGeneration.from_pretrained(export_dir)

from a checkout of the reference repo (its released checkpoints also ship
configuration_spatialvla.py / modeling_spatialvla.py beside the weights for
``AutoModel.from_pretrained(..., trust_remote_code=True)``; those files
belong to the reference and are not vendored here).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping

import torch

from ..config import SpatialVLAConfig, ZoeDepthConfig
from ..models.zoe import REASSEMBLE_FACTORS
from .bridge import map_tree
from .safetensors_io import save_file


def _np(x) -> torch.Tensor:
    return x.detach()


def _unlin(sd: Dict, name: str, tree: Mapping):
    sd[f"{name}.weight"] = _np(tree["w"]).T
    if "b" in tree:
        sd[f"{name}.bias"] = _np(tree["b"])


def _unln(sd: Dict, name: str, tree: Mapping):
    sd[f"{name}.weight"] = _np(tree["scale"])
    sd[f"{name}.bias"] = _np(tree["bias"])


def _unconv(sd: Dict, name: str, tree: Mapping):
    # HWIO -> torch OIHW
    sd[f"{name}.weight"] = _np(tree["w"]).permute(3, 2, 0, 1)
    if "b" in tree:
        sd[f"{name}.bias"] = _np(tree["b"])


def _unconvT(sd: Dict, name: str, tree: Mapping):
    # (kH, kW, O, I) -> torch ConvTranspose2d (I, O, kH, kW)
    sd[f"{name}.weight"] = _np(tree["w"]).permute(3, 2, 0, 1)
    sd[f"{name}.bias"] = _np(tree["b"])


def _layer(tree: Mapping, i: int) -> Dict:
    """Slice layer i out of a stacked subtree."""
    return map_tree(lambda x: x[i], dict(tree))


# ---------------------------------------------------------------------------
# submodule inverses (mirrors of convert/params.py)
# ---------------------------------------------------------------------------


def gemma2_to_state_dict(params: Mapping, cfg, prefix: str = "") -> Dict[str, torch.Tensor]:
    p = prefix
    sd: Dict[str, torch.Tensor] = {
        f"{p}model.embed_tokens.weight": _np(params["embed"]),
        f"{p}model.norm.weight": _np(params["final_norm"]),
    }
    lay = params["layers"]
    for i in range(cfg.num_layers):
        b = f"{p}model.layers.{i}"
        for ours, theirs in (
            ("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
            ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
        ):
            sd[f"{b}.{theirs}.weight"] = _np(lay["attn"][ours][i]).T
        for ours, theirs in (
            ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"),
            ("down", "mlp.down_proj"),
        ):
            sd[f"{b}.{theirs}.weight"] = _np(lay["mlp"][ours][i]).T
        for ours, theirs in (
            ("input_norm", "input_layernorm"),
            ("post_attn_norm", "post_attention_layernorm"),
            ("pre_ffn_norm", "pre_feedforward_layernorm"),
            ("post_ffn_norm", "post_feedforward_layernorm"),
        ):
            sd[f"{b}.{theirs}.weight"] = _np(lay[ours][i])
    if "lm_head" in params:
        sd[f"{p}lm_head.weight"] = _np(params["lm_head"]).T
    return sd


def siglip_to_state_dict(params: Mapping, cfg, prefix: str = "") -> Dict[str, torch.Tensor]:
    p = prefix
    sd: Dict[str, torch.Tensor] = {}
    # (P, P, 3, H) HWIO -> torch (H, 3, P, P)
    sd[f"{p}vision_model.embeddings.patch_embedding.weight"] = _np(
        params["patch_embed"]["w"]
    ).permute(3, 2, 0, 1)
    sd[f"{p}vision_model.embeddings.patch_embedding.bias"] = _np(params["patch_embed"]["b"])
    sd[f"{p}vision_model.embeddings.position_embedding.weight"] = _np(params["pos_embed"])
    lay = params["layers"]
    for i in range(cfg.num_layers):
        b = f"{p}vision_model.encoder.layers.{i}"
        for ours, theirs in (
            ("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
            ("v", "self_attn.v_proj"), ("o", "self_attn.out_proj"),
        ):
            _unlin(sd, f"{b}.{theirs}", _layer(lay["attn"][ours], i))
        _unln(sd, f"{b}.layer_norm1", _layer(lay["ln1"], i))
        _unln(sd, f"{b}.layer_norm2", _layer(lay["ln2"], i))
        _unlin(sd, f"{b}.mlp.fc1", _layer(lay["mlp"]["fc1"], i))
        _unlin(sd, f"{b}.mlp.fc2", _layer(lay["mlp"]["fc2"], i))
    _unln(sd, f"{p}vision_model.post_layernorm", params["post_ln"])
    return sd


def ego3d_to_state_dict(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    p = prefix
    sd: Dict[str, torch.Tensor] = {}
    _unlin(sd, f"{p}position_embedding_head.0", params["fc1"])
    _unln(sd, f"{p}position_embedding_head.1", params["ln"])
    _unlin(sd, f"{p}position_embedding_head.3", params["fc2"])
    return sd


def zoe_to_state_dict(
    params: Mapping, cfg: ZoeDepthConfig, prefix: str = ""
) -> Dict[str, torch.Tensor]:
    p = prefix
    sd: Dict[str, torch.Tensor] = {}

    # backbone
    bb = params["backbone"]
    _unconv(sd, f"{p}backbone.embeddings.patch_embeddings.projection", bb["patch_embed"])
    sd[f"{p}backbone.embeddings.cls_token"] = _np(bb["cls_token"])
    for i in range(cfg.num_layers):
        lp = _layer(bb["layers"], i)
        b = f"{p}backbone.encoder.layer.{i}"
        _unln(sd, f"{b}.layernorm_before", lp["ln1"])
        _unln(sd, f"{b}.layernorm_after", lp["ln2"])
        _unlin(sd, f"{b}.attention.attention.query", lp["q"])
        _unlin(sd, f"{b}.attention.attention.key", lp["k"])
        _unlin(sd, f"{b}.attention.attention.value", lp["v"])
        _unlin(sd, f"{b}.attention.output.dense", lp["proj"])
        sd[
            f"{b}.attention.attention.relative_position_bias.relative_position_bias_table"
        ] = _np(lp["rel_pos_table"])
        sd[f"{b}.lambda_1"] = _np(lp["lambda1"])
        sd[f"{b}.lambda_2"] = _np(lp["lambda2"])
        _unlin(sd, f"{b}.intermediate.dense", lp["fc1"])
        _unlin(sd, f"{b}.output.dense", lp["fc2"])

    # neck
    neck = params["neck"]
    for i, factor in enumerate(REASSEMBLE_FACTORS):
        entry = neck["reassemble"][i]
        _unlin(sd, f"{p}neck.reassemble_stage.readout_projects.{i}.0", entry["readout"])
        _unconv(sd, f"{p}neck.reassemble_stage.layers.{i}.projection", entry["projection"])
        if factor > 1:
            _unconvT(sd, f"{p}neck.reassemble_stage.layers.{i}.resize", entry["resize"])
        elif factor < 1:
            _unconv(sd, f"{p}neck.reassemble_stage.layers.{i}.resize", entry["resize"])
    for i in range(4):
        _unconv(sd, f"{p}neck.convs.{i}", neck["convs"][i])
        fu = neck["fusion"][i]
        _unconv(sd, f"{p}neck.fusion_stage.layers.{i}.projection", fu["projection"])
        for res, rn in (("res1", "residual_layer1"), ("res2", "residual_layer2")):
            _unconv(sd, f"{p}neck.fusion_stage.layers.{i}.{rn}.convolution1", fu[res]["conv1"])
            _unconv(sd, f"{p}neck.fusion_stage.layers.{i}.{rn}.convolution2", fu[res]["conv2"])

    # relative head
    for c in ("conv1", "conv2", "conv3"):
        _unconv(sd, f"{p}relative_head.{c}", params["relative_head"][c])

    # metric head
    mh = params["metric_head"]
    _unconv(sd, f"{p}metric_head.conv2", mh["conv2"])
    _unconv(
        sd, f"{p}metric_head.patch_transformer.embedding_convPxP",
        mh["patch_transformer"]["embed_conv"],
    )
    for i in range(cfg.num_patch_transformer_layers):
        lp = _layer(mh["patch_transformer"]["layers"], i)
        b = f"{p}metric_head.patch_transformer.transformer_encoder.{i}"
        _unlin(sd, f"{b}.self_attn.query", lp["q"])
        _unlin(sd, f"{b}.self_attn.key", lp["k"])
        _unlin(sd, f"{b}.self_attn.value", lp["v"])
        _unlin(sd, f"{b}.self_attn.out_proj", lp["out"])
        _unlin(sd, f"{b}.linear1", lp["fc1"])
        _unlin(sd, f"{b}.linear2", lp["fc2"])
        _unln(sd, f"{b}.norm1", lp["ln1"])
        _unln(sd, f"{b}.norm2", lp["ln2"])
    _unlin(sd, f"{p}metric_head.mlp_classifier.linear1", mh["mlp_classifier"]["fc1"])
    _unlin(sd, f"{p}metric_head.mlp_classifier.linear2", mh["mlp_classifier"]["fc2"])

    def unprojector(name: str, tree: Mapping):
        _unconv(sd, f"{name}.conv1", tree["conv1"])
        _unconv(sd, f"{name}.conv2", tree["conv2"])

    unprojector(f"{p}metric_head.seed_projector", mh["seed_projector"])
    for i in range(4):
        unprojector(f"{p}metric_head.projectors.{i}", mh["projectors"][i])
    for name in ("nyu", "kitti"):
        ex = mh["experts"][name]
        unprojector(f"{p}metric_head.seed_bin_regressors.{name}", ex["seed_bin_regressor"])
        for i in range(4):
            unprojector(f"{p}metric_head.attractors.{name}.{i}", ex["attractors"][i])
        _unconv(
            sd, f"{p}metric_head.conditional_log_binomial.{name}.mlp.0",
            ex["log_binomial"]["conv1"],
        )
        _unconv(
            sd, f"{p}metric_head.conditional_log_binomial.{name}.mlp.2",
            ex["log_binomial"]["conv2"],
        )
    return sd


def spatialvla_to_state_dict(
    params: Mapping, cfg: SpatialVLAConfig
) -> Dict[str, torch.Tensor]:
    """Full fusion pytree -> HF-layout flat state dict (the exact inverse of
    spatialvla_from_state_dict; round-trip is bit-exact)."""
    sd = siglip_to_state_dict(params["vision"], cfg.vision, prefix="vision_tower.")
    _unlin(sd, "multi_modal_projector.linear", params["projector"])
    sd.update(gemma2_to_state_dict(params["lm"], cfg.text, prefix="language_model."))
    if "spatial_embed" in params:
        sd["spatial_embed_tokens.weight"] = _np(params["spatial_embed"])
    if "ego3d" in params:
        sd.update(ego3d_to_state_dict(params["ego3d"], prefix="position_embedding_3d."))
    if "zoe" in params and cfg.zoe is not None:
        sd.update(zoe_to_state_dict(params["zoe"], cfg.zoe, prefix="vision_zoe_model."))
    return sd


# ---------------------------------------------------------------------------
# config + full checkpoint directory
# ---------------------------------------------------------------------------


def config_to_hf(cfg: SpatialVLAConfig) -> Dict[str, Any]:
    """SpatialVLAConfig -> reference config.json schema (the inverse of
    hf_checkpoint.config_from_hf; reference configuration_spatialvla.py)."""
    v, t = cfg.vision, cfg.text
    d: Dict[str, Any] = {
        "model_type": "spatialvla",
        "architectures": ["SpatialVLAForConditionalGeneration"],
        # NOTE: no auto_map — trust_remote_code loading needs the model .py
        # files beside the weights, which belong to the reference repo and
        # are not vendored here; see export_hf_checkpoint's docstring
        "vision_config": {
            "model_type": "siglip_vision_model",
            "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size,
            "num_hidden_layers": v.num_layers,
            "num_attention_heads": v.num_heads,
            "patch_size": v.patch_size,
            "image_size": v.image_size,
            "layer_norm_eps": v.layer_norm_eps,
            "projection_dim": v.projection_dim,
            "vision_use_head": False,
        },
        "text_config": {
            "model_type": "gemma2",
            "vocab_size": t.vocab_size,
            "hidden_size": t.hidden_size,
            "intermediate_size": t.intermediate_size,
            "num_hidden_layers": t.num_layers,
            "num_attention_heads": t.num_heads,
            "num_key_value_heads": t.num_kv_heads,
            "head_dim": t.head_dim,
            "sliding_window": t.sliding_window,
            "rope_theta": t.rope_theta,
            "rms_norm_eps": t.rms_norm_eps,
            "attn_logit_softcapping": t.attn_logit_softcap,
            "final_logit_softcapping": t.final_logit_softcap,
            "query_pre_attn_scalar": t.query_pre_attn_scalar,
            "hidden_activation": "gelu_pytorch_tanh",
        },
        "projection_dim": v.projection_dim,
        "image_token_index": cfg.image_token_index,
        "spatial_token_num": cfg.spatial_token_num,
        "action_token_begin_idx": cfg.action_token_begin_idx,
        "use_spatial_token": cfg.use_spatial_token,
        "use_vision_zoe": cfg.use_vision_zoe and cfg.zoe is not None,
        "ego3d_patch_reso": cfg.ego3d.patch_reso,
        "n_freqs": cfg.ego3d.n_freqs,
    }
    z = cfg.zoe
    if z is not None and cfg.use_vision_zoe:
        d["vision_zoe_config"] = {
            "model_type": "zoedepth",
            "backbone_config": {
                "model_type": "beit",
                "hidden_size": z.hidden_size,
                "intermediate_size": z.intermediate_size,
                "num_hidden_layers": z.num_layers,
                "num_attention_heads": z.num_heads,
                "patch_size": z.patch_size,
                "image_size": z.image_size,
                "out_indices": list(z.out_indices),
                "use_relative_position_bias": True,
            },
            "neck_hidden_sizes": list(z.neck_hidden_sizes),
            "fusion_hidden_size": z.fusion_hidden_size,
            "bottleneck_features": z.bottleneck_features,
            "num_relative_features": z.num_relative_features,
            "num_attractors": list(z.n_attractors),
            "bin_embedding_dim": z.bin_embedding_dim,
            "num_patch_transformer_layers": z.num_patch_transformer_layers,
            "patch_transformer_hidden_size": z.patch_transformer_hidden_size,
            "patch_transformer_intermediate_size": z.patch_transformer_intermediate_size,
            "patch_transformer_num_attention_heads": z.patch_transformer_num_attention_heads,
            "bin_configurations": [
                {"name": "nyu", "n_bins": z.num_bins, "min_depth": 1e-3, "max_depth": 10.0},
                {"name": "kitti", "n_bins": z.num_bins, "min_depth": 1e-3, "max_depth": 80.0},
            ],
            "min_temp": z.min_temp,
            "max_temp": z.max_temp,
        }
    return d


def export_hf_checkpoint(
    params: Mapping,
    cfg: SpatialVLAConfig,
    out_dir: str,
    *,
    processor=None,
) -> str:
    """Write a reference-format checkpoint directory: model.safetensors,
    config.json, and (when given) the processor artifacts
    (processor_config.json + tokenizer files), mirroring what the reference
    trainer saves per checkpoint (train/monkey_patch.py:332-342)."""
    os.makedirs(out_dir, exist_ok=True)
    sd = spatialvla_to_state_dict(params, cfg)
    save_file(sd, os.path.join(out_dir, "model.safetensors"))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config_to_hf(cfg), f, indent=2)
    if processor is not None:
        processor.save(out_dir)
        tok = getattr(processor, "text_tokenizer", None)
        inner = getattr(tok, "tok", None)  # HFTokenizerAdapter wraps .tok
        if inner is not None and hasattr(inner, "save_pretrained"):
            inner.save_pretrained(out_dir)
        # reference-schema image-processor config (SiglipImageProcessor with
        # do_normalize=False — raw pixels are re-used by ZoeDepth,
        # spatialvla_pretrain.py:366): lets the reference's
        # AutoProcessor.from_pretrained(dir, trust_remote_code=True)
        # (test/test_huggingface.py:15) rebuild the image processor once the
        # reference's processing_*.py files are copied into the directory
        # (the auto_map caveat in this module's docstring applies to the
        # processor exactly as to the model)
        size = int(getattr(processor, "image_size", cfg.vision.image_size))
        with open(os.path.join(out_dir, "preprocessor_config.json"), "w") as f:
            json.dump({
                "image_processor_type": "SiglipImageProcessor",
                "processor_class": "SpatialVLAProcessor",
                "do_resize": True,
                "size": {"height": size, "width": size},
                "resample": 3,
                "do_rescale": True,
                "rescale_factor": 1.0 / 255.0,
                "do_normalize": False,
                "image_mean": [0.5, 0.5, 0.5],
                "image_std": [0.5, 0.5, 0.5],
                "image_seq_length": int(processor.image_seq_length),
            }, f, indent=2)
    return out_dir
