"""Configuration system for the SpatialVLA-TPU framework.

Plain frozen dataclasses (hashable -> safe to close over in jitted functions as
static config), JSON round-trip, and named presets matching the reference
model family (SpatialVLA = SigLIP-so400m ViT + Ego3D position encoding +
Gemma2 decoder + spatial action token head).

Reference parity: the reference repository's model/configuration_spatialvla.py:22-119
(composite config with vision/text/zoe sub-configs and the VLA-specific
fields) re-expressed as typed dataclasses instead of HF PretrainedConfig.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


def _asdict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


@dataclass(frozen=True)
class SiglipVisionConfig:
    """SigLIP ViT image encoder (reference default: so400m, 27 layers,
    hidden 1152, patch 14, img 224 — configuration_spatialvla.py:58-67)."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 224
    layer_norm_eps: float = 1e-6
    # output projection into the LM embedding space
    projection_dim: int = 2304

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class Gemma2Config:
    """Gemma2 decoder. Defaults follow the PaliGemma2-3B text tower
    (what the released spatialvla-4b checkpoints use). Semantics mirrored
    from the reference's vendored decoder (model/modeling_gemma2.py):
    GQA, alternating sliding-window layers (even layers windowed,
    modeling_gemma2.py:343), attn/final logit softcapping (:182-185,
    :994-997), query_pre_attn_scalar**-0.5 scaling (:342), embeddings
    scaled by sqrt(hidden) (:739-742), sandwich RMSNorm (:444-448)."""

    vocab_size: int = 257152
    hidden_size: int = 2304
    intermediate_size: int = 9216
    num_layers: int = 26
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 256
    sliding_window: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    attn_logit_softcap: Optional[float] = 50.0
    final_logit_softcap: Optional[float] = 30.0
    query_pre_attn_scalar: float = 256.0
    attention_bias: bool = False
    # distinct lm_head (untied from the embedding table, as the reference
    # untangles it when adding action tokens — spatialvla_pretrain.py:321-325)
    tie_lm_head: bool = False

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


@dataclass(frozen=True)
class Ego3DConfig:
    """Ego3D positional-encoding MLP over back-projected per-patch 3D points
    (reference: Ego3DPositionEmbeddingMLP, modeling_spatialvla.py:41-97;
    reso/n_freqs defaults from train/spatialvla_pretrain.py:89-93)."""

    patch_reso: int = 2  # reso^2 sample points per vision patch
    n_freqs: int = 8
    num_pos_feats: int = 1152  # == vision hidden size

    @property
    def in_channels(self) -> int:
        return 3 * self.patch_reso**2

    @property
    def freq_out_channels(self) -> int:
        return self.in_channels * (2 * self.n_freqs + 1)


@dataclass(frozen=True)
class ZoeDepthConfig:
    """ZoeDepth metric-depth estimator (BEiT backbone + metric-bins head).
    Defaults follow Intel/zoedepth-nyu-kitti (beit-large 24x1024, 2 virtual
    metric-bin experts NYU/KITTI)."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    patch_size: int = 16
    image_size: int = 384
    # indices of backbone layers tapped for the neck (reassemble stages)
    neck_hidden_sizes: tuple = (256, 512, 1024, 1024)
    out_indices: tuple = (6, 12, 18, 24)
    fusion_hidden_size: int = 256
    bottleneck_features: int = 256
    num_relative_features: int = 32
    n_attractors: tuple = (16, 8, 4, 1)
    bin_embedding_dim: int = 128
    num_patch_transformer_layers: int = 4
    patch_transformer_hidden_size: int = 128
    patch_transformer_intermediate_size: int = 1024
    patch_transformer_num_attention_heads: int = 4
    layer_norm_eps: float = 1e-6
    # per-domain (NYU / KITTI) bin configurations
    num_bins: int = 64
    min_depth: float = 1e-3
    max_depth_nyu: float = 10.0
    max_depth_kitti: float = 80.0
    min_temp: float = 0.0212
    max_temp: float = 50.0


@dataclass(frozen=True)
class SpatialVLAConfig:
    """Composite VLA config (reference: configuration_spatialvla.py:26-102)."""

    vision: SiglipVisionConfig = field(default_factory=SiglipVisionConfig)
    text: Gemma2Config = field(default_factory=Gemma2Config)
    ego3d: Ego3DConfig = field(default_factory=Ego3DConfig)
    zoe: Optional[ZoeDepthConfig] = field(default_factory=ZoeDepthConfig)

    image_token_index: int = 257152  # <image> id in the PaliGemma2 tokenizer
    ignore_index: int = -100
    spatial_token_num: int = 8194
    action_token_begin_idx: int = 257153
    use_spatial_token: bool = True
    use_vision_zoe: bool = True

    @property
    def num_image_tokens(self) -> int:
        return self.vision.num_patches

    def to_json(self) -> str:
        d = _asdict(self)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "SpatialVLAConfig":
        d = json.loads(text)
        return cls.from_dict(d)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SpatialVLAConfig":
        def _tupleize(x):
            return tuple(x) if isinstance(x, list) else x

        vision = SiglipVisionConfig(**d["vision"]) if d.get("vision") else SiglipVisionConfig()
        text = Gemma2Config(**d["text"]) if d.get("text") else Gemma2Config()
        ego3d = Ego3DConfig(**d["ego3d"]) if d.get("ego3d") else Ego3DConfig()
        zoe = None
        if d.get("zoe"):
            zd = {k: _tupleize(v) for k, v in d["zoe"].items()}
            zoe = ZoeDepthConfig(**zd)
        extra = {
            k: v
            for k, v in d.items()
            if k not in ("vision", "text", "ego3d", "zoe")
        }
        return cls(vision=vision, text=text, ego3d=ego3d, zoe=zoe, **extra)


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

def spatialvla_4b() -> SpatialVLAConfig:
    """The flagship: PaliGemma2-3B (SigLIP-so400m-14/224 + Gemma2-2B) +
    ZoeDepth + 8194 spatial action tokens. Token-id layout follows the
    reference tokenizer: base vocab 257152, <image>=257152 in PaliGemma2
    tokenizers... the reference uses image_token_index=256000
    (configuration_spatialvla.py:31) with the PaliGemma vocab where <image>
    sits at 256000 and ids 256000-257151 are extra tokens. Action tokens are
    appended after 257152."""
    text = Gemma2Config(vocab_size=257152 + 8194)
    return SpatialVLAConfig(
        vision=SiglipVisionConfig(),
        text=text,
        ego3d=Ego3DConfig(num_pos_feats=1152),
        zoe=ZoeDepthConfig(),
        image_token_index=256000,
        spatial_token_num=8194,
        action_token_begin_idx=257152,
        use_spatial_token=True,
        use_vision_zoe=True,
    )


def spatialvla_tiny(use_vision_zoe: bool = False) -> SpatialVLAConfig:
    """A tiny config for tests/CI: same topology, toy sizes."""
    vision = SiglipVisionConfig(
        hidden_size=32,
        intermediate_size=64,
        num_layers=2,
        num_heads=4,
        patch_size=14,
        image_size=56,
        projection_dim=48,
    )
    text = Gemma2Config(
        vocab_size=1024 + 8194,
        hidden_size=48,
        intermediate_size=96,
        num_layers=4,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        sliding_window=8,
        query_pre_attn_scalar=16.0,
    )
    zoe = (
        ZoeDepthConfig(
            hidden_size=32,
            intermediate_size=64,
            num_layers=4,
            num_heads=4,
            patch_size=16,
            image_size=64,
            neck_hidden_sizes=(8, 16, 32, 32),
            out_indices=(1, 2, 3, 4),
            fusion_hidden_size=16,
            bottleneck_features=16,
            num_relative_features=8,
            bin_embedding_dim=8,
            num_patch_transformer_layers=4,
            patch_transformer_hidden_size=128,
            patch_transformer_intermediate_size=64,
            patch_transformer_num_attention_heads=2,
            num_bins=16,
        )
        if use_vision_zoe
        else None
    )
    return SpatialVLAConfig(
        vision=vision,
        text=text,
        ego3d=Ego3DConfig(patch_reso=2, n_freqs=4, num_pos_feats=32),
        zoe=zoe,
        image_token_index=1000,
        spatial_token_num=8194,  # full action grid; embedding rows stay tiny
        action_token_begin_idx=1024,
        use_spatial_token=True,
        use_vision_zoe=use_vision_zoe,
    )
