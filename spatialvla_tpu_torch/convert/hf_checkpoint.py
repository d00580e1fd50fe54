"""Load reference-format HF SpatialVLA checkpoints (a safetensors directory)
into the port (port of spatialvla_tpu/convert/hf_checkpoint.py): the
offline equivalent of AutoModel.from_pretrained(trust_remote_code=True) +
AutoProcessor (test/test_huggingface.py:12-17).

Handles: sharded/unsharded safetensors (+ index json), read by the port's
own reader (``safetensors_io``: the card's machine has no ``safetensors``
package), the reference config.json schema (configuration_spatialvla.py),
processor state (statistics / bin policy / intrinsics / action config), and
the from_pretrained embedding-sync quirk (spatial_embed_tokens rows are the
source of truth for the LM embedding tail, modeling_spatialvla.py:524-526
-- our model reads the separate table directly, so nothing to sync).
``config_from_hf`` and ``processor_from_hf`` are copies of the JAX
package's.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Tuple

from ..config import (
    Ego3DConfig,
    Gemma2Config,
    SiglipVisionConfig,
    SpatialVLAConfig,
    ZoeDepthConfig,
)
from ..processor import ByteTokenizer, SpatialVLAProcessor
from .params import spatialvla_from_state_dict
from .safetensors_io import (  # noqa: F401 -- the JAX module's names
    LazySafetensorsDict,
    lazy_safetensors_dir,
    load_safetensors_dir,
)


def config_from_hf(d: Dict) -> SpatialVLAConfig:
    """Reference config.json -> SpatialVLAConfig."""
    v = d.get("vision_config", {})
    vision = SiglipVisionConfig(
        hidden_size=v.get("hidden_size", 1152),
        intermediate_size=v.get("intermediate_size", 4304),
        num_layers=v.get("num_hidden_layers", 27),
        num_heads=v.get("num_attention_heads", 16),
        patch_size=v.get("patch_size", 14),
        image_size=v.get("image_size", 224),
        layer_norm_eps=v.get("layer_norm_eps", 1e-6),
        projection_dim=v.get("projection_dim", d.get("projection_dim", 2304)),
    )
    t = d.get("text_config", {})
    text = Gemma2Config(
        vocab_size=t.get("vocab_size", 257152),
        hidden_size=t.get("hidden_size", 2304),
        intermediate_size=t.get("intermediate_size", 9216),
        num_layers=t.get("num_hidden_layers", 26),
        num_heads=t.get("num_attention_heads", 8),
        num_kv_heads=t.get("num_key_value_heads", 4),
        head_dim=t.get("head_dim", 256),
        sliding_window=t.get("sliding_window", 4096),
        rope_theta=t.get("rope_theta", 10000.0),
        rms_norm_eps=t.get("rms_norm_eps", 1e-6),
        attn_logit_softcap=t.get("attn_logit_softcapping", 50.0),
        final_logit_softcap=t.get("final_logit_softcapping", 30.0),
        query_pre_attn_scalar=t.get("query_pre_attn_scalar", 256.0),
    )
    z = d.get("vision_zoe_config")
    zoe = None
    if z and d.get("use_vision_zoe", True):
        bb = z.get("backbone_config", {})
        bins = z.get("bin_configurations", [{"n_bins": 64}])
        zoe = ZoeDepthConfig(
            hidden_size=bb.get("hidden_size", 1024),
            intermediate_size=bb.get("intermediate_size", 4096),
            num_layers=bb.get("num_hidden_layers", 24),
            num_heads=bb.get("num_attention_heads", 16),
            patch_size=bb.get("patch_size", 16),
            image_size=bb.get("image_size", 384),
            neck_hidden_sizes=tuple(z.get("neck_hidden_sizes", (256, 512, 1024, 1024))),
            out_indices=tuple(bb.get("out_indices", (6, 12, 18, 24))),
            fusion_hidden_size=z.get("fusion_hidden_size", 256),
            bottleneck_features=z.get("bottleneck_features", 256),
            num_relative_features=z.get("num_relative_features", 32),
            n_attractors=tuple(z.get("num_attractors", (16, 8, 4, 1))),
            bin_embedding_dim=z.get("bin_embedding_dim", 128),
            num_patch_transformer_layers=z.get("num_patch_transformer_layers", 4) or 4,
            patch_transformer_hidden_size=z.get("patch_transformer_hidden_size", 128) or 128,
            patch_transformer_intermediate_size=z.get("patch_transformer_intermediate_size", 1024) or 1024,
            patch_transformer_num_attention_heads=z.get("patch_transformer_num_attention_heads", 4) or 4,
            num_bins=bins[0].get("n_bins", 64),
            min_temp=z.get("min_temp", 0.0212),
            max_temp=z.get("max_temp", 50.0),
        )
    return SpatialVLAConfig(
        vision=vision,
        text=text,
        ego3d=Ego3DConfig(
            patch_reso=d.get("ego3d_patch_reso", 2),
            n_freqs=d.get("n_freqs", 8),
            num_pos_feats=vision.hidden_size,
        ),
        zoe=zoe,
        image_token_index=d.get("image_token_index", 256000),
        spatial_token_num=d.get("spatial_token_num", 8194),
        action_token_begin_idx=d.get("action_token_begin_idx", 257152),
        use_spatial_token=d.get("use_spatial_token", True),
        use_vision_zoe=d.get("use_vision_zoe", True) and zoe is not None,
    )


def processor_from_hf(directory: str, config: SpatialVLAConfig, text_tokenizer=None):
    path = os.path.join(directory, "processor_config.json")
    state: Dict = {}
    if os.path.exists(path):
        with open(path) as f:
            state = json.load(f)
    if text_tokenizer is None:
        try:  # real Gemma tokenizer when transformers + files are present
            from transformers import AutoTokenizer

            from ..processor import HFTokenizerAdapter

            # trust_remote_code must be explicit: None triggers an
            # interactive prompt when the exported config carries auto_map
            tok = AutoTokenizer.from_pretrained(
                directory, local_files_only=True, trust_remote_code=False
            )
            text_tokenizer = HFTokenizerAdapter(tok)
        except Exception:
            text_tokenizer = ByteTokenizer()
    return SpatialVLAProcessor(
        text_tokenizer,
        image_token_id=config.image_token_index,
        action_token_begin_idx=config.action_token_begin_idx,
        image_seq_length=config.num_image_tokens,
        image_size=config.vision.image_size,
        statistics=state.get("statistics", {}),
        bin_policy=state.get("bin_policy"),
        intrinsic_config=state.get("intrinsic_config"),
        action_config=state.get("action_config"),
        num_obs_steps=state.get("num_obs_steps", 1),
        obs_delta=state.get("obs_delta", 1),
        action_chunk_size=state.get("action_chunk_size", 4),
        min_sigma=state.get("min_sigma", 0.0),
    )


def load_hf_checkpoint(
    directory: str, *, text_tokenizer=None, dtype=None, device="cuda"
) -> Tuple[Dict, SpatialVLAConfig, SpatialVLAProcessor]:
    with open(os.path.join(directory, "config.json")) as f:
        config = config_from_hf(json.load(f))
    # stream tensors through the converter one at a time (LazySafetensorsDict):
    # each goes to ``device`` as it is read, so host memory holds about one
    # tensor instead of the whole state dict
    params = spatialvla_from_state_dict(
        lazy_safetensors_dir(directory), config, dtype=dtype, device=device
    )
    processor = processor_from_hf(directory, config, text_tokenizer)
    return params, config, processor
