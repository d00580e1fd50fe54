"""User-facing inference API (port of spatialvla_tpu/inference.py):

    policy = SpatialVLAPolicy.init_random(spatialvla_4b(), "cuda:0", seed=0)
    policy.quantize(bits=8)
    out = policy.predict(image, "move the cup")
    out["actions"]  # (chunk, 7)

The parameters are the JAX tree's nested dict of tensors (same keys and
shapes; convert/bridge.py moves trees between the packages). ``quantize``
takes every serving format of the JAX package: int8 or int4 LM (per channel
or ``group_size``), ``mlp_bits=4`` for an int4 MLP under an int8 attention
and head, int8 or int4 vision front, and ``kv_bits=8`` for an int8 KV cache.
Loading a real checkpoint (``load``, ``from_hf_checkpoint``), ``shard`` and
``save_serving`` / ``load_serving`` are not ported yet (ROADMAP.md).

On the card the fused decode loop runs as a CUDA graph per batch size and
cache bucket (``models/spatialvla.py:GreedyLoop``; prefixes within 64 tokens
of each other share one), captured at the first request of that shape and
replayed after; the policy keeps them (``decode_graphs``) and drops them
whenever it replaces its parameters (``quantize``, ``to``).
``policy.use_cuda_graph = False`` serves through the eager loop instead.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .config import SpatialVLAConfig
from .convert.bridge import map_tree
from .errors import not_ported
from .models import spatialvla
from .ops.quant import quantize_lm_params, quantize_vision_params
from .processor import ByteTokenizer, SpatialVLAProcessor


def default_processor(config: SpatialVLAConfig) -> SpatialVLAProcessor:
    """A ByteTokenizer processor whose token ids follow ``config``, with
    identity un-normalization (q01 = -1, q99 = 1) for random weights."""
    return SpatialVLAProcessor(
        ByteTokenizer(),
        image_token_id=config.image_token_index,
        action_token_begin_idx=config.action_token_begin_idx,
        image_seq_length=config.num_image_tokens,
        image_size=config.vision.image_size,
        statistics={"random_init": {"action": {"q01": [-1.0] * 7, "q99": [1.0] * 7}}},
    )


class SpatialVLAPolicy:
    def __init__(self, params, config: SpatialVLAConfig, processor: SpatialVLAProcessor, *,
                 device, compute_dtype=torch.bfloat16):
        self.config = config
        self.processor = processor
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.params = map_tree(lambda t: t.to(self.device), params)
        self.depth_image_size: Optional[int] = None  # set by quantize()
        self.kv_bits: Optional[int] = None  # set by quantize()
        self.quant_desc: Optional[Dict] = None  # set by quantize()
        # the fused decode loop's CUDA graphs, captured for self.params;
        # use_cuda_graph None: on for CUDA tensors (predict_action's option)
        self.decode_graphs = spatialvla.DecodeGraphs()
        self.use_cuda_graph: Optional[bool] = None

    @classmethod
    def init_random(cls, config: SpatialVLAConfig, device, seed: int) -> "SpatialVLAPolicy":
        """bf16 random weights from ``torch.Generator(device).manual_seed(seed)``,
        made directly on ``device``, with the ByteTokenizer processor."""
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.inference_mode():
            params = spatialvla.init_params(config, generator=gen, device=device,
                                            dtype=torch.bfloat16)
        return cls(params, config, default_processor(config), device=device)

    def to(self, device) -> "SpatialVLAPolicy":
        """Move every parameter to ``device``; returns self. The decode
        graphs of the old tree are dropped."""
        self.device = torch.device(device)
        self.decode_graphs.clear()
        self.params = map_tree(lambda t: t.to(self.device), self.params)
        return self

    @classmethod
    def load(cls, *args, **kwargs):
        raise not_ported("loading an Orbax checkpoint (load)", "checkpoint")

    @classmethod
    def from_hf_checkpoint(cls, *args, **kwargs):
        raise not_ported("loading a Hugging Face checkpoint (from_hf_checkpoint)", "checkpoint")

    @classmethod
    def load_serving(cls, *args, **kwargs):
        raise not_ported("load_serving")

    def save_serving(self, *args, **kwargs):
        raise not_ported("save_serving")

    def shard(self, *args, **kwargs):
        raise not_ported("shard()")

    # ------------------------------------------------------------------
    def quantize(self, bits: Optional[int] = 8, *, vision_bits: Optional[int] = 8,
                 depth_image_size: Optional[int] = None, kv_bits: Optional[int] = None,
                 mlp_bits: Optional[int] = None,
                 group_size: Optional[int] = None) -> "SpatialVLAPolicy":
        """Serving form (inference.py:94 with its defaults): weight-only int8
        (bits=8) or packed-int4 (bits=4, per channel or ``group_size``) LM
        with fused qkv / gate_up (bits=None keeps it bf16); ``mlp_bits``
        overrides the MLP's precision (bits=8, mlp_bits=4 is the mixed tree);
        an int8 or int4 vision front (vision_bits, per channel; None keeps
        it bf16); the precomputed ZoeDepth relative-position bias; and
        ``kv_bits=8`` for an int8 KV cache on the fused decode path. In
        place; returns self. Each tensor is quantized on its own so the fp32
        temporaries stay small. The decode graphs of the old tree are
        dropped."""
        prior = self.quant_desc or {}
        # per-subtree re-pack guard: only the subtree already packed blocks a
        # second pass over it (a knob-only call never trips it)
        if bits and prior.get("bits"):
            raise ValueError(f"LM is already quantized ({self.quant_desc}); re-quantizing a "
                             "packed tree would corrupt it")
        if vision_bits and prior.get("vision_bits"):
            raise ValueError(f"vision front is already quantized ({self.quant_desc}); "
                             "re-quantizing a packed tree would corrupt it")
        if mlp_bits and not bits:
            raise ValueError("mlp_bits requires bits (the attention/head precision): a bf16 LM "
                             "with an int4 MLP is not a supported tree")
        if kv_bits not in (None, 8):
            raise ValueError(f"kv_bits={kv_bits}: only 8 (or None) is supported")
        self.decode_graphs.clear()
        params = dict(self.params)
        with torch.inference_mode():
            if bits:
                params["lm"] = quantize_lm_params(params["lm"], bits=bits, mlp_bits=mlp_bits,
                                                  group_size=group_size)
            if vision_bits:
                params = quantize_vision_params(params, bits=vision_bits)
            if "zoe" in params and "rel_pos_table" in params["zoe"]["backbone"]["layers"]:
                from .models.zoe import precompute_rel_bias

                params["zoe"] = precompute_rel_bias(params["zoe"], self.config.zoe,
                                                    image_size=depth_image_size)
        self.params = params
        self.depth_image_size = depth_image_size
        self.kv_bits = kv_bits
        if bits or vision_bits:
            self.quant_desc = {
                "bits": bits or prior.get("bits"),
                "vision_bits": vision_bits or prior.get("vision_bits"),
                "mlp_bits": mlp_bits if bits else prior.get("mlp_bits"),
                "group_size": group_size if bits else prior.get("group_size"),
            }
        return self

    # ------------------------------------------------------------------
    def _generate(self, inputs, attention_mask=None, return_margins=False):
        dev = self.device
        with torch.inference_mode():
            return spatialvla.predict_action(
                self.params, self.config,
                torch.as_tensor(inputs["input_ids"], dtype=torch.long, device=dev),
                pixel_values=torch.as_tensor(inputs["pixel_values"], device=dev),
                intrinsic=torch.as_tensor(inputs["intrinsic"], device=dev),
                attention_mask=attention_mask,
                action_chunk_size=self.processor.action_chunk_size,
                compute_dtype=self.compute_dtype,
                depth_image_size=self.depth_image_size,
                kv_bits=self.kv_bits,
                return_margins=return_margins,
                use_cuda_graph=self.use_cuda_graph,
                decode_graphs=self.decode_graphs,
            )

    def predict(self, image, instruction: str, *, unnorm_key: Optional[str] = None,
                return_margins: bool = False) -> Dict[str, np.ndarray]:
        """One observation -> {'actions': (chunk, 7), 'action_ids'} (and
        'margins', the (3*chunk,) per-step top1 - top2 logits)."""
        inputs = self.processor(image, instruction, unnorm_key=unnorm_key)
        generated = self._generate(inputs, return_margins=return_margins)
        if return_margins:
            generated, margins = generated
        out = self.processor.decode_actions(generated.cpu().numpy(), unnorm_key=unnorm_key)
        res = {"actions": out["actions"][0], "action_ids": out["action_ids"][0]}
        if return_margins:
            res["margins"] = margins.cpu().numpy()[0]
        return res

    def predict_batch(self, images, instructions, *, unnorm_key=None) -> Dict[str, np.ndarray]:
        """A batch of observations; mixed instruction lengths are right-padded
        and decoded pad-aware."""
        inputs = self.processor(list(images), list(instructions), unnorm_key=unnorm_key)
        attn = np.asarray(inputs["attention_mask"])
        mask = (torch.as_tensor(attn, device=self.device)
                if bool((attn == 0).any()) else None)
        generated = self._generate(inputs, attention_mask=mask)
        return self.processor.decode_actions(generated.cpu().numpy(), unnorm_key=unnorm_key)
