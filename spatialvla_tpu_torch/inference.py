"""User-facing inference API (port of spatialvla_tpu/inference.py):

    policy = SpatialVLAPolicy.from_hf_checkpoint("path/to/hf_checkpoint")  # on "cuda"
    policy.quantize(bits=8)
    out = policy.predict(image, "move the cup", unnorm_key="bridge_orig/1.0.0")
    out["actions"]  # (chunk, 7)

The parameters are the JAX tree's nested dict of tensors (same keys and
shapes; convert/bridge.py moves trees between the packages). They come from
a reference-format HF checkpoint (``from_hf_checkpoint``), a checkpoint of
the port's own format (``load``, ``train/checkpoints.py``), a serving
checkpoint (``save_serving`` / ``load_serving``: the quantized tree and its
knobs, stored as they are) or random weights (``init_random``). Every loader
takes ``device`` (default "cuda", which raises without a card; the tests
pass "cpu"). ``quantize`` takes every serving format of the JAX package:
int8 or int4 LM (per channel or ``group_size``), ``mlp_bits=4`` for an int4
MLP under an int8 attention and head, int8 or int4 vision front, and
``kv_bits=8`` for an int8 KV cache. ``shard`` lays the tree over a
``data x model`` mesh held by this process (tensor-parallel serving, below).

On the card the fused decode loop runs as a CUDA graph per batch size and
cache bucket (``models/spatialvla.py:GreedyLoop``; prefixes within 64 tokens
of each other share one), captured at the first request of that shape and
replayed after; the policy keeps them (``decode_graphs``) and drops them
whenever it replaces its parameters (``quantize``, ``to``).
``policy.use_cuda_graph = False`` serves through the eager loop instead.

``shard(n_model=, n_data=, devices=None)`` replaces ``params`` with the
trees of the model shards (``parallel/partitioning.py:ShardedParams``), as
JAX replaces its tree with a sharded one, and keeps the ``LocalMesh`` in
``mesh``. Every shard lies on the policy's device by default (what one card
runs); ``devices`` puts each on a CUDA device of its own, one
``torch.cuda.nccl.all_reduce`` a reduction (no machine has tried that form
yet: it needs several cards). Under a mesh ``predict`` / ``predict_batch``
run the masked prefill and the unfused decode loop with no CUDA graph (JAX's
``use_fused_decode=False``), each shard's few-row matmuls on the kernels of
``ops/quant.py`` at the shard's shapes; a batch whose rows n_data divides is
split over the data groups, which run in turn, and otherwise group 0 runs it
whole (JAX's replicated placement).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from .config import SpatialVLAConfig
from .convert.bridge import map_tree
from .convert.params import target_device
from .models import spatialvla
from .ops.quant import quantize_lm_params, quantize_vision_params
from .processor import ByteTokenizer, SpatialVLAProcessor, TextTokenizer


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
        self.quality_gate: Optional[Dict] = None  # a serve.gating artifact
        self.mesh = None  # set by shard()
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
        if self.mesh is not None:
            raise ValueError("to() on a sharded policy is unsupported: shard() placed the "
                             "shards (its devices argument)")
        self.device = torch.device(device)
        self.decode_graphs.clear()
        self.params = map_tree(lambda t: t.to(self.device), self.params)
        return self

    @classmethod
    def load(cls, checkpoint_dir: str, *, device="cuda",
             text_tokenizer: Optional[TextTokenizer] = None,
             param_dtype=torch.bfloat16) -> "SpatialVLAPolicy":
        """A checkpoint of the port's own format (``train/checkpoints.py``:
        params.safetensors, config.json, the processor files), its floating
        leaves cast to ``param_dtype``. The JAX package's Orbax directories
        are not read (the error says so)."""
        from .train.checkpoints import load_params

        device = target_device(device)
        with open(os.path.join(checkpoint_dir, "config.json")) as f:
            config = SpatialVLAConfig.from_json(f.read())
        processor = SpatialVLAProcessor.load(checkpoint_dir, text_tokenizer)
        params = load_params(checkpoint_dir, device=device, float_dtype=param_dtype)
        return cls(params, config, processor, device=device)

    @classmethod
    def from_hf_checkpoint(cls, hf_dir: str, *, device="cuda",
                           text_tokenizer: Optional[TextTokenizer] = None,
                           param_dtype=torch.bfloat16) -> "SpatialVLAPolicy":
        """Load directly from a reference-format HF checkpoint directory
        (safetensors + config.json + processor files), each tensor moved to
        ``device`` in ``param_dtype`` as it is read."""
        from .convert.hf_checkpoint import load_hf_checkpoint

        device = target_device(device)
        params, config, processor = load_hf_checkpoint(
            hf_dir, text_tokenizer=text_tokenizer, dtype=param_dtype, device=device)
        return cls(params, config, processor, device=device)

    def save_serving(self, directory: str, *, quality_gate: Optional[Dict] = None):
        """Persist the CURRENT parameterization as a serving checkpoint.

        Called after quantize(), this writes the int8 / int4 packed tree (+
        scales + precomputed ZoeDepth relative-position bias) verbatim
        (``train/checkpoints.save_params``), so a server restart loads it
        directly with load_serving(): no bf16 tree, no quantize pass. Beside
        it: config.json, the processor files, and serving_config.json with
        the knobs that live on the policy rather than in the tree (kv_bits,
        depth_image_size, quant_desc), as the JAX package writes them.

        quality_gate: a serve.gating artifact measuring THIS
        parameterization against bf16, embedded in serving_config.json;
        rejected (ValueError) unless it covers the baked knobs.

        The JAX package does not read this directory: its serving
        checkpoints are Orbax, the port's are its own safetensors format."""
        from .serve.gating import check_gate, policy_quality_knobs
        from .train.checkpoints import save_params

        if quality_gate is not None:
            ok, problems = check_gate(quality_gate, policy_quality_knobs(self))
            if not ok:
                raise ValueError("quality_gate does not cover this checkpoint's baked knobs: "
                                 + "; ".join(problems))
        if self.mesh is not None:
            raise ValueError("save_serving() on a sharded policy is unsupported: save before "
                             "shard() (the loaded tree re-shards with the same rules)")
        save_params(directory, self.params, config_json=self.config.to_json())
        self.processor.save(directory)
        with open(os.path.join(directory, "serving_config.json"), "w") as f:
            json.dump(
                {
                    "format_version": 1,
                    "kv_bits": self.kv_bits,
                    "depth_image_size": self.depth_image_size,
                    "quant_desc": self.quant_desc,
                    "quality_gate": quality_gate
                    if quality_gate is not None
                    else self.quality_gate,
                },
                f, indent=2,
            )

    @classmethod
    def load_serving(cls, directory: str, *, device="cuda",
                     text_tokenizer: Optional[TextTokenizer] = None) -> "SpatialVLAPolicy":
        """Load a save_serving() checkpoint: the tree with its stored dtypes
        and structure (quantized leaves stay quantized), moved to ``device``
        once; kv_bits, depth_image_size, quant_desc and the quality gate
        from serving_config.json. Do not call quantize() on the result: the
        tree already is."""
        from .train.checkpoints import load_params

        scfg_path = os.path.join(directory, "serving_config.json")
        if not os.path.exists(scfg_path):
            raise FileNotFoundError(f"{scfg_path} not found: not a save_serving() checkpoint "
                                    "(use SpatialVLAPolicy.load for other checkpoints)")
        device = target_device(device)
        with open(scfg_path) as f:
            scfg = json.load(f)
        with open(os.path.join(directory, "config.json")) as f:
            config = SpatialVLAConfig.from_json(f.read())
        processor = SpatialVLAProcessor.load(directory, text_tokenizer)
        policy = cls(load_params(directory, device=device), config, processor, device=device)
        policy.kv_bits = scfg.get("kv_bits")
        policy.depth_image_size = scfg.get("depth_image_size")
        policy.quant_desc = scfg.get("quant_desc")
        policy.quality_gate = scfg.get("quality_gate")
        return policy

    def shard(self, *, n_model: int = 1, n_data: int = 1, devices=None) -> "SpatialVLAPolicy":
        """Mesh-sharded serving (inference.py:308): ``n_model`` shards of
        tensor parallelism, each holding its attention heads, MLP hidden
        columns and vocabulary rows of the weight matrices
        (``parallel/partitioning.py:TensorShards``), their partial products
        summed after each projection (``parallel/mesh.py:sum_shards``), and
        ``n_data`` data groups over which ``predict_batch`` splits its rows
        when it can. ``devices`` (n_data * n_model, data-major) places the
        shards; None puts all of them on the policy's device.

        Prediction under a mesh runs the unfused decode loop, whose
        monolithic form has no int8-cache layout, so policy-level kv_bits is
        rejected; mesh-sharded split serving takes int8 KV through
        SplitServingEngine(kv_bits=8). Call quantize() before shard(): the
        quantized tree shards with the same rules. In place; returns self."""
        from .parallel.mesh import LocalMesh
        from .parallel.partitioning import ShardedParams

        if self.kv_bits:
            raise ValueError(
                "kv_bits on the monolithic mesh path is unsupported: quantize(kv_bits=None) "
                "before shard(); for mesh-sharded split serving pass "
                "SplitServingEngine(kv_bits=8) instead")
        mesh = LocalMesh(data=n_data, model=n_model,
                         devices=None if devices is None else tuple(devices))
        self.decode_graphs.clear()
        with torch.inference_mode():
            self.params = ShardedParams.shard(self.params, self.config, mesh, self.device)
        self.mesh = mesh
        return self

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
        if self.mesh is not None:
            raise ValueError("quantize() after shard() is unsupported: quantize first, then "
                             "shard (the quantized tree shards with the same rules)")
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
        if self.mesh is not None:
            return self._generate_sharded(inputs, attention_mask, return_margins)
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

    def _generate_sharded(self, inputs, attention_mask, return_margins):
        """``_generate`` over the mesh (inference.py:351-395): the rows split
        over the data groups when n_data divides them (each group's on its
        home device, the groups in turn), else group 0 takes them all; each
        group runs the unfused path over its model shards. The result lies on
        group 0's home device."""
        groups = self.params.groups
        ids = torch.as_tensor(inputs["input_ids"], dtype=torch.long)
        B = ids.shape[0]
        n = len(groups) if len(groups) > 1 and B % len(groups) == 0 else 1
        per = B // n
        outs = []
        with torch.inference_mode():
            for g in range(n):
                rows, dev = slice(g * per, (g + 1) * per), groups[g].home
                mask = None if attention_mask is None else attention_mask[rows].to(dev)
                outs.append(spatialvla.predict_action(
                    groups[g], self.config, ids[rows].to(dev),
                    pixel_values=torch.as_tensor(inputs["pixel_values"])[rows].to(dev),
                    intrinsic=torch.as_tensor(inputs["intrinsic"])[rows].to(dev),
                    attention_mask=mask,
                    action_chunk_size=self.processor.action_chunk_size,
                    compute_dtype=self.compute_dtype,
                    depth_image_size=self.depth_image_size,
                    return_margins=return_margins,
                    use_fused_decode=False,
                ))
        home = groups[0].home
        if return_margins:
            return tuple(torch.cat([o[i].to(home) for o in outs]) for i in range(2))
        return torch.cat([o.to(home) for o in outs])

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
