"""SpatialVLA processor: builds model inputs from (image, instruction,
action chunk) and decodes generated action tokens back to continuous
actions.

Reference parity (processing_spatialvla.py):
  - prompt layout: 256 <image> tokens + BOS + instruction + "\\n"
    (build_string_from_input semantics, :152-173); suffix = 3 action tokens
    per step + EOS (:118-124, :151); labels = input_ids with prefix
    (token_type_ids == 0) masked to -100 (:190);
  - per-dataset camera intrinsics rescaled to the processor image size
    (:92-95);
  - decode_actions (:216-254): first 3*chunk generated ids -> (chunk, 7)
    normalized actions -> unnormalize with per-dataset q01/q99 where the
    stats mask is set.

TPU-first difference: everything is composed directly in id space with
static shapes (optional right-padding to a fixed length) — no
string-join-retokenize round trip per sample.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..action import SpatialActionTokenizer
from .image import preprocess_images, preprocess_images_u8
from .text_tokenizer import ByteTokenizer, TextTokenizer

IGNORE_INDEX = -100


def scale_intrinsics(intrinsic_config: Dict, image_size: int) -> Dict[str, np.ndarray]:
    """Rescale per-dataset K matrices from native resolution to the
    processor's square image size (processing_spatialvla.py:92-95)."""
    out = {}
    for name, v in intrinsic_config.items():
        K = np.asarray(v["intrinsic"], dtype=np.float32).copy()
        K[0] *= image_size / v["width"]
        K[1] *= image_size / v["height"]
        out[name] = K
    return out


class SpatialVLAProcessor:
    def __init__(
        self,
        text_tokenizer: Optional[TextTokenizer] = None,
        *,
        action_tokenizer: Optional[SpatialActionTokenizer] = None,
        image_token_id: int = 257152,
        action_token_begin_idx: int = 257153,
        image_seq_length: int = 256,
        image_size: int = 224,
        statistics: Optional[Dict] = None,
        bin_policy: Optional[Dict] = None,
        intrinsic_config: Optional[Dict] = None,
        action_config: Optional[Dict] = None,
        num_obs_steps: int = 1,
        obs_delta: int = 1,
        action_chunk_size: int = 4,
        min_sigma: float = 0.0,
    ):
        self.text_tokenizer = text_tokenizer or ByteTokenizer()
        self.image_token_id = image_token_id
        self.image_seq_length = image_seq_length
        self.image_size = image_size
        self.statistics = statistics or {}
        self.num_obs_steps = num_obs_steps
        self.obs_delta = obs_delta
        self.action_chunk_size = action_chunk_size
        self.min_sigma = min_sigma
        self.action_config = action_config or {
            "num_bins": {
                "translation": {"theta_bins": 16, "phi_bins": 32, "r_bins": 8},
                "rotation": {"roll_bins": 16, "pitch_bins": 16, "yaw_bins": 16},
                "gripper": 2,
            },
            "use_spherical": True,
        }
        self.intrinsic_config = intrinsic_config or {
            "default": {
                "intrinsic": [[623.588, 0, 319.501], [0, 623.588, 239.545], [0, 0, 1]],
                "height": 480,
                "width": 640,
            }
        }
        self.dataset_intrinsics = scale_intrinsics(self.intrinsic_config, image_size)

        if action_tokenizer is not None:
            self.action_tokenizer = action_tokenizer
        else:
            self.action_tokenizer = SpatialActionTokenizer(
                num_bins=self.action_config["num_bins"],
                bin_policy=bin_policy,
                use_spherical=self.action_config.get("use_spherical", True),
                min_sigma=min_sigma,
                token_begin_idx=action_token_begin_idx,
            )

    # ------------------------------------------------------------------
    @property
    def bin_policy(self):
        """Always the tokenizer's CURRENT bins — a snapshot here would go
        stale after adapt_to_gaussian and persist wrong bin edges on save
        (finetune's --adapt_emb path)."""
        return self.action_tokenizer.bin_policy

    @property
    def action_token_begin_idx(self) -> int:
        return self.action_tokenizer.token_begin_idx

    def intrinsic_for(self, unnorm_key: Optional[str]) -> np.ndarray:
        if unnorm_key in self.dataset_intrinsics:
            return self.dataset_intrinsics[unnorm_key]
        return self.dataset_intrinsics["default"]

    # ------------------------------------------------------------------
    def build_prompt_ids(self, text: str, n_images: int = 1) -> List[int]:
        """<image>*(n_images*N) + BOS + text + '\\n' as ids. The text and
        trailing newline are tokenized in ONE pass like the reference's
        f"{prompt}\\n" (processing_spatialvla.py) — separate encodes diverge
        whenever the tokenizer would merge across the boundary (e.g. Gemma's
        multi-newline pieces when the instruction itself ends in '\\n')."""
        tok = self.text_tokenizer
        return (
            [self.image_token_id] * (self.image_seq_length * n_images)
            + [tok.bos_id]
            + tok.encode(text + "\n")
        )

    def __call__(
        self,
        images,
        text: Union[str, Sequence[str]],
        *,
        unnorm_key: Optional[str] = None,
        suffix_actions: Optional[np.ndarray] = None,  # (chunk, 7)
        max_length: Optional[int] = None,
        return_labels: Optional[bool] = None,
    ) -> Dict[str, np.ndarray]:
        if isinstance(text, str):
            text = [text]
            images = [images]
        B = len(text)

        suffix_ids = None
        if suffix_actions is not None:
            acts = np.asarray(suffix_actions)
            if acts.ndim == 2:
                acts = acts[None].repeat(B, 0)
            suffix_ids = [
                self.action_tokenizer.encode_to_global_ids(a).reshape(-1).tolist()
                + [self.text_tokenizer.eos_id]
                for a in acts
            ]
        if return_labels is None:
            return_labels = suffix_ids is not None

        # multi-observation samples arrive as a list of images per sample
        n_images = [
            len(im) if isinstance(im, (list, tuple)) else 1 for im in images
        ]
        rows = []
        for i, t in enumerate(text):
            prefix = self.build_prompt_ids(t, n_images=n_images[i])
            suffix = suffix_ids[i] if suffix_ids is not None else []
            rows.append((prefix, suffix))

        T = max(len(p) + len(s) for p, s in rows)
        if max_length is not None:
            # pad up to AND truncate down to max_length (HF-tokenizer
            # semantics the reference relies on: padding='max_length' +
            # truncation, processing_spatialvla.py) — truncation cuts from
            # the end, like the reference's max_length tokenize
            T = max_length
        pad_id = self.text_tokenizer.pad_id

        input_ids = np.full((B, T), pad_id, dtype=np.int32)
        attention_mask = np.zeros((B, T), dtype=np.int32)
        token_type_ids = np.zeros((B, T), dtype=np.int32)
        for i, (p, s) in enumerate(rows):
            n = min(len(p) + len(s), T)
            input_ids[i, :n] = (p + s)[:n]
            attention_mask[i, :n] = 1
            token_type_ids[i, min(len(p), T) : n] = 1

        pixels_u8 = None
        if any(n > 1 for n in n_images):
            assert len(set(n_images)) == 1, "mixed obs counts in one batch"
            pixel_values = np.stack(
                [preprocess_images(im, self.image_size) for im in images]
            )  # (B, k, H, W, 3)
        else:
            flat = [im[0] if isinstance(im, (list, tuple)) else im for im in images]
            pixels_u8 = preprocess_images_u8(flat, self.image_size)
            if pixels_u8 is not None:  # PIL path: f32 == u8/255 bitwise
                pixel_values = pixels_u8.astype(np.float32) / 255.0
            else:  # PIL-free bicubic fallback: off the u8 grid
                pixel_values = preprocess_images(flat, self.image_size)
        K = self.intrinsic_for(unnorm_key)
        out = {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "token_type_ids": token_type_ids,
            "pixel_values": pixel_values,
            "intrinsic": np.broadcast_to(K, (B, 3, 3)).copy(),
        }
        if pixels_u8 is not None:
            # exact-u8 transport form for serving (split_engine._put_pixels
            # ships these 4x-smaller bytes and rescales on-device)
            out["pixel_values_u8"] = pixels_u8
        if return_labels:
            out["labels"] = np.where(token_type_ids == 0, IGNORE_INDEX, input_ids)
        return out

    # ------------------------------------------------------------------
    def decode_actions(
        self,
        generated_ids: np.ndarray,  # (B, >= 3*chunk) or (>= 3*chunk,)
        unnorm_key: Optional[str] = None,
    ) -> Dict[str, np.ndarray]:
        """Generated token ids -> {'actions': (B, chunk, 7), 'action_ids'}."""
        ids = np.asarray(generated_ids)
        if ids.ndim == 1:
            ids = ids[None]
        n = 3 * self.action_chunk_size
        ids = ids[:, :n]
        if ids.shape[1] < n:  # pad with zeros like the reference (:225-232)
            ids = np.concatenate(
                [ids, np.zeros((ids.shape[0], n - ids.shape[1]), dtype=ids.dtype)], axis=1
            )

        chunks = ids.reshape(ids.shape[0], self.action_chunk_size, 3)
        normalized = np.stack(
            [self.action_tokenizer.decode_global_ids(c) for c in chunks]
        )  # (B, chunk, 7)

        if unnorm_key is None and self.statistics:
            unnorm_key = next(iter(self.statistics.keys()))
        stats = self.statistics[unnorm_key]["action"]
        q01 = np.asarray(stats["q01"], dtype=np.float64)
        q99 = np.asarray(stats["q99"], dtype=np.float64)
        mask = np.asarray(stats.get("mask", np.ones_like(q01)), dtype=bool)
        actions = np.where(mask, 0.5 * (normalized + 1) * (q99 - q01) + q01, normalized)
        return {"actions": actions, "action_ids": ids}

    # ------------------------------------------------------------------
    # persistence (checkpoint artifacts, SURVEY.md §5.4)
    def save(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        # tokenizer artifacts travel with the processor (reference
        # SaveProcessorCallback + tokenizer.save_pretrained semantics,
        # monkey_patch.py:332-342)
        if hasattr(self.text_tokenizer, "save_pretrained"):
            self.text_tokenizer.add_action_tokens(
                self.action_token_begin_idx, self.action_tokenizer.vocab_size
            )
            self.text_tokenizer.save_pretrained(os.path.join(directory, "tokenizer"))
        state = {
            "image_token_id": self.image_token_id,
            "action_token_begin_idx": self.action_token_begin_idx,
            "image_seq_length": self.image_seq_length,
            "image_size": self.image_size,
            "statistics": self.statistics,
            "bin_policy": self.bin_policy,
            "intrinsic_config": self.intrinsic_config,
            "action_config": self.action_config,
            "num_obs_steps": self.num_obs_steps,
            "obs_delta": self.obs_delta,
            "action_chunk_size": self.action_chunk_size,
            "min_sigma": self.min_sigma,
        }
        with open(os.path.join(directory, "processor_config.json"), "w") as f:
            json.dump(state, f, indent=2)

    @classmethod
    def load(cls, directory: str, text_tokenizer: Optional[TextTokenizer] = None):
        with open(os.path.join(directory, "processor_config.json")) as f:
            state = json.load(f)
        if text_tokenizer is None:
            from .text_tokenizer import load_text_tokenizer

            tok_dir = os.path.join(directory, "tokenizer")
            text_tokenizer = load_text_tokenizer(
                tok_dir if os.path.isdir(tok_dir) else None
            )
        return cls(
            text_tokenizer,
            image_token_id=state["image_token_id"],
            action_token_begin_idx=state["action_token_begin_idx"],
            image_seq_length=state["image_seq_length"],
            image_size=state["image_size"],
            statistics=state["statistics"],
            bin_policy=state["bin_policy"],
            intrinsic_config=state["intrinsic_config"],
            action_config=state["action_config"],
            num_obs_steps=state["num_obs_steps"],
            obs_delta=state["obs_delta"],
            action_chunk_size=state["action_chunk_size"],
            min_sigma=state["min_sigma"],
        )
