"""Frame stream -> fixed-shape model batches.

Replaces the reference's per-sample processor call + HF collator
(data/dataset.py:121-154, monkey_patch.py:21-75): samples are tokenized in
id space and right-padded to one static sequence length so every training
step reuses a single compiled XLA program.
"""
from __future__ import annotations

import logging
from typing import Dict, Iterator, Optional

import numpy as np

from ..processor import IGNORE_INDEX, SpatialVLAProcessor

logger = logging.getLogger(__name__)


class VLABatcher:
    """Training-prompt parity with the reference: the model is trained on
    the bare LOWERCASED instruction (reference data/dataset.py:130 —
    ``lang.lower()``, no template). A template (e.g. the inference demo's
    "What action should the robot take to {}?") is opt-in via
    ``prompt_template``.

    Truncation safety: a sample whose prefix+suffix exceeds ``seq_len`` is
    DROPPED and counted (``self.dropped``) — action-suffix labels, the
    entire supervision signal, are never silently cut (the reference
    truncates at max_length 2048 where this is unreachable; at our compact
    static seq_len it would not be)."""

    def __init__(
        self,
        processor: SpatialVLAProcessor,
        *,
        batch_size: int,
        seq_len: int,
        prompt_template: Optional[str] = None,
    ):
        self.proc = processor
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.prompt_template = prompt_template
        self.dropped = 0
        self.encoded = 0

    def encode_frame(self, frame: Dict) -> Optional[Dict[str, np.ndarray]]:
        """Returns None (and counts the drop) if the sample does not fit."""
        instruction = frame.get("language_instruction", "")
        if isinstance(instruction, bytes):
            instruction = instruction.decode("utf-8")
        instruction = instruction.lower()
        text = (
            self.prompt_template.format(instruction)
            if self.prompt_template
            else instruction
        )
        tok = self.proc.text_tokenizer
        actions = np.asarray(frame["action"], dtype=np.float64)
        suffix = (
            self.proc.action_tokenizer.encode_to_global_ids(actions).reshape(-1).tolist()
            + [tok.eos_id]
        )
        # gather every decoded view/obs-window image in a fixed order:
        # primary window (oldest->newest), then secondary, then wrist
        # (reference obs layout, data/obs_transforms.py:47-113 + the
        # multi-obs collator concat, monkey_patch.py:21-75)
        imgs = []
        for key in ("image_primary", "image_secondary", "image_wrist"):
            if key not in frame or frame[key] is None:
                continue
            v = np.asarray(frame[key], dtype=np.float32) / 255.0
            imgs.extend(v if v.ndim == 4 else [v])
        k = len(imgs)
        # the prefix is built once, for the actual image-block count
        prefix = self.proc.build_prompt_ids(text, n_images=k) if k > 1 \
            else self.proc.build_prompt_ids(text)
        T = self.seq_len
        n = len(prefix) + len(suffix)
        if n > T:
            self.dropped += 1
            if self.dropped in (1, 10, 100) or self.dropped % 1000 == 0:
                logger.warning(
                    "dropped %d sample(s) whose prompt+action suffix (%d tokens)"
                    " exceeds seq_len=%d — raise --seq_len if this persists"
                    " (instruction: %.60r)",
                    self.dropped, n, T, instruction,
                )
            return None
        ids = np.full((T,), tok.pad_id, dtype=np.int32)
        attn = np.zeros((T,), dtype=np.int32)
        ttype = np.zeros((T,), dtype=np.int32)
        ids[:n] = prefix + suffix
        attn[:n] = 1
        ttype[len(prefix) : n] = 1
        labels = np.where(ttype == 0, IGNORE_INDEX, ids)
        img = np.stack(imgs) if k > 1 else imgs[0]
        K = self.proc.intrinsic_for(frame.get("dataset_name"))
        self.encoded += 1
        out = {
            "input_ids": ids,
            "attention_mask": attn,
            "token_type_ids": ttype,
            "labels": labels,
            "pixel_values": img,
            "intrinsic": K,
            "actions": np.asarray(frame["action"], dtype=np.float32),
        }
        if frame.get("depth_primary") is not None:
            # only a full per-image depth override is representable in the
            # model (get_image_features depth arg); partial coverage falls
            # back to the in-model ZoeDepth estimate
            d = np.asarray(frame["depth_primary"], dtype=np.float32)
            if d.ndim == 2:
                d = d[None]
            if d.shape[0] == k:
                out["depth"] = d if k > 1 else d[0]
        return out

    def batches(self, frames: Iterator[Dict]) -> Iterator[Dict[str, np.ndarray]]:
        warned_keys: set = set()
        while True:
            rows = []
            while len(rows) < self.batch_size:
                try:
                    row = self.encode_frame(next(frames))
                except StopIteration:
                    return
                if row is not None:
                    rows.append(row)
            # only keys EVERY row carries are stackable (a mixture can have
            # depth for some member datasets only — the optional "depth"
            # override is then dropped for the mixed batch rather than
            # crashing np.stack or silently following rows[0])
            keys = set(rows[0].keys())
            for r in rows[1:]:
                keys &= r.keys()
            missing = set().union(*(r.keys() for r in rows)) - keys
            if missing and not missing <= warned_keys:
                logger.warning(
                    "batch keys %s present in only part of the mixture; "
                    "dropped for mixed batches", sorted(missing),
                )
                warned_keys |= missing
            yield {k: np.stack([r[k] for r in rows]) for k in keys}
