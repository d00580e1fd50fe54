"""Text tokenizer protocol + adapters.

The framework's processor works purely in id space (prompt ids are composed
directly — no "<ACTION00123>"-string round trip like the reference's
processing_spatialvla.py:118-124, which is a known hot-path wart). Any
tokenizer satisfying this small protocol plugs in:

  - encode(text) -> list[int]           (no BOS/EOS added)
  - bos_id / eos_id / pad_id / newline_id properties

`HFTokenizerAdapter` wraps a HuggingFace GemmaTokenizer for use with real
PaliGemma2 checkpoints; `ByteTokenizer` is a self-contained fallback for
tests and offline use.
"""
from __future__ import annotations

import json
import os
from typing import List, Protocol, Sequence


class TextTokenizer(Protocol):
    def encode(self, text: str) -> List[int]: ...

    @property
    def bos_id(self) -> int: ...

    @property
    def eos_id(self) -> int: ...

    @property
    def pad_id(self) -> int: ...


class ByteTokenizer:
    """UTF-8 byte-level tokenizer with reserved control ids.

    id layout: 0 = pad, 1 = bos, 2 = eos, 3..258 = bytes 0..255.
    Deterministic and dependency-free; used by tests and as an offline
    stand-in when no Gemma sentencepiece model is on disk."""

    vocab_size = 259

    def encode(self, text: str) -> List[int]:
        return [3 + b for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i - 3 for i in ids if i >= 3).decode("utf-8", errors="replace")

    @property
    def bos_id(self) -> int:
        return 1

    @property
    def eos_id(self) -> int:
        return 2

    @property
    def pad_id(self) -> int:
        return 0

    def save_pretrained(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "byte_tokenizer.json"), "w") as f:
            json.dump({"type": "byte", "vocab_size": self.vocab_size}, f)

    def add_action_tokens(self, action_token_begin_idx: int, n_tokens: int) -> None:
        pass  # byte vocabulary carries no special-token table


class HFTokenizerAdapter:
    """Wraps a HuggingFace (Gemma/PaliGemma) tokenizer.

    This is the production text path: the reference's processor is built on
    GemmaTokenizerFast (processing_spatialvla.py:24-31), so any model meant
    to interoperate with the reference ecosystem must tokenize through the
    real Gemma sentencepiece vocabulary (257152 ids + <image> + 8194 action
    tokens)."""

    def __init__(self, tokenizer):
        self.tok = tokenizer

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def decode(self, ids) -> str:
        return self.tok.decode(ids)

    @property
    def vocab_size(self) -> int:
        return len(self.tok)

    @property
    def bos_id(self) -> int:
        return self.tok.bos_token_id

    @property
    def eos_id(self) -> int:
        return self.tok.eos_token_id

    @property
    def pad_id(self) -> int:
        return self.tok.pad_token_id if self.tok.pad_token_id is not None else 0

    # -- artifact persistence -------------------------------------------
    def add_action_tokens(self, action_token_begin_idx: int, n_tokens: int) -> None:
        """Append <ACTION00000>..<ACTION{n-1}> special tokens (reference
        action_tokenizer.py:78-86 / spatialvla_pretrain.py:301-310) so the
        persisted tokenizer artifact matches the reference layout. Warns if
        the resulting ids do not line up with the model's action-token block
        (expected with reduced test tokenizers, fatal-ish with real ones)."""
        import warnings

        missing = [
            "<ACTION{:05d}>".format(i)
            for i in range(n_tokens)
            if self.tok.convert_tokens_to_ids("<ACTION{:05d}>".format(i))
            in (None, self.tok.unk_token_id)
        ]
        if missing:
            self.tok.add_special_tokens(
                {"additional_special_tokens": missing},
                replace_additional_special_tokens=False,
            )
        got = self.tok.convert_tokens_to_ids("<ACTION00000>")
        if got != action_token_begin_idx:
            warnings.warn(
                f"<ACTION00000> tokenizes to id {got}, but the model's action"
                f" block begins at {action_token_begin_idx}; the persisted"
                " tokenizer will not line up with the model vocabulary"
                " (expected only for reduced test tokenizers)."
            )

    def save_pretrained(self, directory: str) -> None:
        self.tok.save_pretrained(directory)


def load_text_tokenizer(path: "str | None", *, require: bool = False):
    """Resolve the text tokenizer for the CLIs and processor loading.

    ``path`` is a directory containing HuggingFace tokenizer files (the
    PaliGemma2/Gemma tokenizer of the reference ecosystem) -> returns an
    `HFTokenizerAdapter`. ``path=None`` returns the self-contained
    `ByteTokenizer` — an offline/test fallback ONLY: models trained with it
    speak a 259-id byte vocabulary that is incompatible with reference
    checkpoints. Set ``require=True`` to forbid the fallback.
    """
    if path is None:
        if require:
            raise ValueError(
                "a real tokenizer is required here (pass --tokenizer_path)"
            )
        return ByteTokenizer()
    if os.path.isfile(os.path.join(path, "byte_tokenizer.json")):
        return ByteTokenizer()  # round-trip of a ByteTokenizer artifact
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
    return HFTokenizerAdapter(tok)
