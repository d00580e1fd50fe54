"""The reference's own weight quantization: symmetric per-output-channel
codes of a (K, N) matrix, returned dequantized in float32.

``int8`` is the serving form the configuration states (scale = max |w| /
127 over K, codes rounded half to even); ``int4`` (scale = max |w| / 7,
codes clamped to [-8, 7]) is the next precision below it, which the
control puts in the program's place.
"""
from __future__ import annotations

import torch

LEVELS = {8: (127.0, -127, 127), 4: (7.0, -8, 7)}


def dequant(w: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., K, N) -> the float32 values of its ``bits``-bit per-channel
    codes times their scales."""
    top, lo, hi = LEVELS[bits]
    wf = w.float()
    scale = wf.abs().amax(dim=-2, keepdim=True) / top
    return torch.round(wf / scale.clamp_min(1e-12)).clamp(lo, hi) * scale
