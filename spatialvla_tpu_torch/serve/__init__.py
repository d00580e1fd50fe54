"""Serving helpers of the port. Only the quality gates are ported so far
(``gating``, a copy of the JAX package's); the serving engines wait for
ROADMAP.md Queue A items 4-5."""
from .gating import (
    check_gate,
    covering_entry,
    enforce_gate,
    load_gate,
    policy_quality_knobs,
    quality_trade_knobs,
    write_gate,
)

__all__ = [
    "check_gate",
    "covering_entry",
    "enforce_gate",
    "load_gate",
    "policy_quality_knobs",
    "quality_trade_knobs",
    "write_gate",
]
