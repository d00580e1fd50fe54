"""Serving for the port: the dynamic batcher (``ServingEngine``, with
``assemble_batch`` and ``warmup_buckets``), the split-phase engine with a
persistent decode batch (``SplitServingEngine``), their load-shedding and
deadline errors, and the quality gates (``gating``, a copy of the JAX
package's). ``scripts/serve_torch.py`` puts either engine behind HTTP and
``scripts/bench_serve_torch.py`` drives it with closed-loop clients."""
from .engine import (
    EngineOverloaded,
    RequestExpired,
    ServingEngine,
    assemble_batch,
    warmup_buckets,
)
from .gating import (
    check_gate,
    covering_entry,
    enforce_gate,
    load_gate,
    policy_quality_knobs,
    quality_trade_knobs,
    write_gate,
)
from .split_engine import SplitServingEngine

__all__ = [
    "EngineOverloaded",
    "RequestExpired",
    "ServingEngine",
    "SplitServingEngine",
    "assemble_batch",
    "check_gate",
    "covering_entry",
    "enforce_gate",
    "load_gate",
    "policy_quality_knobs",
    "quality_trade_knobs",
    "warmup_buckets",
    "write_gate",
]
