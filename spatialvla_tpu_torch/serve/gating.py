"""Quality-gate artifacts for quantized serving.

Every serving knob that trades model quality for speed — int4 weights
(per-channel or grouped), the mixed int4-MLP config, the int8 KV cache,
reduced-resolution ZoeDepth, and the int8/int4 vision front — must carry a
measured gate before a server will run it: a machine-readable record of
token agreement and continuous-action drift vs the bf16 baseline on stated
observations (scripts/eval_quant.py --gate_out writes one). The int8
weight-only LM is the measured-near-lossless default and needs no gate
(per-channel symmetric int8; eval_quant reports it anyway when asked).

The artifact travels with the checkpoint: SpatialVLAPolicy.save_serving
embeds it in serving_config.json, and scripts/serve.py / bench_serve.py
refuse a quality-trade knob with no covering gate entry unless --ungated
is passed. The reference's implicit quality bar is unquantized serving
(the reference's README.md:93); this makes the quantized departure from
that bar an explicit, auditable artifact instead of prose in a notes file.

Gate artifact schema (format_version 1):
    {
      "format_version": 1,
      "checkpoint": "<source checkpoint path>",
      "observations": {"source": "images"|"synthetic", "count": N,
                        "files": [...]},
      "instruction": "...",
      "entries": [
        {"label": "int4",
         "knobs": {"bits": 4},                # canonical quality knobs
         "token_agreement": 0.97,
         "action_l1": 0.004,
         "max_abs_delta": 0.02},
        ...
      ]
    }
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

GATE_FORMAT_VERSION = 1


def quality_trade_knobs(
    *,
    bits: Optional[int] = None,
    vision_bits: Optional[int] = None,
    mlp_bits: Optional[int] = None,
    group_size: Optional[int] = None,
    kv_bits: Optional[int] = None,
    depth_image_size: Optional[int] = None,
) -> Dict[str, int]:
    """Canonical dict of the knobs in a serving configuration that trade
    quality and therefore require a gate entry. Empty dict = the
    measured-near-lossless default class (bf16 or int8 weight-only LM,
    bf16 vision, full-res depth, bf16 KV) — no gate needed."""
    knobs: Dict[str, int] = {}
    if bits == 4:
        knobs["bits"] = 4
        if group_size:
            knobs["group_size"] = int(group_size)
    if mlp_bits and mlp_bits != bits:
        knobs["mlp_bits"] = int(mlp_bits)
    if vision_bits:
        # the vision front's quantization effect has never been gated at
        # 4B scale (NOTES_ROUND3: the perf A/B shipped it opt-in), so both
        # int8 and int4 fronts require a gate entry
        knobs["vision_bits"] = int(vision_bits)
    if kv_bits:
        knobs["kv_bits"] = int(kv_bits)
    if depth_image_size:
        knobs["depth_image_size"] = int(depth_image_size)
    return knobs


def policy_quality_knobs(policy) -> Dict[str, int]:
    """The quality-trade knobs of a policy's CURRENT parameterization."""
    desc = policy.quant_desc or {}
    return quality_trade_knobs(
        bits=desc.get("bits"),
        vision_bits=desc.get("vision_bits"),
        mlp_bits=desc.get("mlp_bits"),
        group_size=desc.get("group_size"),
        kv_bits=policy.kv_bits,
        depth_image_size=policy.depth_image_size,
    )


def write_gate(path: str, gate: Dict) -> None:
    gate = {"format_version": GATE_FORMAT_VERSION, **gate}
    with open(path, "w") as f:
        json.dump(gate, f, indent=2)


def load_gate(path: str) -> Dict:
    with open(path) as f:
        gate = json.load(f)
    if gate.get("format_version") != GATE_FORMAT_VERSION:
        raise ValueError(
            f"{path}: unsupported gate format_version "
            f"{gate.get('format_version')!r}"
        )
    return gate


def covering_entry(gate: Optional[Dict], knobs: Dict[str, int]) -> Optional[Dict]:
    """The gate entry whose canonical knob dict equals `knobs`, if any."""
    if not gate:
        return None
    for entry in gate.get("entries", []):
        if entry.get("knobs") == knobs:
            return entry
    return None


def check_gate(
    gate: Optional[Dict], knobs: Dict[str, int]
) -> Tuple[bool, List[str]]:
    """(ok, problems): ok when the configuration needs no gate (empty
    knob dict) or the gate has an entry measuring exactly these knobs."""
    if not knobs:
        return True, []
    entry = covering_entry(gate, knobs)
    if entry is None:
        have = [e.get("knobs") for e in (gate or {}).get("entries", [])]
        return False, [
            f"no gate entry measures knobs {knobs} "
            f"(gate has: {have if have else 'nothing'})"
        ]
    return True, []


def enforce_gate(policy, gate: Optional[Dict], *, ungated: bool = False) -> str:
    """Raise unless the policy's quality-trade knobs are covered by the
    gate artifact (or the operator passed --ungated). Returns a one-line
    status for the server log."""
    knobs = policy_quality_knobs(policy)
    if not knobs:
        return "quality gate: default-quality configuration (no gate needed)"
    ok, problems = check_gate(gate, knobs)
    if ok:
        entry = covering_entry(gate, knobs)
        return (
            "quality gate: knobs %s gated (token agreement %.3f, "
            "action L1 %.4f)" % (
                knobs, entry.get("token_agreement", float("nan")),
                entry.get("action_l1", float("nan")),
            )
        )
    if ungated:
        return f"quality gate: UNGATED serving of quality-trade knobs {knobs} (--ungated)"
    raise SystemExit(
        "refusing to serve quality-trade knobs without a gate artifact: "
        + "; ".join(problems)
        + ". Run scripts/eval_quant.py --gate_out on this checkpoint with "
        "representative task images (bake it in via quantize_checkpoint.py "
        "--gate), or pass --ungated to serve anyway."
    )
