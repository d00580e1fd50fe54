"""The yardstick's arithmetic: the chips' published peaks, and the
operations and bytes that the work of a cell needs, counted from the
configuration's shapes (never from the program).

Operations count a multiply-add as 2 and cover the matrix products and
convolutions the model defines; element-wise work and resampling are left
out. Bytes count each input read once and each output written once.
"""
from __future__ import annotations

import json
import os

PEAKS_FILE = os.path.join(os.path.dirname(__file__), "peaks.json")


def peaks(kind: str):
    """{"bf16_flops", "hbm_bytes_per_s"} of the chip named ``kind``
    (``torch.cuda.get_device_name()``), or None for a chip the table lacks."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)["chips"]
    return table.get(kind)


# ---------------------------------------------------------------------------
# the Gemma2 decoder
# ---------------------------------------------------------------------------

def lm_layer_params(t: dict) -> int:
    """Weights of one decoder layer's matrices (q|k|v, o, gate|up, down)."""
    H, I, D = t["hidden_size"], t["intermediate_size"], t["head_dim"]
    Nq, Nkv = t["num_heads"], t["num_kv_heads"]
    return H * (Nq + 2 * Nkv) * D + Nq * D * H + 3 * H * I


def lm_flops(t: dict, tokens: int, pairs: int) -> int:
    """The decoder stack over ``tokens`` tokens whose attention takes
    ``pairs`` (query, key) pairs in each layer."""
    attn = 2 * 2 * pairs * t["num_heads"] * t["head_dim"]
    return t["num_layers"] * (2 * tokens * lm_layer_params(t) + attn)


def kv_bytes(t: dict, slots: int) -> int:
    """The bf16 keys and values of ``slots`` cache slots in every layer."""
    return t["num_layers"] * 2 * t["num_kv_heads"] * t["head_dim"] * 2 * slots


def head_bytes(t: dict, rows: int, bits: int = 8) -> int:
    """``rows`` rows of the head in ``bits``-bit codes with float32 scales."""
    return rows * (t["hidden_size"] * bits // 8 + 4)


def layers_bytes(t: dict, bits: int = 8) -> int:
    """Every layer's matrices in ``bits``-bit codes with their float32
    per-channel scales, and its four bf16 norms."""
    H, I, D = t["hidden_size"], t["intermediate_size"], t["head_dim"]
    channels = (t["num_heads"] + 2 * t["num_kv_heads"]) * D + H + 2 * I + H  # qkv, o, gate|up, down
    return t["num_layers"] * (lm_layer_params(t) * bits // 8 + 4 * channels + 4 * H * 2)


def decode_step_bytes(t: dict, rows: int, slots_read: int, *, bits: int = 8,
                      head_rows: int = 0) -> int:
    """The bytes one fused decode step of ``rows`` rows must move: the
    layers (``layers_bytes``), the keys and values of ``slots_read`` cache
    slots (summed over the rows) read and of one slot a row written, and
    ``head_rows`` rows of the head."""
    return layers_bytes(t, bits) + kv_bytes(t, slots_read + rows) + head_bytes(t, head_rows, bits)


# ---------------------------------------------------------------------------
# the vision front
# ---------------------------------------------------------------------------

def siglip_flops(v: dict) -> int:
    H, I, P, L = v["hidden_size"], v["intermediate_size"], v["patch_size"], v["num_layers"]
    N = (v["image_size"] // P) ** 2
    layer = 2 * N * (4 * H * H + 2 * H * I) + 2 * 2 * N * N * H
    return 2 * N * P * P * 3 * H + L * layer


def zoe_flops(z: dict) -> int:
    C, I, L, P = z["hidden_size"], z["intermediate_size"], z["num_layers"], z["patch_size"]
    w = z["image_size"] // P
    N = w * w + 1
    total = 2 * w * w * P * P * 3 * C
    total += L * (2 * N * (4 * C * C + 2 * C * I) + 2 * 2 * N * N * C)
    Fh = z["fusion_hidden_size"]
    sides = []
    for s, f in zip(z["neck_hidden_sizes"], (4, 2, 1, 0.5)):
        total += 2 * w * w * (2 * C * C + C * s)  # readout, 1x1 projection
        r = int(w * f)
        if f > 1:
            total += 2 * w * w * int(f) ** 2 * s * s  # transposed conv, kernel = stride
        elif f < 1:
            total += 2 * r * r * 9 * s * s  # 3x3, stride 2
        total += 2 * r * r * 9 * s * Fh  # 3x3 into the fusion width
        sides.append(r)
    fused = []
    for j, r in enumerate(sides[::-1]):
        total += (2 if j == 0 else 4) * 2 * r * r * 9 * Fh * Fh  # residual units
        total += 2 * (2 * r) ** 2 * Fh * Fh  # 1x1 after the 2x upsampling
        fused.append(2 * r)
    R, E, Bf = z["num_relative_features"], z["bin_embedding_dim"], z["bottleneck_features"]
    top = fused[-1]
    out = 2 * top
    # the relative head up to the features the metric head takes (its 1x1
    # relative-depth output is not used)
    total += 2 * top * top * 9 * Fh * (Fh // 2) + 2 * out * out * 9 * (Fh // 2) * R
    b = sides[-1] ** 2  # the bottleneck's positions
    Hp, Ip, Lp = (z["patch_transformer_hidden_size"], z["patch_transformer_intermediate_size"],
                  z["num_patch_transformer_layers"])
    S = b + 1
    total += 2 * b * Bf * Bf + 2 * b * Bf * Hp
    total += Lp * (2 * S * (4 * Hp * Hp + 2 * Hp * Ip) + 2 * 2 * S * S * Hp)
    total += 2 * (Hp * Hp + Hp * 2)
    # one expert: seed regressor and projector, four attractor levels, log-binomial head
    total += 2 * b * (Bf * E // 2 + E // 2 * z["num_bins"]) + 2 * b * (Bf * E // 2 + E // 2 * E)
    for r in fused:
        total += 2 * r * r * (Fh * E // 2 + E // 2 * E + E * E + E * 16)
    total += 2 * out * out * ((R + E) * ((R + E) // 4) + (R + E) // 4 * 4)
    return total


def front_flops(model: dict) -> int:
    """SigLIP, ZoeDepth, Ego3D and the projector for one frame."""
    v, e = model["vision"], model["ego3d"]
    N = (v["image_size"] // v["patch_size"]) ** 2
    total = siglip_flops(v) + 2 * N * v["hidden_size"] * model["text"]["hidden_size"]
    if model.get("use_vision_zoe", True):
        F_ = 3 * e["patch_reso"] ** 2 * (2 * e["n_freqs"] + 1)
        H = e["num_pos_feats"]
        total += 2 * 9 * N * e["patch_reso"] ** 2 + 2 * N * (F_ * H + H * H)  # K^-1 uv; the MLP
        if model.get("zoe"):
            total += zoe_flops(model["zoe"])
    return total


def serve_request_flops(model: dict, prompt_len: int, new_tokens: int) -> int:
    """One served request: the front, the prefill of its own prompt
    (bidirectional), ``new_tokens`` greedy tokens over the action block, of
    which all but the first run a decode step through the layers."""
    t = model["text"]
    steps = new_tokens - 1
    pairs = prompt_len * prompt_len + sum(prompt_len + s for s in range(1, steps + 1))
    head = 2 * t["hidden_size"] * model["spatial_token_num"] * new_tokens
    return front_flops(model) + lm_flops(t, prompt_len + steps, pairs) + head


# ---------------------------------------------------------------------------
# flash attention (training)
# ---------------------------------------------------------------------------

def prefix_lm_pairs(prefix: int, valid: int) -> int:
    """(query, key) pairs of a prefix-LM row: the prefix sees itself, each
    later valid token the prefix and the tokens up to itself."""
    s = valid - prefix
    return prefix * prefix + s * prefix + s * (s + 1) // 2


def flash_fwd(t: dict, B: int, T: int, pairs: int, itemsize: int = 2) -> tuple:
    """(operations, bytes) of the forward over B rows of T slots: Q K^T and
    P V over the allowed pairs (summed over the rows); q, k, v read, the
    output and the float32 log-sum-exp written."""
    Nq, Nkv, D = t["num_heads"], t["num_kv_heads"], t["head_dim"]
    ops = 2 * 2 * pairs * Nq * D
    data = itemsize * B * T * D * (2 * Nq + 2 * Nkv) + 4 * B * Nq * T
    return ops, data
