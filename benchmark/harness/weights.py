"""Seeded random weights for a SpatialVLA model configuration, made by the
benchmark and handed to both the program and the reference.

``tree_spec`` lays out the parameter tree (the JAX tree's keys and shapes,
which the port takes as its input format) from a configuration's ``model``
dict; ``make_tree`` fills it on a device from the seed: every random leaf of
one tower comes from one generator of its own, in a few large
``torch.randn`` calls (``make_tower``), so any tower can be made again
alone (the reference does so, tower by tower, after the program's state is
freed).

Random leaves are N(0, 0.02^2), as the models' own initialisers draw them,
Ego3D's two matrices xavier-normal with gain 0.01, and ZoeDepth's relative
position tables N(0, 0.02^2) so that the serving path's precomputed bias is
not all zero; biases and Gemma norm offsets are 0, LayerNorm scales 1 and
BEiT's layer scales 0.1.
"""
from __future__ import annotations

import hashlib
import math

import torch

TOWERS = ("vision", "projector", "lm", "spatial_embed", "ego3d", "zoe")
REASSEMBLE_FACTORS = (4, 2, 1, 0.5)
STD = 0.02
OWN_BUFFER = 1 << 24  # elements: a leaf this large is drawn on its own


def _n(*shape, std=STD):
    return ("normal", tuple(shape), std)


def _z(*shape):
    return ("const", tuple(shape), 0.0)


def _c(value, *shape):
    return ("const", tuple(shape), value)


def _siglip(v):
    L, H, I, P = v["num_layers"], v["hidden_size"], v["intermediate_size"], v["patch_size"]
    wb = lambda a, b: {"w": _n(L, a, b), "b": _z(L, b)}  # noqa: E731
    n_patch = (v["image_size"] // P) ** 2
    return {
        "patch_embed": {"w": _n(P, P, 3, H), "b": _z(H)},
        "pos_embed": _n(n_patch, H),
        "layers": {
            "attn": {"q": wb(H, H), "k": wb(H, H), "v": wb(H, H), "o": wb(H, H)},
            "ln1": {"scale": _c(1.0, L, H), "bias": _z(L, H)},
            "ln2": {"scale": _c(1.0, L, H), "bias": _z(L, H)},
            "mlp": {"fc1": wb(H, I), "fc2": wb(I, H)},
        },
        "post_ln": {"scale": _c(1.0, H), "bias": _z(H)},
    }


def _gemma2(t):
    L, H, I = t["num_layers"], t["hidden_size"], t["intermediate_size"]
    Nq, Nkv, D = t["num_heads"], t["num_kv_heads"], t["head_dim"]
    tree = {
        "embed": _n(t["vocab_size"], H),
        "layers": {
            "attn": {"q": _n(L, H, Nq * D), "k": _n(L, H, Nkv * D), "v": _n(L, H, Nkv * D),
                     "o": _n(L, Nq * D, H)},
            "mlp": {"gate": _n(L, H, I), "up": _n(L, H, I), "down": _n(L, I, H)},
            "input_norm": _z(L, H), "post_attn_norm": _z(L, H),
            "pre_ffn_norm": _z(L, H), "post_ffn_norm": _z(L, H),
        },
        "final_norm": _z(H),
    }
    if not t.get("tie_lm_head", False):
        tree["lm_head"] = _n(H, t["vocab_size"])
    return tree


def _ego3d(e):
    F_ = 3 * e["patch_reso"] ** 2 * (2 * e["n_freqs"] + 1)
    H = e["num_pos_feats"]
    xavier = lambda a, b: _n(a, b, std=0.01 * math.sqrt(2.0 / (a + b)))  # noqa: E731
    return {"fc1": {"w": xavier(F_, H), "b": _z(H)},
            "ln": {"scale": _c(1.0, H), "bias": _z(H)},
            "fc2": {"w": xavier(H, H), "b": _z(H)}}


def _zoe(z):
    L, C, I, P = z["num_layers"], z["hidden_size"], z["intermediate_size"], z["patch_size"]
    window = z["image_size"] // P
    num_rel = (2 * window - 1) ** 2 + 3
    wb = lambda a, b, bias=True: ({"w": _n(L, a, b), "b": _z(L, b)} if bias  # noqa: E731
                                  else {"w": _n(L, a, b)})
    backbone = {
        "patch_embed": {"w": _n(P, P, 3, C), "b": _z(C)},
        "cls_token": _z(1, 1, C),
        "layers": {
            "ln1": {"scale": _c(1.0, L, C), "bias": _z(L, C)},
            "ln2": {"scale": _c(1.0, L, C), "bias": _z(L, C)},
            "q": wb(C, C), "k": wb(C, C, False), "v": wb(C, C), "proj": wb(C, C),
            "rel_pos_table": _n(L, num_rel, z["num_heads"]),
            "lambda1": _c(0.1, L, C), "lambda2": _c(0.1, L, C),
            "fc1": wb(C, I), "fc2": wb(I, C),
        },
    }
    Fh = z["fusion_hidden_size"]
    conv = lambda kh, kw, a, b, bias=True: ({"w": _n(kh, kw, a, b), "b": _z(b)} if bias  # noqa: E731
                                            else {"w": _n(kh, kw, a, b)})
    reassemble = []
    for size, factor in zip(z["neck_hidden_sizes"], REASSEMBLE_FACTORS):
        entry = {"readout": {"w": _n(2 * C, C), "b": _z(C)}, "projection": conv(1, 1, C, size)}
        if factor > 1:
            entry["resize"] = {"w": _n(int(factor), int(factor), size, size), "b": _z(size)}
        elif factor < 1:
            entry["resize"] = conv(3, 3, size, size)
        reassemble.append(entry)
    unit = lambda: {"conv1": conv(3, 3, Fh, Fh), "conv2": conv(3, 3, Fh, Fh)}  # noqa: E731
    neck = {
        "reassemble": reassemble,
        "convs": [conv(3, 3, size, Fh, False) for size in z["neck_hidden_sizes"]],
        "fusion": [{"projection": conv(1, 1, Fh, Fh), "res1": unit(), "res2": unit()}
                   for _ in z["neck_hidden_sizes"]],
    }
    R = z["num_relative_features"]
    relative = {"conv1": conv(3, 3, Fh, Fh // 2), "conv2": conv(3, 3, Fh // 2, R),
                "conv3": conv(1, 1, R, 1)}
    Hp, Ip, Lp = (z["patch_transformer_hidden_size"], z["patch_transformer_intermediate_size"],
                  z["num_patch_transformer_layers"])
    pwb = lambda a, b: {"w": _n(Lp, a, b), "b": _z(Lp, b)}  # noqa: E731
    Bf, E = z["bottleneck_features"], z["bin_embedding_dim"]
    c1 = lambda a, b: conv(1, 1, a, b)  # noqa: E731
    experts = {
        name: {
            "seed_bin_regressor": {"conv1": c1(Bf, E // 2), "conv2": c1(E // 2, z["num_bins"])},
            "attractors": [{"conv1": c1(E, E), "conv2": c1(E, 16)} for _ in z["n_attractors"]],
            "log_binomial": {"conv1": c1(R + E, (R + E) // 4), "conv2": c1((R + E) // 4, 4)},
        }
        for name in ("nyu", "kitti")
    }
    metric = {
        "conv2": c1(Bf, Bf),
        "patch_transformer": {
            "embed_conv": c1(Bf, Hp),
            "layers": {"q": pwb(Hp, Hp), "k": pwb(Hp, Hp), "v": pwb(Hp, Hp), "out": pwb(Hp, Hp),
                       "fc1": pwb(Hp, Ip), "fc2": pwb(Ip, Hp),
                       "ln1": {"scale": _c(1.0, Lp, Hp), "bias": _z(Lp, Hp)},
                       "ln2": {"scale": _c(1.0, Lp, Hp), "bias": _z(Lp, Hp)}},
        },
        "mlp_classifier": {"fc1": {"w": _n(Hp, Hp), "b": _z(Hp)},
                           "fc2": {"w": _n(Hp, 2), "b": _z(2)}},
        "seed_projector": {"conv1": c1(Bf, E // 2), "conv2": c1(E // 2, E)},
        "projectors": [{"conv1": c1(Fh, E // 2), "conv2": c1(E // 2, E)} for _ in range(4)],
        "experts": experts,
    }
    return {"backbone": backbone, "neck": neck, "relative_head": relative, "metric_head": metric}


def tree_spec(model: dict) -> dict:
    """The parameter tree of a configuration's ``model`` dict: nested dicts
    and lists whose leaves are (kind, shape, value): ("normal", shape, std)
    or ("const", shape, fill)."""
    v, t = model["vision"], model["text"]
    spec = {
        "vision": _siglip(v),
        "projector": {"w": _n(v["hidden_size"], t["hidden_size"]), "b": _z(t["hidden_size"])},
        "lm": _gemma2(t),
    }
    if model.get("use_spatial_token", True):
        spec["spatial_embed"] = _n(model["spatial_token_num"], t["hidden_size"])
    if model.get("use_vision_zoe", True):
        spec["ego3d"] = _ego3d(model["ego3d"])
        if model.get("zoe"):
            spec["zoe"] = _zoe(model["zoe"])
    return spec


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, fill):
    if isinstance(tree, dict):
        return {k: _rebuild(v, fill) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, fill) for v in tree]
    return fill(tree)


def tower_seed(seed: int, tower: str) -> int:
    """A 63-bit generator seed for one tower, from the run's seed (any whole
    number) and the tower's name."""
    h = hashlib.sha256(f"{int(seed)}/{tower}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def make_tower(spec: dict, tower: str, seed: int, device, dtype=torch.bfloat16):
    """One tower of ``spec`` on ``device`` in ``dtype``, from the tower's
    generator: each random leaf of at least ``OWN_BUFFER`` elements is one
    ``torch.randn`` call of its own (so a leaf the program replaces, as
    quantization does, frees its memory), the smaller ones are carved, in
    tree order, out of one shared call; each is scaled by its std, and
    constants are filled."""
    sub = spec[tower]
    normals = [leaf for _, leaf in _leaves(sub) if leaf[0] == "normal"]
    small = sum(math.prod(shape) for _, shape, _ in normals if math.prod(shape) < OWN_BUFFER)
    gen = torch.Generator(device=device).manual_seed(tower_seed(seed, tower))
    with torch.no_grad():
        buf = torch.randn(small, generator=gen, device=device, dtype=dtype) if small else None
    offset = 0

    def fill(leaf):
        nonlocal offset
        kind, shape, value = leaf
        if kind == "const":
            return torch.full(shape, value, device=device, dtype=dtype)
        n = math.prod(shape)
        if n >= OWN_BUFFER:
            return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(value)
        out = buf[offset:offset + n].view(shape).mul_(value)
        offset += n
        return out

    with torch.no_grad():
        return _rebuild(sub, fill)


def make_tree(model: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Every tower of ``model``'s tree from ``seed`` (``make_tower``)."""
    spec = tree_spec(model)
    return {tower: make_tower(spec, tower, seed, device, dtype) for tower in TOWERS
            if tower in spec}
