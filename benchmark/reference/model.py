"""A plain float32 SpatialVLA in PyTorch, the benchmark's reference.

SigLIP, ZoeDepth (BEiT backbone, reassemble / fusion neck, relative head,
metric-bins head with its two experts), Ego3D and the projector make the
image features; Gemma2 runs the prompt and the served tokens as one
sequence under the prefix-LM mask (bidirectional over the prompt, causal
after it) and gives the softcapped logits of the action-token block. It
follows the published SpatialVLA (arXiv:2501.15830) and the
reference-format checkpoint's tree, and imports nothing of the program.

Weights are the benchmark's seeded bf16 tree (``harness/weights.py``), each
leaf widened to float32 where it is used; the LM's matrices are taken as a
``dequant`` function gives them (``reference/quant.py``: the int8 serving
form, or int4 for the control). Every op is a plain ``torch`` call in
float32; callers turn TF32 off (``no_tf32``).

One departure, for a request judged on its own: ZoeDepth picks its expert
(NYU or KITTI) by a vote of the domain classifier. The program votes over
the rows of a batch; this reference votes over the one request.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

REASSEMBLE_FACTORS = (4, 2, 1, 0.5)
ZOE_PAD = 31


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions in float32, not TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def f32(t):
    return t.float()


def linear(p, x):
    y = x @ f32(p["w"])
    return y + f32(p["b"]) if "b" in p else y


def layer_norm(p, x, eps):
    return F.layer_norm(x, x.shape[-1:], f32(p["scale"]), f32(p["bias"]), eps)


def rms_norm(w, x, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + f32(w))


def softcap(x, cap):
    return x if cap is None else torch.tanh(x / cap) * cap


def layer(tree, l):
    """Layer l of a stacked (L, ...) tree."""
    if isinstance(tree, dict):
        return {k: layer(v, l) for k, v in tree.items()}
    return tree[l]


def attention(q, k, v, mask, scale, cap=None):
    """q (B, T, Nq, D), k / v (B, S, Nkv, D), mask (B, T, S) bool or None."""
    g = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    logits = softcap(torch.einsum("btnd,bsnd->bnts", q, k) * scale, cap)
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None], float("-inf"))
    return torch.einsum("bnts,bsnd->btnd", torch.softmax(logits, -1), v)


def conv(p, x, stride=1, padding=0):
    """NHWC x, HWIO weight."""
    y = F.conv2d(x.permute(0, 3, 1, 2), f32(p["w"]).permute(3, 2, 0, 1), stride=stride,
                 padding=padding).permute(0, 2, 3, 1)
    return y + f32(p["b"]) if "b" in p else y


def resize(x, hw, mode="bilinear", align_corners=True):
    """NHWC x to (h, w)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode=mode,
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# SigLIP
# ---------------------------------------------------------------------------

def siglip(p, v, pixels):
    """pixels (B, H, W, 3) in [0, 1] -> (B, N, hidden)."""
    B, Hi, Wi, _ = pixels.shape
    P, H, nh = v["patch_size"], v["hidden_size"], v["num_heads"]
    x = (pixels - 0.5) / 0.5
    x = x.reshape(B, Hi // P, P, Wi // P, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, -1, P * P * 3)
    h = x @ f32(p["patch_embed"]["w"]).reshape(P * P * 3, H) + f32(p["patch_embed"]["b"])
    h = h + f32(p["pos_embed"])[None]
    hd = H // nh
    for l in range(v["num_layers"]):
        lp = layer(p["layers"], l)
        x = layer_norm(lp["ln1"], h, v["layer_norm_eps"])
        q, k, val = (linear(lp["attn"][n], x).reshape(B, -1, nh, hd) for n in ("q", "k", "v"))
        h = h + linear(lp["attn"]["o"], attention(q, k, val, None, hd ** -0.5).reshape(B, -1, H))
        x = layer_norm(lp["ln2"], h, v["layer_norm_eps"])
        h = h + linear(lp["mlp"]["fc2"], F.gelu(linear(lp["mlp"]["fc1"], x), approximate="tanh"))
    return layer_norm(p["post_ln"], h, v["layer_norm_eps"])


# ---------------------------------------------------------------------------
# ZoeDepth
# ---------------------------------------------------------------------------

def relative_position_index(window: int) -> torch.Tensor:
    """(N+1, N+1) rows of BEiT's bias table; the last three rows serve
    cls -> token, token -> cls and cls -> cls."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (window - 1)
    n_rel = (2 * window - 1) ** 2 + 3
    idx = np.zeros((window * window + 1,) * 2, dtype=np.int64)
    idx[1:, 1:] = rel[..., 0] * (2 * window - 1) + rel[..., 1]
    idx[0, :] = n_rel - 3
    idx[:, 0] = n_rel - 2
    idx[0, 0] = n_rel - 1
    return torch.from_numpy(idx)


def beit(p, z, x):
    """x (B, S, S, 3) normalized -> the token sequences after the tapped layers."""
    B = x.shape[0]
    C, nh = z["hidden_size"], z["num_heads"]
    hd = C // nh
    tokens = conv(p["patch_embed"], x, stride=z["patch_size"]).reshape(B, -1, C)
    h = torch.cat([f32(p["cls_token"]).expand(B, 1, C), tokens], 1)
    idx = relative_position_index(x.shape[1] // z["patch_size"]).to(x.device)
    taps = []
    for l in range(z["num_layers"]):
        lp = layer(p["layers"], l)
        y = layer_norm(lp["ln1"], h, z["layer_norm_eps"])
        q, k, v = (linear(lp[n], y).reshape(B, -1, nh, hd) for n in ("q", "k", "v"))
        bias = f32(lp["rel_pos_table"])[idx].permute(2, 0, 1)  # (nh, N+1, N+1)
        logits = torch.einsum("bqnd,bknd->bnqk", q, k) * hd ** -0.5 + bias[None]
        a = torch.einsum("bnqk,bknd->bqnd", torch.softmax(logits, -1), v).reshape(B, -1, C)
        h = h + f32(lp["lambda1"]) * linear(lp["proj"], a)
        y = layer_norm(lp["ln2"], h, z["layer_norm_eps"])
        h = h + f32(lp["lambda2"]) * linear(lp["fc2"], F.gelu(linear(lp["fc1"], y)))
        if l + 1 in z["out_indices"]:
            taps.append(h)
    return taps


def _unit(p, x):
    y = conv(p["conv1"], torch.relu(x), padding=1)
    return x + conv(p["conv2"], torch.relu(y), padding=1)


def neck(p, z, taps, side):
    feats = []
    for hs, entry, factor in zip(taps, p["reassemble"], REASSEMBLE_FACTORS):
        cls, tokens = hs[:, :1], hs[:, 1:]
        B, N, C = tokens.shape
        x = F.gelu(linear(entry["readout"], torch.cat([tokens, cls.expand(B, N, C)], -1)))
        x = conv(entry["projection"], x.reshape(B, side, side, C))
        if factor > 1:  # a transposed convolution with kernel = stride
            f = int(factor)
            w = f32(entry["resize"]["w"])  # (f, f, out, in)
            x = torch.einsum("bhwc,ijoc->bhiwjo", x, w).reshape(B, side * f, side * f, -1)
            x = x + f32(entry["resize"]["b"])
        elif factor < 1:
            x = conv(entry["resize"], x, stride=2, padding=1)
        feats.append(x)
    feats = [conv(c, f, padding=1) for c, f in zip(p["convs"], feats)]
    fused, state = [], None
    for f, fp in zip(feats[::-1], p["fusion"]):
        if state is None:
            hidden = f
        else:
            res = f if f.shape[1:3] == state.shape[1:3] else resize(f, state.shape[1:3],
                                                                  align_corners=False)
            hidden = state + _unit(fp["res1"], res)
        hidden = _unit(fp["res2"], hidden)
        hidden = resize(hidden, (hidden.shape[1] * 2, hidden.shape[2] * 2))
        state = conv(fp["projection"], hidden)
        fused.append(state)
    return fused, feats[-1]


def _mlp2(p, x):
    return conv(p["conv2"], torch.relu(conv(p["conv1"], x)))


def patch_transformer(p, z, x):
    nh = z["patch_transformer_num_attention_heads"]
    emb = conv(p["embed_conv"], x)
    B, H, W, C = emb.shape
    h = torch.cat([torch.zeros(B, 1, C, device=x.device), emb.reshape(B, H * W, C)], 1)
    S = h.shape[1]
    pos = torch.arange(S, dtype=torch.float32, device=x.device)[:, None]
    div = torch.exp(torch.arange(0, C, 2, dtype=torch.float32, device=x.device)
                    * (-math.log(10000.0) / C))
    h = h + torch.cat([torch.sin(pos * div), torch.cos(pos * div)], 1)[None]
    hd = C // nh
    for l in range(z["num_patch_transformer_layers"]):
        lp = layer(p["layers"], l)
        q, k, v = (linear(lp[n], h).reshape(B, S, nh, hd) for n in ("q", "k", "v"))
        a = linear(lp["out"], attention(q, k, v, None, hd ** -0.5).reshape(B, S, C))
        h = layer_norm(lp["ln1"], h + a, 1e-5)
        h = layer_norm(lp["ln2"], h + linear(lp["fc2"], torch.relu(linear(lp["fc1"], h))), 1e-5)
    return h[:, 0]


def _log_binomial_softmax(prob, temperature, n):
    k = torch.arange(n, dtype=torch.float32, device=prob.device)
    n1 = torch.tensor(float(n - 1), device=prob.device)
    p = prob.clamp(1e-4, 1.0)[..., None]
    q = (1 - prob).clamp(1e-4, 1.0)[..., None]

    def log_binom(a, b, e=1e-7):
        a, b = a + e, b + e
        return a * torch.log(a) - b * torch.log(b) - (a - b) * torch.log((a - b + e).clamp_min(1e-12))

    y = log_binom(n1, k) + k * torch.log(p) + (n1 - k) * torch.log(q)
    return torch.softmax(y / temperature, -1)


def _expert(e, mh, z, x, fused, outconv):
    prev_bin = F.softplus(_mlp2(e["seed_bin_regressor"], x))
    prev_emb = _mlp2(mh["seed_projector"], x)
    centers = prev_bin
    for proj, attr, feat in zip(mh["projectors"], e["attractors"], fused):
        emb = _mlp2(proj, feat)
        y = emb + (prev_emb if prev_emb.shape[1:3] == emb.shape[1:3]
                   else resize(prev_emb, emb.shape[1:3]))
        attractors = F.softplus(_mlp2(attr, y))
        centers = resize(prev_bin, attractors.shape[1:3])
        dx = attractors[..., None] - centers[..., None, :]
        centers = centers + (dx / (1.0 + 300.0 * dx ** 2)).mean(-2)
        prev_bin, prev_emb = centers, emb
    hw = outconv.shape[1:3]
    centers = resize(centers, hw)
    x = torch.cat([outconv, resize(prev_emb, hw)], -1)
    lb = e["log_binomial"]
    x = F.softplus(conv(lb["conv2"], F.gelu(conv(lb["conv1"], x))))
    prob = x[..., :2] + 1e-4
    prob = prob[..., 0] / (prob[..., 0] + prob[..., 1])
    temp = x[..., 2:] + 1e-4
    temp = temp[..., 0] / (temp[..., 0] + temp[..., 1])
    temp = ((z["max_temp"] - z["min_temp"]) * temp + z["min_temp"])[..., None]
    return (_log_binomial_softmax(prob, temp, z["num_bins"]) * centers).sum(-1)


def zoe_depth(p, z, pixels):
    """pixels (B, H, W, 3) in [0, 1] -> metric depth (B, H, W), each row's
    expert chosen by its own domain vote."""
    B, Hi, Wi, _ = pixels.shape
    S = z["image_size"]
    x = F.pad(pixels.permute(0, 3, 1, 2), (ZOE_PAD,) * 4, mode="reflect")
    x = F.interpolate(x, size=(S, S), mode="bicubic", align_corners=True).permute(0, 2, 3, 1)
    x = (x - 0.5) / 0.5
    side = S // z["patch_size"]
    fused, bottleneck = neck(p["neck"], z, beit(p["backbone"], z, x), side)
    rh = p["relative_head"]
    y = resize(conv(rh["conv1"], fused[-1], padding=1), (fused[-1].shape[1] * 2,) * 2)
    outconv = torch.relu(conv(rh["conv2"], y, padding=1))
    mh = p["metric_head"]
    xb = conv(mh["conv2"], bottleneck)
    emb = patch_transformer(mh["patch_transformer"], z, xb)
    domain = linear(mh["mlp_classifier"]["fc2"], torch.relu(linear(mh["mlp_classifier"]["fc1"], emb)))
    depth = torch.empty(B, *outconv.shape[1:3], device=pixels.device)
    for i in range(B):
        name = "nyu" if int(torch.argmax(domain[i])) == 0 else "kitti"
        rows = slice(i, i + 1)
        depth[rows] = _expert(mh["experts"][name], mh, z, xb[rows], [f[rows] for f in fused],
                              outconv[rows])
    depth = F.interpolate(depth[:, None], size=(Hi + 2 * ZOE_PAD, Wi + 2 * ZOE_PAD),
                          mode="bicubic", align_corners=True)[:, 0]
    return depth[:, ZOE_PAD:-ZOE_PAD, ZOE_PAD:-ZOE_PAD]


# ---------------------------------------------------------------------------
# Ego3D and the image features
# ---------------------------------------------------------------------------

def ego3d(p, e, K, depth, image_size, patch_size):
    """Back-projected per-patch points -> frequency encoding -> MLP."""
    B = depth.shape[0]
    r = e["patch_reso"]
    side = image_size // patch_size
    n = side * r
    f = depth.shape[1] // n
    d = depth[:, :n * f, :n * f].reshape(B, n, f, n, f).mean((2, 4)).reshape(B, 1, -1)
    step = patch_size // r
    c = torch.arange(0, image_size, step, dtype=torch.float32, device=depth.device) + step / 2
    yy, xx = torch.meshgrid(c, c, indexing="ij")
    uv = torch.stack([xx, yy, torch.ones_like(xx)]).reshape(3, -1)
    pts = (torch.linalg.inv(K) @ uv[None]) * d
    pts = pts.reshape(B, 3, side, r, side, r).permute(0, 2, 4, 3, 5, 1).reshape(B, side * side, -1)
    center = torch.tensor([0.0, 0.0, 2.0], device=depth.device).repeat(r * r)
    xn = (pts - center) / 2.0
    bands = 2.0 ** torch.linspace(0.0, e["n_freqs"] - 1, e["n_freqs"], device=depth.device)
    xf = xn[..., None] * bands
    enc = torch.cat([xn[..., None], torch.sin(xf), torch.cos(xf)], -1).reshape(B, side * side, -1)
    h = torch.relu(layer_norm(p["ln"], linear(p["fc1"], enc), 1e-5))
    return linear(p["fc2"], h)


def image_features(towers, model, pixels, K):
    """The projected image features (B, N, lm hidden) of raw [0, 1] pixels."""
    v = model["vision"]
    feats = siglip(towers["vision"], v, pixels)
    if model.get("use_vision_zoe", True):
        depth = zoe_depth(towers["zoe"], model["zoe"], pixels)
        feats = feats + ego3d(towers["ego3d"], model["ego3d"], K, depth, v["image_size"],
                              v["patch_size"])
    return linear(towers["projector"], feats) / math.sqrt(model["text"]["hidden_size"])


# ---------------------------------------------------------------------------
# Gemma2 over prompt + served tokens
# ---------------------------------------------------------------------------

def rope(x, pos, theta):
    """x (B, T, N, D), pos (B, T) -> rotated x (half rotation)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = pos.float()[..., None] * inv
    ang = torch.cat([ang, ang], -1)[:, :, None]
    half = D // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * torch.cos(ang) + rot * torch.sin(ang)


def embed(lm_embed, spatial_embed, model, ids, feats):
    """ids (B, T) -> (B, T, H): text rows of the embedding, the image
    features in order at the image-token positions, the spatial table at the
    action ids."""
    out = f32(lm_embed[ids.clamp(0, lm_embed.shape[0] - 1)])
    begin, n = model["action_token_begin_idx"], model["spatial_token_num"]
    if spatial_embed is not None:
        is_act = (ids >= begin) & (ids < begin + n)
        out = torch.where(is_act[..., None], f32(spatial_embed[(ids - begin).clamp(0, n - 1)]), out)
    is_img = ids == model["image_token_index"]
    slot = (torch.cumsum(is_img.long(), 1) - 1).clamp(0, feats.shape[1] - 1)
    img = torch.gather(feats, 1, slot[..., None].expand(*slot.shape, feats.shape[-1]))
    return torch.where(is_img[..., None], img, out)


def prefix_lm_mask(lengths, prompt_lens, T, window, device):
    """(B, T, T): key k visible from query q when k lies in the row, and
    k <= q or k is in the prompt; within the sliding window. Queries past a
    row's end (padding, never read) see the row's keys too, so that no
    softmax row is empty."""
    idx = torch.arange(T, device=device)
    valid = idx[None] < lengths[:, None]
    prompt = idx[None] < prompt_lens[:, None]
    causal = idx[None, :, None] >= idx[None, None, :]
    mask = (causal | prompt[:, None, :]) & valid[:, None, :]
    return mask, mask & ((idx[:, None] - idx[None, :]) < window)[None]


def lm_hidden(layers_of, t, h, lengths, prompt_lens):
    """Gemma2's decoder over (B, T, H) embeddings; ``layers_of(l)`` gives
    layer l's float32 matrices {q, k, v, o, gate, up, down} and norms."""
    B, T, H = h.shape
    Nq, Nkv, D = t["num_heads"], t["num_kv_heads"], t["head_dim"]
    eps = t["rms_norm_eps"]
    pos = torch.arange(1, T + 1, device=h.device)[None].expand(B, T)
    full, sliding = prefix_lm_mask(lengths, prompt_lens, T, t["sliding_window"], h.device)
    h = h * math.sqrt(H)
    for l in range(t["num_layers"]):
        w = layers_of(l)
        x = rms_norm(w["input_norm"], h, eps)
        q = rope((x @ w["q"]).reshape(B, T, Nq, D), pos, t["rope_theta"])
        k = rope((x @ w["k"]).reshape(B, T, Nkv, D), pos, t["rope_theta"])
        v = (x @ w["v"]).reshape(B, T, Nkv, D)
        a = attention(q, k, v, sliding if l % 2 == 0 else full,
                      t["query_pre_attn_scalar"] ** -0.5, t["attn_logit_softcap"])
        h = h + rms_norm(w["post_attn_norm"], a.reshape(B, T, -1) @ w["o"], eps)
        x = rms_norm(w["pre_ffn_norm"], h, eps)
        m = (F.gelu(x @ w["gate"], approximate="tanh") * (x @ w["up"])) @ w["down"]
        h = h + rms_norm(w["post_ffn_norm"], m, eps)
    return h
