"""The serving cells' check: the reference run over each sampled request's
prompt followed by the tokens the program served, and the gap by which a
served token's logit lies below the reference's best in the action block.

Greedy decoding serves the block's argmax at every step, so a sound program
serves tokens whose reference gap is 0, or, where two logits are nearly
tied, as small as its rounding. The control reads the same positions with
the LM in int4 (the next precision below the configuration's int8): the
token int4 puts first, and that token's gap in the int8 reference.

Everything the program derived from the inputs (the int8 codes and scales,
the precomputed ZoeDepth bias, the processor's ids and pixels) is worked
out again here from the seed, the traffic's requests and the configuration.
"""
from __future__ import annotations

import numpy as np
import torch

from ..harness import weights
from . import model as ref
from .quant import dequant

VISION_BLOCK = 8  # requests a pass of the vision front takes at once
LM_MATRICES = ("q", "k", "v", "o", "gate", "up", "down")


def prompt_ids(model: dict, instruction: str) -> list:
    """<image> x N + BOS + the instruction and a newline as byte ids
    (0 pad, 1 BOS, 2 EOS, 3 + byte)."""
    v = model["vision"]
    n_img = (v["image_size"] // v["patch_size"]) ** 2
    return [model["image_token_index"]] * n_img + [1] + [3 + b for b in (instruction + "\n").encode()]


def intrinsic(serving: dict, image_size: int) -> np.ndarray:
    """The camera matrix rescaled from its native size to the model's."""
    cam = serving["intrinsic"]
    K = np.asarray(cam["matrix"], dtype=np.float32).copy()
    K[0] *= image_size / cam["width"]
    K[1] *= image_size / cam["height"]
    return K


def _features(model, serving, seed, frames, device):
    spec = weights.tree_spec(model)
    towers = {t: weights.make_tower(spec, t, seed, device)
              for t in ("vision", "projector", "ego3d", "zoe") if t in spec}
    size = model["vision"]["image_size"]
    K = torch.as_tensor(intrinsic(serving, size), device=device)
    out = []
    for i in range(0, len(frames), VISION_BLOCK):
        px = torch.as_tensor(np.stack(frames[i:i + VISION_BLOCK]), device=device).float() / 255.0
        out.append(ref.image_features(towers, model, px, K.expand(px.shape[0], 3, 3)))
    return torch.cat(out)


def lm_logits(model, seed, ids, prompt_lens, lengths, feats, device, bits_list):
    """For each precision in ``bits_list``, the softcapped float32 logits
    (B, n, block) of the action block at the n positions after each row's
    prompt, from the LM with its matrices and head in that precision."""
    t = model["text"]
    spec = weights.tree_spec(model)
    lm = weights.make_tower(spec, "lm", seed, device)
    spatial = weights.make_tower(spec, "spatial_embed", seed, device) if "spatial_embed" in spec else None
    h0 = ref.embed(lm["embed"], spatial, model, ids, feats)
    L = lm["layers"]
    begin, n_block = model["action_token_begin_idx"], model["spatial_token_num"]
    n = int((lengths - prompt_lens).max())
    rows = torch.arange(ids.shape[0], device=device)[:, None]
    at = prompt_lens[:, None] - 1 + torch.arange(n, device=device)[None]
    out = {}
    for bits in bits_list:
        def layers_of(l, bits=bits):
            w = {m: dequant((L["attn"] if m in ("q", "k", "v", "o") else L["mlp"])[m][l], bits)
                 for m in LM_MATRICES}
            w.update({k: L[k][l] for k in ("input_norm", "post_attn_norm", "pre_ffn_norm",
                                           "post_ffn_norm")})
            return w

        h = ref.lm_hidden(layers_of, t, h0, lengths, prompt_lens)
        h = ref.rms_norm(lm["final_norm"], h[rows, at], t["rms_norm_eps"])
        head = dequant(lm["lm_head"][:, begin:begin + n_block], bits)
        out[bits] = ref.softcap(h @ head, t["final_logit_softcap"])
    return out


def check(cfg: dict, seed: int, requests: list, served: list, device, *, control: bool = False):
    """Gaps of the served tokens of ``requests`` (each with .frame and
    .instruction; ``served`` their (n,) ids). Returns {"gap_max", "gaps"
    (per request), "tokens"} and, with ``control``, "control_gap_max" and
    "control_gaps": the int8 reference's gap of the token int4 puts first."""
    model, serving = cfg["model"], cfg["serving"]
    begin, n_block = model["action_token_begin_idx"], model["spatial_token_num"]
    with torch.no_grad(), ref.no_tf32():
        feats = _features(model, serving, seed, [r.frame for r in requests], device)
        prompts = [prompt_ids(model, r.instruction) for r in requests]
        served = [np.asarray(s, dtype=np.int64) for s in served]
        T = max(len(p) + len(s) for p, s in zip(prompts, served))
        ids = torch.zeros((len(requests), T), dtype=torch.long, device=device)
        for i, (p, s) in enumerate(zip(prompts, served)):
            ids[i, :len(p) + len(s)] = torch.as_tensor(p + s.tolist(), device=device)
        prompt_lens = torch.as_tensor([len(p) for p in prompts], device=device)
        lengths = torch.as_tensor([len(p) + len(s) for p, s in zip(prompts, served)], device=device)
        logits = lm_logits(model, seed, ids, prompt_lens, lengths, feats, device,
                           (8, 4) if control else (8,))
        l8 = logits[8]
        best = l8.max(-1).values
        gaps, ctrl = [], []
        for i, s in enumerate(served):
            local = torch.as_tensor(s - begin, device=device)
            inside = (local >= 0) & (local < n_block)
            got = l8[i, torch.arange(len(s), device=device), local.clamp(0, n_block - 1)]
            g = torch.where(inside, best[i, :len(s)] - got, torch.full_like(got, float("inf")))
            gaps.append(float(g.max()))
            if control:
                pick = logits[4][i, :len(s)].argmax(-1)
                ctrl.append(float((best[i, :len(s)] - l8[i, torch.arange(len(s), device=device),
                                                          pick]).max()))
    out = {"gap_max": max(gaps) if gaps else None, "gaps": gaps,
           "tokens": int(sum(len(s) for s in served))}
    if control:
        out.update(control_gap_max=max(ctrl) if ctrl else None, control_gaps=ctrl)
    return out
