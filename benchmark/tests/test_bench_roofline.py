"""The yardstick's counts: the decode step's and the flash forward's bytes
against the bounds that PERF.md's kernel table gives (bytes over 3.35 TB/s),
and the FLOP counts of the vision front and the decoder against PyTorch's
own count of the reference's matrix products on the tiny configuration."""
import dataclasses
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import roofline, weights
from benchmark.reference import model as ref

BW = 3.35e12


@pytest.fixture(scope="module")
def full():
    with open("benchmark/configs/spatialvla-4b-int8.json") as f:
        return json.load(f)["model"]


@pytest.fixture(scope="module")
def tiny():
    from spatialvla_tpu_torch.config import spatialvla_tiny

    cfg = spatialvla_tiny(use_vision_zoe=True)
    return json.loads(dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, sliding_window=512)).to_json())


def test_decode_step_bound_m1_s289(full):
    ms = roofline.decode_step_bytes(full["text"], 1, 288) / BW * 1e3
    assert round(ms, 4) == 0.6144


def test_flash_forward_bound_b2_t320(full):
    pairs = 2 * roofline.prefix_lm_pairs(296, 308)
    ops, data = roofline.flash_fwd(full["text"], 2, 320, pairs)
    assert round(data / BW * 1e3, 4) == 0.0024
    assert ops / 989e12 < data / BW  # bandwidth bounds it at T=320


def test_prefix_lm_pairs():
    assert roofline.prefix_lm_pairs(3, 3) == 9
    assert roofline.prefix_lm_pairs(2, 4) == 4 + 2 * 2 + 3  # suffix sees prefix and itself causally
    assert roofline.prefix_lm_pairs(0, 4) == 10


def test_front_flops_match_counted(tiny):
    spec = weights.tree_spec(tiny)
    towers = {t: weights.make_tower(spec, t, 5, "cpu", torch.float32)
              for t in ("vision", "projector", "ego3d", "zoe")}
    px = torch.rand(2, 56, 56, 3)
    K = torch.tensor([[50.0, 0, 28], [0, 50.0, 28], [0, 0, 1]]).expand(2, 3, 3)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.image_features(towers, tiny, px, K)
    assert fc.get_total_flops() == 2 * roofline.front_flops(tiny)


def test_lm_flops_match_counted(tiny):
    spec = weights.tree_spec(tiny)
    lm = weights.make_tower(spec, "lm", 5, "cpu", torch.float32)
    L = lm["layers"]
    T = 37

    def layers_of(l):
        w = {m: (L["attn"] if m in "qkvo" else L["mlp"])[m][l].float()
             for m in ("q", "k", "v", "o", "gate", "up", "down")}
        w.update({k: L[k][l] for k in ("input_norm", "post_attn_norm", "pre_ffn_norm", "post_ffn_norm")})
        return w

    h = torch.randn(1, T, tiny["text"]["hidden_size"])
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.lm_hidden(layers_of, tiny["text"], h, torch.tensor([T]), torch.tensor([20]))
    assert fc.get_total_flops() == roofline.lm_flops(tiny["text"], T, T * T)


def test_serve_request_flops_parts(full):
    t = full["text"]
    P, n = 290, 12
    pairs = P * P + sum(P + s for s in range(1, n))
    want = (roofline.front_flops(full) + roofline.lm_flops(t, P + n - 1, pairs)
            + 2 * t["hidden_size"] * full["spatial_token_num"] * n)
    assert roofline.serve_request_flops(full, P, n) == want
    assert 1.5e12 < want < 2.5e12
