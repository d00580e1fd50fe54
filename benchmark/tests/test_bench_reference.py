"""The benchmark's reference against the port, both in float32 on the CPU at
the tiny configuration, from the same seeded weights: the image features
(SigLIP, ZoeDepth, Ego3D, projector) and the action block's logits of the
LM with int8 matrices over a prompt and served tokens."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark.harness import traffic, weights
from benchmark.reference import serve_check

SEED = 20250517


def tiny_model():
    from spatialvla_tpu_torch.config import spatialvla_tiny

    cfg = spatialvla_tiny(use_vision_zoe=True)
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, sliding_window=512))
    return json.loads(cfg.to_json())


def serving():
    with open("benchmark/configs/spatialvla-4b-int8.json") as f:
        return json.load(f)["serving"]


def mix():
    with open("benchmark/traffic/fleet28.json") as f:
        m = json.load(f)
    m["frame"] = {"height": 56, "width": 56, "channels": 3}
    return m


@pytest.fixture(scope="module")
def port_side():
    from spatialvla_tpu_torch.config import SpatialVLAConfig
    from spatialvla_tpu_torch.ops.quant import quantize_lm_params

    model = tiny_model()
    params = weights.make_tree(model, SEED, "cpu")
    params["lm"] = quantize_lm_params(params["lm"], bits=8)
    return model, SpatialVLAConfig.from_dict(model), params


@pytest.mark.parametrize("client", [0, 1, 2])
def test_image_features_match_port(port_side, client):
    from spatialvla_tpu_torch.models import spatialvla

    model, cfg, params = port_side
    req = traffic.make(mix(), SEED).request(client, 0)
    K = torch.as_tensor(serve_check.intrinsic(serving(), model["vision"]["image_size"]))[None]
    px = torch.as_tensor(req.frame[None]).float() / 255.0
    with torch.no_grad():
        port = spatialvla.get_image_features(params, cfg, px, K, compute_dtype=torch.float32)
        ref = serve_check._features(model, serving(), SEED, [req.frame], "cpu")
    torch.testing.assert_close(ref, port, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("client", [0, 3])
def test_action_logits_match_port(port_side, client):
    from spatialvla_tpu_torch.models import spatialvla

    model, cfg, params = port_side
    req = traffic.make(mix(), SEED).request(client, 1)
    begin, block = model["action_token_begin_idx"], model["spatial_token_num"]
    served = np.random.default_rng(client).integers(begin, begin + block, 12)
    prompt = serve_check.prompt_ids(model, req.instruction)
    ids = torch.as_tensor([prompt + served.tolist()])
    P, T = len(prompt), ids.shape[1]
    K = torch.as_tensor(serve_check.intrinsic(serving(), model["vision"]["image_size"]))[None]
    px = torch.as_tensor(req.frame[None]).float() / 255.0
    ttype = torch.zeros((1, T), dtype=torch.long)
    ttype[:, P:] = 1
    with torch.no_grad():
        out = spatialvla.forward(params, cfg, ids, pixel_values=px, intrinsic=K,
                                 attention_mask=torch.ones((1, T), dtype=torch.long),
                                 token_type_ids=ttype, compute_dtype=torch.float32)
        port = out["logits"][0, P - 1:T - 1, begin:begin + block]
        feats = serve_check._features(model, serving(), SEED, [req.frame], "cpu")
        ref = serve_check.lm_logits(model, SEED, ids, torch.tensor([P]), torch.tensor([T]), feats,
                                    "cpu", (8,))[8][0]
    torch.testing.assert_close(ref, port, rtol=1e-4, atol=1e-5)
