"""The serving cell's check fails what it must: the control (the reference
with an int4 LM in place of the program) and, through the whole harness
with the engine broken underneath, a token altered where it is produced,
half of a batch's rows answered with another row's tokens, a decode that
never advances past its first token, and a front whose output never
reaches the LM. (It does not see the front's precision: with the
benchmark's random weights the action logits move by about half a logit
when the image features are zeroed, and not at all when they are scaled
by 0.9.)

At the tiny configuration logits are smaller than at full width (the head's
input width is 48, not 2304), so these runs hold the tiny readings to a
limit of their own, TINY_LIMIT, set as the cell's is: sound tiny runs read
0.0025-0.0098, the int4 control 0.18-0.25 (seeds 1-3, 8 requests each), the
program's own int4 LM path 0.22-0.33 through the harness (seeds 1-3)."""
import dataclasses
import json
import time

import pytest
import torch

from benchmark import run as bench_run
from benchmark.drivers import serve_engine
from benchmark.harness import cells, traffic
from benchmark.reference import serve_check

TINY_LIMIT = 0.06


def tiny_cell(robots=4, requests=100, name="serve-int8-fleet28"):
    from spatialvla_tpu_torch.config import spatialvla_tiny

    cell = cells.load(name)
    cfg = spatialvla_tiny(use_vision_zoe=True)
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, sliding_window=512))
    cell.cfg["model"] = json.loads(cfg.to_json())
    cell.cfg["serving"]["max_wait_ms"] = 200.0  # batches of several rows
    cell.cfg["check"]["served_logit_gap"]["limit"] = TINY_LIMIT
    cell.mix.update(robots=robots, frame={"height": 56, "width": 56, "channels": 3},
                    check={"requests": requests})
    if cell.mix["loop"] == "open":
        cell.mix["period_s"] = 2.0
    return cell


def execute(cell, seed=7):
    t0 = time.monotonic()
    line, _ = bench_run.execute(cell, seed, 6.0, False, torch.device("cpu"),
                                setup_clock=lambda: time.monotonic() - t0)
    return line


def test_sound_run_is_correct():
    line = execute(tiny_cell())
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"request_p95_ms", "setup_s"}
    assert list(line)[-1] == "checks"


def test_closed_loop_run_is_correct_and_keeps_its_robots_busy():
    cell = tiny_cell(robots=6, name="serve-int8-closed128")
    line, run = bench_run.execute(cell, 11, 6.0, False, torch.device("cpu"),
                                  setup_clock=lambda: 1.0)
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"actions_per_s", "setup_s"}
    per_robot = {}
    for d in run["answered"]:
        per_robot.setdefault(d.client, []).append(d.index)
    assert sorted(per_robot) == list(range(6))  # every robot sent, each in order
    assert all(sorted(ks) == list(range(len(ks))) for ks in per_robot.values())
    assert line["attempted"] > 6


def test_program_in_lower_precision_is_not_correct():
    """The control through the whole harness: the program with its own int4
    LM path switched on, judged against the configuration's int8."""
    cell = tiny_cell()
    cell.cfg["serving"]["lm_bits"] = 4
    line = execute(cell)
    assert line["failed"] == 0 and not line["correct"]
    assert line["checks"]["served_logit_gap"]["value"] > TINY_LIMIT


def _break(monkeypatch, fault, model):
    import spatialvla_tpu_torch.models.spatialvla as sv
    import spatialvla_tpu_torch.serve.engine as eng

    if fault == "image":  # the front's output never reaches the LM
        front = sv.get_image_features
        monkeypatch.setattr(sv, "get_image_features", lambda *a, **k: front(*a, **k) * 0)
        return

    begin, block = model["action_token_begin_idx"], model["spatial_token_num"]
    real = eng._generate_batch

    def broken(policy, ids, attn, px, intr):
        out = real(policy, ids, attn, px, intr).clone()
        if fault == "token":
            out[:, 5] = (out[:, 5] - begin + 1) % block + begin
        elif fault == "rows":
            out[out.shape[0] // 2:] = out[0]
        else:  # "state": the decode state never advances
            out[:, 1:] = out[:, :1]
        return out

    monkeypatch.setattr(eng, "_generate_batch", broken)


@pytest.mark.parametrize("fault", ["token", "rows", "state", "image"])
def test_broken_path_is_not_correct(monkeypatch, fault):
    cell = tiny_cell()
    _break(monkeypatch, fault, cell.cfg["model"])
    line = execute(cell)
    assert line["failed"] == 0
    assert not line["correct"]
    assert line["checks"]["served_logit_gap"]["value"] > TINY_LIMIT


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(seed):
    cell = tiny_cell()
    gen = traffic.make(cell.mix, seed)
    reqs = [gen.request(i, 0) for i in range(8)]
    policy = serve_engine.build(cell.cfg, seed, torch.device("cpu"))
    served = [policy.predict(r.frame, r.instruction, unnorm_key="random_init")["action_ids"]
              for r in reqs]
    v = serve_check.check(cell.cfg, seed, reqs, served, "cpu", control=True)
    assert v["gap_max"] <= TINY_LIMIT < v["control_gap_max"]
