"""The traffic generator: the same seed gives the same requests, every seed
the same sizes in another order and the same arrivals, and prompts that
fit the serving cell's one padded length."""
import json
import math

import numpy as np
import pytest

from benchmark.harness import traffic
from benchmark.reference import serve_check


@pytest.fixture(scope="module")
def mix():
    with open("benchmark/traffic/fleet28.json") as f:
        return json.load(f)


def test_same_seed_same_requests(mix):
    a, b = traffic.make(mix, 2**31 + 77), traffic.make(mix, 2**31 + 77)
    for client, index in [(0, 0), (5, 3), (15, 41)]:
        ra, rb = a.request(client, index), b.request(client, index)
        assert ra.instruction == rb.instruction
        assert np.array_equal(ra.frame, rb.frame)


def test_other_seed_other_requests(mix):
    a, b = traffic.make(mix, 1), traffic.make(mix, 2)
    assert a.request(0, 0).instruction != b.request(0, 0).instruction or not np.array_equal(
        a.request(0, 0).frame, b.request(0, 0).frame)


@pytest.mark.parametrize("seed", [0, 12345, 2**33 + 5, -3])
def test_every_seed_sends_every_size_each_cycle(mix, seed):
    gen = traffic.make(mix, seed)
    lo, hi = mix["instruction"]["words"]
    for client in range(gen.clients):
        counts = sorted(len(gen.request(client, j).instruction.split()) for j in range(hi - lo + 1))
        assert counts == list(range(lo, hi + 1))


def test_frames_and_prompts_fit_the_cell(mix):
    with open("benchmark/configs/spatialvla-4b-int8.json") as f:
        cfg = json.load(f)
    gen = traffic.make(mix, 9)
    f = mix["frame"]
    pad = cfg["serving"]["prompt_pad_multiple"]
    longest = len(serve_check.prompt_ids(cfg["model"], gen.longest_instruction()))
    shortest = len(serve_check.prompt_ids(cfg["model"], min(gen.vocabulary, key=len)))
    assert -(-longest // pad) == -(-shortest // pad)  # one padded prompt length
    r = gen.request(3, 7)
    assert r.frame.shape == (f["height"], f["width"], f["channels"]) and r.frame.dtype == np.uint8


def test_sample_holds_the_longest(mix):
    gen = traffic.make(mix, 4)
    done = [gen.request(i % 16, i // 16) for i in range(64)]
    pick = gen.sample(done, 24)
    assert len(pick) == 24 and len({(d.client, d.index) for d in pick}) == 24
    assert len(pick[0].instruction.encode()) == max(len(d.instruction.encode()) for d in done)
    assert [(d.client, d.index) for d in gen.sample(done, 24)] == [(d.client, d.index) for d in pick]


def test_arrivals_are_the_mix_rate_for_every_seed(mix):
    a, b = traffic.make(mix, 1), traffic.make(mix, 2**40 + 9)
    due = a.arrivals(30.0)
    assert due == b.arrivals(30.0)
    assert all(0 <= t < 30.0 for t, _, _ in due) and due == sorted(due)
    assert abs(len(due) / 30.0 - mix["robots"] / mix["period_s"]) <= mix["robots"] / 30.0
    for r in range(mix["robots"]):
        ks = [k for _, rr, k in due if rr == r]
        assert ks == list(range(len(ks)))
        times = [t for t, rr, _ in due if rr == r]
        assert all(abs(y - x - mix["period_s"]) < 1e-9 for x, y in zip(times, times[1:]))


def test_closed_loop_makes_its_frames_ahead_and_fixes_no_arrivals():
    with open("benchmark/traffic/closed128.json") as f:
        closed = json.load(f)
    gen = traffic.make(closed, 2**31 + 3)
    pre = gen.premade(30.0)
    each = math.ceil(closed["premade_rps"] * 30.0 / closed["robots"])
    assert len(pre) == each * closed["robots"] == len(set(pre))
    assert (closed["robots"] - 1, each - 1) in pre
    with pytest.raises(ValueError):
        gen.arrivals(30.0)


def test_open_loop_makes_the_frames_of_its_arrivals(mix):
    gen = traffic.make(mix, 5)
    assert gen.premade(10.0) == [(r, k) for _, r, k in gen.arrivals(10.0)]
