"""The port's serving engines (spatialvla_tpu_torch/serve) and their front
ends on the CPU, on spatialvla_tiny(use_vision_zoe=True) with the window
widened to 512, seeded weights (test_torch_serving.seeded_params) through
the bridge, quantize(bits=8) in bf16:

* assemble_batch identical to the JAX package's on the same requests;
* ServingEngine: its results equal predict_batch's on the same batch
  exactly (one batch, no padding beyond the processor's); per-request
  unnorm_key; mixed observation shapes split batches; threaded submit and
  shutdown; load shedding (EngineOverloaded) and deadlines (RequestExpired)
  for both engines;
* SplitServingEngine (bf16 and int8 cache): the first token equal to the
  monolithic engine's, then equal up to the first step whose
  policy.predict margin is below 0.5 (it decodes at n_slots rows, the
  monolithic engine at its batch's); exact scheduling invariance (requests
  one at a time, all at once, and admitted while others decode give
  identical ids); a retired slot readmitted at once while the completion
  thread is slow (its output buffer is rewritten in place); its refusals;
  the uint8 pixel transport exact over all 256 values;
* scripts/serve_torch.py's HTTP handler over both engines on a local port,
  scripts/bench_serve_torch.py --tiny --device cpu in this process.

Every wait has a timeout and every engine is shut down, so a hang fails its
test."""
import base64
import importlib.util
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from spatialvla_tpu.serve.engine import _Request as JaxRequest
from spatialvla_tpu.serve.engine import assemble_batch as jax_assemble_batch
from spatialvla_tpu_torch import SpatialVLAPolicy
from spatialvla_tpu_torch.convert import from_numpy_tree
from spatialvla_tpu_torch.inference import default_processor
from spatialvla_tpu_torch.serve import (EngineOverloaded, RequestExpired, ServingEngine,
                                        SplitServingEngine, assemble_batch)
from spatialvla_tpu_torch.serve import engine as engine_mod
from spatialvla_tpu_torch.serve import split_engine as split_mod
from tests.test_torch_serving import CFG_WIDE, seeded_params
from tests.test_torch_spatialvla import assert_margin_rule

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 120  # seconds: a request that takes longer fails its test
INSTRS = ["go", "pick up the green cup", "push the bowl to the left side", "close the drawer",
          "stack the red block on the blue block"]


@pytest.fixture(scope="module")
def weights():
    return seeded_params(CFG_WIDE)


@pytest.fixture(scope="module")
def policy(weights):
    return SpatialVLAPolicy(from_numpy_tree(weights, dtype=torch.bfloat16), CFG_WIDE,
                            default_processor(CFG_WIDE), device="cpu").quantize(bits=8)


def _frames(n, seed):
    rng = np.random.RandomState(seed)
    s = CFG_WIDE.vision.image_size
    return [(rng.rand(s, s, 3) * 255).astype(np.uint8) for _ in range(n)]


def _split(policy, **kw):
    """A small split engine: every pool prompt (at most 55 tokens) in one
    64-token bucket, 3 slots, prefills of 2 rows, 2 steps a dispatch."""
    for k, v in dict(n_slots=3, max_prompt_len=64, prompt_pad_multiple=64,
                     prefill_buckets=(2,), decode_block=2).items():
        kw.setdefault(k, v)
    return SplitServingEngine(policy, **kw)


def _run(engine, requests, mode="concurrent"):
    """Each (image, instruction) through the engine: one after another
    ("serial"), all submitted at once ("concurrent"), or two first and the
    rest once the engine has run a decode dispatch ("staggered")."""
    if mode == "serial":
        return [engine.submit(img, t).result(timeout=WAIT) for img, t in requests]
    first = 2 if mode == "staggered" else len(requests)
    futs = [engine.submit(img, t) for img, t in requests[:first]]
    if mode == "staggered":
        t0 = time.monotonic()
        while engine.stats()["decode_dispatches"] < 1:
            assert time.monotonic() - t0 < WAIT, "no decode dispatch"
            time.sleep(0.002)
        futs += [engine.submit(img, t) for img, t in requests[first:]]
    return [f.result(timeout=WAIT) for f in futs]


# ---------------------------------------------------------------------------
# batch assembly and the monolithic engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad, buckets", [(16, (1, 2, 4, 8)), (1, (3,)), (64, (1, 2, 4))])
def test_assemble_batch_matches_jax(policy, pad, buckets):
    port, jax_ = [], []
    for img, instr in zip(_frames(3, 3), INSTRS):
        inputs = policy.processor(img, instr)
        kw = dict(ids=np.asarray(inputs["input_ids"]),
                  pixel_values=np.asarray(inputs["pixel_values"]),
                  intrinsic=np.asarray(inputs["intrinsic"]), unnorm_key=None)
        port.append(engine_mod._Request(**kw))
        jax_.append(JaxRequest(**kw))
    pad_id = policy.processor.text_tokenizer.pad_id
    got = assemble_batch(port, pad_id=pad_id, prompt_pad_multiple=pad, batch_buckets=buckets)
    want = jax_assemble_batch(jax_, pad_id=pad_id, prompt_pad_multiple=pad,
                              batch_buckets=buckets)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_monolithic_engine_equals_predict_batch(policy):
    """With prompts padded as the processor pads them (multiple 1) and a
    bucket of exactly 3 rows, the engine's one batch is predict_batch's."""
    imgs, instrs = _frames(3, 4), INSTRS[:3]
    with ServingEngine(policy, max_batch_size=3, max_wait_ms=500.0, prompt_pad_multiple=1,
                       batch_buckets=(1, 2, 3)) as engine:
        results = _run(engine, list(zip(imgs, instrs)))
        stats = engine.stats()
    want = policy.predict_batch(imgs, instrs)
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r["action_ids"], want["action_ids"][i])
        np.testing.assert_array_equal(r["actions"], want["actions"][i])
    assert stats["batches"] == 1 and stats["requests"] == 3
    assert stats["mean_batch_occupancy"] == 3.0 and stats["pad_fraction"] == 0.0


def test_monolithic_per_request_unnorm_keys(policy):
    """Requests against different datasets share a batch; each is
    unnormalized with its own statistics."""
    stats = policy.processor.statistics
    base = stats["random_init"]["action"]
    stats["scaled/1.0.0"] = {"action": dict(base, q01=[-10.0] * 7, q99=[10.0] * 7)}
    try:
        img = _frames(1, 7)[0]
        with ServingEngine(policy, max_batch_size=2, max_wait_ms=500.0) as engine:
            f1 = engine.submit(img, "lift", unnorm_key="random_init")
            f2 = engine.submit(img, "lift", unnorm_key="scaled/1.0.0")
            r1, r2 = f1.result(timeout=WAIT), f2.result(timeout=WAIT)
            assert engine.stats()["batches"] == 1
            with pytest.raises(KeyError, match="unknown unnorm_key"):
                engine.submit(img, "lift", unnorm_key="no/such/key")
    finally:
        stats.pop("scaled/1.0.0")
    np.testing.assert_array_equal(r1["action_ids"], r2["action_ids"])
    assert not np.allclose(r1["actions"], r2["actions"])


def test_monolithic_mixed_observation_shapes_split_batches(policy):
    img, img2 = _frames(2, 17)
    with ServingEngine(policy, max_batch_size=4, max_wait_ms=300.0) as engine:
        f1 = engine.submit(img, "single view")
        f2 = engine.submit([img, img2], "two views")
        r1, r2 = f1.result(timeout=WAIT), f2.result(timeout=WAIT)
        stats = engine.stats()
    for r in (r1, r2):
        assert r["actions"].shape == (4, 7) and np.isfinite(r["actions"]).all()
    assert stats["batches"] == 2 and stats["requests"] == 2


def test_monolithic_threaded_submit_and_shutdown(policy):
    """Concurrent client threads all get results; shutdown drains; submit
    after shutdown fails loudly."""
    images = _frames(5, 11)
    engine = ServingEngine(policy, max_batch_size=4, max_wait_ms=20.0)
    results, errors = {}, []
    try:
        def client(i):
            try:
                results[i] = engine.submit(images[i], f"task {i}").result(timeout=WAIT)
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads) and not errors
    finally:
        engine.shutdown()
    assert sorted(results) == list(range(5))
    for r in results.values():
        assert r["actions"].shape == (4, 7) and np.isfinite(r["actions"]).all()
    assert engine.stats()["requests"] == 5
    with pytest.raises(RuntimeError, match="shut down"):
        engine.submit(images[0], "late")


@pytest.mark.parametrize("kind", ["monolithic", "split"])
def test_engines_shed_load_and_expire_requests(policy, kind):
    make = ((lambda **kw: ServingEngine(policy, **kw)) if kind == "monolithic"
            else (lambda **kw: _split(policy, **kw)))
    img = _frames(1, 13)[0]
    with make(max_queue=0) as engine:
        with pytest.raises(EngineOverloaded):
            engine.submit(img, "go")
        assert engine.stats()["shed"] == 1
    with make() as engine:
        fut = engine.submit(img, "go", deadline_ms=0.0)
        with pytest.raises(RequestExpired):
            fut.result(timeout=WAIT)
        assert engine.stats()["expired"] == 1


# ---------------------------------------------------------------------------
# the split-phase engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [None, 8], ids=["bf16kv", "kv8"])
def test_split_engine_follows_the_monolithic_engine(policy, kv_bits):
    requests = list(zip(_frames(3, 5), INSTRS[:3]))
    with ServingEngine(policy, max_batch_size=1) as engine:
        mono = _run(engine, requests, "serial")
    with _split(policy, kv_bits=kv_bits) as engine:
        split = _run(engine, requests)
        stats = engine.stats()
    for (img, instr), m, s in zip(requests, mono, split):
        ref = policy.predict(img, instr, return_margins=True)
        assert s["action_ids"][0] == m["action_ids"][0]
        assert_margin_rule(s["action_ids"][None], m["action_ids"][None], ref["margins"][None])
        assert s["actions"].shape == (4, 7) and np.isfinite(s["actions"]).all()
    assert stats["requests"] == 3 and stats["decode_dispatches"] > 0


@pytest.fixture(scope="module")
def serial_results(policy):
    requests = list(zip(_frames(len(INSTRS), 9), INSTRS))
    with _split(policy) as engine:
        return requests, _run(engine, requests, "serial")


@pytest.mark.parametrize("mode", ["concurrent", "staggered"])
def test_split_engine_scheduling_invariance(policy, serial_results, mode):
    """Every program shape is pinned (prefills of 2 rows in one prompt
    bucket, decode over all 3 slots), so which requests share a dispatch,
    when they arrive and which slot they take must not change their ids."""
    requests, serial = serial_results
    with _split(policy) as engine:
        got = _run(engine, requests, mode)
        stats = engine.stats()
    for a, b in zip(serial, got):
        np.testing.assert_array_equal(a["action_ids"], b["action_ids"])
        np.testing.assert_array_equal(a["actions"], b["actions"])
    assert stats["requests"] == len(requests)
    assert stats["mean_slot_occupancy"] > 1.0  # rows did share dispatches


class _SlowCopy(split_mod._HostCopy):
    """The completion thread's wait, delayed: a retired slot's row is
    rewritten by the next admission before the completer reads it."""

    def numpy(self):
        time.sleep(0.2)
        return super().numpy()


def test_split_engine_immediate_readmission(policy, serial_results, monkeypatch):
    """One slot: the second request is admitted into the first's slot on
    the loop iteration after it retires. Its ids must still be its own,
    read from the copy taken right after the retiring dispatch."""
    requests, _ = serial_results
    with _split(policy, n_slots=1, prefill_buckets=(1,), decode_block=4) as engine:
        alone = _run(engine, requests[:2], "serial")
        monkeypatch.setattr(split_mod, "_HostCopy", _SlowCopy)
        both = _run(engine, requests[:2])
        stats = engine.stats()
    for a, b in zip(alone, both):
        np.testing.assert_array_equal(a["action_ids"], b["action_ids"])
    assert stats["requests"] == 4 and not np.array_equal(alone[0]["action_ids"],
                                                         alone[1]["action_ids"])


@pytest.mark.parametrize("case", ["bf16 tree", "kv_bits=4", "n_slots=17", "pad multiple",
                                  "overlong prompt"])
def test_split_engine_refusals(policy, weights, case):
    if case == "bf16 tree":
        bf16 = SpatialVLAPolicy(from_numpy_tree(weights, dtype=torch.bfloat16), CFG_WIDE,
                                default_processor(CFG_WIDE), device="cpu")
        with pytest.raises(ValueError, match="fused-quantized"):
            SplitServingEngine(bf16)
    elif case == "kv_bits=4":
        with pytest.raises(ValueError, match="kv_bits=4"):
            _split(policy, kv_bits=4)
    elif case == "n_slots=17":
        with pytest.raises(ValueError, match="n_slots"):
            _split(policy, n_slots=17)
    elif case == "pad multiple":
        with pytest.raises(ValueError, match="multiple"):
            _split(policy, max_prompt_len=100)
    else:
        with _split(policy) as engine:
            with pytest.raises(ValueError, match="max_prompt_len"):
                engine.submit(_frames(1, 1)[0], "a very long instruction " * 3)


def test_u8_pixel_transport_is_exact(policy, monkeypatch):
    """Pixels on the u8/255 grid travel as uint8 and the prefill divides
    by 255 on the device: the host's f32 pixels exactly, over all 256
    values; pixels off the grid travel as f32."""
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, -1)
    px = u8.astype(np.float32) / 255.0
    for given in (None, u8):
        dev = split_mod._put_pixels(px, given, device="cpu")
        assert dev.dtype == torch.uint8
        np.testing.assert_array_equal(dev.numpy(), u8)
    off = px + np.float32(1e-3)
    dev = split_mod._put_pixels(off, device="cpu")
    assert dev.dtype == torch.float32
    np.testing.assert_array_equal(dev.numpy(), off)
    seen = {}

    def record(*args, pixel_values, **kw):
        seen["px"] = pixel_values

    programs = split_mod._Programs(policy, n_slots=1, cache_len=76, n_tokens=12,
                                   decode_block=1, kv_bits=None)
    monkeypatch.setattr(programs.model, "prefill_for_serving", record)
    programs.prefill(np.zeros((1, 4), np.int32), split_mod._put_pixels(px, device="cpu"),
                     np.eye(3, dtype=np.float32)[None], np.ones((1, 4), np.int32))
    assert seen["px"].dtype == torch.float32
    np.testing.assert_array_equal(seen["px"].numpy(), px)


# ---------------------------------------------------------------------------
# the front ends
# ---------------------------------------------------------------------------

def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                     f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kind", ["monolithic", "split"])
def test_serve_torch_http_front_end(policy, kind, monkeypatch):
    """scripts/serve_torch.py's handler over a live local socket: concurrent
    POST /predict with nested-list images, /health and /stats; a request
    without an image is a 500 and a base64 image without PIL a 400 that
    says so, and the server keeps serving."""
    serve = _script("serve_torch")
    engine = (ServingEngine(policy, max_batch_size=2, max_wait_ms=100.0) if kind == "monolithic"
              else _split(policy))
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(engine))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]

    def post(payload):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=WAIT) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=WAIT) as r:
            return json.loads(r.read())

    try:
        images = _frames(2, 21)
        results = {}
        clients = [threading.Thread(target=lambda i=i: results.__setitem__(i, post(
            {"image": images[i].tolist(), "instruction": INSTRS[i]}))) for i in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=WAIT)
        assert sorted(results) == [0, 1]
        for code, body in results.values():
            assert code == 200, body
            assert np.asarray(body["actions"]).shape == (4, 7) and body["latency_ms"] > 0
        assert get("/health") == {"ok": True}
        assert get("/stats")["requests"] == 2
        code, body = post({"instruction": "no image"})
        assert code == 500 and "error" in body
        monkeypatch.setitem(sys.modules, "PIL", None)  # as on the card's machine
        code, body = post({"image": base64.b64encode(b"not a png").decode(),
                           "instruction": "go"})
        assert code == 400 and "PIL" in body["error"]
        code, body = post({"image": images[0].tolist(), "instruction": "after the errors"})
        assert code == 200
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()


@pytest.mark.parametrize("kind", ["monolithic", "split"])
def test_bench_serve_torch_tiny_on_the_cpu(kind):
    bench = _script("bench_serve_torch")
    args = ["--tiny", "--device", "cpu", "--clients", "2", "--requests", "2", "--max_batch",
            "2", "--n_slots", "2"] + (["--split", "--trace"] if kind == "split" else [])
    result = bench.main(args)
    assert result["requests"] == 4 and result["device"] == "cpu" and result["card"] is None
    assert result["actions_per_sec"] > 0
    assert result["latency_ms_p50"] <= result["latency_ms_p95"]
    keys = (("mean_prefill_rows", "mean_slot_occupancy", "dispatch_thread_s")
            if kind == "split" else ("mean_batch_occupancy", "pad_fraction"))
    assert all(k in result for k in keys)
    if kind == "split":
        assert sorted(result["dispatch_thread_s"]) == ["admit", "ahead", "collect", "decode",
                                                       "prefill"]
        # no card: the trace holds no kernel, so the card's numbers stay None
        assert result["trace"]["kernels"] == 0 and result["trace"]["device_busy_ms"] is None
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="is_available"):
            bench.main(["--tiny", "--clients", "1", "--requests", "1"])
