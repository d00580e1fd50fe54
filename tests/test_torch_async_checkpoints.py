"""The port's CheckpointManager writes in the background, in Orbax's form
(``enable_async_checkpointing``): ``save`` copies the state to host memory
and returns, a writer thread writes the step, renames it into place, writes
the sidecars and applies retention; one write is in flight; a step in
flight counts as saved; a writer's error comes back at the next ``save``,
``wait`` or ``close``; a half-written step stays invisible; resume through
``train_loop`` is bit-identical to an uninterrupted run. On the CPU, at
spatialvla_tiny."""
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from spatialvla_tpu.train.checkpoints import CheckpointManager as JaxManager
from spatialvla_tpu_torch.config import spatialvla_tiny
from spatialvla_tpu_torch.models import spatialvla as tsv
from spatialvla_tpu_torch.train import checkpoints as tck
from spatialvla_tpu_torch.train import optimizer as topt
from spatialvla_tpu_torch.train import train_step as tts
from spatialvla_tpu_torch.train.trainer import TrainerConfig, train_loop
from spatialvla_tpu_torch.utils.tree import iter_leaves

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = spatialvla_tiny(use_vision_zoe=False)
TIMEOUT = 60


@pytest.fixture
def gate(monkeypatch):
    """The writer's save_file held until ``gate.set()``; ``gate.entered``
    is set once the writer reaches it."""
    real = tck.save_file
    gate = threading.Event()
    gate.entered = threading.Event()

    def held(tensors, path, metadata=None):
        gate.entered.set()
        assert gate.wait(TIMEOUT), "the test never opened the gate"
        return real(tensors, path, metadata)

    monkeypatch.setattr(tck, "save_file", held)
    yield gate
    gate.set()


def state_of(value, step):
    return {"w": torch.full((4, 3), float(value)), "nested": [torch.arange(5) * value],
            "step": step}


def test_save_returns_while_the_writer_is_blocked(tmp_path, gate):
    mgr = tck.CheckpointManager(str(tmp_path / "ck"), save_interval_steps=1, max_to_keep=2)
    state = state_of(1.0, 1)
    assert mgr.save(1, state)  # returns with the writer held at the gate
    assert gate.entered.wait(TIMEOUT) and mgr.writing()
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1  # in flight counts as saved
    assert not (tmp_path / "ck" / "1").exists()
    assert not mgr.save(1, state, force=True)  # already saved (in flight)
    state["w"].fill_(7.0)  # the caller updates in place: the copy is already taken
    done = threading.Event()
    second = threading.Thread(target=lambda: (mgr.save(2, state_of(2.0, 2)), done.set()))
    second.start()
    assert not done.wait(0.3)  # one write in flight: save(2) waits for the write of 1
    gate.set()
    second.join(TIMEOUT)
    assert not second.is_alive() and done.is_set()
    mgr.wait()
    assert mgr.all_steps() == [1, 2] and not mgr.writing()
    restored = mgr.restore(state_of(0.0, 0), step=1)
    assert torch.equal(restored["w"], torch.full((4, 3), 1.0)) and restored["step"] == 1
    assert torch.equal(restored["nested"][0], torch.arange(5) * 1.0)
    assert [w["step"] for w in mgr.writes] == [1, 2]
    assert all(w["blocked_s"] >= 0 and w["write_s"] >= 0 and w["bytes"] > 0 for w in mgr.writes)


def test_host_buffers_are_reused(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path / "ck"), save_interval_steps=1)
    mgr.save(1, state_of(1.0, 1))
    first = {path: t.data_ptr() for path, t in mgr._host.items()}
    mgr.save(2, state_of(2.0, 2))  # waits for step 1's write, then copies into the same buffers
    assert {path: t.data_ptr() for path, t in mgr._host.items()} == first
    mgr.close()
    assert torch.equal(mgr.restore(state_of(0.0, 0), step=1)["w"], torch.full((4, 3), 1.0))
    assert torch.equal(mgr.restore(state_of(0.0, 0))["w"], torch.full((4, 3), 2.0))


def test_decisions_retention_and_sidecars_match_orbax_without_waiting(tmp_path):
    """The same save calls on the port's manager (no wait between them) and
    the JAX package's Orbax manager (waited for): the same answers and kept
    steps after every call, the same sidecars once both are done."""
    port = tck.CheckpointManager(str(tmp_path / "port"), save_interval_steps=2, max_to_keep=2)
    ref = JaxManager(str(tmp_path / "jax"), save_interval_steps=2, max_to_keep=2)
    calls = [(1, False), (2, False), (3, False), (4, False), (5, True), (5, True), (6, False),
             (7, False), (8, False), (10, False), (10, True)]
    for step, force in calls:
        a = port.save(step, {"x": torch.full((2,), float(step)), "step": step},
                      sidecar={"step": step}, force=force)
        b = ref.save(step, {"x": jnp.full((2,), float(step)), "step": jnp.int32(step)},
                     sidecar={"step": step}, force=force)
        ref.wait()
        assert a == bool(b), (step, force)
        assert port.all_steps() == sorted(ref._mgr.all_steps()), step
        assert port.latest_step() == ref.latest_step(), step
    port.close()
    ref.close()
    assert port.all_steps() == [8, 10] and sorted(os.listdir(tmp_path / "port")) == [
        "10", "8", "artifacts-10.json", "artifacts-8.json", "artifacts.json"]
    for name in ("port", "jax"):
        assert sorted(f for f in os.listdir(tmp_path / name) if f.startswith("artifacts")) == \
            ["artifacts-10.json", "artifacts-8.json", "artifacts.json"]
    assert port.load_sidecar(8) == ref.load_sidecar(8) == {"step": 8}
    assert port.load_sidecar() == ref.load_sidecar() == {"step": 10}


@pytest.mark.parametrize("where", ["wait", "save", "close"])
def test_a_writer_error_is_raised_at_the_next_call(tmp_path, monkeypatch, where):
    d = tmp_path / "ck"
    mgr = tck.CheckpointManager(str(d), save_interval_steps=1)
    mgr.save(2, state_of(2.0, 2))
    mgr.wait()

    def crash(tensors, path, metadata=None):  # dies after a partial write
        with open(path, "wb") as f:
            f.write(b"\x10\x00")
        raise OSError("disk gone")

    monkeypatch.setattr(tck, "save_file", crash)
    assert mgr.save(4, state_of(4.0, 4))  # returns: the error is the writer's
    with pytest.raises(OSError, match="disk gone"):
        if where == "save":
            mgr.save(6, state_of(6.0, 6), force=True)
        else:
            getattr(mgr, where)()
    monkeypatch.undo()
    mgr.wait()  # raised once
    assert mgr.all_steps() == [2] and sorted(os.listdir(d)) == ["2"]  # no half-written step
    assert mgr.save(8, state_of(8.0, 8))  # the manager goes on
    mgr.close()
    assert mgr.all_steps() == [2, 8]


_KILLED = r"""
import os, sys, time
import torch
from spatialvla_tpu_torch.train import checkpoints as tck
def stuck(tensors, path, metadata=None):  # half the file, then never done
    with open(path, "wb") as f:
        f.write(b"\x10\x00\x00\x00")
        f.flush()
    print("writing", flush=True)
    time.sleep(600)
tck.save_file = stuck
mgr = tck.CheckpointManager(sys.argv[1], save_interval_steps=1)
mgr.save(4, {"w": torch.ones(3), "step": 4})
time.sleep(600)
"""


def test_a_killed_write_leaves_no_visible_step(tmp_path):
    """A process killed in the middle of a background write: the step is
    not seen, and the next manager of the directory removes the leftover."""
    d = tmp_path / "ck"
    mgr = tck.CheckpointManager(str(d), save_interval_steps=1)
    mgr.save(2, state_of(2.0, 2))
    mgr.close()
    proc = subprocess.Popen([sys.executable, "-c", _KILLED, str(d)], cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
                            text=True)
    try:
        assert proc.stdout.readline().strip() == "writing"
        assert any(".tmp-" in n for n in os.listdir(d))
    finally:
        proc.kill()
        proc.wait(TIMEOUT)
    assert sorted(n for n in os.listdir(d) if ".tmp-" not in n) == ["2"]
    again = tck.CheckpointManager(str(d))
    assert again.all_steps() == [2] and sorted(os.listdir(d)) == ["2"]
    assert again.restore(state_of(0.0, 0))["step"] == 2


def _tiny_batch(seed=0, B=2):
    rng = np.random.RandomState(seed)
    N, begin = CFG.num_image_tokens, CFG.action_token_begin_idx
    ids = np.concatenate([np.full((B, N), CFG.image_token_index), rng.randint(3, 250, (B, 4)),
                          rng.randint(begin, begin + CFG.spatial_token_num, (B, 6))], axis=1)
    tt = np.zeros(ids.shape, np.int32)
    tt[:, N + 4:] = 1
    size = CFG.vision.image_size
    return {"input_ids": ids, "attention_mask": np.ones(ids.shape, np.int32),
            "token_type_ids": tt, "labels": np.where(tt == 0, -100, ids),
            "pixel_values": rng.rand(B, size, size, 3).astype(np.float32),
            "intrinsic": np.array([[60.0, 0, 28], [0, 55.0, 27], [0, 0, 1]],
                                  np.float32)[None].repeat(B, 0)}


def test_resume_through_train_loop_is_bit_identical(tmp_path, monkeypatch):
    """Five steps with a background save every 2 (each write slowed, so the
    next steps run during it); a fresh state resumed from step 4 ends
    bit-identical to the uninterrupted run."""
    real = tck.save_file

    def slow(tensors, path, metadata=None):
        time.sleep(0.2)
        return real(tensors, path, metadata)

    monkeypatch.setattr(tck, "save_file", slow)
    ocfg = topt.OptimizerConfig(learning_rate=1e-3, total_steps=10, schedule="constant")
    scfg = tts.TrainStepConfig(use_remat=False, compute_dtype=torch.float32)
    batches = [_tiny_batch(i) for i in range(5)]

    def setup():
        params = tsv.init_params(CFG, generator=torch.Generator().manual_seed(0), device="cpu",
                                 dtype=torch.float32)
        tx = topt.make_optimizer(ocfg, params, None)
        return tts.init_train_state(params, tx), tts.make_train_step(CFG, tx, scfg)

    def config(out, steps):
        return TrainerConfig(output_dir=str(out), max_steps=steps, log_every=1, save_every=2,
                             tensorboard=False)

    state, step = setup()
    during = []

    def watched(state, batch):
        during.append(mgr.writing())
        return step(state, batch)

    mgr = tck.CheckpointManager(str(tmp_path / "ck"), save_interval_steps=2, max_to_keep=5)
    straight = train_loop(state=state, train_step=watched, batches=iter(batches),
                          config=config(tmp_path / "a", 5), checkpoint_manager=mgr)
    assert mgr.all_steps() == [2, 4, 5] and any(during)
    fresh, step2 = setup()
    # the latest is 5: resume from 4 in a copy of the directory without 5
    shutil.copytree(tmp_path / "ck", tmp_path / "ck4", ignore=shutil.ignore_patterns("5"))
    resumer = tck.CheckpointManager(str(tmp_path / "ck4"), save_interval_steps=2, max_to_keep=5)
    resumed = train_loop(state=fresh, train_step=step2, batches=iter(batches[4:]),
                         config=config(tmp_path / "b", 5), checkpoint_manager=resumer)
    assert resumed["step"] == 5
    a, b = dict(iter_leaves(straight)), dict(iter_leaves(resumed))
    assert sorted(a) == sorted(b)
    for path, t in a.items():
        if torch.is_tensor(t):
            assert torch.equal(t.detach(), b[path].detach()), path
        else:
            assert t == b[path], path


def test_another_manager_waits_for_the_write_in_flight(tmp_path, gate):
    mgr = tck.CheckpointManager(str(tmp_path / "ck"), save_interval_steps=1)
    mgr.save(3, state_of(3.0, 3))
    assert gate.entered.wait(TIMEOUT)
    made = []
    other = threading.Thread(target=lambda: made.append(
        tck.CheckpointManager(str(tmp_path / "ck"))))
    other.start()
    other.join(0.3)
    assert other.is_alive()  # it would remove the write's temporary directory
    gate.set()
    other.join(TIMEOUT)
    assert not other.is_alive() and made[0].all_steps() == [3]
    assert made[0].restore(state_of(0.0, 0))["step"] == 3


@pytest.mark.parametrize("chunk", [0, 1, 100, 4096])
def test_a_checkpoint_written_in_chunks_is_the_same_file(tmp_path, monkeypatch, chunk):
    """save_file writes WRITE_CHUNK_BYTES a system call (0: a tensor a
    call); the file is the same at every chunk size, and the manager's
    background write reads back bit for bit."""
    from spatialvla_tpu_torch.convert import safetensors_io

    state = {"w": torch.randn(64, 33, generator=torch.Generator().manual_seed(0)),
             "b": torch.arange(7, dtype=torch.int64), "h": torch.ones(5, dtype=torch.bfloat16),
             "empty": torch.zeros(0), "step": 3}
    tck.save_params(str(tmp_path / "whole"), state)
    monkeypatch.setattr(safetensors_io, "WRITE_CHUNK_BYTES", chunk)
    tck.save_params(str(tmp_path / "chunked"), state)
    whole, chunked = (open(tmp_path / d / tck.PARAMS_FILE, "rb").read()
                      for d in ("whole", "chunked"))
    assert whole == chunked
    mgr = tck.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, state)
    mgr.close()
    like = {k: torch.empty_like(v) if torch.is_tensor(v) else v for k, v in state.items()}
    back = mgr.restore(like)
    assert all(torch.equal(back[k], v) for k, v in state.items() if torch.is_tensor(v))
