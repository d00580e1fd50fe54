"""The port's parallel training over process groups: 2 or 4 processes on
the CPU with torch.distributed's gloo backend (workers in
tests/torch_dist_workers.py, each spawn by parallel.spawn_ranks with a
timeout, ports from the OS).

* ring attention over an sp group and the pipeline over a pipe group equal
  the one-process transports on the same numbers (atol 1e-6);
* two sharded train steps of spatialvla_tiny(use_vision_zoe=True) on
  (data=2), (fsdp=2), (sp=2, "ring"), (pipe=2, "pipeline") and (data=2,
  sp=2, "ring"; 4 ranks) against JAX's unsharded XLA step on the same
  weights and batches: loss, metrics and grad_norm rtol 1e-4, parameters
  atol 1e-6 after the two steps (test_torch_train.py's step tolerances,
  with its eps = 1e-3);
* a checkpoint written under fsdp=2 restores bit-identical in one process;
* the pretrain CLI on two processes (fsdp=2 by the default --mesh_fsdp -1)
  over the RLDS fixture: both ranks log the same losses, on different rows.
"""
import json
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvla_tpu.action import SpatialActionTokenizer
from spatialvla_tpu.config import spatialvla_tiny
from spatialvla_tpu.models import spatialvla as jsv
from spatialvla_tpu.train import optimizer as jopt
from spatialvla_tpu.train import train_step as jts
from spatialvla_tpu.train.metrics import build_decode_luts as j_luts
from spatialvla_tpu.utils.tree import path_str
from spatialvla_tpu_torch.convert import from_numpy_tree
from spatialvla_tpu_torch.parallel import spawn_ranks
from spatialvla_tpu_torch.train import (OptimizerConfig, init_train_state, make_optimizer,
                                        trainable_mask)
from spatialvla_tpu_torch.train.checkpoints import CheckpointManager
from spatialvla_tpu_torch.utils.tree import iter_leaves
from tests import torch_dist_workers as workers
from tests.fixtures import make_bridge_like_dataset

CFG = spatialvla_tiny(use_vision_zoe=True)
OCFG = dict(learning_rate=1e-3, total_steps=10, schedule="constant", eps=1e-3)


def _read(out_dir, world):
    return [pickle.load(open(os.path.join(out_dir, f"rank{r}.pkl"), "rb")) for r in range(world)]


TRANSPORTS = [((1, 1, 1, 2, 1), 2), ((1, 1, 1, 1, 2), 2), ((2, 1, 1, 2, 1), 4)]


@pytest.mark.parametrize("shape, world", TRANSPORTS, ids=["sp2", "pipe2", "data2-sp2"])
def test_process_group_transports_match_one_process(shape, world, tmp_path):
    spawn_ranks(workers.transports, world, shape, str(tmp_path))
    for r in _read(tmp_path, world):
        for key, diffs in r.items():
            assert max(diffs) <= 1e-6, (key, diffs)
        assert r, "no transport ran"


# ---------------------------------------------------------------------------
# sharded train steps against JAX's unsharded step
# ---------------------------------------------------------------------------

def make_batch(seed, B=4, n_text=5, n_action=7):
    """Image tokens + text + action suffix (T = 28, a multiple of sp); row 1
    right-padded by 2."""
    rng = np.random.RandomState(seed)
    N, begin = CFG.num_image_tokens, CFG.action_token_begin_idx
    ids = np.concatenate([np.full((B, N), CFG.image_token_index), rng.randint(3, 250, (B, n_text)),
                          rng.randint(begin, begin + CFG.spatial_token_num, (B, n_action))],
                         axis=1).astype(np.int32)
    T = ids.shape[1]
    am, tt = np.ones((B, T), np.int32), np.zeros((B, T), np.int32)
    tt[:, N + n_text:] = 1
    am[1, -2:], tt[1, -2:], ids[1, -2:] = 0, 0, 0
    size = CFG.vision.image_size
    return {"input_ids": ids, "attention_mask": am, "token_type_ids": tt,
            "labels": np.where(tt == 0, -100, ids).astype(np.int32),
            "pixel_values": rng.rand(B, size, size, 3).astype(np.float32),
            "intrinsic": np.array([[60.0, 0, 28], [0, 55.0, 27], [0, 0, 1]],
                                  np.float32)[None].repeat(B, 0)}


@pytest.fixture(scope="module")
def reference():
    """The weights, two batches, and JAX's unsharded XLA steps on them."""
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: jsv.init_params(key, CFG))(jax.random.PRNGKey(0)))
    batches = [make_batch(0), make_batch(1)]
    luts = {k: jnp.asarray(v) for k, v in j_luts(SpatialActionTokenizer(
        token_begin_idx=CFG.action_token_begin_idx)).items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**OCFG), jparams,
                             jopt.trainable_mask(jparams))
    step = jax.jit(jts.make_train_step(CFG, tx, jts.TrainStepConfig(
        use_remat=False, compute_dtype=jnp.float32, attn_backend="xla"), luts=luts))
    state = jts.init_train_state(jparams, tx)
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    flat = {path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(state["params"])}
    return params, batches, metrics, flat


_RUNS = {}


def _run(name, reference, tmp_path_factory):
    """One spawn of a mesh's sharded steps (cached: the checkpoint test reads
    the fsdp run's files)."""
    shape, world, backend = STEP_MESHES[name]
    if name not in _RUNS:
        out = tmp_path_factory.mktemp(name)
        inputs = os.path.join(out, "inputs.pkl")
        with open(inputs, "wb") as f:
            pickle.dump((reference[0], reference[1], OCFG), f)
        spawn_ranks(workers.train_steps, world, shape, backend, inputs, str(out))
        _RUNS[name] = (out, _read(out, world))
    return _RUNS[name]


STEP_MESHES = {  # name: (data, fsdp, model, sp, pipe), processes, backend
    "data2": ((2, 1, 1, 1, 1), 2, "flash"),
    "fsdp2": ((1, 2, 1, 1, 1), 2, "flash"),
    "sp2": ((1, 1, 1, 2, 1), 2, "ring"),
    "pipe2": ((1, 1, 1, 1, 2), 2, "pipeline"),
    "data2-sp2": ((2, 1, 1, 2, 1), 4, "ring"),
}


@pytest.mark.parametrize("name", list(STEP_MESHES))
def test_sharded_train_step_matches_jax_unsharded(name, reference, tmp_path_factory):
    _, _, want_metrics, want_params = reference
    _, ranks = _run(name, reference, tmp_path_factory)
    for r in ranks:  # every rank reports the same metrics
        assert r["metrics"] == ranks[0]["metrics"]
    for got, want in zip(ranks[0]["metrics"], want_metrics):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7, err_msg=k)
    got_params = ranks[0]["params"]
    assert set(got_params) == set(want_params)
    worst = max(float(np.abs(got_params[p] - want_params[p]).max()) for p in want_params)
    assert worst < 1e-6, worst
    # form_global_batch's DTensor of a rank's rows spans the global batch
    assert ranks[0]["global_rows"][0] == 4


def test_fsdp_checkpoint_restores_bit_identical_in_one_process(reference, tmp_path_factory):
    """Written under fsdp=2 (each rank holding half of every cut leaf),
    restored into an unsharded state in this process, bit for bit."""
    out, ranks = _run("fsdp2", reference, tmp_path_factory)
    params = from_numpy_tree(reference[0])
    full = sum(t.numel() for _, t in iter_leaves(params))
    assert all(r["shard_numel"] < 0.6 * full for r in ranks)
    tx = make_optimizer(OptimizerConfig(**OCFG), params, trainable_mask(params))
    state = CheckpointManager(os.path.join(out, "ckpt")).restore(init_train_state(params, tx))
    assert state["step"] == 2 and state["opt_state"]["count"] == 2
    got = {p: t for p, t in iter_leaves(state) if torch.is_tensor(t)}
    want = ranks[0]["state"]
    assert set(got) == set(want)
    for p in want:
        assert torch.equal(got[p].detach(), want[p]), p


# ---------------------------------------------------------------------------
# the pretrain CLI on two processes
# ---------------------------------------------------------------------------

def test_pretrain_cli_on_two_processes(tmp_path):
    data_dir, _ = make_bridge_like_dataset(str(tmp_path / "data"))
    out = str(tmp_path / "pretrain")
    argv = ["--data_root_dir", data_dir, "--mixture", "bridge", "--output_dir", out,
            "--model_preset", "spatialvla_tiny", "--image_size", "56", "--seq_len", "80",
            "--max_steps", "2", "--per_device_batch_size", "2", "--shuffle_buffer_size", "4",
            "--logging_steps", "1", "--learning_rate", "1e-3", "--device", "cpu"]
    spawn_ranks(workers.pretrain_cli, 2, argv, str(tmp_path))
    ranks = _read(tmp_path, 2)
    assert [r["step"] for r in ranks] == [2, 2]
    logged = [[{k: v for k, v in m.items() if k != "steps_per_sec"} for m in r["metrics"]]
              for r in ranks]  # the host's step rate is each rank's own
    assert len(logged[0]) == 2 and logged[0] == logged[1]
    assert all(np.isfinite(m["loss"]) for m in ranks[0]["metrics"])
    assert all(a != b for a, b in zip(ranks[0]["digests"], ranks[1]["digests"]))
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2]  # process 0 alone writes the log
    assert os.path.exists(os.path.join(out, "params.safetensors"))
    assert CheckpointManager(os.path.join(out, "checkpoints")).all_steps() == [2]

