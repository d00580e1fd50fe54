"""The model axis in training (tensor parallelism: parallel/mesh.py's
autograd collectives, parallel/partitioning.py:TrainShards, the
vocabulary-parallel cross-entropy of train/loss.py, the sharded full and
LoRA steps) against the JAX package's unsharded functions on the CPU, on
spatialvla_tiny(use_vision_zoe=True) with numpy-seeded weights and batches.

Its vocabulary (9218 ids) is cut at n = 2 and whole at n = 4; its 2 kv heads
give one a shard at n = 2 and one duplicated over 2 shards at n = 4.

* ShardSum, ShardCopy and ShardGather, forward and backward, against their
  single-tensor definitions in one process (exact) and over a 2-rank gloo
  model group (atol 1e-6);
* the vocabulary-parallel cross-entropy and argmax at n = 1, 2, 4, chunked
  and not, against JAX's cross_entropy_loss and chunked loss: rtol 1e-5,
  the ids exact (zero rows tie every id: the lowest wins);
* a train state cut over model (n = 2, 4) and joined again, bit for bit;
* two full-parameter and two LoRA steps on LocalMesh(model=2) and (model=4)
  in one process, and on the process-group meshes model2, fsdp2-model2 and
  data2-model2 (tests/torch_dist_workers.py:train_steps), against JAX's
  unsharded XLA steps on the same weights and batches: loss, metrics and
  grad_norm rtol 1e-4, parameters and factors atol 1e-6
  (tests/test_torch_distributed.py's bounds);
* a checkpoint written under fsdp2-model2 restores bit-identical in one
  process;
* the pretrain CLI with --mesh_model 2 in one process and on 2 gloo
  processes (both model ranks draw the same rows), and the fine-tune CLI
  with --use_lora --mesh_model 2 in one process.
"""
import dataclasses
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
from spatialvla_tpu.models import gemma2 as jg
from spatialvla_tpu.models import spatialvla as jsv
from spatialvla_tpu.train import lora as jlora
from spatialvla_tpu.train import optimizer as jopt
from spatialvla_tpu.train import train_step as jts
from spatialvla_tpu.train.loss import chunked_loss_and_metrics as j_chunked
from spatialvla_tpu.train.metrics import build_decode_luts as j_luts
from spatialvla_tpu.utils import tree as jtree
from spatialvla_tpu.utils.tree import path_str
from spatialvla_tpu_torch.convert import from_numpy_tree, to_numpy_tree
from spatialvla_tpu_torch.models import spatialvla as tsv
from spatialvla_tpu_torch.parallel import (LocalMesh, ShardCopy, ShardGather, ShardSum,
                                           TensorShards, TrainShards, join_ranks, spawn_ranks,
                                           start_ranks)
from spatialvla_tpu_torch.parallel.partitioning import ShardGroup
from spatialvla_tpu_torch.train import (OptimizerConfig, TrainStepConfig, init_lora_train_state,
                                        init_train_state, make_lora_train_step, make_optimizer,
                                        make_train_step, shard_lora_train_step, shard_train_step,
                                        trainable_mask)
from spatialvla_tpu_torch.train.checkpoints import CheckpointManager
from spatialvla_tpu_torch.train.loss import position_loss
from spatialvla_tpu_torch.train.metrics import build_decode_luts
from spatialvla_tpu_torch.utils import tree as ttree
from tests import torch_dist_workers as workers
from tests.fixtures import make_bridge_like_dataset
from tests.test_torch_distributed import OCFG, make_batch

torch.set_num_threads(2)

CFG = spatialvla_tiny(use_vision_zoe=True)
LORA_OCFG = dict(learning_rate=1e-3, warmup_ratio=0.2, total_steps=10, eps=1e-3)
ALPHA, RANK, PRESET = 8.0, 4, "linear+emb+h"  # the head's factors cross the vocabulary cut


def _read(out_dir, world):
    return [pickle.load(open(os.path.join(out_dir, f"rank{r}.pkl"), "rb")) for r in range(world)]


# ---------------------------------------------------------------------------
# the autograd collectives
# ---------------------------------------------------------------------------

def test_collectives_in_one_process_match_their_definitions():
    rng = np.random.RandomState(0)
    parts = [torch.from_numpy(rng.randn(3, 5).astype(np.float32)).requires_grad_()
             for _ in range(3)]
    up = torch.from_numpy(rng.randn(3, 5).astype(np.float32))
    y = ShardSum.apply(None, *parts)
    y.backward(up)
    want = parts[0].detach() + parts[1].detach() + parts[2].detach()
    assert torch.equal(y, want) and all(torch.equal(p.grad, up) for p in parts)

    x = parts[0].detach().clone().requires_grad_()
    copies = ShardCopy.apply(None, 3, x)
    ups = [torch.from_numpy(rng.randn(3, 5).astype(np.float32)) for _ in range(3)]
    torch.autograd.backward(copies, ups)
    assert all(torch.equal(c, x) for c in copies)
    assert torch.equal(x.grad, ups[0] + ups[1] + ups[2])

    xs = [p.detach().clone().requires_grad_() for p in parts]
    y = ShardGather.apply(None, -1, *xs)
    wide = torch.from_numpy(rng.randn(3, 15).astype(np.float32))
    y.backward(wide)
    assert torch.equal(y, torch.cat([p.detach() for p in parts], -1))
    assert all(torch.equal(x.grad, wide[:, 5 * i:5 * (i + 1)]) for i, x in enumerate(xs))


# ---------------------------------------------------------------------------
# the vocabulary-parallel cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [0, 5])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_vocab_parallel_cross_entropy_matches_jax(n, chunk):
    """position_loss over an LM head cut into n vocabulary shards (9216 ids:
    cut at n = 4 too) against JAX's cross_entropy_loss (chunk 0) and chunked
    loss; argmax ids exact, rows of zeros tying every id."""
    tcfg = dataclasses.replace(CFG.text, vocab_size=9216)
    rng = np.random.RandomState(3)
    B, T, H, V = 2, 13, tcfg.hidden_size, tcfg.vocab_size
    head = (rng.randn(H, V) * 0.5).astype(np.float32)
    hidden = rng.randn(B, T, H).astype(np.float32)
    hidden[1, 3:6] = 0.0  # every logit 0: the argmax is id 0
    labels = rng.randint(0, V, (B, T)).astype(np.int32)
    labels[0, 4] = -100
    am = np.ones((B, T), np.int32)
    am[1, -2:] = 0
    lm = {"embed": torch.from_numpy(head.T.copy()), "lm_head": torch.from_numpy(head)}
    cut = TensorShards({"lm": lm}, dataclasses.replace(CFG, text=tcfg), n) if n > 1 else None
    group = (ShardGroup(cut, [cut.cut_tree({"lm": lm}, s) for s in range(n)], [None] * n)
             if n > 1 else lm)
    if n > 1:
        assert cut.blocks["vocab"]
    h = torch.from_numpy(hidden).requires_grad_()
    lab = torch.from_numpy(labels).long()
    targets, valid = lab[:, 1:], (lab[:, 1:] != -100) & (torch.from_numpy(am)[:, 1:] != 0)
    nll, preds = position_loss(group, tcfg, h[:, :-1], targets, valid, chunk_size=chunk)
    loss = nll / valid.sum()
    grad, = torch.autograd.grad(loss, h)

    jlm = {"lm_head": jnp.asarray(head)}
    jh = jnp.asarray(hidden)

    def jloss(jh):
        if chunk == 0:
            logits = jg.compute_logits(jlm, tcfg, jh)
            return jsv.cross_entropy_loss(logits, jnp.asarray(labels), jnp.asarray(am)), logits
        out, _ = j_chunked(jlm, tcfg, jh, jnp.asarray(labels), jnp.asarray(am),
                           begin_idx=CFG.action_token_begin_idx, chunk_size=chunk)
        return out, jg.compute_logits(jlm, tcfg, jh)

    (want, logits), jgrad = jax.value_and_grad(jloss, has_aux=True)(jh)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(jgrad)).max()))
    want_ids = np.asarray(jnp.argmax(logits[:, :-1], axis=-1))
    np.testing.assert_array_equal(preds.numpy(), want_ids)
    assert (preds[1, 3:6] == 0).all()


# ---------------------------------------------------------------------------
# the cut of a train state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    """The weights (the port's init from seed 0, as numpy: the JAX tree's
    keys and shapes), two batches, LoRA factors, and JAX's unsharded XLA
    full and LoRA steps on them."""
    params = to_numpy_tree(tsv.init_params(CFG, generator=torch.Generator().manual_seed(0),
                                           device="cpu"))
    batches = [make_batch(0), make_batch(1)]
    luts = {k: jnp.asarray(v) for k, v in j_luts(SpatialActionTokenizer(
        token_begin_idx=CFG.action_token_begin_idx)).items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**OCFG), jparams, jopt.trainable_mask(jparams))
    step = jax.jit(jts.make_train_step(CFG, tx, jts.TrainStepConfig(
        use_remat=False, compute_dtype=jnp.float32, attn_backend="xla"), luts=luts))
    state = jts.init_train_state(jparams, tx)
    metrics = []
    for b in jbatches:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    flat = {path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(state["params"])}

    pats = jlora.TARGET_PRESETS[PRESET]
    factors = jlora.lora_init(jax.random.PRNGKey(1), jparams, target_patterns=pats, rank=RANK)
    rng = np.random.RandomState(5)
    factors = {p: {"a": np.asarray(f["a"]),
                   "b": (rng.randn(*f["b"].shape) * 0.02).astype(np.float32)}
               for p, f in factors.items()}
    ltx = jopt.make_optimizer(jopt.OptimizerConfig(**LORA_OCFG), None, None)
    lstate = jts.init_lora_train_state(jax.random.PRNGKey(1), jparams, ltx, target_patterns=pats,
                                       rank=RANK)
    lstate["trainable"]["lora"] = jax.tree_util.tree_map(jnp.asarray, factors)
    lstate["opt_state"] = ltx.init(lstate["trainable"])
    lstep = jax.jit(jts.make_lora_train_step(CFG, ltx, jts.TrainStepConfig(
        use_remat=False, compute_dtype=jnp.float32, attn_backend="xla"), alpha=ALPHA, rank=RANK,
        luts=luts))
    lmetrics = []
    for b in jbatches:
        lstate, m = lstep(lstate, jparams, b)
        lmetrics.append({k: float(v) for k, v in m.items()})
    lflat = dict(jtree.leaves_with_paths(jax.tree_util.tree_map(np.asarray,
                                                                lstate["trainable"])))
    return dict(params=params, batches=batches, metrics=metrics, flat=flat, factors=factors,
                lora_metrics=lmetrics, lora_flat=lflat)


@pytest.mark.parametrize("n", [2, 4])
def test_train_state_cut_and_joined_is_bit_identical(n, reference):
    params = from_numpy_tree(reference["params"])
    tx = make_optimizer(OptimizerConfig(**OCFG), params, trainable_mask(params))
    state = init_train_state(params, tx)
    gen = torch.Generator().manual_seed(n)
    with torch.no_grad():
        for _, t in ttree.iter_leaves(state["opt_state"]):
            if torch.is_tensor(t):
                t.copy_(torch.randn(t.shape, generator=gen))
    want = {p: t.detach().clone() for p, t in ttree.iter_leaves(state) if torch.is_tensor(t)}
    shards = TrainShards(LocalMesh(model=n), state["params"], CFG)
    cut = shards.cut_state(state)
    q = cut["params"]["lm"]["layers"]["attn"]["q"]
    assert q.shape[0] == n and q.shape[-1] == want["params/lm/layers/attn/q"].shape[-1] // n
    assert shards.stacked("lm/embed") == (n == 2)  # 9218 ids: cut at 2, whole at 4
    if n == 4:  # each kv head on two shards, equal
        k = cut["opt_state"]["mu"]["lm/layers/attn/k"]
        assert torch.equal(k[0], k[1]) and torch.equal(k[2], k[3])
    got = {p: t for p, t in ttree.iter_leaves(shards.gather_state(cut)) if torch.is_tensor(t)}
    assert set(got) == set(want)
    for p in want:
        assert got[p].dtype == want[p].dtype and torch.equal(got[p], want[p]), p


# ---------------------------------------------------------------------------
# the steps against JAX's unsharded steps
# ---------------------------------------------------------------------------

def _assert_metrics(got_metrics, want_metrics):
    for got, want in zip(got_metrics, want_metrics):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7, err_msg=k)


def _assert_params(got, want):
    assert set(got) == set(want)
    worst = max(float(np.abs(got[p] - want[p]).max()) for p in want)
    assert worst < 1e-6, worst


def _assert_lora(got_metrics, got_tree, reference):
    _assert_metrics(got_metrics, reference["lora_metrics"])
    got = dict(ttree.leaves_with_paths(got_tree))
    _assert_params(got, reference["lora_flat"])


def local_mesh_steps(mesh, step_cfg, reference):
    """Two full-parameter and two LoRA steps over ``mesh``, a LocalMesh with
    a model axis, from the reference's weights, factors and batches, held to
    JAX's unsharded steps; returns the full step's state."""
    luts = build_decode_luts(SpatialActionTokenizer(token_begin_idx=CFG.action_token_begin_idx))
    params = from_numpy_tree(reference["params"])
    tx = make_optimizer(OptimizerConfig(**OCFG), params, trainable_mask(params))
    step, state = shard_train_step(make_train_step(CFG, tx, step_cfg, luts=luts, mesh=mesh), mesh,
                                   init_train_state(params, tx))
    metrics = []
    for b in reference["batches"]:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    _assert_metrics(metrics, reference["metrics"])
    full = step.shards.gather_tree(state["params"])
    _assert_params({p: t.numpy() for p, t in ttree.iter_leaves(full)}, reference["flat"])

    base = from_numpy_tree(reference["params"])
    ltx = make_optimizer(OptimizerConfig(**LORA_OCFG), None, None)
    lstate = init_lora_train_state(torch.Generator().manual_seed(1), base, ltx,
                                   target_patterns=jlora.TARGET_PRESETS[PRESET], rank=RANK)
    with torch.no_grad():
        for p, f in reference["factors"].items():
            for k in ("a", "b"):
                lstate["trainable"]["lora"][p][k].copy_(torch.from_numpy(np.array(f[k])))
    lstep = make_lora_train_step(CFG, ltx, step_cfg, alpha=ALPHA, rank=RANK, luts=luts, mesh=mesh)
    lstep, base = shard_lora_train_step(lstep, mesh, base)
    lmetrics = []
    for b in reference["batches"]:
        lstate, m = lstep(lstate, base, b)
        lmetrics.append({k: float(v) for k, v in m.items()})
    _assert_lora(lmetrics, ttree.map_with_paths(lambda _, t: t.detach().numpy(),
                                                lstate["trainable"]), reference)
    assert all(not t.requires_grad for _, t in ttree.iter_leaves(base))
    return state


@pytest.mark.parametrize("n, backend, chunk", [(2, "flash", 7), (4, "flash", 7), (2, "xla", 0),
                                               (4, "xla", 0)])
def test_local_mesh_steps_match_jax_unsharded(n, backend, chunk, reference):
    """Two full-parameter and two LoRA steps over LocalMesh(model=n)."""
    state = local_mesh_steps(LocalMesh(model=n), TrainStepConfig(
        use_remat=True, compute_dtype=torch.float32, attn_backend=backend,
        loss_chunk_size=chunk), reference)
    if n == 4:  # the copies of a kv head stay equal
        k = state["params"]["lm"]["layers"]["attn"]["k"]
        assert torch.equal(k[0], k[1]) and torch.equal(k[2], k[3])


STEP_MESHES = {  # name: (data, fsdp, model, sp, pipe), processes
    "model2": ((1, 1, 2, 1, 1), 2),
    "fsdp2-model2": ((1, 2, 2, 1, 1), 4),
    "data2-model2": ((2, 1, 2, 1, 1), 4),
}
_RUNS = {}


def _run(name, reference, tmp_path_factory):
    """The sharded full and LoRA steps of a mesh (the spawns of every mesh
    start together, at the first call; cached: the checkpoint test reads
    the fsdp2-model2 run's files)."""
    if not _RUNS:
        lora = (reference["factors"], LORA_OCFG, ALPHA, RANK, jlora.TARGET_PRESETS[PRESET])
        for key, (shape, world) in STEP_MESHES.items():
            out = tmp_path_factory.mktemp(key)
            inputs = os.path.join(out, "inputs.pkl")
            with open(inputs, "wb") as f:
                pickle.dump((reference["params"], reference["batches"], OCFG, *lora), f)
            _RUNS[key] = (out, world, start_ranks(workers.train_steps, world, shape, "flash",
                                                  inputs, str(out)))
    out, world, ctx = _RUNS[name]
    if ctx is not None:
        join_ranks(ctx)
        _RUNS[name] = (out, world, None)
    return out, _read(out, world)


@pytest.fixture(scope="module", autouse=True)
def _stop_spawns():
    """Stops the spawns no test joined (a run of a subset of the tests)."""
    yield
    for _, _, ctx in _RUNS.values():
        if ctx is not None:
            for p in ctx.processes:
                p.kill()


@pytest.mark.parametrize("name", list(STEP_MESHES))
def test_process_group_steps_match_jax_unsharded(name, reference, tmp_path_factory):
    _, ranks = _run(name, reference, tmp_path_factory)
    for r in ranks:  # every rank reports the same metrics
        assert r["metrics"] == ranks[0]["metrics"]
        assert r["lora"]["metrics"] == ranks[0]["lora"]["metrics"]
    _assert_metrics(ranks[0]["metrics"], reference["metrics"])
    _assert_params(ranks[0]["params"], reference["flat"])
    for r in ranks:  # the factors are whole on every rank, and agree
        _assert_lora(r["lora"]["metrics"], r["lora"]["trainable"], reference)


def test_process_group_collectives_match_their_definitions(reference, tmp_path_factory):
    _, ranks = _run("model2", reference, tmp_path_factory)
    for r in ranks:
        for key, errs in r["collectives"].items():
            assert max(errs) <= 1e-6, (key, errs)


def test_fsdp_model_checkpoint_restores_bit_identical_in_one_process(reference,
                                                                     tmp_path_factory):
    """Written under fsdp2-model2 (each rank a quarter of the leaves cut on
    both axes), restored into an unsharded state in this process."""
    out, ranks = _run("fsdp2-model2", reference, tmp_path_factory)
    params = from_numpy_tree(reference["params"])
    full = sum(t.numel() for _, t in ttree.iter_leaves(params))
    assert all(r["shard_numel"] < 0.45 * full for r in ranks)
    tx = make_optimizer(OptimizerConfig(**OCFG), params, trainable_mask(params))
    state = CheckpointManager(os.path.join(out, "ckpt")).restore(init_train_state(params, tx))
    assert state["step"] == 2 and state["opt_state"]["count"] == 2
    got = {p: t for p, t in ttree.iter_leaves(state) if torch.is_tensor(t)}
    want = ranks[0]["state"]
    assert set(got) == set(want)
    for p in want:
        assert torch.equal(got[p].detach(), want[p]), p


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

CLI = ["--mixture", "bridge", "--model_preset", "spatialvla_tiny", "--image_size", "56",
       "--seq_len", "80", "--max_steps", "2", "--per_device_batch_size", "2",
       "--shuffle_buffer_size", "4", "--logging_steps", "1", "--learning_rate", "1e-3",
       "--device", "cpu", "--mesh_model", "2"]


def _logged(out):
    return [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]


def test_model_axis_clis_in_one_process_and_on_two(tmp_path):
    """pretrain --mesh_model 2 in one process (a LocalMesh) and on 2 gloo
    processes (one shard a rank): both model ranks take the same rows
    (model rank 0's, broadcast: the threaded reader's order differs from
    process to process) and log the same metrics; then fine-tune
    --use_lora --mesh_model 2 from the one-process run's output in one
    process."""
    from spatialvla_tpu_torch.train import finetune, pretrain

    data_dir, _ = make_bridge_like_dataset(str(tmp_path / "data"))
    one = str(tmp_path / "one")
    state = pretrain.main(["--data_root_dir", data_dir, "--output_dir", one] + CLI)
    assert state["step"] == 2 and state["params"]["lm"]["layers"]["attn"]["q"].shape[0] == 2
    rows_one = _logged(one)
    assert [r["step"] for r in rows_one] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows_one)
    assert CheckpointManager(os.path.join(one, "checkpoints")).all_steps() == [2]

    two = str(tmp_path / "two")
    spawn_ranks(workers.pretrain_cli, 2, ["--data_root_dir", data_dir, "--output_dir", two]
                + CLI, str(tmp_path))
    ranks = _read(tmp_path, 2)
    assert [r["step"] for r in ranks] == [2, 2]
    assert ranks[0]["digests"] == ranks[1]["digests"]  # the same rows on both model ranks
    logged = [[{k: v for k, v in m.items() if k != "steps_per_sec"} for m in r["metrics"]]
              for r in ranks]
    assert len(logged[0]) == 2 and logged[0] == logged[1]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in _logged(two))

    ft = str(tmp_path / "ft")
    state = finetune.main(["--pretrained_dir", one, "--data_root_dir", data_dir, "--output_dir", ft,
                           "--use_lora", "--lora_rank", "4"] + CLI)
    assert state["step"] == 2
    assert all(np.isfinite(r["loss"]) for r in _logged(ft))
