"""The model axis with sp and pipe in training: ring attention and the GPipe
pipeline over model shards (each shard runs its own ring over its own
heads, or its part of every stage), against the JAX package's unsharded
functions on the CPU, with numpy-seeded weights and batches.

* a LocalMesh holds model x sp or model x pipe on the caller's device only;
* ``forward_ring`` over LocalMesh(model=2, sp=2) and (model=4, sp=2: each kv
  head on two shards), ``forward_pipeline`` over (model=2, pipe=2) and
  (model=2, pipe=3: uneven stages), on a 10-layer tiny decoder, against
  JAX's XLA forward on the valid rows: atol 2e-5 / rtol 1e-5
  (test_torch_parallel.py's decoder bounds);
* a pipeline stage's group computes with its own views: the gradients reach
  the stage's leaves and the group's cached views stay as they were;
* two full-parameter and two LoRA steps of spatialvla_tiny(use_vision_zoe=
  True) (4/2 heads: 2/1 a shard at model=2, 1/1 at model=4) on the
  one-process meshes (model=2, sp=2), (model=4, sp=2) and (model=2,
  pipe=2), and on the process-group meshes
  model2-sp2 and model2-pipe2 (4 gloo processes each,
  tests/torch_dist_workers.py:train_steps), against JAX's unsharded XLA
  steps on the same weights and batches: loss, metrics and grad_norm rtol
  1e-4, parameters and factors atol 1e-6 (test_torch_model_parallel.py's
  bounds); every rank reports the same metrics;
* make_mesh lays model x sp and model x pipe out as JAX's mesh does (rank
  = model x size + index, row-major), each ring and each pipe inside one
  model coordinate.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest

import torch

from spatialvla_tpu.train import lora as jlora
from spatialvla_tpu_torch.convert import from_numpy_tree
from spatialvla_tpu_torch.models import gemma2 as tg2
from spatialvla_tpu_torch.parallel import LocalMesh, TensorShards, join_ranks, start_ranks
from spatialvla_tpu_torch.parallel.partitioning import ShardGroup
from spatialvla_tpu_torch.train import TrainStepConfig
from tests import torch_dist_workers as workers
from tests.test_torch_model_parallel import (ALPHA, CFG, LORA_OCFG, PRESET, RANK, _assert_lora,
                                             _assert_metrics, _assert_params, _read,
                                             local_mesh_steps)
from tests.test_torch_model_parallel import reference  # noqa: F401 (a fixture)
from tests.test_torch_distributed import OCFG
from tests.test_torch_parallel import G_CFG, _valid_rows_of
from tests.test_torch_parallel import decoder  # noqa: F401 (a fixture)

torch.set_num_threads(2)


def _group(params, n):
    """The decoder tree cut over n model shards held by this process."""
    tree = {"lm": from_numpy_tree(params)}
    cut = TensorShards(tree, dataclasses.replace(CFG, text=G_CFG), n)
    assert cut.blocks["lm_attn"] and cut.blocks["lm_mlp"]
    return ShardGroup(cut, [cut.cut_tree(tree, s) for s in range(n)], [None] * n)


def test_local_mesh_holds_a_ring_or_pipe_on_the_callers_device():
    assert LocalMesh(model=2, sp=2).shape == {"data": 1, "fsdp": 1, "model": 2, "sp": 2,
                                              "pipe": 1}
    for axes in (dict(sp=2), dict(pipe=2)):
        with pytest.raises(ValueError, match="caller's device"):
            LocalMesh(model=2, devices=("cpu", "cpu"), **axes)


FORWARDS = [  # backend, LocalMesh sizes
    ("ring", dict(model=2, sp=2)), ("ring", dict(model=4, sp=2)),
    ("pipeline", dict(model=2, pipe=2)), ("pipeline", dict(model=2, pipe=3)),
]


@pytest.mark.parametrize("backend, sizes", FORWARDS,
                         ids=["-".join(f"{k}{v}" for k, v in s.items()) for _, s in FORWARDS])
def test_model_sharded_forward_matches_jax_forward(decoder, backend, sizes):
    params, x, pos, prefix, valid, want = decoder
    fn = tg2.forward_ring if backend == "ring" else tg2.forward_pipeline
    got = fn(_group(params, sizes["model"]), G_CFG, torch.from_numpy(x), torch.from_numpy(pos),
             torch.from_numpy(prefix), torch.from_numpy(valid), mesh=LocalMesh(**sizes),
             use_remat=True)
    rows = _valid_rows_of(valid, x.shape[1])
    np.testing.assert_allclose(got.detach().numpy()[rows], want[rows], atol=2e-5, rtol=1e-5)


def test_pipeline_stage_groups_compute_with_their_own_views(decoder):
    """Over model shards a stage's weights are every shard's views of its
    layers; the pipeline rebuilds them as leaves of their own graph, and the
    stage group made of those must compute with them: the gradients reach
    each shard's stacked leaves through the stage leaves, and the group's
    own cached views are not replaced."""
    params, x, pos, prefix, valid, _ = decoder
    group = _group(params, 2)
    for t in group.trees:
        for leaf in (t["lm"]["layers"]["attn"]["q"], t["lm"]["layers"]["mlp"]["down"]):
            leaf.requires_grad_(True)
    views = group.layers("lm", G_CFG.num_layers)
    args = [torch.from_numpy(a) for a in (x, pos, prefix, valid)]
    out = tg2.forward_pipeline(group, G_CFG, *args, mesh=LocalMesh(model=2, pipe=2),
                               use_remat=True)
    out.pow(2).sum().backward()
    assert group.layers("lm", G_CFG.num_layers) is views
    for t in group.trees:
        for leaf in (t["lm"]["layers"]["attn"]["q"], t["lm"]["layers"]["mlp"]["down"]):
            assert leaf.grad is not None and bool((leaf.grad.abs().sum((1, 2)) > 0).all())


# ---------------------------------------------------------------------------
# the steps against JAX's unsharded steps
# ---------------------------------------------------------------------------

LOCAL_MESHES = {"model2-sp2": (dict(model=2, sp=2), "ring"),
                "model4-sp2": (dict(model=4, sp=2), "ring"),  # kv heads on two shards each
                "model2-pipe2": (dict(model=2, pipe=2), "pipeline")}


@pytest.mark.parametrize("name", list(LOCAL_MESHES))
def test_local_mesh_steps_match_jax_unsharded(name, reference):
    """Two full-parameter and two LoRA steps in one process."""
    sizes, backend = LOCAL_MESHES[name]
    state = local_mesh_steps(LocalMesh(**sizes), TrainStepConfig(
        use_remat=True, compute_dtype=torch.float32, attn_backend=backend, loss_chunk_size=7),
        reference)
    if sizes["model"] == 4:  # the copies of a kv head stay equal
        k = state["params"]["lm"]["layers"]["attn"]["k"]
        assert torch.equal(k[0], k[1]) and torch.equal(k[2], k[3])


STEP_MESHES = {  # name: (data, fsdp, model, sp, pipe), processes, backend
    "model2-sp2": ((1, 1, 2, 2, 1), 4, "ring"),
    "model2-pipe2": ((1, 1, 2, 1, 2), 4, "pipeline"),
}
_RUNS = {}


def _run(name, reference, tmp_path_factory):
    """The sharded full and LoRA steps of a mesh (the spawns of every mesh
    start together, at the first call; cached)."""
    if not _RUNS:
        lora = (reference["factors"], LORA_OCFG, ALPHA, RANK, jlora.TARGET_PRESETS[PRESET])
        for key, (shape, world, backend) in STEP_MESHES.items():
            out = tmp_path_factory.mktemp(key)
            inputs = os.path.join(out, "inputs.pkl")
            with open(inputs, "wb") as f:
                pickle.dump((reference["params"], reference["batches"], OCFG, *lora), f)
            _RUNS[key] = (out, world, start_ranks(workers.train_steps, world, shape, backend,
                                                  inputs, str(out)))
    out, world, ctx = _RUNS[name]
    if ctx is not None:
        join_ranks(ctx)
        _RUNS[name] = (out, world, None)
    return _read(out, world)


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
    ranks = _run(name, reference, tmp_path_factory)
    axis = "sp" if "sp2" in name else "pipe"
    for rank, r in enumerate(ranks):  # rank = model coordinate x 2 + sp / pipe coordinate
        assert r["groups"]["model"] == [rank % 2, rank % 2 + 2]
        assert r["groups"][axis] == [rank - rank % 2, rank - rank % 2 + 1]
    for r in ranks:  # every rank reports the same metrics
        assert r["metrics"] == ranks[0]["metrics"]
        assert r["lora"]["metrics"] == ranks[0]["lora"]["metrics"]
        for key, errs in r["collectives"].items():
            assert max(errs) <= 1e-6, (key, errs)
    _assert_metrics(ranks[0]["metrics"], reference["metrics"])
    _assert_params(ranks[0]["params"], reference["flat"])
    for r in ranks:  # the factors are whole on every rank, and agree
        _assert_lora(r["lora"]["metrics"], r["lora"]["trainable"], reference)
