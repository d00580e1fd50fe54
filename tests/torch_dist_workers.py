"""Worker processes of tests/test_torch_distributed.py: each runs one rank of
a gloo process group on the CPU. Imports torch and the port only (no jax),
so a spawned rank starts in a few seconds; results go to pickle files."""
import hashlib
import os
import pickle

import numpy as np
import torch

def _init(rank, world, port, shape):
    from spatialvla_tpu_torch.parallel import MeshConfig, initialize_distributed, make_mesh

    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank, device_type="cpu")
    return make_mesh(MeshConfig(*shape), "cpu")


def _done(out_dir, rank, result):
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# ring attention and the pipeline over process groups
# ---------------------------------------------------------------------------

def transports(rank, world, port, shape, out_dir):
    """Ring attention over the sp group and pipeline_apply over the pipe
    group against the one-process transports on the same numbers: outputs
    and gradients of this rank's part."""
    from spatialvla_tpu_torch.parallel import (LocalMesh, local_rows, pipeline_apply,
                                               ring_flash_attention)
    from spatialvla_tpu_torch.parallel.ring_attention import seq_shard

    mesh = _init(rank, world, port, shape)
    result = {}
    rng = np.random.RandomState(0)
    B, T, Nq, Nkv, D = 4, 16, 4, 2, 8
    q, k, v = (torch.from_numpy(rng.randn(B, T, n, D).astype(np.float32)) for n in (Nq, Nkv, Nkv))
    co = torch.from_numpy(rng.randn(B, T, Nq, D).astype(np.float32))
    prefix = torch.tensor([3, 0, 9, 16], dtype=torch.int32)
    valid = torch.tensor([16, 12, 14, 16], dtype=torch.int32)
    kw = dict(scale=D ** -0.5, logit_softcap=50.0, window=5)
    rows = local_rows(mesh, B)
    if mesh.shape["sp"] > 1:
        def run(m, sl):
            leaves = [t[rows, sl].clone().requires_grad_() for t in (q, k, v)]
            out = ring_flash_attention(*leaves, prefix[rows], valid[rows], mesh=m, **kw)
            return [out] + list(torch.autograd.grad((out * co[rows, sl]).sum(), leaves))

        start, stop = seq_shard(mesh, T)
        group = run(mesh, slice(start, stop))
        local = [t[:, start:stop] for t in run(LocalMesh(sp=mesh.shape["sp"]), slice(None))]
        result["ring"] = [float((a - b).abs().max()) for a, b in zip(group, local)]
    if mesh.shape["pipe"] > 1:
        S, H = mesh.shape["pipe"], 8
        w = [torch.from_numpy((rng.randn(H, H) * 0.3).astype(np.float32)) for _ in range(S)]
        x = torch.from_numpy(rng.randn(B, 6, H).astype(np.float32))

        def run(m):
            ws = [t.clone().requires_grad_() for t in w]
            xs = x[rows].clone().requires_grad_()
            y = pipeline_apply(lambda w_s, h, aux: torch.tanh(h @ w_s) * aux["s"][:, None, None],
                               ws, xs, {"s": torch.arange(1.0, B + 1)[rows]}, mesh=m,
                               n_microbatches=2)
            held = [ws[mesh.index("pipe")]] if m is mesh else ws
            # every stage holds the output, so each takes 1/S of the loss:
            # the output's gradients are summed over the pipe axis
            replicas = S if m is mesh else 1
            grads = torch.autograd.grad((y ** 2).sum() / replicas, [xs] + held)
            return y.detach(), grads

        y_g, (gx_g, gw_g) = run(mesh)
        y_l, (gx_l, *gw_l) = run(LocalMesh(pipe=S))
        s = mesh.index("pipe")
        # a stage's input gradient arrives on stage 0 only; its weights'
        # gradient on its own rank
        gx_want = gx_l if s == 0 else torch.zeros_like(gx_l)
        result["pipeline"] = [float((y_g - y_l).abs().max()), float((gx_g - gx_want).abs().max()),
                              float((gw_g - gw_l[s]).abs().max())]
    _done(out_dir, rank, result)


# ---------------------------------------------------------------------------
# sharded train steps
# ---------------------------------------------------------------------------

def train_steps(rank, world, port, shape, backend, inputs, out_dir):
    """Two sharded train steps of the tiny model on this rank's rows; rank 0
    writes the metrics and the gathered parameters; every rank the ranks of
    its model, sp and pipe groups ("groups"). Under fsdp every rank also
    saves the state through a sharded CheckpointManager. Where the
    inputs hold LoRA factors, two LoRA steps follow ("lora"); with a model
    axis, the autograd collectives are checked over its group first
    ("collectives")."""
    from spatialvla_tpu_torch.action import SpatialActionTokenizer
    from spatialvla_tpu_torch.config import spatialvla_tiny
    from spatialvla_tpu_torch.convert import from_numpy_tree
    from spatialvla_tpu_torch.parallel import form_global_batch, local_rows
    from spatialvla_tpu_torch.train import (OptimizerConfig, TrainStepConfig, build_decode_luts,
                                            init_train_state, make_optimizer, make_train_step,
                                            shard_train_step, trainable_mask)
    from spatialvla_tpu_torch.train.checkpoints import CheckpointManager
    from spatialvla_tpu_torch.utils.tree import iter_leaves

    mesh = _init(rank, world, port, shape)
    with open(inputs, "rb") as f:
        np_params, batches, ocfg, *lora = pickle.load(f)
    result = {"groups": {axis: torch.distributed.get_process_group_ranks(mesh.group(axis))
                         for axis in ("model", "sp", "pipe")}}
    if mesh.shape["model"] > 1:
        result["collectives"] = collectives_errors(mesh)
    cfg = spatialvla_tiny(use_vision_zoe=True)
    params = from_numpy_tree(np_params)
    tx = make_optimizer(OptimizerConfig(**ocfg), params, trainable_mask(params))
    luts = build_decode_luts(SpatialActionTokenizer(token_begin_idx=cfg.action_token_begin_idx))
    step = make_train_step(cfg, tx, TrainStepConfig(use_remat=True, compute_dtype=torch.float32,
                                                    attn_backend=backend, loss_chunk_size=7),
                           luts=luts, mesh=mesh)
    step, state = shard_train_step(step, mesh, init_train_state(params, tx))
    metrics = []
    for batch in batches:
        rows = local_rows(mesh, batch["input_ids"].shape[0])
        local = form_global_batch(mesh, {k: v[rows] for k, v in batch.items()})
        state, m = step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
    full = step.shards.gather_tree(state["params"])
    result.update(metrics=metrics, global_rows=tuple(
        form_global_batch(mesh, {"x": batches[0]["input_ids"][rows]})["x"].shape))
    if shape[1] > 1:
        CheckpointManager(os.path.join(out_dir, "ckpt"), shards=step.shards).save(
            state["step"], state, force=True)
        result["state"] = {p: t.detach().clone() for p, t in iter_leaves(
            step.shards.gather_state(state)) if torch.is_tensor(t)}
        result["shard_numel"] = sum(t.numel() for _, t in iter_leaves(state["params"]))
    if rank == 0:
        result["params"] = {p: t.detach().numpy() for p, t in iter_leaves(full)}
    if lora:
        result["lora"] = lora_steps(mesh, cfg, np_params, batches, luts, backend, *lora)
    _done(out_dir, rank, result)


def lora_steps(mesh, cfg, np_params, batches, luts, backend, factors, ocfg, alpha, rank,
               patterns):
    """Two LoRA steps of the tiny model from the given factors on this
    rank's rows (its base cut over the model axis): the metrics and the
    trainable tree as numpy."""
    from spatialvla_tpu_torch.convert import from_numpy_tree, to_numpy_tree
    from spatialvla_tpu_torch.parallel import form_global_batch, local_rows
    from spatialvla_tpu_torch.train import (OptimizerConfig, TrainStepConfig,
                                            init_lora_train_state, make_lora_train_step,
                                            make_optimizer, shard_lora_train_step)

    base = from_numpy_tree(np_params)
    tx = make_optimizer(OptimizerConfig(**ocfg), None, None)
    state = init_lora_train_state(torch.Generator().manual_seed(1), base, tx,
                                  target_patterns=patterns, rank=rank)
    with torch.no_grad():
        for p, f in factors.items():
            for k in ("a", "b"):
                state["trainable"]["lora"][p][k].copy_(torch.from_numpy(np.array(f[k])))
    step = make_lora_train_step(cfg, tx, TrainStepConfig(
        use_remat=True, compute_dtype=torch.float32, attn_backend=backend, loss_chunk_size=7),
        alpha=alpha, rank=rank, luts=luts, mesh=mesh)
    step, base = shard_lora_train_step(step, mesh, base)
    metrics = []
    for batch in batches:
        rows = local_rows(mesh, batch["input_ids"].shape[0])
        state, m = step(state, base, form_global_batch(mesh, {k: v[rows]
                                                              for k, v in batch.items()}))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "trainable": to_numpy_tree(state["trainable"])}


def collectives_errors(mesh):
    """The model axis' autograd collectives over its process group against
    their single-tensor definitions: max|difference| of each output and
    input gradient."""
    from spatialvla_tpu_torch.parallel import ShardCopy, ShardGather, ShardSum

    group, n, r = mesh.group("model"), mesh.shape["model"], mesh.index("model")
    rng = np.random.RandomState(0)
    parts = [torch.from_numpy(rng.randn(3, 5).astype(np.float32)) for _ in range(n)]
    ups = [torch.from_numpy(rng.randn(3, 5).astype(np.float32)) for _ in range(n)]
    wide = torch.from_numpy(rng.randn(3, 5 * n).astype(np.float32))
    errs = {}
    x = parts[r].clone().requires_grad_()
    y = ShardSum.apply(group, x)
    y.backward(ups[0])
    errs["sum"] = [float((y - sum(parts)).abs().max()), float((x.grad - ups[0]).abs().max())]
    x = parts[0].clone().requires_grad_()
    (y,) = ShardCopy.apply(group, 1, x)
    y.backward(ups[r])
    errs["copy"] = [float((y - parts[0]).abs().max()), float((x.grad - sum(ups)).abs().max())]
    x = parts[r].clone().requires_grad_()
    y = ShardGather.apply(group, -1, x)
    y.backward(wide)
    errs["gather"] = [float((y - torch.cat(parts, -1)).abs().max()),
                      float((x.grad - wide[:, 5 * r:5 * (r + 1)]).abs().max())]
    return errs


# ---------------------------------------------------------------------------
# the pretrain CLI on two processes
# ---------------------------------------------------------------------------

def pretrain_cli(rank, world, port, argv, out_dir):
    """pretrain.main on this rank with the multi-host flags; records each
    logged step's metrics and a digest of each step's batch rows (sha1: the
    same rows give the same digest in every process)."""
    from spatialvla_tpu_torch.train import pretrain, trainer

    torch.set_num_threads(1)
    seen, digests = [], []
    loop = trainer.train_loop

    def recording_loop(**kw):
        batches = kw.pop("batches")

        def rows():
            for batch in batches:
                ids = batch["input_ids"]
                ids = ids.to_local() if hasattr(ids, "to_local") else ids
                digests.append(hashlib.sha1(np.asarray(ids).tobytes()).hexdigest())
                yield batch

        return loop(batches=rows(), on_metrics=lambda s, m: seen.append(m), **kw)

    trainer.train_loop = recording_loop
    state = pretrain.main(argv + ["--coordinator_address", f"localhost:{port}",
                                  "--num_processes", str(world), "--process_id", str(rank)])
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"metrics": seen, "digests": digests, "step": state["step"]}, f)
    torch.distributed.destroy_process_group()
