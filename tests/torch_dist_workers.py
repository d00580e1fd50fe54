"""Worker processes of tests/test_torch_distributed.py: each runs one rank of
a gloo process group on the CPU. Imports torch and the port only (no jax),
so a spawned rank starts in a few seconds; results go to pickle files."""
import os
import pickle
import socket
import time

import numpy as np
import torch

SPAWN_TIMEOUT_S = 300  # a rendezvous that hangs fails the test instead of the run


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn, world: int, *args):
    """Runs fn(rank, world, port, *args) in ``world`` processes; raises if
    one fails or they outlast SPAWN_TIMEOUT_S."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(fn, args=(world, free_port(), *args), nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks of {fn.__name__} did not finish in "
                               f"{SPAWN_TIMEOUT_S} s")


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
    writes the metrics and the gathered parameters. Under fsdp every rank
    also saves the state through a sharded CheckpointManager."""
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
        np_params, batches, ocfg = pickle.load(f)
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
    result = {"metrics": metrics,
              "global_rows": tuple(form_global_batch(mesh, {"x": batches[0]["input_ids"][rows]})
                                   ["x"].shape)}
    if shape[1] > 1:
        CheckpointManager(os.path.join(out_dir, "ckpt"), shards=step.shards).save(
            state["step"], state, force=True)
        result["state"] = {p: t.detach().clone() for p, t in iter_leaves(
            step.shards.gather_state(state)) if torch.is_tensor(t)}
        result["shard_numel"] = sum(t.numel() for _, t in iter_leaves(state["params"]))
    if rank == 0:
        result["params"] = {p: t.detach().numpy() for p, t in iter_leaves(full)}
    _done(out_dir, rank, result)


# ---------------------------------------------------------------------------
# the pretrain CLI on two processes
# ---------------------------------------------------------------------------

def pretrain_cli(rank, world, port, argv, out_dir):
    """pretrain.main on this rank with the multi-host flags; records each
    logged step's metrics and a digest of each step's batch rows."""
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
                digests.append(hash(np.asarray(ids).tobytes()))
                yield batch

        return loop(batches=rows(), on_metrics=lambda s, m: seen.append(m), **kw)

    trainer.train_loop = recording_loop
    state = pretrain.main(argv + ["--coordinator_address", f"localhost:{port}",
                                  "--num_processes", str(world), "--process_id", str(rank)])
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"metrics": seen, "digests": digests, "step": state["step"]}, f)
    torch.distributed.destroy_process_group()
