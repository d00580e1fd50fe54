"""Entry points of the PyTorch port (the counterpart of __graft_entry__.py).

entry(device="cuda") -> (fn, (params, batch)): the forward step of the
    flagship spatialvla-4b-224 (SigLIP-so400m + Ego3D + ZoeDepth + Gemma2-2B)
    on one card, bf16 weights from a seeded generator; fn(params, batch) ->
    (loss, logits) through spatialvla.forward with its default attention
    ("xla": no kernel of csrc/ runs).

dryrun_multichip(n_devices, device="cuda"): the steps of the JAX surface, in
    its order, with its factorization and its printed lines; raises with no
    card unless ``device="cpu"`` (the serving half's device; the training
    meshes always run as gloo ranks on the CPU, the flagship on meta):
    * one sharded train step of spatialvla_tiny(use_vision_zoe=False) over
      (data, fsdp, model), and at n % 8 == 0 over (data=2, fsdp=2, pipe=2)
      with the GPipe pipeline and (data=2, sp=4) with ring attention, each a
      finite loss. The JAX surface runs these on n virtual CPU devices of
      one process. Here every mesh is a torch.distributed group of n gloo
      ranks on the CPU, one process a rank (parallel/mesh.py:spawn_ranks,
      initialize_distributed, make_mesh): one card cannot hold two NCCL
      ranks, and a LocalMesh (one process) refuses data > 1 with model > 1
      in training (train/train_step.py:_check_model_axis). Every rendezvous,
      collective and join has a timeout.
    * at n % 4 == 0, int8 tensor-parallel serving and split-phase
      tensor-parallel serving over (data=2, model=2) in this process on
      ``device`` (SpatialVLAPolicy.shard, SplitServingEngine): ids (2, 6) in
      the action block.
    * in place of the JAX surface's ahead-of-time compiles of the full
      spatialvla_4b() train step, the flagship on the "meta" device (shapes
      without data): its train state (fp32 masters, both AdamW moments of
      each trainable leaf) cut over each mesh's model and fsdp axes by the
      port's own cut (TrainShards, FsdpShards), every cut exact; the 26
      layers split into pipe stages by the pipeline's own partition (7 + 6
      window / global pairs, as JAX's forward_pipeline); T=2048 cut into sp
      halves by seq_shard; and one loss and its gradients of the flagship
      over each mesh's one-process form (LocalMesh: model, pipe, sp), the
      flash wrappers taking their plain versions on meta
      (ops/flash_attention.PLAIN_DEVICES), every gradient of its master's
      shape. The optimizer's update is left out: its clipping reads the gradient norm
      on the host, which a meta tensor does not have.

    python -c "import graft_entry_torch as g; g.dryrun_multichip(8)"  # on a card
    python -c "import graft_entry_torch as g; g.dryrun_multichip(8, device='cpu')"
    python -c "import graft_entry_torch as g; fn, a = g.entry(); print(fn(*a)[0])"  # on a card

Imports torch and the port, never jax or the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

# rendezvous, collectives and the join of the gloo ranks: a hang fails the run
DRYRUN_TIMEOUT_S = 300.0


def _flagship_cfg():
    from spatialvla_tpu_torch.config import spatialvla_4b

    return spatialvla_4b()  # full model incl. the ZoeDepth tower


def _device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card raises (the
    CPU only when the caller asks for it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the entry points run on the card "
                           "unless the caller passes device='cpu'")
    return device


def _example_batch(cfg, B=1, n_text=10, n_action=12, device="cpu", image_size=224):
    """__graft_entry__._example_batch's ids, masks, labels, pixels and
    intrinsic (numpy RandomState(0)), as tensors on ``device``: ids and
    labels int64, masks and token types int32, floats float32. The pixels
    are ``image_size`` square (224, as there, for the flagship)."""
    rng = np.random.RandomState(0)
    N = cfg.num_image_tokens
    ids = np.concatenate(
        [
            np.full((B, N), cfg.image_token_index),
            rng.randint(10, 1000, (B, n_text)),
            rng.randint(
                cfg.action_token_begin_idx,
                cfg.action_token_begin_idx + cfg.spatial_token_num,
                (B, n_action),
            ),
        ],
        axis=1,
    ).astype(np.int64)
    T = ids.shape[1]
    ttype = np.zeros((B, T), np.int32)
    ttype[:, N + n_text:] = 1
    K = np.asarray([[623.588 * 224 / 640, 0, 319.5 * 224 / 640],
                    [0, 623.588 * 224 / 480, 239.5 * 224 / 480],
                    [0, 0, 1.0]], np.float32)
    arrays = {
        "input_ids": ids,
        "attention_mask": np.ones((B, T), np.int32),
        "token_type_ids": ttype,
        "labels": np.where(ttype == 0, -100, ids),
        "pixel_values": rng.rand(B, image_size, image_size, 3).astype(np.float32),
        "intrinsic": np.broadcast_to(K, (B, 3, 3)).copy(),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def forward_step(cfg, compute_dtype=torch.bfloat16):
    """fn(params, batch) -> (loss, logits): spatialvla.forward of ``cfg``
    with its default attention, in ``compute_dtype``."""
    from spatialvla_tpu_torch.models import spatialvla

    def fn(params, batch):
        out = spatialvla.forward(
            params,
            cfg,
            batch["input_ids"],
            pixel_values=batch["pixel_values"],
            intrinsic=batch["intrinsic"],
            attention_mask=batch["attention_mask"],
            token_type_ids=batch["token_type_ids"],
            labels=batch["labels"],
            compute_dtype=compute_dtype,
        )
        return out["loss"], out["logits"]

    return fn


def entry_for(cfg, *, device="cuda", dtype=torch.bfloat16, compute_dtype=torch.bfloat16):
    """``entry`` for any config: (fn, (params, batch)) with ``dtype`` weights
    from spatialvla.init_params under torch.Generator(device).manual_seed(0)
    and the example batch, both on ``device``."""
    from spatialvla_tpu_torch.models import spatialvla

    device = _device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        params = spatialvla.init_params(cfg, generator=gen, device=device, dtype=dtype)
    batch = _example_batch(cfg, device=device, image_size=cfg.vision.image_size)
    return forward_step(cfg, compute_dtype), (params, batch)


def entry(device="cuda"):
    """The flagship's forward step on one card (bf16 weights, bf16 compute);
    raises with no card unless ``device="cpu"``."""
    return entry_for(_flagship_cfg(), device=device)


# ---------------------------------------------------------------------------
# dryrun_multichip
# ---------------------------------------------------------------------------

def _factorize(n_devices: int):
    """(data, fsdp, model) of the JAX surface: prefer 3-axis coverage."""
    model = 2 if n_devices % 2 == 0 else 1
    rest = n_devices // model
    fsdp = 2 if rest % 2 == 0 else 1
    return rest // fsdp, fsdp, model


def _tiny_train_batch(cfg, rng, B):
    """__graft_entry__._tiny_train_batch as numpy arrays (image block + text +
    action tail)."""
    N = cfg.num_image_tokens
    ids = np.concatenate(
        [
            np.full((B, N), cfg.image_token_index),
            rng.randint(0, 1000, (B, 4)),
            rng.randint(
                cfg.action_token_begin_idx,
                cfg.action_token_begin_idx + cfg.spatial_token_num,
                (B, 6),
            ),
        ],
        axis=1,
    ).astype(np.int32)
    T = ids.shape[1]
    ttype = np.zeros((B, T), np.int32)
    ttype[:, N + 4:] = 1
    return {
        "input_ids": ids,
        "attention_mask": np.ones((B, T), np.int32),
        "token_type_ids": ttype,
        "labels": np.where(ttype == 0, -100, ids),
        "pixel_values": rng.rand(B, cfg.vision.image_size, cfg.vision.image_size, 3).astype(
            np.float32),
    }


def _pad_seq(batch, multiple):
    """The sequence padded to a multiple of ``multiple`` (ids, masks and
    token types with 0, labels with -100)."""
    pad = (-batch["input_ids"].shape[1]) % multiple
    if not pad:
        return batch
    out = dict(batch)
    for k in ("input_ids", "attention_mask", "token_type_ids", "labels"):
        out[k] = np.pad(batch[k], ((0, 0), (0, pad)),
                        constant_values=-100 if k == "labels" else 0)
    return out


@dataclasses.dataclass(frozen=True)
class _TrainMesh:
    """One tiny training mesh of the dry run: its name and tag in the JAX
    surface's line, (data, fsdp, model, sp, pipe), attention backend,
    pipeline microbatches, batch rows and the seed of its batch."""
    name: str
    tag: str
    shape: tuple
    backend: str
    microbatches: int
    rows: int
    seed: int


def _train_meshes(n_devices: int):
    """The dry run's training meshes, in the JAX surface's order."""
    data, fsdp, model = _factorize(n_devices)
    meshes = [_TrainMesh(f"mesh=({data},{fsdp},{model})", "tiny executed",
                         (data, fsdp, model, 1, 1), "xla", 0, max(data * fsdp, 2), 0)]
    if n_devices % 8 == 0:
        # B=8: 2 microbatches of 4 = the composed (data, fsdp) batch shard
        meshes.append(_TrainMesh("mesh=(data=2,fsdp=2,pipe=2)", "tiny pp executed",
                                 (2, 2, 1, 1, 2), "pipeline", 2, 8, 1))
        meshes.append(_TrainMesh("mesh=(data=2,sp=4)", "tiny sp executed", (2, 1, 1, 4, 1),
                                 "ring", 0, 4, 3))
    return meshes


def _training_rank(rank, world, port, meshes, out_dir):
    """One gloo rank of the dry run: one sharded train step of the tiny
    model on each mesh of ``meshes`` that spans ``world`` ranks; rank 0
    writes the losses to ``out_dir``/losses.json."""
    from spatialvla_tpu_torch.config import spatialvla_tiny
    from spatialvla_tpu_torch.models import spatialvla
    from spatialvla_tpu_torch.parallel import (MeshConfig, form_global_batch,
                                               initialize_distributed, local_rows, make_mesh)
    from spatialvla_tpu_torch.train import (OptimizerConfig, TrainStepConfig, init_train_state,
                                            make_optimizer, make_train_step, shard_train_step,
                                            trainable_mask)

    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank, device_type="cpu",
                           timeout_s=DRYRUN_TIMEOUT_S)
    cfg = spatialvla_tiny(use_vision_zoe=False)
    losses = {}
    for m in meshes:
        mesh = make_mesh(MeshConfig(*m.shape), "cpu")
        params = spatialvla.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                        device="cpu")
        tx = make_optimizer(
            OptimizerConfig(learning_rate=1e-3, total_steps=10, schedule="constant"),
            params, trainable_mask(params, freeze_llm_embed=True))
        step = make_train_step(
            cfg, tx, TrainStepConfig(use_remat=True, compute_dtype=torch.float32,
                                     attn_backend=m.backend, pp_microbatches=m.microbatches),
            mesh=mesh)
        step, state = shard_train_step(step, mesh, init_train_state(params, tx))
        batch = _tiny_train_batch(cfg, np.random.RandomState(m.seed), m.rows)
        if m.backend == "ring":  # T must divide sp (the tiny batch is 26 long)
            batch = _pad_seq(batch, m.shape[3])
        rows = local_rows(mesh, m.rows)
        _, metrics = step(state, form_global_batch(mesh, {k: v[rows] for k, v in batch.items()}))
        losses[m.name] = float(metrics["loss"])
    if rank == 0:
        with open(os.path.join(out_dir, "losses.json"), "w") as f:
            json.dump(losses, f)
    torch.distributed.destroy_process_group()


def _run_training_meshes(meshes):
    """Each mesh's loss: the meshes of one size run in one spawn of that
    many gloo ranks."""
    from spatialvla_tpu_torch.parallel import spawn_ranks

    losses = {}
    by_world = {}
    for m in meshes:
        by_world.setdefault(int(np.prod(m.shape)), []).append(m)
    for world, group in by_world.items():
        with tempfile.TemporaryDirectory() as out_dir:
            spawn_ranks(_training_rank, world, group, out_dir, timeout_s=DRYRUN_TIMEOUT_S)
            with open(os.path.join(out_dir, "losses.json")) as f:
                losses.update(json.load(f))
    return losses


def _serving_policy(cfg, device, seed=0):
    """The tiny policy of the serving half: fp32 weights from
    torch.Generator().manual_seed(seed), the LM quantized to int8 (the
    vision front stays fp32, as the JAX surface quantizes the LM alone),
    two action steps (6 ids) a request, sharded over (data=2, model=2) on
    ``device``."""
    from spatialvla_tpu_torch import SpatialVLAPolicy
    from spatialvla_tpu_torch.inference import default_processor
    from spatialvla_tpu_torch.models import spatialvla

    params = spatialvla.init_params(cfg, generator=torch.Generator().manual_seed(seed),
                                    device="cpu")
    processor = default_processor(cfg)
    processor.action_chunk_size = 2
    policy = SpatialVLAPolicy(params, cfg, processor, device=device,
                              compute_dtype=torch.float32)
    return policy.quantize(bits=8, vision_bits=None).shard(n_model=2, n_data=2)


def _serving_requests(cfg, seed):
    rng = np.random.RandomState(seed)
    size = cfg.vision.image_size
    images = [(rng.rand(size, size, 3) * 255).astype(np.uint8) for _ in range(2)]
    return images, ["pick up the red cup", "open the drawer"]


def _check_ids(ids, cfg, what):
    ids = np.asarray(ids)
    lo = cfg.action_token_begin_idx
    if not (ids.shape == (2, 6) and ((ids >= lo) & (ids < lo + cfg.spatial_token_num)).all()):
        raise AssertionError(f"{what}: ids {ids.tolist()} (shape {ids.shape}), want (2, 6) in "
                             f"[{lo}, {lo + cfg.spatial_token_num})")
    return ids


def run_tiny_tp_serving(device="cuda"):
    """Mesh-sharded greedy serving (SpatialVLAPolicy.shard) on (data=2,
    model=2): the 2-row batch's rows split over the data groups, each over
    its two model shards. Returns the (2, 6) ids."""
    from spatialvla_tpu_torch.config import spatialvla_tiny

    cfg = spatialvla_tiny(use_vision_zoe=False)
    policy = _serving_policy(cfg, _device(device))
    images, texts = _serving_requests(cfg, 2)
    ids = _check_ids(policy.predict_batch(images, texts)["action_ids"], cfg, "TP serving")
    print("dryrun_multichip: mesh=(data=2,model=2) int8 TP serving ok (tiny tp-serving executed)",
          flush=True)
    return ids


def run_tiny_split_tp_serving(device="cuda"):
    """Split-phase serving over the same mesh (SplitServingEngine over the
    sharded policy: one prefill of the two rows, their admission into 4
    slots, decode blocks of 2 steps over each shard's kv heads until both
    retire). The sliding window is widened so the serving cache sits below
    it, as the JAX surface does. Returns the (2, 6) ids."""
    from spatialvla_tpu_torch.config import spatialvla_tiny
    from spatialvla_tpu_torch.serve.split_engine import SplitServingEngine

    cfg = spatialvla_tiny(use_vision_zoe=False)
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, sliding_window=4096))
    policy = _serving_policy(cfg, _device(device))
    images, texts = _serving_requests(cfg, 5)
    with SplitServingEngine(policy, n_slots=4, max_prompt_len=64, prompt_pad_multiple=16,
                            decode_block=2, prefill_wait_ms=50.0) as engine:
        futures = [engine.submit(img, text) for img, text in zip(images, texts)]
        outs = [f.result(timeout=DRYRUN_TIMEOUT_S) for f in futures]
    ids = _check_ids(np.stack([o["action_ids"] for o in outs]), cfg, "split TP serving")
    print("dryrun_multichip: mesh=(data=2,model=2) split-phase TP serving ok "
          "(tiny split-tp admission+decode executed)", flush=True)
    return ids


# ---------------------------------------------------------------------------
# the flagship on the meta device
# ---------------------------------------------------------------------------

class _MetaMesh:
    """The axis sizes of a process-group mesh and one rank's coordinates,
    without processes: what FsdpShards and seq_shard read of a Mesh."""

    def __init__(self, shape, coords=None):
        from spatialvla_tpu_torch.parallel.mesh import AXES

        self.shape = dict(zip(AXES, shape))
        self.coords = dict.fromkeys(AXES, 0) if coords is None else dict(coords)

    def index(self, axis):
        return self.coords[axis]

    def group(self, *axes):
        return None


def _flagship_state():
    """The full spatialvla_4b() train state on meta: fp32 masters and both
    AdamW moments of each trainable leaf (the reference's freeze policy)."""
    from spatialvla_tpu_torch.models import spatialvla
    from spatialvla_tpu_torch.train import (OptimizerConfig, init_train_state, make_optimizer,
                                            trainable_mask)

    cfg = _flagship_cfg()
    params = spatialvla.init_params(cfg, generator=None, device="meta")
    tx = make_optimizer(OptimizerConfig(learning_rate=2e-5, total_steps=100, schedule="linear"),
                        params, trainable_mask(params, freeze_llm_embed=True))
    return cfg, init_train_state(params, tx)


def cut_flagship_state(shape):
    """The spatialvla_4b() train state cut over a mesh of ``shape`` (data,
    fsdp, model, sp, pipe) on meta, by TrainShards (model) and FsdpShards
    (fsdp inside each model shard): every master and moment a rank holds,
    checked to tile its leaf exactly (equal shards whose sizes multiply back
    to the leaf's). Returns {"leaves", "model_cut", "fsdp_cut", "whole",
    "params", "rank_bytes", "state_bytes"}; raises on an inexact cut."""
    from spatialvla_tpu_torch.parallel import FsdpShards, LocalMesh, TrainShards
    from spatialvla_tpu_torch.utils.tree import iter_leaves, map_with_paths

    cfg, state = _flagship_state()
    mesh = _MetaMesh(shape)
    n_model, n_fsdp = mesh.shape["model"], mesh.shape["fsdp"]
    shards = TrainShards(LocalMesh(model=n_model), state["params"], cfg)
    one = map_with_paths(lambda p, t: t[0] if shards.stacked(p) else t,
                         map_with_paths(shards.cut_leaf, state["params"]))
    fsdp = FsdpShards(mesh, one)
    out = {"leaves": 0, "model_cut": 0, "fsdp_cut": 0, "whole": 0, "rank_bytes": 0,
           "state_bytes": 0, "params": sum(t.numel() for _, t in iter_leaves(state["params"]))}
    for path, leaf in iter_leaves(state):
        param = shards.param_path(path)
        if param is None or not torch.is_tensor(leaf):
            continue
        out["leaves"] += 1
        out["state_bytes"] += leaf.numel() * leaf.element_size()
        shard = leaf
        if shards.stacked(param):
            dim, idx, _ = shards.cut.cuts[param]
            sizes = {len(i) for i in idx}
            covered = torch.cat([torch.as_tensor(i) for i in idx]).unique().numel()
            if len(sizes) != 1 or covered != leaf.shape[dim]:
                raise AssertionError(f"{path}: the model cut's shards take {sorted(sizes)} of "
                                     f"{leaf.shape[dim]} rows, covering {covered}")
            shard = shards.cut_leaf(param, leaf)[0]
            out["model_cut"] += 1
        dim = fsdp.dim(param)
        if dim is not None and n_fsdp > 1:
            parts = shard.chunk(n_fsdp, dim)
            if len(parts) != n_fsdp or {p.shape[dim] for p in parts} != {
                    shard.shape[dim] // n_fsdp} or shard.shape[dim] % n_fsdp:
                raise AssertionError(f"{path}: fsdp={n_fsdp} does not cut dim {dim} of "
                                     f"{tuple(shard.shape)} into equal shards")
            shard = fsdp.cut(shard, dim)
            out["fsdp_cut"] += 1
        if shard is leaf:
            out["whole"] += 1
        out["rank_bytes"] += shard.numel() * shard.element_size()
    return out


def flagship_stages(n_stages: int = 2):
    """The flagship's layers of each pipe stage, by the pipeline's own
    partition of the window / global layer pairs (gemma2.stage_pairs, as
    JAX's forward_pipeline partitions them)."""
    from spatialvla_tpu_torch.models.gemma2 import stage_pairs

    L = _flagship_cfg().text.num_layers
    return [list(range(2 * a, 2 * b)) for a, b in stage_pairs(L // 2, n_stages)]


def flagship_seq_shards(T: int = 2048, n_sp: int = 2):
    """[start, stop) of each sp rank's part of a T-token sequence
    (ring_attention.seq_shard over a mesh of n_sp sequence ranks)."""
    from spatialvla_tpu_torch.parallel.ring_attention import seq_shard

    return [seq_shard(_MetaMesh((1, 1, 1, n_sp, 1), {"sp": i}), T) for i in range(n_sp)]


def flagship_meta_step(mesh, B: int, T: int):
    """One loss and its gradients of the full spatialvla_4b() on meta over a
    one-process mesh (a LocalMesh): with a model axis the state cut by
    TrainShards and the loss over the shards, with pipe the GPipe pipeline
    (2 microbatches), with sp ring attention, else the flash kernels' plain
    versions; bf16 compute, remat, 256-token loss chunks, the depth map
    given (ZoeDepth's domain vote reads a value on the host). Returns
    {"loss": shape, "grads": n, "params": n}; raises where a gradient's
    shape is not its master's."""
    from spatialvla_tpu_torch.parallel import TrainShards
    from spatialvla_tpu_torch.train import TrainStepConfig
    from spatialvla_tpu_torch.train.train_step import make_loss_fn
    from spatialvla_tpu_torch.utils.tree import iter_leaves

    cfg, state = _flagship_state()
    backend = "pipeline" if mesh.pipe > 1 else "ring" if mesh.sp > 1 else "flash"
    step_cfg = TrainStepConfig(use_remat=True, compute_dtype=torch.bfloat16, loss_chunk_size=256,
                               attn_backend=backend, pp_microbatches=2 if mesh.pipe > 1 else 0)
    full = state["params"]
    compute = full
    if mesh.model > 1:
        shards = TrainShards(mesh, full, cfg)
        full = shards.compute_tree(shards.cut_tree(full))
        compute = shards.group(full)
    else:
        for _, t in iter_leaves(full):
            if t.is_floating_point():
                t.requires_grad_(True)
    S = cfg.vision.image_size
    ids = torch.full((B, T), cfg.image_token_index, dtype=torch.long, device="meta")
    batch = {"input_ids": ids, "labels": ids,
             "attention_mask": torch.ones((B, T), dtype=torch.int32, device="meta"),
             "token_type_ids": torch.zeros((B, T), dtype=torch.int32, device="meta"),
             "pixel_values": torch.empty((B, S, S, 3), device="meta"),
             "intrinsic": torch.empty((B, 3, 3), device="meta"),
             "depth": torch.empty((B, S, S), device="meta")}
    loss, _ = make_loss_fn(cfg, step_cfg, mesh=mesh)(compute, batch)
    leaves = [(p, t) for p, t in iter_leaves(full) if torch.is_tensor(t) and t.requires_grad]
    grads = torch.autograd.grad(loss, [t for _, t in leaves], allow_unused=True)
    n = 0
    for (path, t), g in zip(leaves, grads):
        if g is None:
            continue
        if g.shape != t.shape or g.device.type != "meta":
            raise AssertionError(f"{path}: gradient {tuple(g.shape)} on {g.device} for a master "
                                 f"of {tuple(t.shape)}")
        n += 1
    return {"loss": tuple(loss.shape), "grads": n, "params": len(leaves)}


def _flagship_check(shape, label, *, B, T):
    """The dry run's line for one mesh at flagship scale: the state cut over
    the mesh, and the loss and gradients of its one-process form (its
    model, pipe and sp axes in a LocalMesh) on meta."""
    from spatialvla_tpu_torch.parallel import LocalMesh

    cut = cut_flagship_state(shape)
    _, _, model, sp, pipe = shape
    step = flagship_meta_step(LocalMesh(model=model, sp=sp, pipe=pipe), B, T)
    print(f"dryrun_multichip: spatialvla_4b ({cut['params'] / 1e9:.2f}B params) {label} "
          f"full-pretrain state cut exact ({cut['model_cut']} leaves over model, "
          f"{cut['fsdp_cut']} over fsdp, {cut['whole']} whole; "
          f"{cut['rank_bytes'] / 2**30:.2f} of {cut['state_bytes'] / 2**30:.2f} GiB a rank), "
          f"loss and {step['grads']} gradients on meta ok (4b cut)", flush=True)
    return {"cut": cut, "meta_step": step}


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The steps of __graft_entry__.dryrun_multichip (module docstring);
    prints its lines and returns what each step gave. The serving half runs
    on ``device``: a card unless the caller passes "cpu" (raises at once
    with no card); the training meshes are gloo ranks on the CPU either
    way."""
    device = _device(device)
    data, fsdp, model = _factorize(n_devices)
    out = {"losses": {}}
    meshes = _train_meshes(n_devices)
    losses = _run_training_meshes(meshes)
    for m in meshes:
        loss = out["losses"][m.name] = losses[m.name]
        if not np.isfinite(loss):
            raise AssertionError(f"dryrun_multichip: {m.name}: loss {loss}")
        print(f"dryrun_multichip: {m.name} loss={loss:.4f} ok ({m.tag})", flush=True)
    if n_devices % 4 == 0:
        out["tp_serving_ids"] = run_tiny_tp_serving(device).tolist()
        out["split_tp_serving_ids"] = run_tiny_split_tp_serving(device).tolist()
    out["flagship"] = {"main": _flagship_check(
        (data, fsdp, model, 1, 1), f"mesh=({data},{fsdp},{model})",
        B=max(data * fsdp, 2), T=256 + 64)}
    if n_devices % 8 == 0:
        stages = flagship_stages(2)
        print(f"dryrun_multichip: spatialvla_4b pipe=2 stages of {[len(s) for s in stages]} "
              f"layers ({len(stages[0]) // 2}+{len(stages[1]) // 2} window/global pairs)",
              flush=True)
        out["flagship"]["pipe"] = _flagship_check(
            (2, 2, 1, 1, 2), "mesh=(data=2,fsdp=2,pipe=2)", B=8, T=256 + 64)
        out["flagship"]["pipe"]["stages"] = stages
        shards = flagship_seq_shards(2048, 2)
        print(f"dryrun_multichip: spatialvla_4b T=2048 over sp=2: {shards}", flush=True)
        out["flagship"]["sp"] = _flagship_check(
            (2, 2, 1, 2, 1), "mesh=(data=2,fsdp=2,sp=2) T=2048", B=4, T=2048)
        out["flagship"]["sp"]["seq_shards"] = shards
    return out
