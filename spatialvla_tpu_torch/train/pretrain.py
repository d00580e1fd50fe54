"""Pretraining entry point of the port (port of
spatialvla_tpu/train/pretrain.py): RLDS mixture pipeline (the port's copy of
the JAX package's jax-free data layer) -> processor / action tokenizer -> SpatialVLA with
random weights from ``--seed`` (or ``--init_checkpoint``, a directory of the
port's own format) -> the train step, on one device or sharded over a mesh
of processes -> metrics and step-numbered checkpoints under
``<output_dir>/checkpoints`` (resumed from the latest on a restart) -> the
final parameters in ``<output_dir>`` (``params.safetensors`` beside the
processor and ``config.json``, what the fine-tuning CLI's
``--pretrained_dir`` reads).

    python -m spatialvla_tpu_torch.train.pretrain \\
        --data_root_dir /data/oxe --mixture bridge \\
        --output_dir out/pretrain --max_steps 100000

Several processes, one a GPU, through torchrun or the explicit flags
(``--coordinator_address host:port --num_processes N --process_id I``):

    torchrun --nproc_per_node 4 -m spatialvla_tpu_torch.train.pretrain \\
        ... --mesh_data 2 --mesh_fsdp 2

The mesh flags lay the processes out (``parallel.MeshConfig``; -1 takes
what is left); ``--mesh_sp`` > 1 selects the "ring" backend and
``--mesh_pp`` > 1 the "pipeline" one. Each process loads its own rows,
``per_device_batch_size`` x ``grad_accum`` a step, so the global batch is
that times data x fsdp; processes that share a (data, fsdp) place draw the
same rows (the model ranks of one place take model rank 0's, broadcast:
``parallel.model_group_batches``). ``--mesh_model n``
cuts the weight matrices over n tensor-parallel shards, with or without
``--mesh_sp`` / ``--mesh_pp`` (each shard runs its own ring over its
heads, or its part of each pipeline stage). In one process a ``LocalMesh``
holds the model, sp and pipe axes and runs their shards in turn on its
device (one card); over a process group each rank holds one shard of each
(gloo on the CPU, NCCL with one process a card).
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch


def build_argparser():
    """The JAX CLI's flags (pretrain.py:26), plus ``--device``."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root_dir", type=str, required=True)
    p.add_argument("--mixture", type=str, default="bridge")
    p.add_argument("--shuffle_buffer_size", type=int, default=8192)
    p.add_argument("--obs_backward_steps", type=int, default=0)
    p.add_argument("--obs_backward_delta", type=int, default=1)
    p.add_argument("--action_forward_steps", type=int, default=3)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--seq_len", type=int, default=320)
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--camera_views", type=str, default="primary")
    p.add_argument("--load_depth", action="store_true")
    p.add_argument("--model_preset", type=str, default="spatialvla_4b",
                   choices=["spatialvla_4b", "spatialvla_tiny"])
    p.add_argument("--init_checkpoint", type=str, default=None,
                   help="a directory of the port's own format (params.safetensors, as this CLI "
                        "writes it) to start from")
    p.add_argument("--action_config", type=str, default=None)
    p.add_argument("--gs_params", type=str, default=None)
    p.add_argument("--intrinsics", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--prompt_template", type=str, default=None)
    p.add_argument("--min_sigma", type=float, default=0.0)
    p.add_argument("--freeze_vision_tower", action="store_true")
    p.add_argument("--no_freeze_llm_embed", action="store_true")
    p.add_argument("--no_vision_zoe", action="store_true")
    p.add_argument("--flash_attn", dest="attn_backend", action="store_const",
                   const="flash", default="flash")
    p.add_argument("--attn_backend", type=str, choices=["xla", "flash", "ring", "pipeline"])
    p.add_argument("--per_device_batch_size", type=int, default=2)
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--warmup_ratio", type=float, default=0.005)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--max_steps", type=int, default=100_000)
    p.add_argument("--no_remat", action="store_true")
    p.add_argument("--loss_chunk_size", type=int, default=256,
                   help="sequence-chunked CE (0 = full logits)")
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_fsdp", type=int, default=-1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--mesh_sp", type=int, default=1,
                   help="sequence-parallel axis (ring attention); >1 selects attn_backend=ring")
    p.add_argument("--mesh_pp", type=int, default=1,
                   help="pipeline-parallel axis (GPipe decoder stages); >1 selects "
                        "attn_backend=pipeline")
    p.add_argument("--pp_microbatches", type=int, default=0,
                   help="GPipe microbatches per step (0 = one per stage)")
    p.add_argument("--loader_workers", type=int, default=1)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--save_steps", type=int, default=20_000)
    p.add_argument("--save_total_limit", type=int, default=3)
    p.add_argument("--logging_steps", type=int, default=500)
    p.add_argument("--profile_steps", type=int, nargs=2, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda; without a card this raises, and "
                        "the CPU is used only with --device cpu)")
    return p


def training_device(args) -> torch.device:
    """The device of a training CLI's ``args`` (``--device``): raises on
    ``cuda`` without a card."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available; pass "
                           "--device cpu to train on the CPU")
    return device


def setup_parallel(args, device: torch.device, *, explain: bool):
    """(device, mesh, batch rank, batch ranks) of a training CLI: the
    process group from the multi-host flags or a launcher
    (``initialize_distributed``; NCCL on cuda, gloo on cpu), the mesh of the
    mesh flags over its processes (in one process a ``LocalMesh`` of the
    model, sp and pipe sizes where one is above 1 or the backend is "ring" /
    "pipeline", else None), and this process's place on the batch
    axes (data x fsdp), which picks its rows and data seed: the model ranks
    of one batch rank share it. ``--mesh_sp`` / ``--mesh_pp`` > 1 select
    their backend with the JAX CLIs' message (``explain``: pretrain's, which
    says what it is). On a card, the data layer's JPEG decode (where it runs
    on the GPU) is put on this process's card."""
    from ..data import native
    from ..parallel import LocalMesh, MeshConfig, initialize_distributed, make_mesh

    rank, nproc = initialize_distributed(args.coordinator_address, args.num_processes,
                                         args.process_id, device_type=device.type)
    if device.type == "cuda" and nproc > 1:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cuda":  # the nvJPEG route decodes on this process's card
        native.set_decode_device(torch.cuda.current_device() if device.index is None
                                 else device.index)
    selections = (("mesh_sp", args.mesh_sp, "ring", "sequence-parallel ring flash attention"),
                  ("mesh_pp", args.mesh_pp, "pipeline", "GPipe decoder stages"))
    for axis, n, backend, what in selections:
        if n > 1 and (args.attn_backend or "flash") != backend:
            print(f"{axis}={n}: selecting attn_backend={backend}"
                  + (f" ({what})" if explain else ""))
            args.attn_backend = backend
    cfg = MeshConfig(args.mesh_data, args.mesh_fsdp, args.mesh_model, args.mesh_sp, args.mesh_pp)
    if nproc == 1:
        # data x fsdp larger than one process raises here; this process
        # holds the model, sp and pipe axes
        dataclasses.replace(cfg, model=1, sp=1, pipe=1).resolve(1)
        local = (max(args.mesh_model, args.mesh_sp, args.mesh_pp) > 1
                 or args.attn_backend in ("ring", "pipeline"))
        if not local:
            return device, None, 0, 1
        return device, LocalMesh(sp=args.mesh_sp, pipe=args.mesh_pp, model=args.mesh_model), 0, 1
    mesh = make_mesh(cfg, device.type)
    n_batch = mesh.shape["data"] * mesh.shape["fsdp"]
    return device, mesh, mesh.index("data") * mesh.shape["fsdp"] + mesh.index("fsdp"), n_batch


def build_everything(args):
    from ..action import DEFAULT_NUM_BINS, SpatialActionTokenizer
    from ..config import spatialvla_4b, spatialvla_tiny
    from ..data import FrameTransformConfig, InterleavedRLDSDataset, TrajTransformConfig, VLABatcher
    from ..data.statistics import save_dataset_statistics
    from ..models import spatialvla
    from ..parallel import form_global_batch, model_group_batches, process_index
    from ..processor import SpatialVLAProcessor, load_text_tokenizer
    from . import (OptimizerConfig, TrainStepConfig, build_decode_luts, init_train_state,
                   make_optimizer, make_train_step, shard_train_step, trainable_mask)
    from ..utils.tree import count_params, iter_leaves, map_with_paths, param_summary
    from .checkpoints import CheckpointManager, restore_params

    device = training_device(args)
    device, mesh, batch_rank, n_batch = setup_parallel(args, device, explain=True)
    primary = process_index() == 0
    cfg = spatialvla_4b() if args.model_preset == "spatialvla_4b" else spatialvla_tiny()
    if args.no_vision_zoe:
        cfg = dataclasses.replace(cfg, use_vision_zoe=False, zoe=None)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = spatialvla.init_params(cfg, generator=gen, device=device, dtype=torch.float32)
    if args.init_checkpoint:
        params = restore_params(args.init_checkpoint, params)
    # each batch rank draws its own rows (pretrain.py:182-183)
    data_seed, data_shard = args.seed + 3407 * batch_rank, (batch_rank, n_batch)

    ds = InterleavedRLDSDataset(
        args.mixture, args.data_root_dir,
        traj_config=TrajTransformConfig(backward_window_size=args.obs_backward_steps,
                                        backward_delta=args.obs_backward_delta,
                                        forward_window_size=args.action_forward_steps),
        frame_config=FrameTransformConfig(resize_size=(args.image_size, args.image_size),
                                          augment=not args.no_augment),
        shuffle_buffer_size=args.shuffle_buffer_size, seed=data_seed, shard_by_rank=data_shard,
        load_camera_views=tuple(args.camera_views.split(",")), load_depth=args.load_depth,
    )
    gs_params = json.load(open(args.gs_params)) if args.gs_params else None
    action_config = (json.load(open(args.action_config)) if args.action_config
                     else {"num_bins": DEFAULT_NUM_BINS, "use_spherical": True})
    intrinsic_config = json.load(open(args.intrinsics)) if args.intrinsics else None
    action_tokenizer = SpatialActionTokenizer(
        num_bins=action_config["num_bins"], gs_params=gs_params,
        use_spherical=action_config.get("use_spherical", True), min_sigma=args.min_sigma,
        token_begin_idx=cfg.action_token_begin_idx,
    )
    if args.tokenizer_path is None and primary:
        print("WARNING: no --tokenizer_path given; using the byte-level test tokenizer. The "
              "trained model's text interface will NOT be compatible with reference "
              "(PaliGemma2) checkpoints.")
    processor = SpatialVLAProcessor(
        load_text_tokenizer(args.tokenizer_path), action_tokenizer=action_tokenizer,
        image_token_id=cfg.image_token_index, action_token_begin_idx=cfg.action_token_begin_idx,
        image_seq_length=cfg.num_image_tokens, image_size=args.image_size,
        statistics=ds.statistics, intrinsic_config=intrinsic_config,
        action_config=action_config, action_chunk_size=args.action_forward_steps + 1,
        min_sigma=args.min_sigma,
    )

    mask = trainable_mask(params,
                          freeze_llm_embed=not args.no_freeze_llm_embed and cfg.use_spatial_token,
                          freeze_vision=args.freeze_vision_tower, freeze_zoe=True)
    tx = make_optimizer(OptimizerConfig(learning_rate=args.learning_rate,
                                        warmup_ratio=args.warmup_ratio,
                                        total_steps=args.max_steps,
                                        weight_decay=args.weight_decay), params, mask)
    # the trainable-parameter dump (reference spatialvla_pretrain.py:352-354)
    flags = dict(iter_leaves(mask))
    trainable = param_summary(map_with_paths(lambda p, t: t if flags[p] else None, params),
                              max_depth=1)
    if primary:
        print(f"params: {count_params(params) / 1e6:.1f}M total; trainable by module: "
              + ", ".join(f"{k}={v / 1e6:.1f}M" for k, v in trainable.items()))
    luts = {k: torch.as_tensor(v, device=device)
            for k, v in build_decode_luts(action_tokenizer).items()}
    step = make_train_step(cfg, tx, TrainStepConfig(
        use_remat=not args.no_remat, compute_dtype=torch.bfloat16, micro_steps=args.grad_accum,
        attn_backend=args.attn_backend or "flash", pp_microbatches=args.pp_microbatches,
        loss_chunk_size=args.loss_chunk_size,
    ), luts=luts, mesh=mesh)
    step, state = shard_train_step(step, mesh, init_train_state(params, tx))
    del params  # the state holds this rank's shards
    batcher = VLABatcher(processor, batch_size=args.per_device_batch_size * args.grad_accum,
                         seq_len=args.seq_len, prompt_template=args.prompt_template)

    def batches():
        if args.loader_workers > 1:
            from ..data.mploader import ProcessShardedFrameLoader

            frames = ProcessShardedFrameLoader(dict(
                mixture=args.mixture, data_dir=args.data_root_dir, traj_config=ds.traj_config,
                frame_config=ds.frame_config, shuffle_buffer_size=args.shuffle_buffer_size,
                seed=data_seed, shard_by_rank=data_shard, statistics_override=ds.statistics,
                load_camera_views=tuple(args.camera_views.split(",")),
                load_depth=args.load_depth,
            ), num_workers=args.loader_workers).frames()
        else:
            frames = ds.frames()
        for batch in model_group_batches(mesh, batcher.batches(frames)):
            batch.pop("actions", None)
            if args.grad_accum > 1:
                batch = {k: v.reshape((args.grad_accum, -1) + v.shape[1:])
                         for k, v in batch.items()}
            yield form_global_batch(mesh, batch, dim=int(args.grad_accum > 1))

    shards = getattr(step, "shards", None)
    ckpt = CheckpointManager(os.path.join(args.output_dir, "checkpoints"),
                             save_interval_steps=args.save_steps,
                             max_to_keep=args.save_total_limit, shards=shards)
    sidecar = {"model_config": json.loads(cfg.to_json()), "mixture": args.mixture}
    if primary:
        processor.save(args.output_dir)
        save_dataset_statistics(ds.statistics, f"{args.output_dir}/ds_stats.json")
        with open(f"{args.output_dir}/config.json", "w") as f:
            f.write(cfg.to_json())
    return dict(cfg=cfg, state=state, step=step, batches=batches(), ckpt=ckpt, sidecar=sidecar,
                processor=processor, dataset=ds, device=device, mesh=mesh, shards=shards)


def main(argv=None):
    from ..parallel import process_index
    from .checkpoints import save_params
    from .trainer import TrainerConfig, train_loop

    args = build_argparser().parse_args(argv)
    parts = build_everything(args)
    config = TrainerConfig(
        output_dir=args.output_dir, max_steps=args.max_steps, log_every=args.logging_steps,
        save_every=args.save_steps, save_total_limit=args.save_total_limit,
        profile_steps=tuple(args.profile_steps) if args.profile_steps else None,
    )
    state = train_loop(state=parts["state"], train_step=parts["step"], batches=parts["batches"],
                       config=config, checkpoint_manager=parts["ckpt"], sidecar=parts["sidecar"])
    parts["ckpt"].close()  # lets go of its saves' host buffers before the export
    # bare-params export for inference / finetune-from (beside the processor),
    # gathered from every rank's shards and written by process 0
    shards = parts["shards"]
    params = shards.gather_tree(state["params"]) if shards is not None else state["params"]
    if process_index() == 0:
        save_params(args.output_dir, params, config_json=parts["cfg"].to_json())
    return state


if __name__ == "__main__":
    main()
