"""The device mesh and the multi-process bootstrap (port of
spatialvla_tpu/parallel/mesh.py).

The JAX package names a ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives. The port runs one process a GPU and calls the collectives
itself: ``make_mesh`` lays the processes of an initialized
``torch.distributed`` group out as a ``DeviceMesh`` over the same five named
axes, in JAX's order, and ``Mesh`` keeps it with the process groups the
training layer reduces over.

Axes (as in JAX):
  data   data parallelism: the batch's rows, gradients summed
  fsdp   ZeRO-3: the fp32 masters and AdamW moments cut by the rules
         (parallel/partitioning.py), weights gathered for compute, gradients
         reduce-scattered back to the shards; the batch's rows too
  model  tensor parallelism: the weight matrices cut by heads and hidden
         columns (parallel/partitioning.py:TensorShards), the partial
         products summed by ``ShardSum``, a column-parallel block's input
         handed to the shards by ``ShardCopy`` and column blocks joined by
         ``ShardGather`` (autograd functions: the collectives of training);
         held by one process in a ``LocalMesh`` (serving, and training on
         one card) or one shard a rank of a process-group ``Mesh``
         (training); with sp or pipe each model shard runs its own ring
         over its heads, or its part of every pipeline stage
  sp     sequence parallelism: the ring of parallel/ring_attention.py
  pipe   pipeline parallelism: the GPipe stages of parallel/pipeline.py

``LocalMesh`` holds the sp, pipe, data and model axes in one process: a ring
of ``sp`` sequence shards and a pipe of ``pipe`` stages, run in turn by this
process through the same loops as the process-group transports, and the
``data x model`` shards of a sharded serving policy
(``SpatialVLAPolicy.shard``, as JAX's single controller lays its mesh over
the devices it drives) or the ``model`` shards of a training step
(``LocalMesh(model=n)``, with sp or pipe too, every shard on the caller's
device). It is the counterpart of the JAX tests' virtual CPU devices, and
what one card runs. The caller asks for it by name; a mesh of several
processes never turns into one.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import socket
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

AXES = ("data", "fsdp", "model", "sp", "pipe")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    fsdp: int = -1  # -1: absorb the remaining devices
    model: int = 1
    sp: int = 1  # sequence parallelism (ring attention)
    pipe: int = 1  # pipeline parallelism (GPipe stages)

    def resolve(self, n_devices: int) -> tuple:
        """The five sizes, -1 replaced by what the others leave of
        ``n_devices`` (mesh.py:44-54); raises when they need more."""
        dims = [self.data, self.fsdp, self.model, self.sp, self.pipe]
        if -1 in dims:
            known = math.prod(d for d in dims if d != -1)
            dims[dims.index(-1)] = n_devices // known
        if math.prod(dims) > n_devices:
            raise ValueError(f"mesh {dims} needs more than the {n_devices} available devices")
        return tuple(dims)


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """The sp, pipe, data and model axes held by one process (see the module
    docstring). ``devices`` places the ``data x model`` shards, data-major
    (shard s of data group g on ``devices[g * model + s]``), as JAX's
    ``make_mesh(MeshConfig(data, 1, model), devices)`` lays them out; None
    puts every shard on the caller's device. Two forms: every shard on one
    device, or each on a CUDA device of its own (the slice form)."""
    sp: int = 1
    pipe: int = 1
    data: int = 1
    model: int = 1
    devices: Optional[Tuple[torch.device, ...]] = None

    def __post_init__(self):
        if self.devices is None:
            return
        if self.sp > 1 or self.pipe > 1:
            raise ValueError("a ring or a pipe held by one process runs on the caller's device "
                             f"(devices=None), got sp={self.sp}, pipe={self.pipe} on devices")
        devices = tuple(torch.device(d) for d in self.devices)
        object.__setattr__(self, "devices", devices)
        if len(devices) != self.data * self.model:
            raise ValueError(f"{len(devices)} devices for a data={self.data} x "
                             f"model={self.model} mesh")
        for g in range(self.data):
            group = devices[g * self.model:(g + 1) * self.model]
            if len(set(group)) not in (1, len(group)):
                raise ValueError(f"data group {g} on {group}: its model shards share one device "
                                 "or take one device each")
            if len(set(group)) > 1:
                if any(d.type != "cuda" for d in group):
                    raise ValueError(f"shards on distinct devices are CUDA devices, got {group}")
                count = torch.cuda.device_count()
                missing = [d for d in group if (d.index or 0) >= count]
                if missing:
                    raise RuntimeError(f"shards on {missing}: this machine has {count} CUDA "
                                       "device(s)")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "fsdp": 1, "model": self.model, "sp": self.sp,
                "pipe": self.pipe}

    def group_devices(self, g: int, default) -> List[torch.device]:
        """The devices of data group ``g``'s model shards, in shard order."""
        if self.devices is None:
            return [torch.device(default)] * self.model
        return list(self.devices[g * self.model:(g + 1) * self.model])


def sum_shards(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of the model shards' partial results, handed back to each
    shard: summed in fp32, in shard order, and returned in the parts' dtype.
    Parts on one device: ``ShardSum``, one tensor returned for every shard.
    Parts on distinct CUDA devices: one ``torch.cuda.nccl.all_reduce`` over
    the list (single-process NCCL), each shard's sum on its own device."""
    if len({p.device for p in parts}) == 1:
        return [ShardSum.apply(None, *parts)] * len(parts)
    import torch.cuda.nccl as nccl

    bufs = [p.float().contiguous() for p in parts]
    nccl.all_reduce(bufs)
    return [b.to(dtype) for b in bufs]


def gather_shards(parts: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """The model shards' column blocks joined in shard order along ``dim``, on
    the first shard's device."""
    home = parts[0].device
    return torch.cat([p.to(home) for p in parts], dim)


# ---------------------------------------------------------------------------
# the model axis' collectives, with their gradients: one implementation for
# this process's shards (a LocalMesh: ``group`` None) and one for a process
# group (one shard a rank). Every model rank computes the same loss, so the
# gradient of a replicated tensor is the same on every rank.
# ---------------------------------------------------------------------------

def _fp32_sum(parts) -> torch.Tensor:
    """The parts summed in fp32 in order, in a tensor of its own."""
    total = parts[0].to(torch.float32, copy=True)
    for p in parts[1:]:
        total += p.float()
    return total


class ShardSum(torch.autograd.Function):
    """``ShardSum.apply(group, *parts)``: the sum of the model shards'
    partial results (a row-parallel block's products, the masked rows of a
    vocabulary cut): this process's parts summed in fp32 in shard order,
    all-reduced over ``group`` where one is given, in the parts' dtype.
    Backward: the sum's gradient is each part's."""

    @staticmethod
    def forward(ctx, group, *parts):
        ctx.dtypes = [p.dtype for p in parts]
        total = _fp32_sum(parts)
        if group is not None:
            torch.distributed.all_reduce(total, group=group)
        return total.to(parts[0].dtype)

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(g.to(d) for d in ctx.dtypes)


class ShardCopy(torch.autograd.Function):
    """``ShardCopy.apply(group, n, x)``: the input of a column-parallel block
    handed to this process's ``n`` shards, the same values each (ShardSum's
    dual). Backward: the shards' input gradients summed in fp32 in shard
    order, all-reduced over ``group`` where one is given."""

    @staticmethod
    def forward(ctx, group, n, x):
        ctx.group, ctx.dtype = group, x.dtype
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        total = _fp32_sum(grads)
        if ctx.group is not None:
            torch.distributed.all_reduce(total, group=ctx.group)
        return None, None, total.to(ctx.dtype)


class ShardGather(torch.autograd.Function):
    """``ShardGather.apply(group, dim, *parts)``: the model shards' column
    blocks joined in shard order along ``dim``: this process's parts, or
    over ``group`` every rank's one part (all-gathered). Backward: each
    part's slice of the gradient."""

    @staticmethod
    def forward(ctx, group, dim, *parts):
        ctx.group, ctx.dim = group, dim
        ctx.widths = [p.shape[dim] for p in parts]
        if group is None:
            return torch.cat(parts, dim)
        if len(parts) != 1:
            raise ValueError("a rank of a process group holds one model shard")
        ctx.rank = torch.distributed.get_rank(group)
        return gather_along(parts[0], group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.group is None:
            return (None, None) + tuple(g.split(ctx.widths, ctx.dim))
        w = ctx.widths[0]
        return None, None, g.narrow(ctx.dim, ctx.rank * w, w).contiguous()


def shard_max(parts: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """The elementwise max of the shards' parts (no gradient): this
    process's, all-reduced over ``group`` where one is given."""
    out = torch.stack([p.detach() for p in parts]).amax(0)
    if group is not None:
        torch.distributed.all_reduce(out, op=torch.distributed.ReduceOp.MAX, group=group)
    return out


def shard_stack(parts: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """Every model shard's part stacked along a new last dim in shard order
    (no gradient): this process's, or over ``group`` every rank's one."""
    out = torch.stack([p.detach() for p in parts], -1)
    return out if group is None else gather_along(out, group, -1)


class Mesh:
    """A ``DeviceMesh`` over ``AXES`` (``device_mesh``) and the process
    groups of the axes and of the axis sets the training layer reduces over.
    ``shape`` maps an axis to its size, as JAX's ``mesh.shape`` does."""

    # the axis sets the train step reduces over (besides single axes): the
    # batch axes; the batch and sequence axes (the ring's loss); a fsdp-cut
    # gradient's other axes; a whole leaf's gradient (every axis but model);
    # the squares of grad_norm; the LoRA factors
    GROUPS = (("data", "fsdp"), ("data", "fsdp", "sp"), ("data", "sp", "pipe"),
              ("data", "fsdp", "sp", "pipe"), ("fsdp", "model"), AXES)

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.device_type = device_mesh.device_type
        self.shape = dict(zip(AXES, device_mesh.mesh.shape))
        ranks = device_mesh.mesh
        me = torch.distributed.get_rank()
        self.coords = dict(zip(AXES, torch.nonzero(ranks == me)[0].tolist()))
        self._groups = {}
        for axes in self.GROUPS:  # every rank creates every group, in one order
            dims = [AXES.index(a) for a in axes]
            rest = [d for d in range(len(AXES)) if d not in dims]
            moved = ranks.permute(*rest, *dims).reshape(-1, math.prod(ranks.shape[d] for d in dims))
            for row in moved.tolist():
                group = torch.distributed.new_group(row)
                if me in row:
                    self._groups[axes] = group

    def group(self, *axes: str):
        """The process group of the ranks that share this rank's place on
        every axis but ``axes``."""
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._groups[tuple(axes)]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.coords[axis]

    def __repr__(self):
        return f"Mesh({self.shape}, {self.device_type!r})"


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis sizes of a ``Mesh``, a ``LocalMesh``, or a plain dict (all 1 for
    None)."""
    if mesh is None:
        return dict.fromkeys(AXES, 1)
    shape = mesh if isinstance(mesh, dict) else mesh.shape
    return {a: int(shape.get(a, 1)) for a in AXES}


def gather_along(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The tensors of every rank of ``group``, in rank order, joined along
    ``dim``."""
    parts = [torch.empty_like(t) for _ in range(torch.distributed.get_world_size(group))]
    torch.distributed.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(cfg: MeshConfig = MeshConfig(), device_type: str = "cuda") -> Mesh:
    """The named mesh over the processes of the initialized process group
    (``initialize_distributed``), one device each; the sizes must use every
    process. ``device_type`` is the caller's (``cuda`` by default)."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh lays out the processes of an initialized process group "
                           "(initialize_distributed); one process holds a ring or a pipe with "
                           "LocalMesh")
    world = dist.get_world_size()
    shape = cfg.resolve(world)
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} leaves processes out of the {world} started")
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(init_device_mesh(device_type, shape, mesh_dim_names=AXES))


def _launcher_env() -> Optional[Tuple[int, int, str]]:
    """(rank, world size, address) from a launcher's environment: torchrun's
    RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT, SLURM's or Open MPI's
    rank and size (with MASTER_ADDR / MASTER_PORT for the address); None
    outside a launch of several processes."""
    env = os.environ
    for size_key, rank_key in (("WORLD_SIZE", "RANK"), ("SLURM_NTASKS", "SLURM_PROCID"),
                               ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK")):
        if int(env.get(size_key, "1")) > 1:
            if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
                raise RuntimeError(f"{size_key}={env[size_key]}: set MASTER_ADDR and "
                                   "MASTER_PORT (or pass --coordinator_address) to say where "
                                   "process 0 listens")
            return (int(env[rank_key]), int(env[size_key]),
                    f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}")
    return None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device_type: str = "cuda",
                           timeout_s: Optional[float] = None) -> tuple:
    """The multi-process bootstrap (mesh.py:67-113), in JAX's order:

      1. explicit arguments (or SPATIALVLA_COORDINATOR / _NUM_PROCESSES /
         _PROCESS_ID), ``coordinator_address`` as ``host:port``;
      2. a launcher's environment (torchrun, SLURM, Open MPI);
      3. otherwise one process: nothing to do.

    The process group's backend is NCCL for ``cuda`` (each process takes the
    card LOCAL_RANK names, or its rank modulo the cards) and gloo for
    ``cpu``; ``cuda`` without a card raises. ``timeout_s`` bounds the
    rendezvous and every collective of the group (None: torch's default).
    Returns (process_index, process_count)."""
    env = os.environ
    coordinator_address = coordinator_address or env.get("SPATIALVLA_COORDINATOR")
    if num_processes is None and env.get("SPATIALVLA_NUM_PROCESSES"):
        num_processes = int(env["SPATIALVLA_NUM_PROCESSES"])
    if process_id is None and env.get("SPATIALVLA_PROCESS_ID"):
        process_id = int(env["SPATIALVLA_PROCESS_ID"])
    dist = torch.distributed
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is not None and num_processes is not None:
        if process_id is None:
            raise ValueError("--coordinator_address and --num_processes need --process_id")
        rank, world, address = process_id, num_processes, coordinator_address
    else:
        found = _launcher_env()
        if found is None:
            return 0, 1
        rank, world, address = found
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(device_type='cuda'): no CUDA device is "
                               "available; pass device_type='cpu' (--device cpu) for gloo")
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    extra = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=f"tcp://{address}", rank=rank, world_size=world,
                            **extra)
    return rank, world


def start_ranks(fn, world: int, *args, timeout_s: float = 300.0):
    """Starts ``fn(rank, world, port, *args)`` in ``world`` fresh processes
    (``torch.multiprocessing``, start method "spawn"), ``port`` a free one
    on localhost for ``initialize_distributed``'s rendezvous; ``fn`` is a
    module-level function. Returns their context for ``join_ranks``, which
    gives them ``timeout_s`` from now."""
    import torch.multiprocessing as mp

    with socket.socket() as s:  # a port the OS has just handed out
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.spawn(fn, args=(world, port, *args), nprocs=world, join=False)
    ctx.deadline, ctx.timeout_s = time.monotonic() + timeout_s, timeout_s
    ctx.what = f"{world} ranks of {fn.__name__}"
    return ctx


def join_ranks(ctx) -> None:
    """Waits for the processes ``start_ranks`` began; raises when one fails,
    or kills them all and raises when they outlast their timeout."""
    while not ctx.join(timeout=1):
        if time.monotonic() > ctx.deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{ctx.what} did not finish in {ctx.timeout_s} s")


def spawn_ranks(fn, world: int, *args, timeout_s: float = 300.0) -> None:
    """``start_ranks`` and ``join_ranks``: runs ``fn(rank, world, port,
    *args)`` in ``world`` processes to their end."""
    join_ranks(start_ranks(fn, world, *args, timeout_s=timeout_s))


def batch_sharding(mesh, dim: int = 0) -> tuple:
    """DTensor placements of a batch: its rows (dim ``dim``) over (data,
    fsdp), the same rows on every other axis."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(dim) if a in ("data", "fsdp") else Replicate() for a in AXES)


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in AXES)


def form_global_batch(mesh, batch: dict, dim: int = 0) -> dict:
    """The global batch as DTensors made from each process's own rows, dim
    ``dim`` (1 under gradient accumulation) (mesh.py:131-144:
    ``make_array_from_process_local_data``); the batch unchanged in one
    process. The train step reads each process's rows back (``to_local``)
    and reduces across the batch axes itself."""
    if process_count() == 1 or not isinstance(mesh, Mesh):
        return batch
    import numpy as np
    from torch.distributed.tensor import DTensor

    placements = batch_sharding(mesh, dim)
    return {k: DTensor.from_local(torch.as_tensor(np.asarray(v)), mesh.device_mesh, placements,
                                  run_check=False) for k, v in batch.items()}


def model_group_batches(mesh, batches):
    """``batches`` as the model ranks of one batch rank must see them: the
    same rows on each. On a ``Mesh`` with a model axis model rank 0 draws
    them and broadcasts each over the model axis, the other ranks drawing
    nothing (the data layer's threaded reader hands records over in the
    order its threads finish, so two processes' own draws may differ);
    elsewhere ``batches`` itself."""
    if not isinstance(mesh, Mesh) or mesh.shape["model"] == 1:
        yield from batches
        return
    group = mesh.group("model")
    src = torch.distributed.get_global_rank(group, 0)
    it = iter(batches) if mesh.index("model") == 0 else None
    while True:
        box = [None if it is None else next(it, None)]
        torch.distributed.broadcast_object_list(box, src=src, group=group)
        if box[0] is None:
            return
        yield box[0]


def local_rows(mesh, n_rows: int) -> slice:
    """The rows of an ``n_rows`` global batch that this process takes: its
    block on the combined (data, fsdp) axes."""
    shape = mesh_shape(mesh)
    n = shape["data"] * shape["fsdp"]
    if n_rows % n:
        raise ValueError(f"{n_rows} rows do not split over data x fsdp = {n}")
    i = mesh.index("data") * shape["fsdp"] + mesh.index("fsdp") if isinstance(mesh, Mesh) else 0
    per = n_rows // n
    return slice(i * per, (i + 1) * per)
