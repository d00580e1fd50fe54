"""GPipe pipeline parallelism over the ``pipe`` axis (port of
spatialvla_tpu/parallel/pipeline.py).

The batch splits into m microbatches and the layer stack into S stages. At
tick t (m + S - 1 of them) stage s works on microbatch t - s and hands its
output to stage s + 1; a bubble tick (t - s outside [0, m)) computes and
sends nothing. The last stage's outputs are the result, replicated over the
pipe axis as JAX's ``psum`` does (pipeline.py:136-137).

The backward is the reverse pipeline, run by hand in the autograd
function's backward: ticks in reverse order, where the backward of a
hand-off is a receive of its gradient; each stage's tick replays its saved
graph (``torch.autograd.grad``), so a stage holds its microbatches'
activations, as GPipe does. The replicated output's gradient is summed over
the pipe axis first (the transpose of JAX's ``psum``).

Two transports: the ``pipe`` process group of a ``Mesh`` (one stage a
rank, its weights only), or a ``LocalMesh`` pipe, where one process runs all
S stages in turn and a hand-off moves a tensor from one stage's slot to the
next. One loop over "the stages this process holds" serves both.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from ..utils.tree import iter_leaves, map_with_paths
from .mesh import LocalMesh, Mesh


class LocalPipe:
    """All S stages in this process."""

    def __init__(self, S: int):
        self.S = S
        self.held = list(range(S))

    def forward_hand_off(self, sent: Dict[int, torch.Tensor], t: int, like) -> Dict[int, torch.Tensor]:
        """{stage: activation it takes at tick t + 1} from {stage: output of tick t}."""
        return {s + 1: y for s, y in sent.items() if s + 1 < self.S}

    def backward_hand_off(self, sent: Dict[int, torch.Tensor], t: int, like):
        """{stage: gradient of its tick t - 1 output} from {stage: gradient
        of its tick t input}."""
        return {s - 1: g for s, g in sent.items() if s > 0}

    def replicate(self, out, like):
        return out

    def sum_replicas(self, g):
        return g


class GroupPipe:
    """One stage a rank of the process group ``group`` (stage = the rank's
    index in it)."""

    def __init__(self, group, index: int, m: int):
        self.group = group
        self.ranks = torch.distributed.get_process_group_ranks(group)
        self.S, self.held, self.m = len(self.ranks), [index], m

    def _active(self, s: int, t: int) -> bool:
        return 0 <= s < self.S and 0 <= t - s < self.m

    def _exchange(self, sent: Dict[int, torch.Tensor], to: int, receive: bool, like):
        """Sends this stage's tensor (if any) to stage + ``to``, takes one
        from stage - ``to`` when ``receive``; one batch."""
        dist = torch.distributed
        (s,) = self.held
        ops, got = [], None
        if s in sent:
            ops.append(dist.P2POp(dist.isend, sent[s].contiguous(), self.ranks[s + to],
                                  self.group))
        if receive:
            got = torch.empty(like.shape, dtype=like.dtype, device=like.device)
            ops.append(dist.P2POp(dist.irecv, got, self.ranks[s - to], self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return {} if got is None else {s: got}

    def forward_hand_off(self, sent, t, like):
        (s,) = self.held
        sent = {k: v for k, v in sent.items() if k + 1 < self.S}
        return self._exchange(sent, 1, s > 0 and self._active(s, t + 1), like)

    def backward_hand_off(self, sent, t, like):
        (s,) = self.held
        sent = {k: v for k, v in sent.items() if k > 0}
        return self._exchange(sent, -1, s + 1 < self.S and self._active(s, t - 1), like)

    def replicate(self, out, like):
        """The last stage's output on every stage."""
        if out is None:
            out = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        torch.distributed.broadcast(out, self.ranks[-1], group=self.group)
        return out

    def sum_replicas(self, g):
        g = g.contiguous().clone()
        torch.distributed.all_reduce(g, group=self.group)
        return g


def pipe_of(mesh, m: int, axis_name: str = "pipe"):
    if isinstance(mesh, LocalMesh):
        return LocalPipe(mesh.shape[axis_name])
    if isinstance(mesh, Mesh):
        return GroupPipe(mesh.group(axis_name), mesh.index(axis_name), m)
    raise TypeError(f"pipeline_apply takes a Mesh or a LocalMesh, not {type(mesh).__name__}")


class _Plan:
    """What the autograd function needs besides its tensors."""

    def __init__(self, stage_fn, pipe, m, aux, trees):
        self.stage_fn, self.pipe, self.m, self.aux, self.trees = stage_fn, pipe, m, aux, trees


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan: _Plan, *flat):
        pipe, m, S = plan.pipe, plan.m, plan.pipe.S
        xm = x.detach().chunk(m, 0)
        aux = [{k: v.chunk(m, 0)[i] for k, v in plan.aux.items()} for i in range(m)]
        # each held stage's weights as leaves of their own graph
        leaves, trees, at = {}, {}, 0
        for s in pipe.held:
            n = len(list(iter_leaves(plan.trees[s])))
            leaves[s] = [p.detach().requires_grad_(p.requires_grad) for p in flat[at:at + n]]
            it = iter(leaves[s])
            trees[s] = map_with_paths(lambda _, __: next(it), plan.trees[s])
            at += n
        saved, outs, inbox = {}, [None] * m, {}
        for t in range(m + S - 1):
            sent = {}
            for s in pipe.held:
                mb = t - s
                if not 0 <= mb < m:
                    continue  # a bubble tick computes nothing
                x_in = (xm[mb] if s == 0 else inbox.pop(s)).detach().requires_grad_()
                with torch.enable_grad():
                    y = plan.stage_fn(trees[s], x_in, aux[mb])
                saved[(s, t)] = (x_in, y)
                if s == S - 1:
                    outs[mb] = y.detach()
                else:
                    sent[s] = y.detach()
            inbox = pipe.forward_hand_off(sent, t, xm[0])
        last = torch.cat(outs, 0) if S - 1 in pipe.held else None
        ctx.plan, ctx.saved, ctx.leaves = plan, saved, leaves
        return pipe.replicate(last, x)

    @staticmethod
    def backward(ctx, grad_out):
        plan, saved, leaves = ctx.plan, ctx.saved, ctx.leaves
        pipe, m, S = plan.pipe, plan.m, plan.pipe.S
        gm = pipe.sum_replicas(grad_out).chunk(m, 0)
        grads = {s: [None] * len(leaves[s]) for s in pipe.held}
        gx = [torch.zeros_like(g) for g in gm]
        inbox = {}
        for t in reversed(range(m + S - 1)):
            sent = {}
            for s in pipe.held:
                if (s, t) not in saved:
                    continue
                x_in, y = saved.pop((s, t))
                gy = gm[t - s] if s == S - 1 else inbox.pop(s)
                params = [p for p in leaves[s] if p.requires_grad]
                got = torch.autograd.grad(y, [x_in] + params, gy, allow_unused=True)
                it = iter(got[1:])
                for i, p in enumerate(leaves[s]):
                    if not p.requires_grad:
                        continue
                    g = next(it)
                    if g is not None:
                        grads[s][i] = g if grads[s][i] is None else grads[s][i] + g
                if s == 0:
                    gx[t] = got[0]
                else:
                    sent[s] = got[0]
            inbox = pipe.backward_hand_off(sent, t, gm[0])
        flat = [g for s in pipe.held for g in grads[s]]
        return (torch.cat(gx, 0), None, *flat)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor, Dict[str, torch.Tensor]], torch.Tensor],
                   stage_params: List[Any], x: torch.Tensor, aux: Dict[str, torch.Tensor], *,
                   mesh, n_microbatches: int, axis_name: str = "pipe") -> torch.Tensor:
    """Runs ``x`` (B, ...) through S pipelined stages and returns the last
    stage's output, on every stage (pipeline.py:49-149).

    ``stage_fn(params_s, x_mb, aux_mb) -> y_mb`` applies one stage to one
    microbatch and keeps its shape. ``stage_params[s]`` is stage s's tree of
    tensors (on a ``Mesh`` only this rank's entry is read; the others may be
    None). ``aux`` holds per-example tensors (positions, lengths), leading
    dim B, indexed by microbatch and never handed off."""
    m = n_microbatches
    B = x.shape[0]
    if B % m:
        raise ValueError(f"batch {B} not divisible by {m} microbatches")
    pipe = pipe_of(mesh, m, axis_name)
    trees = {s: stage_params[s] for s in pipe.held}
    flat = [p for s in pipe.held for _, p in iter_leaves(trees[s])]
    return _Pipeline.apply(x, _Plan(stage_fn, pipe, m, aux, trees), *flat)
