"""Ring attention over the ``sp`` axis (port of
spatialvla_tpu/parallel/ring_attention.py).

The sequence is cut into n equal shards. Each q shard stays where it is
while the K/V shards travel around the ring, n - 1 rotations; every visit
runs the flash forward kernel (ops/flash_attention.py, TPU kernel #4) in the
visiting shard's key frame, with ``prefix - k_start``, ``valid - k_start``
and ``q_off - k_start``, and the partials merge by their log-sum-exps. A
visit's rows with no allowed key are kept out of the merge
(``_valid_rows``): the kernel gives such rows a finite LSE. The backward is
the standard ring: each visit runs the dq and dk/dv kernels (#5) against the
merged output and LSE, dQ accumulates where it is, and the dK/dV
accumulators travel with their K/V shard, n rotations, to arrive home.

The rotation goes through a transport: the ``sp`` process group of a
``Mesh`` (one shard a rank, ``batch_isend_irecv`` to rank + 1 and from
rank - 1), or a ``LocalMesh`` ring, where one process holds all n shards and
a rotation moves its list by one. One loop over "the shards this process
holds" serves both, so both run the same arithmetic and the same launches:
n visits a shard, n * n forward launches a call over the whole ring, and
as many of each backward kernel.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..ops.flash_attention import (attention_delta, flash_attention_bwd_dkv,
                                   flash_attention_bwd_dq, flash_attention_with_lse)
from .mesh import LocalMesh, Mesh


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

class LocalRing:
    """All n shards in this process; slot j holds ring position j."""

    def __init__(self, n: int):
        self.n = n
        self.held = list(range(n))

    def rotate(self, slots: List[tuple]) -> List[tuple]:
        """Slot j takes what slot j - 1 held."""
        return slots[-1:] + slots[:-1]


class GroupRing:
    """One shard a rank of the process group ``group`` (ring position = the
    rank's index in it)."""

    def __init__(self, group, index: int):
        dist = torch.distributed
        ranks = dist.get_process_group_ranks(group)
        self.n, self.group, self.held = len(ranks), group, [index]
        self.next, self.prev = ranks[(index + 1) % self.n], ranks[(index - 1) % self.n]

    def rotate(self, slots: List[tuple]) -> List[tuple]:
        """Sends this rank's tensors to the next rank and takes the previous
        rank's, all in one batch."""
        if self.n == 1:
            return slots
        dist = torch.distributed
        (sent,) = slots
        sent = tuple(t.contiguous() for t in sent)
        got = tuple(torch.empty_like(t) for t in sent)
        ops = [dist.P2POp(dist.isend, t, self.next, self.group) for t in sent]
        ops += [dist.P2POp(dist.irecv, t, self.prev, self.group) for t in got]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [got]


def ring_of(mesh, axis_name: str = "sp"):
    """The transport of ``mesh``'s ``axis_name`` axis."""
    if isinstance(mesh, LocalMesh):
        return LocalRing(mesh.shape[axis_name])
    if isinstance(mesh, Mesh):
        return GroupRing(mesh.group(axis_name), mesh.index(axis_name))
    raise TypeError(f"ring attention takes a Mesh or a LocalMesh, not {type(mesh).__name__}")


def seq_shard(mesh, T: int, axis_name: str = "sp") -> Tuple[int, int]:
    """[start, stop) of the sequence positions this process holds: all T for
    a ``LocalMesh``, its 1/n for a ``Mesh``."""
    if isinstance(mesh, LocalMesh):
        return 0, T
    n = mesh.shape[axis_name]
    if T % n:
        raise ValueError(f"sequence {T} not divisible by {axis_name}={n}")
    i = mesh.index(axis_name)
    return i * (T // n), (i + 1) * (T // n)


# ---------------------------------------------------------------------------
# partial merging
# ---------------------------------------------------------------------------

def _valid_rows(q_pos, prefix, valid, window, causal, k_start: int, k_len: int):
    """(B, Tq) bool: does a q row have ANY allowed key in the global key
    interval [k_start, k_start + k_len)? (ring_attention.py:48-68)"""
    qp = q_pos[None, :]
    if causal:
        hi = torch.minimum(torch.maximum(prefix[:, None], qp + 1), valid[:, None])
    else:
        hi = valid[:, None].expand(-1, qp.shape[1])
    lo = (qp - (window - 1)).clamp_min(0) if window is not None else torch.zeros_like(qp)
    return lo.clamp_min(k_start) < hi.clamp_max(k_start + k_len)


def _merge(out_a, lse_a, out_b, lse_b, valid_b):
    """Two normalized partials merged by their LSEs (ring_attention.py:71-88):
    out (B, Tq, Nq, D) fp32, lse (B, Nq, Tq, 1) fp32, valid_b (B, Tq)."""
    lse_b = torch.where(valid_b[:, None, :, None], lse_b, float("-inf"))
    m = torch.maximum(lse_a, lse_b)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    wa, wb = torch.exp(lse_a - m_safe), torch.exp(lse_b - m_safe)
    den = wa + wb
    lse = torch.where(den > 0, m_safe + torch.log(torch.where(den > 0, den, 1.0)),
                      float("-inf"))
    den_safe = torch.where(den == 0, 1.0, den)
    to_btn1 = lambda w: w[..., 0].transpose(1, 2)[..., None]  # noqa: E731
    return (out_a * to_btn1(wa) + out_b * to_btn1(wb)) / to_btn1(den_safe), lse


# ---------------------------------------------------------------------------
# forward and backward over the shards this process holds
# ---------------------------------------------------------------------------

def _visits(ring, Tq: int, Tk: int):
    """For each visit i, for each held slot: (slot, q_off, k_start) in the
    visiting shard's frame."""
    for i in range(ring.n):
        yield i, [(slot, j * Tq, ((j - i) % ring.n) * Tk) for slot, j in enumerate(ring.held)]


def _ring_forward(ring, qs, ks, vs, prefix, valid, kw):
    B, Tq, Nq, D = qs[0].shape
    Tk = ks[0].shape[1]
    dev = qs[0].device
    outs = [torch.zeros((B, Tq, Nq, D), dtype=torch.float32, device=dev) for _ in qs]
    lses = [torch.full((B, Nq, Tq, 1), float("-inf"), device=dev) for _ in qs]
    kv = list(zip(ks, vs))
    for i, visits in _visits(ring, Tq, Tk):
        for slot, q0, k_start in visits:
            k, v = kv[slot]
            q_off = torch.full((B,), q0 - k_start, dtype=torch.int32, device=dev)
            o, lse = flash_attention_with_lse(qs[slot], k, v, prefix - k_start, valid - k_start,
                                              q_off, **kw)
            q_pos = torch.arange(q0, q0 + Tq, device=dev)
            rows = _valid_rows(q_pos, prefix, valid, kw["window"], kw["causal"], k_start, Tk)
            outs[slot], lses[slot] = _merge(outs[slot], lses[slot], o.float(), lse, rows)
        if i + 1 < ring.n:
            kv = ring.rotate(kv)
    # rows with no allowed key anywhere take the kernel's finite LSE, so the
    # backward's recompute stays free of NaN (ring_attention.py:120-122)
    lses = [torch.where(torch.isfinite(l), l, 0.0) for l in lses]
    return [o.to(qs[0].dtype) for o in outs], lses


def _ring_backward(ring, qs, ks, vs, outs, lses, dos, prefix, valid, kw):
    B, Tq = qs[0].shape[:2]
    Tk = ks[0].shape[1]
    dev = qs[0].device
    deltas = [attention_delta(o, do) for o, do in zip(outs, dos)]
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=dev) for q in qs]
    acc = [(torch.zeros(k.shape, dtype=torch.float32, device=dev),
            torch.zeros(k.shape, dtype=torch.float32, device=dev)) for k in ks]
    kv = list(zip(ks, vs))
    for i, visits in _visits(ring, Tq, Tk):
        for slot, q0, k_start in visits:
            k, v = kv[slot]
            q_off = torch.full((B,), q0 - k_start, dtype=torch.int32, device=dev)
            args = (qs[slot], k, v, dos[slot], lses[slot], deltas[slot], prefix - k_start,
                    valid - k_start, q_off)
            dq[slot] += flash_attention_bwd_dq(*args, **kw).float()
            dk, dv = flash_attention_bwd_dkv(*args, **kw)
            acc[slot] = (acc[slot][0] + dk.float(), acc[slot][1] + dv.float())
        # the dK/dV accumulators rotate with their K/V shard: after n
        # rotations each is home; K/V need only the first n - 1
        if i + 1 < ring.n:
            moved = ring.rotate([a + b for a, b in zip(acc, kv)])
            acc, kv = [m[:2] for m in moved], [m[2:] for m in moved]
        else:
            acc = ring.rotate(acc)
    dtype = qs[0].dtype
    return ([g.to(dtype) for g in dq], [a[0].to(dtype) for a in acc],
            [a[1].to(dtype) for a in acc])


def _split(t: torch.Tensor, n: int) -> List[torch.Tensor]:
    return [c.contiguous() for c in t.chunk(n, dim=1)]


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, prefix, valid, ring, kw):
        n = len(ring.held)
        qs, ks, vs = _split(q, n), _split(k, n), _split(v, n)
        outs, lses = _ring_forward(ring, qs, ks, vs, prefix, valid, kw)
        out = torch.cat(outs, 1)
        ctx.save_for_backward(q, k, v, out, torch.cat(lses, 2), prefix, valid)
        ctx.ring, ctx.kw = ring, kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, prefix, valid = ctx.saved_tensors
        n = len(ctx.ring.held)
        lses = [c.contiguous() for c in lse.chunk(n, dim=2)]
        dq, dk, dv = _ring_backward(ctx.ring, _split(q, n), _split(k, n), _split(v, n),
                                    _split(out, n), lses, _split(dout, n), prefix, valid,
                                    ctx.kw)
        return torch.cat(dq, 1), torch.cat(dk, 1), torch.cat(dv, 1), None, None, None, None


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         prefix_lens: torch.Tensor, valid_lens: torch.Tensor, *, mesh,
                         axis_name: str = "sp", scale: float = 1.0,
                         logit_softcap: Optional[float] = None, window: Optional[int] = None,
                         causal: bool = True) -> torch.Tensor:
    """Sequence-parallel flash attention, differentiable.

    q (B, T, Nq, D), k / v (B, T, Nkv, D) hold the sequence positions this
    process holds (``seq_shard``): all T, cut into ``mesh.sp`` shards, on a
    ``LocalMesh``; this rank's shard on a ``Mesh``. ``prefix_lens`` /
    ``valid_lens`` (B,) are global. Returns the output for the same
    positions, in q's dtype."""
    ring = ring_of(mesh, axis_name)
    n = len(ring.held)
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(f"sequence {q.shape[1]} not divisible by {axis_name}={n}")
    kw = dict(scale=scale, logit_softcap=logit_softcap, window=window, causal=causal)
    lens = [t.to(torch.int32).contiguous() for t in (prefix_lens, valid_lens)]
    return _RingAttention.apply(q, k, v, *lens, ring, kw)
