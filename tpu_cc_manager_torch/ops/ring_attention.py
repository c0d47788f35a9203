"""Ring attention: causal attention with the sequence split over a ring of ranks.

Port of ``tpu_cc_manager/ops/ring_attention.py``. Rank i of an n-rank ring
holds the i-th contiguous chunk of the sequence: q (B, H, S/n, D) and k/v
(B, KV, S/n, D), covering positions [i·S/n, (i+1)·S/n). K/V chunks pass
around the ring (rank i sends to i+1 and receives from i-1) while each rank
keeps its q, and the partial results merge with the online-softmax
recurrence. K/V stay KV-head-shaped: the block math works in the grouped
layout q (B, KV, G, S/n, D), so ring traffic is 1/G of the repeated form.

Ring step r on rank i holds the chunk that started on rank src = (i - r) % n.
Chunks with src > i lie wholly in this rank's future, so their attention
math is skipped; the exchange itself runs at every step on every rank.

- :func:`ring_spec`, :func:`_block_attn` and :func:`_merge` are the JAX
  functions of the same names;
- :func:`ring_forward` and :func:`ring_backward` are one rank's forward and
  backward; :func:`ring_attention` joins them in an autograd Function.

The block math is plain PyTorch, as the reference's is XLA einsums: scores,
softmax and the PV product in f32. The gradient is an explicit backward, not
autograd through the exchange. With the skip, the ranks' graphs differ, and a
rank that never reaches the backward of a hop would leave its peer blocked;
and NCCL matches point-to-point operations by order, not by tag. So the
backward makes its exchanges in one fixed order on every rank: it rebuilds
each block's probabilities from the saved ``lse`` (as K3/K4 do), and for
r = 0..n-1 adds the held chunk's dq, dk and dv contributions (when that chunk
is not in the future), then shifts (k, v, dk, dv) to the next rank; the last
shift carries dk and dv only. After n shifts every rank holds its own
chunk's finished dk and dv, accumulated in f32 on the way.

The exchange is one seam: a ring object with ``index``, ``size`` and
``shift(tensors) -> tensors``, which sends to the next rank and receives from
the previous one. :class:`GroupRing` is the package's, over a process group.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

NEG_INF = -1e30


def ring_spec(sizes, axis: str, B: int, H: int, KV: int) -> tuple:
    """Where (B, heads, S, D) tensors lie on a mesh of ``sizes`` (axis name
    -> size, in mesh order: ``parallel.mesh.mesh_sizes`` of a DeviceMesh):
    sequence on ``axis``, batch on every other axis but ``tp``, heads on
    ``tp``. The batch axes are dropped when they do not divide ``B``, the
    head axis when ``tp`` does not divide ``H`` and ``KV``. Returns the
    per-dim entries of the JAX ``PartitionSpec``."""
    batch_axes = tuple(a for a in sizes if a not in (axis, "tp"))
    if batch_axes and B % math.prod(sizes[a] for a in batch_axes):
        batch_axes = ()
    head_axis = "tp" if ("tp" in sizes and axis != "tp") else None
    if head_axis and (KV % sizes["tp"] or H % sizes["tp"]):
        head_axis = None
    # One batch axis is written bare, as the PartitionSpec normalises it.
    batch = batch_axes[0] if len(batch_axes) == 1 else (batch_axes or None)
    return (batch, head_axis, axis, None)


def _scores(q, k, q_off: int, k_off: int, scale: float):
    """f32 scores of grouped q (B, KV, G, S, D) against k (B, KV, T, D),
    masked to NEG_INF where key position > query position; and the mask."""
    s = torch.einsum("bkgsd,bktd->bkgst", q.float(), k.float()) * scale
    q_pos = q_off + torch.arange(q.shape[3], device=q.device)
    k_pos = k_off + torch.arange(k.shape[2], device=q.device)
    mask = k_pos[None, :] <= q_pos[:, None]
    return torch.where(mask, s, NEG_INF), mask


def _block_attn(q, k, v, q_off: int, k_off: int, scale: float):
    """Partial (unnormalised-softmax) attention of grouped q (B, KV, G, S, D)
    against one K/V chunk (B, KV, T, D), causal over absolute positions.
    Returns (m, l, acc) in f32."""
    s, mask = _scores(q, k, q_off, k_off, scale)
    m = s.amax(dim=-1, keepdim=True)
    # Guard fully-masked rows (m == NEG_INF) against exp overflow to nan.
    m_safe = torch.clamp(m, min=-1e29)
    p = torch.where(mask, torch.exp(s - m_safe), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return m_safe, l, acc


def _merge(m1, l1, acc1, m2, l2, acc2):
    """Merge two online-softmax partials."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return m, a1 * l1 + a2 * l2, a1 * acc1 + a2 * acc2


def _grouped(x, kv: int):
    """(B, H, S, D) -> (B, KV, G, S, D): head h = kv_head * G + g."""
    B, H, S, D = x.shape
    return x.reshape(B, kv, H // kv, S, D)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"ring attention wants q (B, H, S, D) and k, v (B, KV, S, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} differ in B, S or D")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"{q.shape[1]} query heads not divisible by {k.shape[1]} kv heads")


def ring_forward(q, k, v, ring):
    """One rank's forward: ``(out, lse)``, out (B, H, S, D) in q's dtype and
    lse = m + log(l) (B, KV, G, S, 1) in f32, for this rank's chunk."""
    _check(q, k, v)
    B, H, S, D = q.shape
    idx, n = ring.index, ring.size
    scale = 1.0 / D**0.5
    qg = _grouped(q, k.shape[1])
    m, l, acc = _block_attn(qg, k, v, idx * S, idx * S, scale)
    k_cur, v_cur = k, v
    for r in range(1, n):
        # The exchange runs at every hop on every rank; only the math of a
        # chunk from this rank's future is skipped.
        k_cur, v_cur = ring.shift((k_cur, v_cur))
        src = (idx - r) % n
        if src <= idx:
            m, l, acc = _merge(m, l, acc, *_block_attn(qg, k_cur, v_cur, idx * S, src * S, scale))
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype).reshape(B, H, S, D)
    return out, m + torch.log(l)


def _block_grads(qg, k, v, dog, lse, delta, q_off: int, k_off: int, scale: float):
    """f32 (dq, dk, dv) contributions of one K/V chunk, its probabilities
    rebuilt from ``lse``; ``delta`` = rowsum(dO * O)."""
    s, mask = _scores(qg, k, q_off, k_off, scale)
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)
    ds = p * (torch.einsum("bkgsd,bktd->bkgst", dog, v.float()) - delta)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg.float()) * scale
    return dq, dk, dv


def ring_backward(q, k, v, out, lse, dout, ring):
    """One rank's backward from :func:`ring_forward`'s ``out`` and ``lse``:
    ``(dq, dk, dv)`` of this rank's chunk, in the inputs' dtypes. Every rank
    makes the same n exchanges in the same order."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    idx, n = ring.index, ring.size
    scale = 1.0 / D**0.5
    qg = _grouped(q, KV)
    dog = _grouped(dout, KV).float()
    delta = (dog * _grouped(out, KV).float()).sum(dim=-1, keepdim=True)
    dq = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    k_cur, v_cur = k, v
    for r in range(n):
        src = (idx - r) % n  # the chunk held now, with its running dk and dv
        if src <= idx:
            gq, gk, gv = _block_grads(qg, k_cur, v_cur, dog, lse, delta, idx * S, src * S, scale)
            dq += gq
            dk += gk
            dv += gv
        if r < n - 1:
            k_cur, v_cur, dk, dv = ring.shift((k_cur, v_cur, dk, dv))
        elif n > 1:
            dk, dv = ring.shift((dk, dv))
    return dq.to(q.dtype).reshape(B, H, S, D), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """Forward :func:`ring_forward`, saving q, k, v, out and lse; backward
    :func:`ring_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, ring):
        out, lse = ring_forward(q, k, v, ring)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = ring
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*ring_backward(q, k, v, out, lse, dout, ctx.ring), None)


def ring_attention(q, k, v, ring):
    """Causal attention of this rank's chunk against the whole sequence.
    q: (B, H, S/n, D), k/v: (B, KV, S/n, D) with H divisible by KV; returns
    (B, H, S/n, D). ``ring`` is a :class:`GroupRing` (or any object with its
    ``index``, ``size`` and ``shift``)."""
    return _RingAttention.apply(q, k, v, ring)


class GroupRing:
    """The exchange over a process group, ranks in group order:
    :meth:`shift` sends to the next rank and receives from the previous one
    in one ``batch_isend_irecv``, sends first and in the same order on every
    rank. gloo serves CPU tensors, NCCL CUDA tensors."""

    def __init__(self, group):
        self.group = group
        self.index = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self._next = dist.get_global_rank(group, (self.index + 1) % self.size)
        self._prev = dist.get_global_rank(group, (self.index - 1) % self.size)

    def shift(self, tensors):
        sends = [t.contiguous() for t in tensors]
        received = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.isend, t, self._next, self.group, tag)
               for tag, t in enumerate(sends)]
        ops += [dist.P2POp(dist.irecv, t, self._prev, self.group, tag)
                for tag, t in enumerate(received)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return received
