"""Tensor parallelism over ``tp``: the exchange seam and Megatron's f and g.

The JAX package has no module here: its parameters carry ``tp`` in their
shardings (``heads``, ``kv_heads``, ``mlp`` and ``vocab`` on ``tp``,
``parallel/sharding.py``) and XLA inserts the collectives. The port's Llama
runs each decoder layer on its local head shard instead
(``models/llama.py``), with the collectives explicit:

- :func:`copy_to_tp` before each column-parallel product (``wq``, ``wk``,
  ``wv``, ``w_gate``, ``w_up``, ``lm_head``): identity forward, all-reduce of
  the input's gradient backward (each rank's gradient covers its own columns
  only);
- :func:`reduce_from_tp` after each row-parallel product (``wo``,
  ``w_down``) and after the vocab-sharded embedding lookup: all-reduce
  forward, identity backward;
- :func:`gather_from_tp` on the ``lm_head`` logits: all-gather on the last
  dim forward; backward keeps this rank's slice. Every tp rank computes the
  same loss from the same full logits, so its gradient is already whole: a
  reduce-scatter there would multiply every ``lm_head`` gradient by ``tp``.

The exchange is one seam, as ``ops/ring_attention.py``'s: an object with
``index``, ``size``, ``all_reduce(t)`` (a sum, returning a new tensor) and
``all_gather(t, dim)``. :class:`GroupTP` is the package's, over a process
group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class GroupTP:
    """The tp exchange over a process group, ranks in group order. gloo
    serves CPU tensors, NCCL CUDA tensors."""

    def __init__(self, group):
        self.group = group
        self.index = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        out = t.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.all_reduce(grad), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.width = tp, x.shape[-1]
        return tp.all_gather(x, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.tp.index * ctx.width, ctx.width), None


def copy_to_tp(x: torch.Tensor, tp) -> torch.Tensor:
    """Identity; the backward sums the gradient over the tp ranks."""
    return _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp) -> torch.Tensor:
    """The sum of ``x`` over the tp ranks; the backward is the identity."""
    return _ReduceFromTP.apply(x, tp)


def gather_from_tp(x: torch.Tensor, tp) -> torch.Tensor:
    """The tp ranks' ``x`` joined on the last dim, in rank order; the
    backward keeps this rank's slice."""
    return _GatherFromTP.apply(x, tp)
