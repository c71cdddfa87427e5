"""Differentiable collectives of the tensor- and sequence-parallel layers.

``torch.distributed``'s calls have no autograd, and
``torch.distributed.nn.functional.all_reduce`` differentiates an all-reduce
as another all-reduce, which counts a replicated loss once per rank. The
model's layers need the Megatron pair and the halo exchange instead:

* :func:`copy_to_group`: identity forward, sum of the gradients over the
  group backward (before the column-parallel products, and on the q/k gains
  that each rank applies to its own heads);
* :func:`reduce_from_group`: sum over the group forward, identity backward
  (after the row-parallel products);
* :func:`halo_exchange`: each rank sends its last rows to the next rank and
  its first rows to the one before; the backward sends the halo gradients
  back the other way (the JAX ``ppermute``'s VJP is the inverse
  permutation);
* :func:`row_parallel_int8`: the int8 out-projection of a tensor-parallel
  block, the single device's product bit for bit (inference only).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group`` in the backward."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the gradient passed through."""
    return _ReduceFromGroup.apply(x, group)


def _exchange(send_right: torch.Tensor, send_left: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank i sends ``send_right`` to rank i + 1 and ``send_left`` to rank
    i - 1 of ``group``; returns what it receives ``(from_left, from_right)``,
    zeros at the group's edges."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    send_right, send_left = send_right.contiguous(), send_left.contiguous()
    from_left, from_right = torch.zeros_like(send_right), torch.zeros_like(send_left)
    ops = []
    if rank + 1 < size:
        peer = dist.get_global_rank(group, rank + 1)
        ops += [dist.P2POp(dist.isend, send_right, peer, group), dist.P2POp(dist.irecv, from_right, peer, group)]
    if rank > 0:
        peer = dist.get_global_rank(group, rank - 1)
        ops += [dist.P2POp(dist.isend, send_left, peer, group), dist.P2POp(dist.irecv, from_left, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_left, from_right


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, head, tail, group):
        ctx.group = group
        return _exchange(tail, head, group)

    @staticmethod
    def backward(ctx, g_from_left, g_from_right):
        # The left neighbour's tail came in as from_left: its gradient goes
        # back to the left, and from_right's to the right.
        g_head, g_tail = _exchange(g_from_right, g_from_left, ctx.group)
        return g_head, g_tail, None


def halo_exchange(x: torch.Tensor, width: int, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(left neighbour's last width rows, right neighbour's first width
    rows)`` of ``x`` along axis 1, zeros at the edges of ``group``;
    differentiable in ``x``. Booleans travel as bytes."""
    head, tail = x[:, :width], x[:, -width:]
    if x.dtype == torch.bool:
        left, right = _exchange(tail.to(torch.uint8), head.to(torch.uint8), group)
        return left.bool(), right.bool()
    return _HaloExchange.apply(head, tail, group)


@torch.no_grad()
def row_parallel_int8(x: torch.Tensor, w_int8: torch.Tensor, w_scale: torch.Tensor, group) -> torch.Tensor:
    """``int8_linear`` of a row whose channels are split over ``group``:
    ``x [..., K/n]`` and ``w_int8 [N, K/n]`` are this rank's columns,
    ``w_scale [N]`` whole. Each token is quantized with the absmax of its
    whole row (the maximum over the group), and the int32 partial products
    are summed over the group before they are scaled, so the result is the
    single device's ``int8_linear`` bit for bit on every rank."""
    from vitok_torch.ops import quant as q8

    x32 = x.float()
    amax = x32.abs().amax(-1, keepdim=True)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(q8._div(amax, 127.0), q8._SCALE_FLOOR)
    acc = q8._int_mm(q8.quantize_by(x32, scale).reshape(-1, x.shape[-1]), w_int8)
    dist.all_reduce(acc, group=group)
    return q8.dequantize_product(acc, scale, w_scale, x.dtype).reshape(*x.shape[:-1], w_int8.shape[0])


__all__ = ["copy_to_group", "reduce_from_group", "halo_exchange", "row_parallel_int8"]
