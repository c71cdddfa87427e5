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
  block, the single device's product bit for bit (inference only);
* :func:`isend` / :func:`irecv`: the point-to-point transfers of the
  pipeline schedule (``parallel/pipeline.py``).

Under gloo a CUDA tensor crosses through host memory (gloo's ``send`` and
``recv`` take host buffers only); NCCL gets the device tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


class Pending:
    """An issued point-to-point transfer: :meth:`wait` blocks until it is
    done and returns the received tensor (None for a send)."""

    def __init__(self, work, buf: torch.Tensor, out: Optional[torch.Tensor] = None):
        self.work, self.buf, self.out = work, buf, out

    def wait(self) -> Optional[torch.Tensor]:
        self.work.wait()
        if self.out is not None and self.out is not self.buf:
            self.out.copy_(self.buf)
        return self.out


def _host_staged(t: torch.Tensor, group) -> bool:
    """Whether a transfer of ``t`` over ``group`` goes through host memory:
    a CUDA tensor under gloo, whose ``send``/``recv`` take host buffers."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _send_buffer(t: torch.Tensor, group) -> torch.Tensor:
    """What goes on the wire for ``t``: a contiguous host copy under gloo
    (for a CUDA tensor), else ``t`` itself, contiguous."""
    t = t.detach().contiguous()
    return t.cpu() if _host_staged(t, group) else t


def _recv_buffer(out: torch.Tensor, group) -> torch.Tensor:
    """Where a transfer into ``out`` lands: a host buffer under gloo (for a
    CUDA ``out``), a contiguous one for a strided ``out``, else ``out``;
    copy it into ``out`` once the transfer is done."""
    if _host_staged(out, group):
        return torch.empty(out.shape, dtype=out.dtype)
    return out if out.is_contiguous() else torch.empty(out.shape, dtype=out.dtype, device=out.device)


def isend(t: torch.Tensor, peer: int, group, tag: int = 0) -> Pending:
    """Send ``t`` to rank ``peer`` of ``group``; wait on the result before
    ``t`` changes. Under gloo a CUDA tensor is copied to host memory first
    (gloo's point-to-point calls take host buffers only); NCCL sends the
    device tensor. Errors propagate."""
    buf = _send_buffer(t, group)
    return Pending(dist.isend(buf, dist.get_global_rank(group, peer), group=group, tag=tag), buf)


def irecv(out: torch.Tensor, peer: int, group, tag: int = 0) -> Pending:
    """Receive into ``out`` from rank ``peer`` of ``group``; ``wait()``
    returns ``out``. Under gloo a CUDA ``out`` is received into a host
    buffer (and a strided one into a contiguous buffer) and copied over when
    the transfer is done."""
    buf = _recv_buffer(out, group)
    return Pending(dist.irecv(buf, dist.get_global_rank(group, peer), group=group, tag=tag), buf, out)


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
    zeros at the group's edges. The four transfers are one group
    (``batch_isend_irecv``: NCCL must not see two neighbours each send
    first); under gloo a CUDA tensor's buffers are in host memory."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    from_left, from_right = torch.zeros_like(send_right), torch.zeros_like(send_left)
    ops, landed = [], []
    for peer, send, out in ((rank + 1, send_right, from_right), (rank - 1, send_left, from_left)):
        if 0 <= peer < size:
            buf, g = _recv_buffer(out, group), dist.get_global_rank(group, peer)
            ops += [dist.P2POp(dist.isend, _send_buffer(send, group), g, group),
                    dist.P2POp(dist.irecv, buf, g, group)]
            landed.append((out, buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for out, buf in landed:
        if buf is not out:
            out.copy_(buf)
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


__all__ = ["Pending", "copy_to_group", "reduce_from_group", "halo_exchange", "irecv", "isend", "row_parallel_int8"]
