"""Sharding: the model and the NaFlex batch laid over a ``(data, fsdp, model)`` mesh.

The port's counterpart of ``vitok_tpu/parallel/sharding.py``. The JAX
package annotates its parameter tree with ``NamedSharding``s and lets XLA
insert the collectives; here each axis of the mesh selects a PyTorch layer:

* ``model`` (tensor parallelism, the Megatron split): each block keeps its
  own heads and its own slice of the FFN hidden. qkv and fc1 are
  column-parallel, sliced slab by slab (q, k and v rows of the rank's heads;
  v and g rows of its hidden columns), so the local qkv is ``[B, N, 3C/tp]``
  in the kernels' layout for ``H/tp`` heads and the fused kernels run on it
  as they are; out and fc2 are row-parallel. The block's input gradient is
  summed over the group before the column-parallel products, the q/k gains'
  too, and the row-parallel partial sums are all-reduced once a block
  (:mod:`vitok_torch.parallel.comm`). A plain ``ColwiseParallel`` would
  split the fused ``[3C, C]`` weight's rows contiguously (rank 0 all of q
  and part of k), and the blocks read their weights inside ``forward``
  rather than calling the linears, so the slices are made here. The AE's
  blocks and the DiT's (whose adaLN ``mod`` stays whole) take the same
  plan. An int8 block (``Int8Linear``) slices qkv's codes and scales by
  the same rows and out's codes by columns, and keeps its FFN whole: #7
  and #8 quantize t with the absmax of its whole row of F' columns inside
  the kernel. Its out-projection quantizes with the whole row's absmax and
  sums the int32 partial products over the group, so the tensor-parallel
  int8 forward is the single device's bit for bit.
* ``fsdp``: FSDP2, one ``fully_shard`` a block and then the root, over the
  ``(data, fsdp)`` mesh (HSDP where ``data`` is there too).
* ``data`` alone: ``DistributedDataParallel``.
* ``pipe`` (with ``data`` only): each process keeps its stage's slice of
  the decoder blocks and the schedule of :mod:`vitok_torch.parallel.pipeline`
  reduces the gradients itself.

The optimizer, the EMA and the checkpoints work on each rank's local
tensors (a DTensor's local shard, a tensor-parallel slice); :class:`Layout`
gives the global gradient norm, whole matrices for Muon's Newton-Schulz,
and the full single-device state for a checkpoint.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from vitok_torch.parallel.mesh import DATA_AXIS, FSDP_AXIS, MODEL_AXIS, PIPE_AXIS, axis_size

# The block linears that tensor parallelism slices, and how: "slab3" keeps
# the rows of the rank's heads in each of the q, k and v slabs, "slab2" the
# rows of its hidden columns in each of the v and g slabs (SwiGLU), "cols"
# the input columns of its heads or hidden columns.
TP_LINEARS = {"attn.qkv_proj": "slab3", "ffn.fc1": "slab2", "attn.out_proj": "cols", "ffn.fc2": "cols"}
TP_INT8_LINEARS = {"attn.qkv_proj": "slab3", "attn.out_proj": "cols"}
_BLOCK_STACKS = ("encoder_blocks", "decoder_blocks", "blocks")  # the AE's, the DiT's


def _dtensor_cls():
    from torch.distributed.tensor import DTensor

    return DTensor


def local(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A DTensor's local shard (a view: in-place updates reach the DTensor),
    any other tensor as it is."""
    if t is not None and isinstance(t, _dtensor_cls()):
        return t.to_local()
    return t


def _tp_kind(name: str) -> Optional[str]:
    """How tensor parallelism slices parameter ``name`` (None: replicated)."""
    parts = name.split(".")
    if len(parts) == 5 and parts[0] in _BLOCK_STACKS and parts[-1] == "weight":
        return TP_LINEARS.get(".".join(parts[2:4]))
    return None


def ae_param_specs(mesh) -> Callable[[str, torch.Tensor], Tuple]:
    """``spec_for(name, tensor)``: per dimension of the parameter (torch's
    ``[out, in]`` orientation) the mesh axes that split it, outermost first,
    or None. FSDP2 splits dim 0 of every parameter over ``fsdp``; tensor
    parallelism splits the column-parallel weights' dim 0 (by slabs) and the
    row-parallel weights' dim 1 over ``model``; the rest is replicated."""
    fsdp = FSDP_AXIS if axis_size(mesh, FSDP_AXIS) else None
    tp = MODEL_AXIS if axis_size(mesh, MODEL_AXIS) else None

    def spec_for(name: str, tensor: torch.Tensor) -> Tuple:
        kind = _tp_kind(name) if tp else None
        dim0 = tuple(a for a in ((tp if kind in ("slab3", "slab2") else None), fsdp) if a)
        spec = [dim0 or None] + [None] * (tensor.dim() - 1)
        if kind == "cols":
            spec[1] = (tp,)
        return tuple(spec)

    return spec_for


def param_shardings(model: nn.Module, mesh) -> Dict[str, Tuple]:
    """Parameter name -> its :func:`ae_param_specs` spec."""
    spec_for = ae_param_specs(mesh)
    return {name: spec_for(name, p) for name, p in model.named_parameters()}


def replicated(mesh) -> list:
    """The placements of a tensor replicated over every axis of ``mesh``."""
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def batch_specs(mesh) -> Tuple[str, ...]:
    """The axes the batch rows split over: ``data`` and ``fsdp`` (both are
    data parallel for the inputs). ``model`` ranks share their rows."""
    return tuple(a for a in (DATA_AXIS, FSDP_AXIS) if axis_size(mesh, a))


def _coord(mesh, name: str) -> int:
    return mesh.get_local_rank(name) if axis_size(mesh, name) else 0


def data_rank(mesh) -> Tuple[int, int]:
    """``(rank, size)`` of this process among the batch shards of ``mesh``."""
    rank, size = 0, 1
    for a in batch_specs(mesh):
        n = axis_size(mesh, a)
        rank, size = rank * n + _coord(mesh, a), size * n
    return rank, size


def shard_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This process's rows of a global NaFlex batch: the batch axis split
    in contiguous blocks over ``data x fsdp`` (:func:`batch_specs`);
    metadata without a batch axis is kept. The loaders give each process
    its own rows already (rank-strided), so a training loop does not call
    this; tests and a global batch do."""
    rank, size = data_rank(mesh)
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape") and len(v.shape) >= 1:
            if v.shape[0] % size:
                raise ValueError(f"batch {k}: {v.shape[0]} rows do not split over {size} data shards")
            per = v.shape[0] // size
            out[k] = v[rank * per:(rank + 1) * per]
        else:
            out[k] = v
    return out


def _groups_over(mesh, axes: Sequence[str]):
    """The group over ``axes`` of ``mesh`` that holds this process: every
    such group is made (``new_group`` is collective), this one kept."""
    axes = [a for a in axes if axis_size(mesh, a)]
    if not axes:
        return None
    if len(axes) == 1:
        return mesh[axes[0]].get_group()
    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh.permute(*[names.index(a) for a in names if a not in axes],
                              *[names.index(a) for a in axes])
    ranks = ranks.reshape(-1, math.prod(axis_size(mesh, a) for a in axes))
    mine = None
    for row in ranks.tolist():
        group = dist.new_group(row)
        if dist.get_rank() in row:
            mine = group
    return mine


def _slab_rows(kind: str, rows: int, size: int, rank: int) -> torch.Tensor:
    """The row indices of a column-parallel weight with ``rows`` rows that
    tensor-parallel rank ``rank`` of ``size`` keeps."""
    slabs = 3 if kind == "slab3" else 2
    per = rows // slabs // size
    return torch.cat([torch.arange(s * rows // slabs + rank * per, s * rows // slabs + (rank + 1) * per)
                      for s in range(slabs)])


class Layout:
    """How a model lies over ``mesh``: the tensor-parallel slices, FSDP2's
    shards, the data-parallel wrapper, and the groups the train step
    reduces over. Made by :func:`shard_params`."""

    def __init__(self, mesh, model: nn.Module):
        self.mesh = mesh
        self.pipe_size = axis_size(mesh, PIPE_AXIS)
        self.pipe = self.pipe_size > 0
        if self.pipe:  # only data composes with pipe; other axes of size 1 select nothing
            from vitok_torch.parallel.pipeline import check_pipe_mesh

            check_pipe_mesh(mesh)
        self.stage = _coord(mesh, PIPE_AXIS)
        self.pipe_group = mesh[PIPE_AXIS].get_group() if self.pipe else None
        self.tp_size = 0 if self.pipe else axis_size(mesh, MODEL_AXIS)
        self.tp = self.tp_size > 0
        self.tp_rank = _coord(mesh, MODEL_AXIS)
        self.tp_group = mesh[MODEL_AXIS].get_group() if self.tp else None
        self.fsdp_size = 0 if self.pipe else axis_size(mesh, FSDP_AXIS)
        self.fsdp = self.fsdp_size > 0
        self.fsdp_rank = _coord(mesh, FSDP_AXIS)
        self.fsdp_group = mesh[FSDP_AXIS].get_group() if self.fsdp else None
        self.ddp = axis_size(mesh, DATA_AXIS) > 0 and not (self.fsdp or self.pipe)
        self.data_rank, self.data_size = data_rank(mesh)
        self.data_group = _groups_over(mesh, batch_specs(mesh))
        self.names = [n for n, _ in model.named_parameters()]
        self.kinds = [_tp_kind(n) if self.tp else None for n in self.names]
        self.shapes: List[torch.Size] = [p.shape for _, p in model.named_parameters()]  # full, set before slicing
        self.local_names = list(self.names)  # those this process holds (a pipe stage drops the others' blocks)
        self.module: nn.Module = model

    # -- reductions -------------------------------------------------------

    def mean_over_data(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of a per-shard scalar over the batch shards."""
        if self.data_group is None or self.data_size == 1:
            return t
        return _all_sum(t.detach().float(), self.data_group) / self.data_size

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of the gradients whose local parts are
        ``grads`` (in parameter order): the single-device norm where every
        rank holds whole gradients (no FSDP, no tensor parallelism). On a
        pipe mesh each stage holds its blocks' gradients, whose squares are
        summed over the stages; the rest is whole on every rank."""
        if self.pipe:
            from vitok_torch.parallel.pipeline import is_block_param

            sq = torch.stack([n.float() for n in torch._foreach_norm(grads)]).square()
            staged = torch.tensor([is_block_param(n) for n in self.local_names], device=sq.device)
            return (_all_sum(sq[staged].sum(), self.pipe_group) + sq[~staged].sum()).sqrt()
        if not (self.fsdp or self.tp):
            from vitok_torch.train_lib import global_norm

            return global_norm(grads)
        sq = torch.stack([n.float() for n in torch._foreach_norm(grads)]).square()
        split = torch.tensor([k is not None for k in self.kinds], device=sq.device)
        parts = torch.stack([sq[split].sum(), sq[~split].sum()])
        if self.fsdp:
            parts = _all_sum(parts, self.fsdp_group)
        if self.tp:
            parts = torch.stack([_all_sum(parts[0], self.tp_group), parts[1]])
        return parts.sum().sqrt()

    # -- whole tensors from local parts, and back ------------------------

    def full(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Parameter ``i``'s whole tensor (or of a state tensor shaped like
        it) from this rank's local part ``t``, on every rank."""
        if self.fsdp:
            rows = self._tp_shape(i)[0]
            t = _gather_rows(t, rows, self.fsdp_size, self.fsdp_group)
        kind = self.kinds[i]
        if kind is not None:
            parts = _all_gather(t, self.tp_group, self.tp_size)
            if kind == "cols":
                t = torch.cat(parts, 1)
            else:
                slabs = 3 if kind == "slab3" else 2
                t = torch.cat([p.unflatten(0, (slabs, -1)) for p in parts], 1).flatten(0, 1)
        return t

    def full_named(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole tensors, by parameter name, from this rank's local parts
        (every rank takes part; on a pipe mesh every parameter's, each
        block's from its stage: every parameter of the model)."""
        if self.pipe:
            from vitok_torch.parallel.pipeline import gather_staged

            return gather_staged(self, tensors)
        return {n: self.full(self.names.index(n), t) for n, t in tensors.items()}

    def local_of(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's local part of parameter ``i``'s whole tensor ``full``
        (the inverse of :meth:`full`; a copy)."""
        kind = self.kinds[i]
        t = full
        if kind == "cols":
            per = full.shape[1] // self.tp_size
            t = full[:, self.tp_rank * per:(self.tp_rank + 1) * per]
        elif kind is not None:
            t = full[_slab_rows(kind, full.shape[0], self.tp_size, self.tp_rank).to(full.device)]
        if self.fsdp:
            chunk = -(-t.shape[0] // self.fsdp_size)
            t = t[self.fsdp_rank * chunk:(self.fsdp_rank + 1) * chunk]
        return t.clone()

    def _tp_shape(self, i: int) -> torch.Size:
        shape = list(self.shapes[i])
        kind = self.kinds[i]
        if kind == "cols":
            shape[1] //= self.tp_size
        elif kind is not None:
            shape[0] //= self.tp_size
        return torch.Size(shape)

    # -- checkpoints ------------------------------------------------------

    def state_indices(self, opt_state: Dict[str, Any], matrix: Optional[List[bool]]) -> Dict[str, List[int]]:
        """Parameter index of each entry of each tensor list of an
        optimizer state: AdamW's moments follow every parameter; Muon's
        momentum its matrices (``matrix``) and its Adam moments the rest."""
        out = {}
        for key, v in opt_state.items():
            if not isinstance(v, list):
                continue
            if matrix is None or key not in ("momentum", "mu", "nu"):
                out[key] = list(range(len(v)))
            else:
                want = key == "momentum"
                out[key] = [i for i, m in enumerate(matrix) if m == want]
            if len(out[key]) != len(v):
                raise ValueError(f"optimizer state {key}: {len(v)} tensors for {len(out[key])} parameters")
        return out


def _all_sum(t: torch.Tensor, group) -> torch.Tensor:
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def _all_gather(t: torch.Tensor, group, size: int) -> List[torch.Tensor]:
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def _gather_rows(t: torch.Tensor, rows: int, size: int, group) -> torch.Tensor:
    """The whole of a tensor of ``rows`` rows whose dim-0 chunks
    (``torch.chunk``'s, as FSDP2 cuts them) lie on the ranks of ``group``."""
    chunk = -(-rows // size)
    padded = t.new_zeros((chunk, *t.shape[1:]))
    padded[: t.shape[0]] = t
    return torch.cat(_all_gather(padded, group, size))[:rows]


def _sliced_linear(lin: nn.Module, kind: str, tp: int, r: int) -> nn.Module:
    """Rank ``r``'s slice (``kind`` of :data:`TP_LINEARS`) of a block
    linear: an ``nn.Linear``'s weight, or an ``Int8Linear``'s codes with
    the scales of the rows it keeps."""
    from vitok_torch.models.ae import Int8Linear

    int8 = isinstance(lin, Int8Linear)
    w = lin.weight_int8 if int8 else lin.weight.detach()
    if kind == "cols":
        per = w.shape[1] // tp
        keep = (slice(None), slice(r * per, (r + 1) * per))
    else:
        keep = _slab_rows(kind, w.shape[0], tp, r).to(w.device)
    w = w[keep].contiguous()
    if int8:
        return Int8Linear(w, lin.scale if kind == "cols" else lin.scale[keep].contiguous())
    out = nn.Linear(w.shape[1], w.shape[0], bias=False, device=w.device, dtype=w.dtype)
    with torch.no_grad():
        out.weight.copy_(w)
    out.weight.requires_grad_(lin.weight.requires_grad)
    return out


def apply_tensor_parallel(model: nn.Module, layout: Layout) -> None:
    """Slice every block's linears for this rank (:data:`TP_LINEARS`, an
    int8 block's :data:`TP_INT8_LINEARS`) and give each block its local
    head count and the tensor-parallel group."""
    from vitok_torch.models.ae import Int8Linear

    tp, r = layout.tp_size, layout.tp_rank
    for stack in _BLOCK_STACKS:
        for blk in getattr(model, stack, ()):
            int8 = isinstance(blk.attn.qkv_proj, Int8Linear)
            ffn = 0 if int8 else blk.ffn.fc2.weight.shape[1]
            if blk.heads % tp or ffn % tp:
                raise ValueError(f"model={tp} must divide the heads ({blk.heads}) and the FFN hidden ({ffn})")
            for path, kind in (TP_INT8_LINEARS if int8 else TP_LINEARS).items():
                parent, name = path.split(".")
                mod = getattr(blk, parent)
                setattr(mod, name, _sliced_linear(getattr(mod, name), kind, tp, r))
            blk.heads //= tp
            blk.tp_group, blk.tp_size = layout.tp_group, tp


def shard_params(model: nn.Module, mesh, device=None) -> Layout:
    """Lay ``model`` over ``mesh``: tensor parallelism where the mesh has a
    ``model`` axis, FSDP2 where it has ``fsdp`` (one ``fully_shard`` a
    block, then the root, over the ``(data, fsdp)`` mesh), else DDP over
    ``data``. An axis of size 1 still selects its layer. On a mesh with
    ``pipe`` (the counterpart of the JAX ``pipeline_param_specs``) the AE
    keeps this stage's decoder blocks only
    (:func:`vitok_torch.parallel.pipeline.stage_model`) and nothing is
    wrapped. Every process must hold the same weights first (the same seed,
    or :func:`place_on_mesh`).

    Returns the :class:`Layout`; ``layout.module`` is what to call (the DDP
    wrapper, or the model itself), and ``model.layout`` is set to it.
    """
    layout = Layout(mesh, model)
    if layout.pipe:
        from vitok_torch.parallel.pipeline import stage_model

        stage_model(model, layout)
    if layout.tp:
        if not any(hasattr(model, stack) for stack in _BLOCK_STACKS):
            raise ValueError(f"tensor parallelism slices the blocks of {_BLOCK_STACKS}; {type(model).__name__} "
                             "has none")
        apply_tensor_parallel(model, layout)
    if layout.fsdp:
        from torch.distributed.fsdp import fully_shard

        dims = [a for a in (DATA_AXIS, FSDP_AXIS) if axis_size(mesh, a)]
        fs_mesh = mesh[tuple(dims)] if len(dims) > 1 else mesh[FSDP_AXIS]
        for stack in model.children():  # the block stacks, bottom-up before the root
            if isinstance(stack, nn.ModuleList):
                for blk in stack:
                    fully_shard(blk, mesh=fs_mesh)
        fully_shard(model, mesh=fs_mesh)
    elif layout.ddp:
        from torch.nn.parallel import DistributedDataParallel

        dev = next(model.parameters()).device
        layout.module = DistributedDataParallel(
            model, process_group=mesh[DATA_AXIS].get_group(),
            device_ids=[dev.index] if dev.type == "cuda" else None)
    model.layout = layout
    return layout


@torch.no_grad()
def place_on_mesh(tree, mesh):
    """Every parameter and buffer of a module (or every tensor of a dict)
    broadcast from the mesh's first process, so that all replicas start
    from the same values. Returns ``tree``."""
    src = int(mesh.mesh.flatten()[0])
    tensors = (list(tree.parameters()) + list(tree.buffers()) if isinstance(tree, nn.Module)
               else [v for v in tree.values() if isinstance(v, torch.Tensor)])
    for t in tensors:
        dist.broadcast(local(t), src=src)
    return tree


__all__ = [
    "Layout",
    "TP_INT8_LINEARS",
    "TP_LINEARS",
    "ae_param_specs",
    "apply_tensor_parallel",
    "batch_specs",
    "data_rank",
    "local",
    "param_shardings",
    "place_on_mesh",
    "replicated",
    "shard_batch",
    "shard_params",
]
