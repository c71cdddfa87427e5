"""Sequence parallelism: a token-sharded forward with halo-exchange attention.

The port's counterpart of ``vitok_tpu/parallel/sequence.py``. At 8192p one
image is 262k tokens, more than one card's memory holds for training. The
token axis splits over the processes of a ``seq`` group; everything in a
ViT block is per token except sliding-window attention, which needs each
shard's ``sw`` neighbouring keys and values: a halo exchange
(:func:`vitok_torch.parallel.comm.halo_exchange`, differentiable) brings
them, and each shard attends its queries to ``[sw | local | sw]`` keys under
the exact global window. The traffic is ``O(sw * width)`` a shard and layer,
whatever the sequence length.

The model runs on its shard with ``attn_impl="halo:seq"`` (q/k norm and RoPE
locally, then :func:`halo_attention`, the unfused composition of
``ops/attention.py``: the function JAX computes on ``_xla_attention``).
Parameters are replicated; the per-image Charbonnier denominator is summed
over the group outside the gradient, and the loss and the gradients are
summed over the group, so every shard returns the single-device values.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from vitok_torch.parallel.comm import halo_exchange
from vitok_torch.parallel.mesh import SEQ_AXIS

# The process group of each token axis a forward runs under (``halo:<axis>``).
_GROUPS: Dict[str, Any] = {}


def _seq_group(mesh_or_group):
    """The ``seq`` group of a mesh, or a process group as it is."""
    names = getattr(mesh_or_group, "mesh_dim_names", None)
    if names is not None:
        return mesh_or_group[SEQ_AXIS].get_group()
    return mesh_or_group


@contextlib.contextmanager
def token_axis(group, axis: str = SEQ_AXIS):
    """Run ``halo:<axis>`` attention over ``group`` inside the block."""
    saved = _GROUPS.get(axis)
    _GROUPS[axis] = group
    try:
        yield
    finally:
        if saved is None:
            _GROUPS.pop(axis, None)
        else:
            _GROUPS[axis] = saved


def halo_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    patch_mask: Optional[torch.Tensor],
    sliding_window: int,
    axis: str = SEQ_AXIS,
) -> torch.Tensor:
    """Windowed attention over a token-sharded sequence, on one shard.

    q, k, v: ``[B, n_local, H, D]`` (this shard's tokens, shard ``i`` of the
    group holding tokens ``[i n_local, (i + 1) n_local)``). Each shard
    receives both neighbours' ``sw`` boundary keys, values and mask (zeros,
    masked out, at the edges), then attends its queries to ``[sw | local |
    sw]`` keys with the global window ``|i - j| <= sw`` and the keys' mask.
    Dead query rows (padding) are 0, as the flash kernel leaves them.
    """
    from vitok_torch.ops.attention import _xla_attention

    group = _GROUPS.get(axis)
    if group is None:
        raise RuntimeError(f"halo:{axis} attention outside a sequence-parallel forward (no group for {axis!r})")
    idx = dist.get_rank(group)
    b, nl, h, d = q.shape
    sw = int(sliding_window)
    if sw > nl:
        raise ValueError(f"halo attention needs sliding_window ({sw}) <= tokens per shard ({nl})")
    pm = (torch.ones((b, nl), dtype=torch.bool, device=q.device) if patch_mask is None
          else torch.as_tensor(patch_mask, device=q.device).bool())

    def extend(x):
        left, right = halo_exchange(x, sw, group)
        return torch.cat([left, x, right], dim=1)

    k_ext, v_ext, pm_ext = extend(k), extend(v), extend(pm)
    q_pos = idx * nl + torch.arange(nl, device=q.device)
    k_pos = idx * nl - sw + torch.arange(nl + 2 * sw, device=q.device)
    window = (q_pos[:, None] - k_pos[None, :]).abs() <= sw
    mask = window[None, None] & pm_ext[:, None, None, :]
    out = _xla_attention(q, k_ext, v_ext, mask)
    return out * pm[:, :, None, None].to(out.dtype)


def _local_cfg(model):
    cfg = model.cfg
    if cfg.sw is None:
        raise ValueError("sequence parallelism requires cfg.sw (sliding-window attention)")
    return dataclasses.replace(cfg, attn_impl=f"halo:{SEQ_AXIS}")


@contextlib.contextmanager
def _sharded(model, group):
    """``model`` with ``attn_impl="halo:seq"`` over ``group``."""
    saved = model.cfg
    model.cfg = _local_cfg(model)
    try:
        with token_axis(group):
            yield
    finally:
        model.cfg = saved


def sequence_parallel_forward(model, patch_dict: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The AE forward (inference) on this process's token shard, the token
    axis split over ``mesh``'s ``seq`` axis (or a process group).

    ``patch_dict`` holds the shard's tokens (:func:`place_batch_token_sharded`);
    the output holds the shard's ``patches`` (or ``z``). Requires ``cfg.sw``,
    and a token count that the shards split evenly, each at least ``sw``.
    """
    with _sharded(model, _seq_group(mesh)):
        return model(patch_dict)


def sequence_parallel_value_and_grad(
    model,
    patch_dict: Dict[str, Any],
    mesh,
    charbonnier_eps: float = 1e-3,
    drop_uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The masked Charbonnier reconstruction loss and the gradients of every
    parameter (in ``model.parameters()`` order), with the token axis sharded.

    Each shard's loss is its part of the per-image masked mean (the
    denominator, the image's valid tokens, summed over the group outside the
    gradient); the loss and the gradients are summed over the group, so
    every shard returns the single-device ``charbonnier_loss`` of the full
    forward and its gradients. Stochastic depth: ``drop_uniforms`` (or a
    ``generator`` seeded alike on every shard) gives every shard the same
    per-image gates, so an image is dropped on all of its shards or none.
    """
    group = _seq_group(mesh)
    dev = model.device
    batch = {k: (torch.as_tensor(v).to(dev) if hasattr(v, "shape") else v) for k, v in patch_dict.items()}
    mask = batch.get("patch_mask")
    m0 = mask.float() if mask is not None else torch.ones(batch["patches"].shape[:2], device=dev)
    den = m0.sum(-1)
    dist.all_reduce(den, group=group)
    den = den.clamp(min=1.0)
    params = list(model.parameters())
    with _sharded(model, group):
        out = model(batch, deterministic=False, generator=generator, drop_uniforms=drop_uniforms)
        diff = out["patches"].float() - batch["patches"].float()
        per_token = torch.sqrt(diff * diff + charbonnier_eps * charbonnier_eps).mean(-1)
        loss_local = ((per_token * m0).sum(-1) / den).mean()
        grads = list(torch.autograd.grad(loss_local, params))
    loss = loss_local.detach().clone()
    dist.all_reduce(loss, group=group)
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    grads = [t.view_as(g).to(g.dtype) for t, g in zip(flat.split([g.numel() for g in grads]), grads)]
    return loss, grads


def place_batch_token_sharded(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This process's token shard of a NaFlex batch: every ``[B, N, ...]``
    tensor split along axis 1 over the ``seq`` group (evenly: ``N`` must be
    a multiple of the group size); 1-D metadata kept whole."""
    group = _seq_group(mesh)
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    out = {}
    for k, v in batch.items():
        if v is not None and hasattr(v, "shape") and len(v.shape) >= 2:
            n = v.shape[1]
            if n % size:
                raise ValueError(f"{k}: {n} tokens do not split over seq={size}")
            out[k] = v[:, rank * n // size:(rank + 1) * n // size]
        else:
            out[k] = v
    return out


def make_sp_train_step(tx, mesh, ema_decay: float = 0.999, charbonnier_eps: float = 1e-3,
                       stochastic: bool = False):
    """The token-sharded train step ``(state, batch, rng=None) ->
    (state, metrics)`` of the high-resolution finetune: the Charbonnier
    backward token-sharded (:func:`sequence_parallel_value_and_grad`, the
    gradients come back whole on every shard), then the optimizer and the
    fp32 EMA on the replicated parameters, the state layout of
    ``train_lib.make_train_step`` (checkpoints interchange). With
    ``stochastic`` the step draws drop-path gates from a generator seeded
    from ``rng`` and the step, alike on every shard."""
    from vitok_torch.train_lib import global_norm, update_ema

    def step(state, batch, rng=None, drop_uniforms=None):
        model = state.model
        generator = None
        if stochastic and drop_uniforms is None and rng is not None:
            generator = torch.Generator(device=model.device).manual_seed(int(rng) * 1_000_003 + state.step)
        loss, grads = sequence_parallel_value_and_grad(model, batch, mesh, charbonnier_eps=charbonnier_eps,
                                                       drop_uniforms=drop_uniforms, generator=generator)
        params = list(model.parameters())
        metrics = {"loss/total": loss, "grad_norm": global_norm(grads)}
        tx.update(params, grads, state.opt_state)
        if state.ema_params is not None:
            update_ema(state.ema_params, dict(model.named_parameters()), ema_decay)
        state.step += 1
        return state, metrics

    return step


__all__ = [
    "SEQ_AXIS",
    "halo_attention",
    "make_sp_train_step",
    "place_batch_token_sharded",
    "sequence_parallel_forward",
    "sequence_parallel_value_and_grad",
    "token_axis",
]
