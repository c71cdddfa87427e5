"""Pipeline parallelism: the decoder's block stack staged over a ``pipe`` axis.

The port's counterpart of ``vitok_tpu/parallel/pipeline.py``, in PyTorch's
idiom: one process a stage on the ``pipe`` group of the ``DeviceMesh``
(``parallel/mesh.py``), explicit point-to-point transfers between the
stages (``parallel/comm.py``: ``isend``/``irecv``), and a GPipe schedule,
all forwards of the microbatches, then all backwards.

* **Stages.** :func:`stage_model` (called by ``shard_params`` on a mesh with
  ``pipe``) keeps stage ``s``'s ``decoder_depth / S`` consecutive decoder
  blocks and frees the others (an :class:`Elsewhere` stands in). Parameter
  names stay the single-device ones. ``decoder_embed`` runs on stage 0,
  ``to_pixels`` on the last stage; the encoder and the heads are whole on
  every process.
* **Ownership.** As in the JAX package, stage ``s`` owns microbatches
  ``r * S + s``: their latents ``z`` (the encoder runs on the owners' rows,
  data-parallel over ``(data, pipe)``), their targets and loss partials, and
  their latent cotangents ``dz``. An owner sends its ``z`` to stage 0 and
  receives its decoded patches from the last stage; activations move down
  the stage line, their cotangents back up.
* **Recomputation.** With ``remat=True`` (the default, as in the JAX
  package) a stage keeps only the input of each microbatch and runs its
  forward again under grad in the backward; ``remat=False`` keeps the graph.
* **Gradients.** Block gradients stay on their stage (summed over ``data``
  replicas); ``decoder_embed``, ``to_pixels`` and encoder gradients are
  summed over every process. ``Layout.global_norm`` sums the block
  gradients' squares over the stages, so clipping sees the global norm.
* **Data.** On a ``(data, pipe)`` mesh each ``data`` slice runs its own
  pipeline on its own rows; the loss is the global mean, as one process
  computes it on all rows. The rows are stage 0's: each entry point
  broadcasts stage 0's batch over the pipe group, so a stage whose loader
  drew other crops (a random pp) still decodes, and takes the loss of, the
  same images as the stage that encoded them.
* **Loss.** ``train_lib.loss_from_output``, the loss stack of
  ``compute_loss``, on each microbatch, over the global number of
  microbatches (each holds the same number of rows and tiles, so the shares
  sum to the loss of all rows).

Only ``data`` composes with ``pipe``: any other axis of size > 1 raises
(the JAX package's ``_mesh_data_axes`` would treat it as data). The
schedule runs deterministic: ``drop_path_rate > 0`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from vitok_torch.parallel import comm
from vitok_torch.parallel.mesh import DATA_AXIS, PIPE_AXIS
from vitok_torch.parallel.sharding import _all_sum

_TARGETS = "target_patches"  # the key the targets travel under beside encode_dict

# Message kinds, in the tag of a transfer (gloo matches on it; NCCL keeps order).
_Z, _ACT, _PATCH, _DPATCH, _GRAD, _DZ = range(6)
_KINDS = 8


def _tag(q: int, kind: int) -> int:
    return q * _KINDS + kind


def check_pipe_mesh(mesh) -> None:
    """Raise ``ValueError`` where an axis other than ``data`` and ``pipe``
    has more than one process: only data parallelism composes with the
    pipeline."""
    others = {a: n for a, n in zip(mesh.mesh_dim_names or (), mesh.shape) if a not in (DATA_AXIS, PIPE_AXIS) and n > 1}
    if others:
        raise ValueError(f"a pipe mesh composes with data only, not with {others}")


def is_block_param(name: str) -> bool:
    """Whether parameter ``name`` belongs to a decoder block (held by one stage)."""
    return name.startswith("decoder_blocks.")


class Elsewhere(nn.Module):
    """The place of a decoder block that another stage holds."""

    def __init__(self, index: int, stage: int):
        super().__init__()
        self.index, self.stage = index, stage

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"decoder block {self.index} lives on pipe stage {self.stage}; run the staged model "
                           "through pipeline_parallel_decode or make_pipeline_train_step")


def stage_model(model: nn.Module, layout) -> None:
    """Keep this stage's slice of ``model.decoder_blocks`` and free the
    rest; record the stage's blocks and parameter names on ``layout``.
    A ``quantize()``d model's blocks stage as they are."""
    blocks = getattr(model, "decoder_blocks", None)
    if blocks is None:
        raise ValueError(f"pipeline parallelism stages the decoder blocks; {type(model).__name__} has none")
    depth, n_stages = len(blocks), layout.pipe_size
    if depth % n_stages:
        raise ValueError(f"decoder_depth {depth} not divisible by pipe={n_stages}")
    per = depth // n_stages
    own = range(layout.stage * per, (layout.stage + 1) * per)
    for i in range(depth):
        if i not in own:
            blocks[i] = Elsewhere(i, i // per)
    layout.stage_blocks = own
    layout.blocks_per_stage = per
    layout.local_names = [n for n, _ in model.named_parameters()]
    layout.local_set = set(layout.local_names)


def pipeline_param_specs(mesh) -> Callable[[str, Any], Optional[str]]:
    """``spec_for(name, tensor)``: ``"pipe"`` for a decoder block's parameter
    (held whole by one stage, with its gradient and optimizer state), None
    for the rest (replicated). ``shard_params(model, mesh)`` on a mesh with
    ``pipe`` lays the model out so."""
    del mesh

    def spec_for(name: str, tensor=None) -> Optional[str]:
        return PIPE_AXIS if is_block_param(name) else None

    return spec_for


def _pipe_layout(model):
    layout = getattr(model, "layout", None)
    if layout is None or not getattr(layout, "pipe", False):
        raise ValueError("the model is not laid over a pipe mesh: call shard_params(model, mesh) with a 'pipe' axis "
                         "first")
    return layout


def _validate(cfg, batch: int, n_stages: int, m: int) -> int:
    if cfg.decoder_depth % n_stages:
        raise ValueError(f"decoder_depth {cfg.decoder_depth} not divisible by pipe={n_stages}")
    if batch % m:
        raise ValueError(f"batch {batch} not divisible by microbatches {m}")
    if m % n_stages:
        raise ValueError(f"microbatches {m} not divisible by pipe={n_stages} (the stages own them round-robin)")
    return batch // m


def _rows(d: Dict[str, Any], lo: int, hi: Optional[int], device) -> Dict[str, Any]:
    return {k: torch.as_tensor(v, device=device)[lo:hi] for k, v in d.items()
            if hasattr(v, "shape") and len(v.shape) >= 1}


def _from_stage0(d: Dict[str, Any], layout, device) -> Dict[str, torch.Tensor]:
    """The tensors of stage 0's ``d`` (those with a batch axis) on
    ``device``, the same on every stage of the pipe group: their shapes and
    dtypes, then the tensors, broadcast from stage 0. The other stages' ``d``
    is not read. Booleans travel as bytes."""
    group = layout.pipe_group
    if layout.pipe_size == 1:
        return _rows(d, 0, None, device)
    src = dist.get_global_rank(group, 0)
    spec = [None]
    if layout.stage == 0:
        local = _rows(d, 0, None, device)
        spec = [{k: (tuple(v.shape), v.dtype) for k, v in local.items()}]
    dist.broadcast_object_list(spec, src=src, group=group)
    out = {}
    for k, (shape, dtype) in sorted(spec[0].items()):
        wire = torch.uint8 if dtype == torch.bool else dtype
        t = local[k].to(wire).contiguous() if layout.stage == 0 else torch.empty(shape, dtype=wire, device=device)
        dist.broadcast(t, src, group=group)
        out[k] = t.to(dtype)
    return out


def _stage_runner(model, layout) -> Callable[[torch.Tensor, Dict[str, Any], bool], torch.Tensor]:
    """This stage's function: ``decoder_embed`` (stage 0), its blocks,
    ``to_pixels`` (the last stage)."""
    from vitok_torch.models.ae import _linear

    cfg = model.cfg
    first, last = layout.stage == 0, layout.stage == layout.pipe_size - 1
    blocks = [model.decoder_blocks[i] for i in layout.stage_blocks]

    def run(inp, meta, deterministic):
        x = _linear(inp.to(model.compute_dtype), model.decoder_embed) if first else inp
        x = model._blocks(x, blocks, meta, cfg.decoder_head_dim, deterministic)
        return _linear(x, model.to_pixels) if last else x

    return run


def _stage_params(model, layout) -> List[Tuple[str, nn.Parameter]]:
    first, last = layout.stage == 0, layout.stage == layout.pipe_size - 1
    keep = lambda n: is_block_param(n) or (first and n.startswith("decoder_embed.")) or (
        last and n.startswith("to_pixels."))
    return [(n, p) for n, p in model.named_parameters() if keep(n)]


@torch.no_grad()
def pipeline_parallel_decode(model, encode_dict: Dict[str, Any], num_microbatches: Optional[int] = None
                             ) -> Dict[str, Any]:
    """Decode with the block stack pipelined over the stages of ``model``'s
    pipe layout (``shard_params(model, mesh)``).

    Stage 0's ``encode_dict`` (``z`` and the metadata of the ``data``
    slice's rows) is broadcast over the stages; the batch streams through
    the stages in ``num_microbatches`` (default: the pipe size) microbatches
    and the decoded patches come back in batch order on every stage.
    Requires ``decoder_depth % S == 0``, ``batch % num_microbatches == 0``
    and ``num_microbatches % S == 0``.
    """
    from vitok_torch.models.ae import _meta

    layout = _pipe_layout(model)
    cfg, dev, dt = model.cfg, model.device, model.compute_dtype
    n_stages, s, group = layout.pipe_size, layout.stage, layout.pipe_group
    encode_dict = _from_stage0(encode_dict, layout, dev)
    z = encode_dict["z"]
    b, n = z.shape[:2]
    m = num_microbatches or n_stages
    mb = _validate(cfg, b, n_stages, m)
    run = _stage_runner(model, layout)
    last = s == n_stages - 1
    sends, outs = [], []
    for q in range(m):
        meta = _rows(encode_dict, q * mb, (q + 1) * mb, dev)
        if s == 0:
            inp = z[q * mb:(q + 1) * mb]
        else:
            inp = comm.irecv(torch.empty((mb, n, cfg.decoder_width), dtype=dt, device=dev), s - 1, group,
                             _tag(q, _ACT)).wait()
        out = run(inp, meta, True)
        if last:
            outs.append(out)
        else:
            sends.append(comm.isend(out, s + 1, group, _tag(q, _ACT)))
    for p in sends:
        p.wait()
    y = torch.cat(outs) if last else torch.empty((b, n, model.to_pixels.out_features), dtype=dt, device=dev)
    dist.broadcast(y, dist.get_global_rank(group, n_stages - 1), group=group)
    out = _meta(encode_dict)
    out["patches"] = y
    return out


def _schedule(model, layout, meta: Dict[str, Any], z_own: Dict[int, torch.Tensor], m: int, mb: int, remat: bool,
              loss_of: Callable[[int, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]):
    """One GPipe pass of a ``data`` slice's batch (``meta``: its rows on
    the device; ``z_own``: this stage's microbatches' latents, compute
    dtype). ``loss_of(q, patches)`` gives microbatch ``q``'s loss partial
    and its metrics (a dict of 0-d tensors) on its owner.

    Returns ``(parts, grads, dz)``: the sum of this stage's metrics, the
    gradients of :func:`_stage_params` (fp32, by name, this stage's
    microbatches summed), and ``{q: dz}`` of the microbatches it owns.
    """
    cfg, dev, dt = model.cfg, model.device, model.compute_dtype
    n_stages, s, group = layout.pipe_size, layout.stage, layout.pipe_group
    first, last = s == 0, s == n_stages - 1
    n = meta["row_idx"].shape[1]
    width, ppt = cfg.decoder_width, model.to_pixels.out_features
    zdim = cfg.channels_per_token
    run = _stage_runner(model, layout)
    named = _stage_params(model, layout)
    params = [p for _, p in named]
    micro = lambda q: {k: v[q * mb:(q + 1) * mb] for k, v in meta.items()}
    empty = lambda c: torch.empty((mb, n, c), dtype=dt, device=dev)
    sends, saved, patches, pend = [], {}, {}, {}

    # Forward: every microbatch down the stage line.
    for q in range(m):
        owner = q % n_stages
        if first:
            inp = z_own[q] if owner == 0 else comm.irecv(empty(zdim), owner, group, _tag(q, _Z)).wait()
        else:
            if owner == s:
                sends.append(comm.isend(z_own[q], 0, group, _tag(q, _Z)))
            inp = comm.irecv(empty(width), s - 1, group, _tag(q, _ACT)).wait()
        inp = inp.detach()
        if remat:
            with torch.no_grad():
                out = run(inp, micro(q), False)
            saved[q] = (inp, None)
        else:
            inp.requires_grad_(True)
            with torch.enable_grad():
                out = run(inp, micro(q), False)
            saved[q] = (inp, out)
        if not last:
            sends.append(comm.isend(out, s + 1, group, _tag(q, _ACT)))
        elif owner == s:
            patches[q] = out.detach()
        else:
            sends.append(comm.isend(out, owner, group, _tag(q, _PATCH)))
        if owner == s and not last:
            pend[q] = comm.irecv(empty(ppt), n_stages - 1, group, _tag(q, _PATCH))

    # The owners' losses and their gradients in the decoded patches.
    parts, dpatch = None, {}
    for q in range(s, m, n_stages):
        pred = (patches[q] if last else pend.pop(q).wait()).detach().requires_grad_(True)
        with torch.enable_grad():
            total, p = loss_of(q, pred)
            (dpatch[q],) = torch.autograd.grad(total, pred)
        parts = p if parts is None else {k: v + p[k] for k, v in parts.items()}

    # Backward: the cotangents back up the line, in microbatch order (the
    # order one process adds gradient-accumulation chunks in).
    grads: List[Optional[torch.Tensor]] = [None] * len(params)
    dz = {}
    for q in range(m):
        owner = q % n_stages
        if last:
            g = dpatch.pop(q) if owner == s else comm.irecv(empty(ppt), owner, group, _tag(q, _DPATCH)).wait()
        else:
            if owner == s:
                sends.append(comm.isend(dpatch.pop(q), n_stages - 1, group, _tag(q, _DPATCH)))
            g = comm.irecv(empty(width), s + 1, group, _tag(q, _GRAD)).wait()
        inp, out = saved.pop(q)
        with torch.enable_grad():
            if remat:
                inp.requires_grad_(True)
                out = run(inp, micro(q), False)
            got = torch.autograd.grad(out, [inp] + params, g, allow_unused=True)
        for i, gp in enumerate(got[1:]):
            if gp is not None:
                grads[i] = gp.float() if grads[i] is None else grads[i] + gp.float()
        if not first:
            sends.append(comm.isend(got[0], s - 1, group, _tag(q, _GRAD)))
        elif owner == 0:
            dz[q] = got[0]
        else:
            sends.append(comm.isend(got[0], owner, group, _tag(q, _DZ)))
        if owner == s and not first:
            pend[q] = comm.irecv(empty(zdim), 0, group, _tag(q, _DZ))
    for p in sends:
        p.wait()
    dz.update({q: p.wait() for q, p in pend.items()})
    grads = {n: (torch.zeros_like(p, dtype=torch.float32) if g is None else g)
             for (n, p), g in zip(named, grads)}
    return parts, grads, dz


def _flat_sum(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor summed over ``group`` (one all-reduce of their concatenation)."""
    if not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def _reduce_grads(model, layout, grads: Dict[str, torch.Tensor], names: List[str]) -> Dict[str, torch.Tensor]:
    """The gradients of ``names`` (0 where this process computed none):
    block gradients summed over the ``data`` slices, the rest over every
    process (every process passes the same replicated names)."""
    params = dict(model.named_parameters())
    grads = {n: grads[n] if n in grads else torch.zeros_like(params[n], dtype=torch.float32) for n in names}
    rest = [n for n in names if not is_block_param(n)]
    out = dict(zip(rest, _flat_sum([grads[n] for n in rest], None)))
    blocks = [n for n in names if is_block_param(n)]
    if layout.data_size > 1:
        out.update(zip(blocks, _flat_sum([grads[n] for n in blocks], layout.data_group)))
    else:
        out.update({n: grads[n] for n in blocks})
    return {n: out[n] for n in names}


def _loss_fn(meta, targets, mb: int, micro_global: int, loss_cfg, feature_fn,
             tiles: Optional[Tuple[torch.Tensor, torch.Tensor]]):
    """``loss_of(q, pred)`` of :func:`_schedule`: ``train_lib.loss_from_output``
    on microbatch ``q``'s rows, loss and metrics over ``micro_global``, the
    microbatches of every ``data`` slice (each holds the same number of rows
    and tiles, so the shares sum to the means over all rows)."""
    from vitok_torch.train_lib import loss_from_output

    def loss_of(q, pred):
        rows = {k: v[q * mb:(q + 1) * mb] for k, v in meta.items()}
        rows["patches"] = targets[q * mb:(q + 1) * mb]
        idx = None if tiles is None else tuple(t[q * mb:(q + 1) * mb] for t in tiles)
        out = {"patches": pred, "patch_mask": rows.get("patch_mask")}
        loss, metrics = loss_from_output(out, rows, loss_cfg, feature_fn=feature_fn, tile_indices=idx)
        return loss / micro_global, {k: v / micro_global for k, v in metrics.items()}

    return loss_of


def _draw_tiles(layout, meta, loss_cfg, feature_fn, generator, tile_indices):
    """The tile origins of a batch (``compute_loss``'s draw, or
    ``tile_indices``) as stage 0 has them, on every stage; None where the
    loss takes no tiles."""
    from vitok_torch.train_lib import tile_shape

    tile = tile_shape(loss_cfg, feature_fn)
    if tile is None:
        return None
    if tile_indices is None:
        from vitok_torch.pp.ops import sample_tile_indices

        if "orig_height" not in meta or "orig_width" not in meta:
            raise ValueError("the SSIM/perceptual tiles need orig_height/orig_width in the batch")
        tile_indices = sample_tile_indices(meta["orig_height"], meta["orig_width"], n_tiles=loss_cfg.n_tiles,
                                           tile_size=tile, generator=generator)
    got = _from_stage0({"start_y": tile_indices[0], "start_x": tile_indices[1]}, layout, meta["row_idx"].device)
    return got["start_y"], got["start_x"]


def _global_sum(parts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each metric summed over every process (one all-reduce)."""
    keys = sorted(parts)
    return dict(zip(keys, _all_sum(torch.stack([parts[k] for k in keys]), None).unbind()))


def _check_training(model) -> None:
    if model.cfg.drop_path_rate > 0:
        raise ValueError("pipeline training runs deterministic: drop_path_rate must be 0 (stochastic depth would "
                         "need a gate per microbatch and block inside the schedule)")


def pipeline_parallel_value_and_grad(
    model,
    encode_dict: Dict[str, Any],
    target_patches: torch.Tensor,
    num_microbatches: Optional[int] = None,
    charbonnier_eps: float = 1e-3,
    remat: bool = True,
    loss_cfg=None,
    feature_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    tile_indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    return_metrics: bool = False,
):
    """The reconstruction loss and its gradients through the pipelined
    decoder.

    Stage 0's ``encode_dict`` (``z`` and the metadata of the ``data``
    slice's rows), ``target_patches`` and tile origins are broadcast over
    the stages;
    stage ``s`` feeds the latents of the microbatches it owns. The loss is
    ``train_lib.loss_from_output`` under ``loss_cfg`` (default: masked
    Charbonnier alone) with ``charbonnier_eps``: a ``train_lib.LossConfig``
    with ``ssim_grid`` adds the SSIM tiles and, with ``feature_fn``, the
    perceptual term, at origins drawn once for the batch (from
    ``generator``, or ``tile_indices``), so the loss equals
    ``train_lib.compute_loss`` on all rows.

    Returns ``(loss, grads, dz)``: the global loss on every process; the
    gradients by parameter name of ``decoder_embed``, ``to_pixels`` (summed
    over every process) and this stage's decoder blocks only (summed over
    the ``data`` slices); ``dz`` of the slice's batch in batch order on
    every stage. With ``return_metrics``, a fourth element:
    ``{"loss/charbonnier", "loss/ssim", "loss/perceptual"}`` (0 for a term
    the loss leaves out).
    """
    from vitok_torch.train_lib import LossConfig

    layout = _pipe_layout(model)
    _check_training(model)
    cfg, dev, dt = model.cfg, model.device, model.compute_dtype
    n_stages, s = layout.pipe_size, layout.stage
    loss_cfg = dataclasses.replace(LossConfig() if loss_cfg is None else loss_cfg, charbonnier_eps=charbonnier_eps)
    meta = _from_stage0({**encode_dict, _TARGETS: target_patches}, layout, dev)
    targets = meta.pop(_TARGETS)
    z = meta["z"].to(dt)
    b = z.shape[0]
    m = num_microbatches or n_stages
    mb = _validate(cfg, b, n_stages, m)
    tiles = _draw_tiles(layout, meta, loss_cfg, feature_fn, generator, tile_indices)
    loss_of = _loss_fn(meta, targets, mb, m * layout.data_size, loss_cfg, feature_fn, tiles)
    z_own = {q: z[q * mb:(q + 1) * mb] for q in range(s, m, n_stages)}
    parts, grads, dz_own = _schedule(model, layout, meta, z_own, m, mb, remat, loss_of)
    parts = _global_sum(parts)
    grads = _reduce_grads(model, layout, grads, [n for n in layout.local_names if is_block_param(n) or n.startswith(
        ("decoder_embed.", "to_pixels."))])
    dz = torch.zeros_like(z)
    for q, g in dz_own.items():
        dz[q * mb:(q + 1) * mb] = g
    dist.all_reduce(dz, group=layout.pipe_group)
    if return_metrics:
        zero = torch.zeros((), device=dev)
        return parts["loss/total"], grads, dz, {k: parts.get(k, zero) for k in (
            "loss/charbonnier", "loss/ssim", "loss/perceptual")}
    return parts["loss/total"], grads, dz


def make_pipeline_train_step(
    tx: Any,
    loss_cfg=None,
    ema_decay: float = 0.999,
    feature_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    grad_accum: int = 1,
    num_microbatches: Optional[int] = None,
    remat: bool = True,
):
    """The pipelined train step ``(state, batch, rng=None, tile_indices=None)
    -> (state, metrics)``, ``train_lib.make_train_step``'s contract on a
    pipe layout (``state.layout``).

    ``batch`` is the ``data`` slice's rows: stage 0's, broadcast over the
    stages with its tile origins (the other stages' are not read). Each
    stage encodes the rows of the microbatches it owns (the
    encoder data-parallel over ``(data, pipe)``), the decoder runs the GPipe
    schedule, and the encoder's backward chains from the owners' ``dz``.
    Gradients are reduced as :func:`pipeline_parallel_value_and_grad` says,
    the encoder's over every process. ``grad_accum > 1`` splits the batch
    into that many chunks, one schedule each, and averages their gradients
    in fp32. The optimizer (AdamW or Muon) and the fp32 EMA work on each
    stage's parameters; ``metrics["grad_norm"]`` is the global norm. Tile
    origins come from ``rng`` as ``make_train_step`` draws them (a
    generator seeded from the seed, the step and the ``data`` slice), or
    from ``tile_indices``.
    """
    from vitok_torch.train_lib import LossConfig, update_ema

    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    loss_cfg = LossConfig() if loss_cfg is None else loss_cfg
    enc_prefixes = ("patch_embed.", "encoder_blocks.", "to_code.")

    def step(state, batch: Dict[str, Any], rng=None, tile_indices=None):
        model = state.model
        layout = _pipe_layout(model)
        _check_training(model)
        dev, dt = model.device, model.compute_dtype
        n_stages, s = layout.pipe_size, layout.stage
        generator = rng
        if isinstance(rng, int):
            generator = torch.Generator(device=dev).manual_seed(rng * 1_000_003 + state.step + 7919 * layout.data_rank)
        full = _from_stage0(batch, layout, dev)
        b = full["patches"].shape[0]
        if b % grad_accum:
            raise ValueError(f"batch size {b} not divisible by grad_accum {grad_accum}")
        cb = b // grad_accum
        m = num_microbatches or n_stages
        mb = _validate(model.cfg, cb, n_stages, m)
        enc = [(n, p) for n, p in model.named_parameters() if n.startswith(enc_prefixes)]
        acc: Dict[str, torch.Tensor] = {}
        parts = None
        for c in range(grad_accum):
            meta = {k: v[c * cb:(c + 1) * cb] for k, v in full.items()}
            rows = None if tile_indices is None else tuple(torch.as_tensor(t)[c * cb:(c + 1) * cb]
                                                           for t in tile_indices)
            tiles = _draw_tiles(layout, meta, loss_cfg, feature_fn, generator, rows)
            # The encoder on each microbatch this stage owns, as one process
            # encodes a chunk; its backward waits for the microbatch's dz.
            with torch.enable_grad():
                zs = {q: model._encode({k: v[q * mb:(q + 1) * mb] for k, v in meta.items()},
                                       deterministic=False)["z"] for q in range(s, m, n_stages)}
            loss_of = _loss_fn(meta, meta["patches"], mb, m * layout.data_size, loss_cfg, feature_fn, tiles)
            p, grads, dz = _schedule(model, layout, meta, {q: z.detach().to(dt) for q, z in zs.items()}, m, mb,
                                     remat, loss_of)
            for q, z in zs.items():
                egrads = torch.autograd.grad(z, [t for _, t in enc], dz[q].to(z.dtype))
                for (n, _), g in zip(enc, egrads):
                    grads[n] = g.float() if n not in grads else grads[n] + g.float()
            for n, g in grads.items():
                acc[n] = g if n not in acc else acc[n] + g
            parts = p if parts is None else {k: v + p[k] for k, v in parts.items()}
            del zs, dz, egrads, grads
        named = list(model.named_parameters())
        acc = _reduce_grads(model, layout, acc, [n for n, _ in named])
        metrics = _global_sum(parts)
        if grad_accum > 1:
            acc = {n: g / grad_accum for n, g in acc.items()}
            metrics = {k: v / grad_accum for k, v in metrics.items()}
        params = [p for _, p in named]
        grads = [acc[n] for n, _ in named]
        metrics["grad_norm"] = layout.global_norm(grads)  # before clipping
        tx.update(params, [g.to(p.dtype) for g, p in zip(grads, params)], state.opt_state, layout=layout)
        if state.ema_params is not None:
            update_ema(state.ema_params, dict(named), ema_decay)
        state.step += 1
        return state, metrics

    return step


# ---------------------------------------------------------------------------
# Checkpoints: a staged state gathered into, and loaded from, the
# single-device layout
# ---------------------------------------------------------------------------


def _representative(layout, name: str) -> str:
    """``name`` itself where this stage holds it, else the same tensor of
    this stage's first block (every block has the same parameters)."""
    if not is_block_param(name) or name in layout.local_set:
        return name
    rest = name.split(".", 2)[2]
    return f"decoder_blocks.{layout.stage_blocks[0]}.{rest}"


def _owner(layout, name: str) -> int:
    return int(name.split(".")[1]) // layout.blocks_per_stage


def gather_staged(layout, tensors: Dict[str, torch.Tensor], names: Optional[List[str]] = None
                  ) -> Dict[str, torch.Tensor]:
    """``{name: whole tensor}`` for ``names`` (default: every parameter of
    the model) on every stage, from each stage's ``tensors``: the replicated
    ones as they are, each block's broadcast from the stage that holds it.
    Every stage of the pipe group calls it with the same names."""
    out = {}
    for n in layout.names if names is None else names:
        if not is_block_param(n):
            out[n] = tensors[n]
            continue
        owner = _owner(layout, n)
        if owner == layout.stage:
            t = tensors[n].detach().contiguous()
        else:
            like = tensors[_representative(layout, n)]
            t = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        dist.broadcast(t, dist.get_global_rank(layout.pipe_group, owner), group=layout.pipe_group)
        out[n] = t
    return out


def _list_names(layout, model, opt_state: Dict[str, Any], names: List[str]) -> Dict[str, List[str]]:
    """The parameter name of each entry of each tensor list of an optimizer
    state over ``names``: AdamW's moments follow every parameter, Muon's
    momentum its matrices and its Adam moments the rest."""
    matrix = None
    if "momentum" in opt_state:
        from vitok_torch.muon import matrix_mask

        local = matrix_mask(model)
        matrix = [local[_representative(layout, n)] for n in names]
    out = {}
    for key, v in opt_state.items():
        if not isinstance(v, list):
            continue
        if matrix is None or key not in ("momentum", "mu", "nu"):
            out[key] = list(names)
        else:
            out[key] = [n for n, mat in zip(names, matrix) if mat == (key == "momentum")]
    return out


def full_payload(state) -> Dict[str, Any]:
    """The single-device checkpoint payload of a staged state (a
    collective over each pipe group)."""
    layout, model = state.layout, state.model
    params = gather_staged(layout, {n: p.detach() for n, p in model.named_parameters()})
    opt = dict(state.opt_state)
    here = _list_names(layout, model, opt, layout.local_names)
    whole = _list_names(layout, model, opt, layout.names)
    for key, names in here.items():
        if len(names) != len(opt[key]):
            raise ValueError(f"optimizer state {key}: {len(opt[key])} tensors for {len(names)} parameters")
        got = gather_staged(layout, dict(zip(names, opt[key])), whole[key])
        opt[key] = [got[n] for n in whole[key]]
    ema = None if state.ema_params is None else gather_staged(layout, state.ema_params)
    return {"step": int(state.step), "params": params, "opt_state": opt, "ema_params": ema}


@torch.no_grad()
def load_staged(target, payload: Dict[str, Any]):
    """Each stage's tensors of a single-device payload into a staged state."""
    layout, model = target.layout, target.model
    saved_params = payload["params"]
    if sorted(saved_params) != sorted(layout.names):
        raise ValueError("checkpoint parameters do not match the model's")
    for n, p in model.named_parameters():
        p.copy_(saved_params[n].to(p.device))
    saved = payload["opt_state"]
    here = _list_names(layout, model, target.opt_state, layout.local_names)
    whole = _list_names(layout, model, target.opt_state, layout.names)
    if sorted(here) != sorted(k for k, v in saved.items() if isinstance(v, list)):
        raise ValueError(f"checkpoint optimizer state holds {sorted(saved)}, expected {sorted(target.opt_state)}")
    target.opt_state["count"] = int(saved["count"])
    for key, names in here.items():
        if len(saved[key]) != len(whole[key]):
            raise ValueError(f"checkpoint optimizer state {key}: {len(saved[key])} tensors, expected "
                             f"{len(whole[key])}")
        by_name = dict(zip(whole[key], saved[key]))
        for dst, n in zip(target.opt_state[key], names):
            dst.copy_(by_name[n].to(dst.device))
    if target.ema_params is not None and payload["ema_params"]:
        for n, dst in target.ema_params.items():
            dst.copy_(payload["ema_params"][n].to(dst.device))
    target.step = int(payload["step"])
    return target


__all__ = [
    "PIPE_AXIS",
    "Elsewhere",
    "check_pipe_mesh",
    "gather_staged",
    "is_block_param",
    "make_pipeline_train_step",
    "pipeline_param_specs",
    "pipeline_parallel_decode",
    "pipeline_parallel_value_and_grad",
    "stage_model",
]
