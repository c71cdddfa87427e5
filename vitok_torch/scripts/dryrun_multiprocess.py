"""Multi-process dryrun: the distributed layouts, run for real on the CPU.

The port's counterpart of the JAX package's ``scripts/dryrun_multiprocess.py``:
it spawns N processes joined by gloo (a ``file://`` rendezvous in a
temporary folder, no port), lays a tiny AE over each mesh given
(``data``, ``data x fsdp``, ``fsdp x model``, ``model``, ...), and in every
process holds the sharded forward, one AdamW step and one Muon step
against the same model unsharded in that process on the whole batch, and a
checkpoint of the sharded state against the single-device layout; then a
step under selective recomputation (``remat_save``), one step of a tiny
DiT, and, where ``model`` splits the blocks, the int8 forward. A mesh with
``pipe`` (``pipe=4``, ``data=2,pipe=2``) stages a tiny AE with eight
decoder blocks instead and holds the pipelined decode, the loss and
gradients of ``pipeline_parallel_value_and_grad`` (``remat`` on and off),
the AdamW and Muon steps of ``make_pipeline_train_step`` with the full
loss, gradient accumulation, a decode and a step whose later stages are
given other rows (each takes stage 0's), and a checkpoint against one
process (:func:`compare_pipeline`). It prints one JSON report and exits 1 if a
layout disagrees.

    python -m vitok_torch.scripts.dryrun_multiprocess --processes 4 \\
        --mesh data=4 --mesh data=2,fsdp=2 --mesh fsdp=2,model=2 --mesh model=4
    python -m vitok_torch.scripts.dryrun_multiprocess --processes 4 --mesh pipe=4 --mesh data=2,pipe=2

With ``--cards`` it runs what crosses cards instead, one process a card over
NCCL (:func:`cards_job`: the halo exchange at 8 MiB a message, and the
pipeline against one process):

    python -m vitok_torch.scripts.dryrun_multiprocess --processes 4 --cards

The tests spawn their workers through :func:`spawn` and the jobs here: the
``spawn`` start method needs an importable target.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from vitok_torch.parallel.mesh import parse_mesh

VARIANT = "w256_d1_h4-w256_d1_h4/1x16x8"
GLOBAL_BATCH = 8
TOKENS = 16
GRIDS = [(4, 4), (3, 4), (4, 2), (2, 3), (4, 4), (1, 4), (3, 3), (4, 3)]
LR = 3e-4
LOSS = dict(ssim_weight=0.1, tile_size=32, n_tiles=2, patch=16, ssim_grid=(4, 4))
DIT_CODE, DIT_CLASSES = 8, 10


def mesh_name(axes: Dict[str, int]) -> str:
    return ",".join(f"{k}={v}" for k, v in axes.items())


def make_global_batch(seed: int = 0, b: int = GLOBAL_BATCH, n: int = TOKENS, grids=GRIDS, patch: int = 16):
    """A numpy NaFlex batch, the same in every process: sample i a dense
    ``grids[i]`` grid, tail padding; and SSIM tile origins for it."""
    rng = np.random.default_rng(seed)
    dim = patch * patch * 3
    d = {
        "patches": np.zeros((b, n, dim), np.float32),
        "patch_mask": np.zeros((b, n), bool),
        "row_idx": np.zeros((b, n), np.int32),
        "col_idx": np.zeros((b, n), np.int32),
        "orig_height": np.array([g[0] * patch for g in grids[:b]], np.int32),
        "orig_width": np.array([g[1] * patch for g in grids[:b]], np.int32),
    }
    for i, (gr, gc) in enumerate(grids[:b]):
        nv = gr * gc
        yy, xx = np.meshgrid(np.arange(gr), np.arange(gc), indexing="ij")
        d["patches"][i, :nv] = rng.standard_normal((nv, dim))
        d["patch_mask"][i, :nv] = True
        d["row_idx"][i, :nv] = yy.ravel()
        d["col_idx"][i, :nv] = xx.ravel()
    tiles = (rng.integers(0, 9, (b, LOSS["n_tiles"])), rng.integers(0, 9, (b, LOSS["n_tiles"])))
    return d, tiles


def build_model(variant: str = VARIANT, seed: int = 0, device="cpu", **overrides):
    """A trainable fp32 AE on ``device`` (default the CPU), its gains and
    LayerScale ~ U(0.5, 1.5) from numpy, the same in every process."""
    from vitok_torch.models.ae import AE, AEConfig

    cfg = AEConfig.from_variant(variant, **overrides)
    model = AE(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__}, seed=seed, device=device,
               compute_dtype=torch.float32, param_dtype=torch.float32, trainable=True)
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("norm1.weight", "norm_q.weight", "norm_k.weight", "layer_scale.gamma")):
                p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, tuple(p.shape)).astype(np.float32)))
    return model


def build_dit(seed: int = 0):
    """A trainable fp32 DiT on the CPU (width 256, four heads, two blocks,
    8-channel latents, 10 classes), its adaLN ``mod`` weights ~
    U(+-0.05) from numpy (adaLN-zero would gate every block off)."""
    from vitok_torch.models.dit import DiT

    model = DiT(width=256, depth=2, heads=4, code_width=DIT_CODE, text_dim=DIT_CLASSES, seed=seed, device="cpu",
                compute_dtype=torch.float32, param_dtype=torch.float32, trainable=True)
    rng = np.random.default_rng(seed + 2)
    with torch.no_grad():
        for blk in model.blocks:
            blk.mod.weight.copy_(torch.from_numpy(rng.uniform(-0.05, 0.05, tuple(blk.mod.weight.shape))
                                                  .astype(np.float32)))
    return model


def dit_step(model, z, labels, draws):
    """One AdamW step (constant LR, clipping at 1.0, EMA) of the flow-matching
    loss with the given draws: ``(state, loss)``."""
    from vitok_torch import train_lib as tl
    from vitok_torch.scripts.train_dit import make_dit_train_step

    tx = tl.create_optimizer(tl.create_schedule("constant", LR, 100, warmup_frac=0.0))
    state = tl.create_train_state(model, tx, ema=True)
    return make_dit_train_step(tx, DIT_CLASSES)(state, z, labels, draws=draws)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _rows(t, lo, hi):
    return tuple(torch.as_tensor(x)[lo:hi] for x in t)


def one_step(model, optimizer: str, batch, tiles, grad_accum: int = 1, loss: Optional[Dict[str, Any]] = None,
             feature_fn=None, rng=None):
    """One train step (constant LR, clipping at 1.0, EMA) of ``model`` on
    ``batch`` (the loss of :data:`LOSS`, or ``loss``): ``(state, metrics)``."""
    from vitok_torch import train_lib as tl

    tx = tl.create_optimizer(tl.create_schedule("constant", LR, 100, warmup_frac=0.0), optimizer=optimizer)
    state = tl.create_train_state(model, tx)
    step = tl.make_train_step(tx, tl.LossConfig(**(LOSS if loss is None else loss)), grad_accum=grad_accum,
                              feature_fn=feature_fn)
    return step(state, batch, rng, tile_indices=tiles)


def _max_abs(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> float:
    return max(float((a[k].detach().float() - b[k].detach().float()).abs().max()) for k in b)


def compare_layout(axes: Dict[str, int], workdir: str) -> Dict[str, Any]:
    """In this process: the tiny AE laid over ``axes`` against itself
    unsharded on the whole batch. Returns the largest differences."""
    from vitok_torch.parallel import create_mesh, shard_batch, shard_params
    from vitok_torch.parallel.sharding import local
    from vitok_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    mesh = create_mesh(axes, device="cpu")
    gbatch, gtiles = make_global_batch()
    batch = _torch_batch(gbatch)
    report: Dict[str, Any] = {}

    ref = build_model()
    want = ref(batch)["patches"]
    model = build_model()
    layout = shard_params(model, mesh)
    local_batch = shard_batch(batch, mesh)
    rank, size = layout.data_rank, layout.data_size
    lo, hi = rank * GLOBAL_BATCH // size, (rank + 1) * GLOBAL_BATCH // size
    got = layout.module(local_batch)["patches"]
    valid = local_batch["patch_mask"]
    report["forward_max_abs"] = float((got - want[lo:hi])[valid].abs().max())

    for opt in ("adamw", "muon"):
        ref = build_model()
        ref_state, ref_m = one_step(ref, opt, batch, _rows(gtiles, 0, GLOBAL_BATCH))
        model = build_model()
        layout = shard_params(model, mesh)
        state, m = one_step(model, opt, local_batch, _rows(gtiles, lo, hi))
        full = {n: layout.full(i, local(p).detach()) for i, (n, p) in enumerate(model.named_parameters())}
        ema = {n: layout.full(layout.names.index(n), t) for n, t in state.ema_params.items()}
        loss, ref_loss = float(m["loss/total"]), float(ref_m["loss/total"])
        report[opt] = {
            "params_max_abs": _max_abs(full, dict(ref.named_parameters())),
            "ema_max_abs": _max_abs(ema, ref_state.ema_params),
            "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
            "grad_norm_rel": abs(float(m["grad_norm"]) - float(ref_m["grad_norm"])) / float(ref_m["grad_norm"]),
            "moved": _max_abs(full, dict(build_model().named_parameters())),
        }
        if opt == "adamw":
            # The sharded state saves as the single-device checkpoint, and
            # loads back into a fresh sharded state.
            ckpt = os.path.join(workdir, "ckpt_" + mesh_name(axes).replace(",", "_").replace("=", ""))
            save_checkpoint(state, ckpt)
            payload = load_checkpoint(ckpt)
            report["checkpoint_params_max_abs"] = _max_abs(payload["params"], full)
            report["checkpoint_mu_max_abs"] = max(
                float((payload["opt_state"]["mu"][i] - layout.full(i, t)).abs().max())
                for i, t in enumerate(state.opt_state["mu"]))
            fresh = build_model(seed=5)
            flayout = shard_params(fresh, mesh)
            from vitok_torch import train_lib as tl

            tx = tl.create_optimizer(tl.create_schedule("constant", LR, 100, warmup_frac=0.0))
            target = load_checkpoint(ckpt, target=tl.create_train_state(fresh, tx))
            back = {n: flayout.full(i, local(p).detach()) for i, (n, p) in enumerate(fresh.named_parameters())}
            report["checkpoint_reload_max_abs"] = _max_abs(back, full)
            report["checkpoint_step"] = target.step

    # Gradient accumulation over the shard's rows (two microbatches) against
    # the whole batch in one (the JAX TestShardedGradAccum).
    ref = build_model()
    _, ref_m = one_step(ref, "adamw", batch, _rows(gtiles, 0, GLOBAL_BATCH))
    model = build_model()
    layout = shard_params(model, mesh)
    _, m = one_step(model, "adamw", local_batch, _rows(gtiles, lo, hi), grad_accum=2)
    full = {n: layout.full(i, local(p).detach()) for i, (n, p) in enumerate(model.named_parameters())}
    report["accum"] = {"params_max_abs": _max_abs(full, dict(ref.named_parameters())),
                       "loss_rel": abs(float(m["loss/total"]) - float(ref_m["loss/total"])) / float(ref_m["loss/total"])}

    # Selective recomputation: every block under checkpoint 1 keeping qkv
    # and the FFN hidden, its replay inside the block's call.
    remat = dict(checkpoint=1, remat_save=("qkv_out", "ffn_hid"))
    ref = build_model(**remat)
    _, ref_m = one_step(ref, "adamw", batch, _rows(gtiles, 0, GLOBAL_BATCH))
    model = build_model(**remat)
    layout = shard_params(model, mesh)
    _, m = one_step(model, "adamw", local_batch, _rows(gtiles, lo, hi))
    full = {n: layout.full(i, local(p).detach()) for i, (n, p) in enumerate(model.named_parameters())}
    report["remat"] = {"params_max_abs": _max_abs(full, dict(ref.named_parameters())),
                       "loss_rel": abs(float(m["loss/total"]) - float(ref_m["loss/total"])) / float(ref_m["loss/total"])}

    # The DiT: one flow-matching step, the draws fixed.
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.standard_normal((GLOBAL_BATCH, TOKENS, DIT_CODE)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, DIT_CLASSES, GLOBAL_BATCH))
    draws = {"sigma": torch.from_numpy(rng.uniform(0, 1, GLOBAL_BATCH).astype(np.float32)),
             "eps": torch.from_numpy(rng.standard_normal(z.shape).astype(np.float32)),
             "drop": torch.from_numpy(rng.uniform(0, 1, GLOBAL_BATCH) < 0.25)}
    ref = build_dit()
    _, ref_loss = dit_step(ref, z, labels, draws)
    model = build_dit()
    layout = shard_params(model, mesh)
    _, loss = dit_step(model, z[lo:hi], labels[lo:hi], {k: v[lo:hi] for k, v in draws.items()})
    full = {n: layout.full(i, local(p).detach()) for i, (n, p) in enumerate(model.named_parameters())}
    report["dit"] = {"params_max_abs": _max_abs(full, dict(ref.named_parameters())),
                     "loss_rel": abs(float(loss) - float(ref_loss)) / float(ref_loss),
                     "moved": _max_abs(full, dict(build_dit().named_parameters()))}

    if layout.tp:
        # int8 inference: qkv and out sliced, the FFN whole on each rank.
        want = build_model().quantize()(batch)["patches"]
        model = build_model().quantize()
        layout = shard_params(model, mesh)
        got = layout.module(local_batch)["patches"]
        report["int8_forward_max_abs"] = float((got - want[lo:hi])[valid].abs().max())
    return report


PIPE_VARIANT = "w256_d1_h4-w256_d8_h4/1x16x8"  # eight decoder blocks: two a stage under pipe=4
PIPE_FULL = dict(LOSS, perceptual_weight=0.5)  # with a random-init DINO ViT-S on the tiles


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _perceptual_fn():
    from vitok_torch.models.vit_features import load_dino_backbone, make_dino_feature_fn

    return make_dino_feature_fn(load_dino_backbone(None, size="S", device="cpu"), target_size=LOSS["tile_size"])


def pipe_step(model, optimizer: str, batch, tiles=None, grad_accum: int = 1, loss=None, feature_fn=None,
              microbatches=None, rng=None):
    """One pipelined train step (constant LR, clipping at 1.0, EMA) of a
    staged ``model``: ``(state, metrics)``."""
    from vitok_torch import train_lib as tl
    from vitok_torch.parallel import make_pipeline_train_step

    tx = tl.create_optimizer(tl.create_schedule("constant", LR, 100, warmup_frac=0.0), optimizer=optimizer)
    state = tl.create_train_state(model, tx)
    step = make_pipeline_train_step(tx, tl.LossConfig(**(LOSS if loss is None else loss)), feature_fn=feature_fn,
                                    grad_accum=grad_accum, num_microbatches=microbatches)
    return step(state, batch, rng, tile_indices=tiles)


def _error(fn) -> Optional[str]:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def compare_pipeline(axes: Dict[str, int], workdir: str) -> Dict[str, Any]:
    """In this process: the tiny eight-block AE staged over ``axes`` (a
    mesh with ``pipe``, and ``data`` at most) against itself unstaged on the
    whole batch. Saves the raw decode, loss, gradients and ``dz`` of
    ``pipe``-only meshes to ``workdir`` (``pipe_<rank>.npz``) for the JAX
    comparison. Returns the largest differences."""
    from vitok_torch.losses import charbonnier_loss
    from vitok_torch.parallel import (create_mesh, pipeline_parallel_decode, pipeline_parallel_value_and_grad,
                                      shard_batch, shard_params)
    from vitok_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    mesh = create_mesh(axes, device="cpu")
    n_stages, rank = axes["pipe"], torch.distributed.get_rank()
    gbatch, gtiles = make_global_batch()
    batch = _torch_batch(gbatch)
    report: Dict[str, Any] = {}
    saved: Dict[str, np.ndarray] = {}
    ref = build_model(PIPE_VARIANT)
    model = build_model(PIPE_VARIANT)
    layout = shard_params(model, mesh)
    local_batch = shard_batch(batch, mesh)
    lo, hi = layout.data_rank * GLOBAL_BATCH // layout.data_size, (layout.data_rank + 1) * GLOBAL_BATCH // layout.data_size
    report["blocks_held"] = sorted({int(n.split(".")[1]) for n in layout.local_names if n.startswith("decoder_blocks.")})

    # Decode: masked with m = S and 2S, and a batch without padding.
    dense = _torch_batch(make_global_batch(grids=[(4, 4)] * GLOBAL_BATCH)[0])
    for tag, b in (("masked", batch), ("dense", dense)):
        enc = ref.encode(b)
        want = ref.decode(enc)["patches"]
        local_enc = shard_batch(enc, mesh)
        valid = local_enc["patch_mask"]
        for m in (n_stages, 2 * n_stages) if tag == "masked" else (n_stages,):
            got = pipeline_parallel_decode(model, local_enc, num_microbatches=m)["patches"]
            report[f"decode_{tag}_m{m}_max_abs"] = float((got - want[lo:hi])[valid].abs().max())
            saved[f"decode_{tag}_m{m}"] = got.numpy()
        saved[f"z_{tag}"] = enc["z"].numpy()
    # The stages after the first given the masked batch's latents: the
    # decode is stage 0's, the dense batch's.
    mine = local_enc if layout.stage == 0 else shard_batch(ref.encode(batch), mesh)
    got = pipeline_parallel_decode(model, mine)["patches"]
    report["decode_stage0_max_abs"] = float((got - want[lo:hi])[valid].abs().max())

    # Loss and gradients: remat with m = S, the kept graph with m = 2S.
    enc = ref.encode(batch)
    z = enc["z"].clone().requires_grad_(True)
    out = ref._decode({**enc, "z": z}, deterministic=False)
    ref_loss = charbonnier_loss(out["patches"], batch["patches"], batch["patch_mask"])
    dec = [(n, p) for n, p in ref.named_parameters() if n.startswith(("decoder_", "to_pixels"))]
    got = torch.autograd.grad(ref_loss, [z] + [p for _, p in dec])
    ref_dz, ref_grads = got[0], dict(zip([n for n, _ in dec], got[1:]))
    local_enc = shard_batch(enc, mesh)
    for remat, m in ((True, n_stages), (False, 2 * n_stages)):
        tag = f"vjg_remat{int(remat)}"
        loss, grads, dz = pipeline_parallel_value_and_grad(model, local_enc, local_batch["patches"],
                                                           num_microbatches=m, remat=remat)
        report[tag] = {"loss_rel": abs(float(loss) - float(ref_loss.detach())) / float(ref_loss.detach()),
                       "grads_rel_l2": max(_rel_l2(g, ref_grads[n]) for n, g in grads.items()),
                       "dz_rel_l2": _rel_l2(dz, ref_dz[lo:hi]),
                       "blocks": sorted({int(n.split(".")[1]) for n in grads if n.startswith("decoder_blocks.")})}
        saved[f"{tag}/loss"] = np.asarray(float(loss))
        saved[f"{tag}/dz"] = dz.numpy()
        for n, g in grads.items():
            saved[f"{tag}/grad/{n}"] = g.numpy()

    # The train step, AdamW and Muon: the full loss (the perceptual term on
    # a data x pipe mesh), fixed tile origins, against one process.
    full_loss = PIPE_FULL if layout.data_size > 1 else LOSS
    feature_fn = _perceptual_fn() if layout.data_size > 1 else None
    tiles = _rows(gtiles, lo, hi)
    for opt in ("adamw", "muon"):
        ref_state, ref_m = one_step(build_model(PIPE_VARIANT), opt, batch, _rows(gtiles, 0, GLOBAL_BATCH), loss=full_loss,
                                    feature_fn=feature_fn)
        model = build_model(PIPE_VARIANT)
        layout = shard_params(model, mesh)
        state, m = pipe_step(model, opt, local_batch, tiles, loss=full_loss, feature_fn=feature_fn)
        full = layout.full_named({n: p.detach() for n, p in model.named_parameters()})
        ema = layout.full_named(state.ema_params)
        report[opt] = {
            "params_max_abs": _max_abs(full, dict(ref_state.model.named_parameters())),
            "ema_max_abs": _max_abs(ema, ref_state.ema_params),
            "loss_rel": max(abs(float(m[k]) - float(ref_m[k])) / abs(float(ref_m[k])) for k in ref_m
                            if k.startswith("loss/")),
            "grad_norm_rel": abs(float(m["grad_norm"]) - float(ref_m["grad_norm"])) / float(ref_m["grad_norm"]),
            "moved": _max_abs(full, dict(build_model(PIPE_VARIANT).named_parameters())),
            "metrics": sorted(m) == sorted(ref_m),
        }
        if opt == "adamw":
            ckpt = os.path.join(workdir, "ckpt_" + mesh_name(axes).replace(",", "_").replace("=", ""))
            save_checkpoint(state, ckpt)
            payload = load_checkpoint(ckpt)
            report["checkpoint_params_max_abs"] = _max_abs(payload["params"], full)
            report["checkpoint_ema_max_abs"] = _max_abs(payload["ema_params"], ema)
            mu = layout.full_named(dict(zip(layout.local_names, state.opt_state["mu"])))
            report["checkpoint_mu_max_abs"] = max(float((a - mu[n]).abs().max()) for n, a in zip(
                layout.names, payload["opt_state"]["mu"]))
            report["checkpoint_mu_layout"] = [tuple(t.shape) for t in payload["opt_state"]["mu"]] == [
                tuple(t.shape) for t in ref_state.opt_state["mu"]]
            from vitok_torch import train_lib as tl

            fresh = build_model(PIPE_VARIANT, seed=5)
            flayout = shard_params(fresh, mesh)
            tx = tl.create_optimizer(tl.create_schedule("constant", LR, 100, warmup_frac=0.0))
            target = load_checkpoint(ckpt, target=tl.create_train_state(fresh, tx))
            back = flayout.full_named({n: p.detach() for n, p in fresh.named_parameters()})
            report["checkpoint_reload_max_abs"] = _max_abs(back, full)
            report["checkpoint_step"] = target.step

    # Gradient accumulation: two chunks of the slice's rows against the
    # whole batch in one unsharded step.
    ref_state, ref_m = one_step(build_model(PIPE_VARIANT), "adamw", batch, _rows(gtiles, 0, GLOBAL_BATCH))
    model = build_model(PIPE_VARIANT)
    layout = shard_params(model, mesh)
    _, m = pipe_step(model, "adamw", local_batch, tiles, grad_accum=2, microbatches=2 if n_stages == 2 else None)
    full = layout.full_named({n: p.detach() for n, p in model.named_parameters()})
    report["accum"] = {"params_max_abs": _max_abs(full, dict(ref_state.model.named_parameters())),
                       "loss_rel": abs(float(m["loss/total"]) - float(ref_m["loss/total"])) / float(ref_m["loss/total"])}

    # The stages after the first given other rows, sizes and tile origins
    # (as a loader with a random pp gives each process its own crops): the
    # step takes stage 0's, the same reference.
    other, other_tiles = make_global_batch(seed=1, grids=GRIDS[::-1])
    model = build_model(PIPE_VARIANT)
    layout = shard_params(model, mesh)
    mine = (local_batch, tiles) if layout.stage == 0 else (shard_batch(_torch_batch(other), mesh), _rows(other_tiles, lo, hi))
    _, m = pipe_step(model, "adamw", *mine)
    full = layout.full_named({n: p.detach() for n, p in model.named_parameters()})
    report["stage0_rows"] = {"params_max_abs": _max_abs(full, dict(ref_state.model.named_parameters())),
                             "loss_rel": abs(float(m["loss/total"]) - float(ref_m["loss/total"])) / float(
                                 ref_m["loss/total"])}

    if layout.data_size == 1:
        # Tile origins drawn from the step's seed, as make_train_step draws them.
        ref_state, ref_m = one_step(build_model(PIPE_VARIANT), "adamw", batch, None, rng=5)
        model = build_model(PIPE_VARIANT)
        layout = shard_params(model, mesh)
        _, m = pipe_step(model, "adamw", batch, rng=5)
        full = layout.full_named({n: p.detach() for n, p in model.named_parameters()})
        report["seeded"] = {"params_max_abs": _max_abs(full, dict(ref_state.model.named_parameters())),
                            "loss_rel": abs(float(m["loss/total"]) - float(ref_m["loss/total"])) / float(
                                ref_m["loss/total"])}

        # int8: a quantize()d model's blocks stage as they are.
        qref = build_model(PIPE_VARIANT).quantize()
        qenc = qref.encode(batch)
        model = build_model(PIPE_VARIANT).quantize()
        shard_params(model, mesh)
        got = pipeline_parallel_decode(model, qenc)["patches"]
        report["int8_decode_max_abs"] = float((got - qref.decode(qenc)["patches"])[batch["patch_mask"]].abs().max())

        # The layouts and calls the pipeline refuses.
        def staged(variant=PIPE_VARIANT, **kw):
            model = build_model(variant, **kw)
            shard_params(model, mesh)
            return model

        odd = "w256_d1_h4-w256_d9_h4/1x16x8"  # nine decoder blocks: no pipe of 2 or 4 divides them
        report["errors"] = {
            "depth": _error(lambda: staged(odd)),
            "batch": _error(lambda: pipeline_parallel_decode(staged(), {k: v[:n_stages + 1] for k, v in enc.items()})),
            "microbatches": _error(lambda: pipeline_parallel_decode(staged(), enc, num_microbatches=n_stages // 2)),
            "model_axis": _error(lambda: shard_params(build_model(PIPE_VARIANT),
                                                      create_mesh({"pipe": n_stages // 2, "model": 2}, device="cpu"))),
            "drop_path": _error(lambda: pipeline_parallel_value_and_grad(staged(drop_path_rate=0.1), enc,
                                                                         batch["patches"])),
        }
        np.savez(os.path.join(workdir, f"pipe_{rank}.npz"), **saved)
    return report


CARDS_HALO_ROWS = 2048  # halo messages of 2048 x 1024 fp32 rows, 8 MiB: past NCCL's staging buffers


def cards_job(rank: int, world: int, workdir: str, device: str = "cpu", halo_rows: int = CARDS_HALO_ROWS) -> None:
    """What crosses cards, one process a card (under NCCL; ``device="cpu"``
    rehearses it over gloo): the halo exchange of ``halo_rows`` rows of
    width 1024 to each neighbour, forward and backward (both neighbours
    send at once: the exchange must be one group); then the tiny AE of
    :data:`PIPE_VARIANT` (fp32, the unfused attention: no kernel) staged
    over ``pipe=world`` against itself unstaged on this process's device:
    the masked decode, ``pipeline_parallel_value_and_grad`` with ``remat``
    on and off, and one AdamW step (Charbonnier + SSIM at fixed tile
    origins) against the unstaged step on the same microbatches. Saves
    ``cards_<rank>.json``."""
    import torch.distributed as dist

    from vitok_torch.losses import charbonnier_loss
    from vitok_torch.parallel import (comm, create_mesh, pipeline_parallel_decode, pipeline_parallel_value_and_grad,
                                      shard_params)

    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report: Dict[str, Any] = {"device": str(dev), "backend": dist.get_backend()}

    # The halo exchange: each rank's rows are its rank plus a ramp.
    rows = lambda r: torch.arange(2 * halo_rows * 1024, dtype=torch.float32, device=dev).reshape(
        1, 2 * halo_rows, 1024) / 1024 + r
    x = rows(rank).requires_grad_(True)
    left, right = comm.halo_exchange(x, halo_rows, dist.group.WORLD)
    report["halo"] = bool((torch.equal(left, rows(rank - 1)[:, -halo_rows:]) if rank > 0 else not left.any())
                          and (torch.equal(right, rows(rank + 1)[:, :halo_rows]) if rank < world - 1
                               else not right.any()))
    (left.sum() + 2 * right.sum()).backward()  # d/d head: 2 from the left neighbour, d/d tail: 1 from the right
    g = x.grad[0, :, 0]
    report["halo_grad"] = bool((g[:halo_rows] == (2.0 if rank > 0 else 0.0)).all()
                               and (g[halo_rows:] == (1.0 if rank < world - 1 else 0.0)).all())
    del x, left, right, g

    # The pipeline, against the unstaged model on the same device.
    mesh = create_mesh({"pipe": world}, device=dev.type)
    gbatch, gtiles = make_global_batch()
    batch = {k: v.to(dev) for k, v in _torch_batch(gbatch).items()}
    tiles = tuple(t.to(dev) for t in _rows(gtiles, 0, GLOBAL_BATCH))
    build = lambda: build_model(PIPE_VARIANT, device=dev, attn_impl="xla")
    ref, model = build(), build()
    shard_params(model, mesh)
    enc = ref.encode(batch)
    want, valid = ref.decode(enc)["patches"], batch["patch_mask"]
    for m in (world, 2 * world):
        got = pipeline_parallel_decode(model, enc, num_microbatches=m)["patches"]
        report[f"decode_masked_m{m}_max_abs"] = float((got - want)[valid].abs().max())
    z = enc["z"].clone().requires_grad_(True)
    ref_loss = charbonnier_loss(ref._decode({**enc, "z": z}, deterministic=False)["patches"], batch["patches"], valid)
    dec = [(n, p) for n, p in ref.named_parameters() if n.startswith(("decoder_", "to_pixels"))]
    got = torch.autograd.grad(ref_loss, [z] + [p for _, p in dec])
    ref_dz, ref_grads, ref_loss = got[0], dict(zip([n for n, _ in dec], got[1:])), float(ref_loss.detach())
    for remat, m in ((True, world), (False, 2 * world)):
        loss, grads, dz = pipeline_parallel_value_and_grad(model, enc, batch["patches"], num_microbatches=m,
                                                           remat=remat)
        report[f"vjg_remat{int(remat)}"] = {
            "loss_rel": abs(float(loss) - ref_loss) / ref_loss,
            "grads_rel_l2": max(_rel_l2(g, ref_grads[n]) for n, g in grads.items()),
            "dz_rel_l2": _rel_l2(dz, ref_dz)}
    # The reference steps on the pipeline's microbatches (gradient
    # accumulation over ``world`` chunks): on a card, products of other
    # shapes round otherwise, and the first Adam step carries that to the
    # parameters whose gradients are near 0 (2.5e-5 against the whole batch).
    ref_state, ref_m = one_step(build(), "adamw", batch, tiles, grad_accum=world)
    model = build()
    layout = shard_params(model, mesh)
    state, m = pipe_step(model, "adamw", batch, tiles)
    full = layout.full_named({n: p.detach() for n, p in model.named_parameters()})
    report["adamw"] = {
        "params_max_abs": _max_abs(full, dict(ref_state.model.named_parameters())),
        "ema_max_abs": _max_abs(layout.full_named(state.ema_params), ref_state.ema_params),
        "loss_rel": abs(float(m["loss/total"]) - float(ref_m["loss/total"])) / float(ref_m["loss/total"]),
        "grad_norm_rel": abs(float(m["grad_norm"]) - float(ref_m["grad_norm"])) / float(ref_m["grad_norm"])}
    report["launches"] = {k: v for k, v in kernel_launches().items() if v}
    with open(os.path.join(workdir, f"cards_{rank}.json"), "w") as f:
        json.dump(report, f)


def cards_check(n_processes: int, device: str = "cuda", halo_rows: int = CARDS_HALO_ROWS) -> Dict[str, Any]:
    """:func:`cards_job` in ``n_processes`` processes, one a card over NCCL
    (``device="cpu"``: over gloo on the host): ``{"ok", "failed", "ranks"}``."""
    with tempfile.TemporaryDirectory() as wd:
        spawn("cards_job", n_processes, wd, backend="nccl" if device == "cuda" else "gloo", device=device,
              halo_rows=halo_rows)
        reports = []
        for r in range(n_processes):
            with open(os.path.join(wd, f"cards_{r}.json")) as f:
                reports.append(json.load(f))
    bad = sorted({b for rep in reports for b in failures(rep, pipe=True)
                  + [k for k in ("halo", "halo_grad") if not rep[k]] + (["launches"] if rep["launches"] else [])})
    return {"ok": not bad, "failed": bad, "ranks": reports}


def metrics_mean(rank: int, world: int) -> float:
    """``MeanCovAccumulator`` over each process's rows, all-reduced, against
    the mean of all rows (the JAX ``TestDistributedMetrics``)."""
    from vitok_torch.metrics import MeanCovAccumulator

    x = np.random.default_rng(0).standard_normal((64, 16))
    acc = MeanCovAccumulator(16)
    acc.update(x[rank::world])
    acc.allreduce()
    mu, cov = acc.finalize()
    return max(float(np.abs(mu - x.mean(0)).max()), float(np.abs(cov - np.cov(x, rowvar=False)).max()))


def layouts_job(rank: int, world: int, workdir: str, meshes: Sequence[Dict[str, int]]) -> None:
    out = {mesh_name(axes): (compare_pipeline if "pipe" in axes else compare_layout)(axes, workdir)
           for axes in meshes}
    out["metrics"] = {"mean_cov_max_abs": metrics_mean(rank, world)}
    with open(os.path.join(workdir, f"layouts_{rank}.json"), "w") as f:
        json.dump(out, f)


def sequence_job(rank: int, world: int, workdir: str) -> None:
    """Sequence parallelism over ``seq=world``: the halo attention, the
    token-sharded forward and its loss and gradients, with and without
    padding, saved for the test to hold against the single-device port and
    the JAX package; then a ``data=world`` AdamW step of the same model."""
    from vitok_torch.parallel import (create_mesh, place_batch_token_sharded, sequence_parallel_forward,
                                      sequence_parallel_value_and_grad, shard_batch, shard_params)
    from vitok_torch.parallel.sequence import halo_attention, token_axis
    from vitok_torch.parallel.sharding import local

    mesh = create_mesh({"seq": world}, device="cpu")
    group = mesh["seq"].get_group()
    saved: Dict[str, np.ndarray] = {}
    # halo attention against the global windowed attention
    rng = np.random.default_rng(3)
    b, n, h, d, sw = 2, 32, 2, 64, 5
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32)) for _ in range(3))
    pm = torch.from_numpy(np.arange(n)[None, :] < np.array([[n], [23]]))
    nl = n // world
    sl = slice(rank * nl, (rank + 1) * nl)
    with token_axis(group):
        saved["halo"] = halo_attention(q[:, sl], k[:, sl], v[:, sl], pm[:, sl], sw).numpy()
    for padded in (False, True):
        tag = "pad" if padded else "full"
        grids = [(4, 4), (2, 4)] if padded else [(4, 4), (4, 4)]
        gbatch, _ = make_global_batch(seed=4, b=2, n=16, grids=grids)
        model = build_model(sw=2)
        shard = place_batch_token_sharded(_torch_batch(gbatch), mesh)
        saved[f"fwd_{tag}"] = sequence_parallel_forward(model, shard, mesh)["patches"].numpy()
        loss, grads = sequence_parallel_value_and_grad(model, shard, mesh)
        saved[f"loss_{tag}"] = np.asarray(float(loss))
        for (name, _), g in zip(model.named_parameters(), grads):
            saved[f"grad_{tag}/{name}"] = g.numpy()
    # a data-parallel AdamW step (Charbonnier loss), for the JAX package's step
    dmesh = create_mesh({"data": world}, device="cpu")
    gbatch, _ = make_global_batch(seed=6, b=2 * world)
    model = build_model()
    layout = shard_params(model, dmesh)
    state, metrics = one_step(model, "adamw", shard_batch(_torch_batch(gbatch), dmesh), None,
                              loss=dict(ssim_weight=0.0))
    saved["data_loss"] = np.asarray(float(metrics["loss/total"]))
    saved["data_grad_norm"] = np.asarray(float(metrics["grad_norm"]))
    for i, (name, p) in enumerate(model.named_parameters()):
        saved[f"data_param/{name}"] = layout.full(i, local(p).detach()).numpy()
    np.savez(os.path.join(workdir, f"sequence_{rank}.npz"), **saved)


def p2p_job(rank: int, world: int, workdir: str, device: str = "cpu", host_staged: bool = False) -> None:
    """Point-to-point transfers around the ring of ``world`` processes
    (``comm.isend`` / ``comm.irecv``), and a halo exchange, of tensors on
    ``device``; ``host_staged`` forces their copy through host memory (what
    gloo takes for a CUDA tensor). Saves whether each rank received what it
    should."""
    import torch.distributed as dist

    from vitok_torch.parallel import comm

    if host_staged:
        comm._host_staged = lambda t, group: True
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = dist.group.WORLD
    ramp = lambda shape, base: torch.arange(int(np.prod(shape)), dtype=torch.float32, device=dev).reshape(shape) + base
    got = torch.empty((3, 4), device=dev)
    nxt, prev = (rank + 1) % world, (rank - 1) % world
    for p in (comm.isend(ramp((3, 4), 100 * rank), nxt, group, tag=7), comm.irecv(got, prev, group, tag=7)):
        p.wait()
    left, right = comm.halo_exchange(ramp((2, 6, 3), 1000 * rank), 2, group)
    halo = ((rank == 0 or torch.equal(left, ramp((2, 6, 3), 1000 * (rank - 1))[:, -2:]))
            and (rank == world - 1 or torch.equal(right, ramp((2, 6, 3), 1000 * (rank + 1))[:, :2]))
            and (rank > 0 or not left.any()) and (rank < world - 1 or not right.any()))
    with open(os.path.join(workdir, f"p2p_{rank}.json"), "w") as f:
        json.dump({"ring": bool(torch.equal(got, ramp((3, 4), 100 * prev))), "halo": bool(halo),
                   "device": str(got.device)}, f)


def random_gates(model, device) -> None:
    """LayerScale gains ~ U(0.5, 1.5) from a generator seeded 1 on ``device``
    (every block matters), the same in every process."""
    gen = torch.Generator(device=device).manual_seed(1)
    with torch.no_grad():
        for blk in [*getattr(model, "encoder_blocks", ()), *getattr(model, "decoder_blocks", ())]:
            g = blk.layer_scale.gamma
            g.copy_(0.5 + torch.rand(g.shape, generator=gen, device=device))


def kernel_launches() -> Dict[str, int]:
    """The launch counts of the kernels a block runs: #1 and its q/k
    prologue, #3 (two a call), and the int8 block kernels."""
    from vitok_torch.ops import fused_attention as fa
    from vitok_torch.ops import quant

    return {"fused_attention": fa.LAUNCHES, "fused_qk_prologue": fa.PROLOGUE_LAUNCHES,
            "fused_attention_bwd": fa.BWD_LAUNCHES, **quant.LAUNCHES}


def reset_launches() -> None:
    from vitok_torch.ops import fused_attention as fa
    from vitok_torch.ops import quant

    fa.LAUNCHES = fa.PROLOGUE_LAUNCHES = fa.BWD_LAUNCHES = 0
    for k in quant.LAUNCHES:
        quant.LAUNCHES[k] = 0


def pipe_card_job(rank: int, world: int, workdir: str) -> None:
    """``pipe=world`` on the one device that ``workdir/pipe_job.pt`` names
    (gloo; on a card every process on ``cuda:0``), each run with the launch
    counts set to 0 before it and read after it: the 350M decode of the
    job's latents (bf16) in its microbatches; one training step of the
    job's fp32 state and batch (``attn_impl="fused"``, Charbonnier + SSIM at
    the job's tile origins); then the 5B decoder from seed 0 (bf16, then
    ``quantize()``d) on its latents. The stages after the first are given
    the inputs with their rows reversed: each entry point takes stage 0's.
    Every rank saves its launches, rank 0 the outputs, the loss and the
    whole parameters."""
    from vitok_torch import AE, decode_variant
    from vitok_torch import train_lib as tl
    from vitok_torch.parallel import (create_mesh, make_pipeline_train_step, pipeline_parallel_decode,
                                      shard_params)

    job = torch.load(os.path.join(workdir, "pipe_job.pt"), weights_only=True)
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    # Stage 0's inputs as the job has them, the other stages' reversed.
    on = lambda d: {k: (v if rank == 0 else v.flip(0)).to(device) for k, v in d.items()}
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    mesh = create_mesh({"pipe": world}, device=device.type)
    out: Dict[str, Any] = {"launches": {}}

    def counted(tag, fn):
        reset_launches()
        result = fn()
        sync()
        out["launches"][tag] = {k: v for k, v in kernel_launches().items() if v}
        return result

    state = {k: v.to(device) for k, v in job["state"].items()}
    model = AE(**decode_variant(job["variant"]), state_dict=state, device=device)
    shard_params(model, mesh)
    y = counted("decode", lambda: pipeline_parallel_decode(model, on(job["decode"]), job["microbatches"]))
    out["decode"] = y["patches"].cpu()
    del model

    model = AE(**{**decode_variant(job["variant"]), "attn_impl": "fused"}, state_dict=state, device=device,
               param_dtype=torch.float32, trainable=True)
    layout = shard_params(model, mesh)
    tx = tl.create_optimizer(tl.create_schedule("constant", job["lr"], 10, warmup_frac=0.0))
    st = tl.create_train_state(model, tx)
    step = make_pipeline_train_step(tx, tl.LossConfig(**job["loss"]), num_microbatches=job["microbatches"])
    tiles = on(dict(enumerate(job["tiles"])))
    st, metrics = counted("train", lambda: step(st, on(job["train"]), tile_indices=(tiles[0], tiles[1])))
    out["loss"] = float(metrics["loss/total"])
    out["grad_norm"] = float(metrics["grad_norm"])
    params = layout.full_named({n: p.detach() for n, p in model.named_parameters()})
    if rank == 0:
        out["params"] = {n: t.cpu() for n, t in params.items()}
    del model, st, params, state
    if device.type == "cuda":
        torch.cuda.empty_cache()

    big = AE(**decode_variant(job["big_variant"]), seed=0, device=device)
    random_gates(big, device)
    shard_params(big, mesh)
    big_in = on(job["big_decode"])
    out["big_decode"] = counted("big_decode", lambda: pipeline_parallel_decode(big, big_in, job["microbatches"])
                                )["patches"].cpu()
    big.quantize()
    out["big_int8"] = counted("big_int8", lambda: pipeline_parallel_decode(big, big_in, job["microbatches"])
                              )["patches"].cpu()
    torch.save(out if rank == 0 else {"launches": out["launches"]}, os.path.join(workdir, f"pipe_card_{rank}.pt"))


def ddp_job(rank: int, world: int, workdir: str) -> None:
    """``data=world`` on the one device that ``workdir/job.pt`` names (on a
    card every process on ``cuda:0``, gloo carrying the CUDA gradients): one
    AdamW step of the model and batch that the job holds
    (``attn_impl="fused"``), each rank on its rows; rank 0 saves the loss,
    the parameters and its kernel launches."""
    from vitok_torch import AE, decode_variant
    from vitok_torch import train_lib as tl
    from vitok_torch.ops import fused_attention as fa
    from vitok_torch.parallel import create_mesh, shard_batch, shard_params

    job = torch.load(os.path.join(workdir, "job.pt"), weights_only=True)
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    model = AE(**{**decode_variant(job["variant"]), "attn_impl": "fused"},
               state_dict={k: v.to(device) for k, v in job["state"].items()}, device=device,
               param_dtype=torch.float32, trainable=True)
    layout = shard_params(model, create_mesh({"data": world}, device=device.type))
    tx = tl.create_optimizer(tl.create_schedule("constant", job["lr"], 10, warmup_frac=0.0))
    state = tl.create_train_state(model, tx)
    batch = shard_batch({k: v.to(device) if hasattr(v, "to") else v for k, v in job["inputs"].items()},
                        layout.mesh)
    fa.LAUNCHES = fa.BWD_LAUNCHES = fa.PROLOGUE_LAUNCHES = 0
    state, metrics = tl.make_train_step(tx, tl.LossConfig(ssim_weight=0.0))(state, batch)
    if device.type == "cuda":
        torch.cuda.synchronize()
    if rank == 0:
        torch.save({"loss": float(metrics["loss/total"]),
                    "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
                    "launches": {"fused_attention": fa.LAUNCHES, "fused_attention_bwd": fa.BWD_LAUNCHES,
                                 "fused_qk_prologue": fa.PROLOGUE_LAUNCHES}},
                   os.path.join(workdir, f"ddp_{rank}.pt"))


def _entry(rank: int, world: int, job: str, workdir: str, backend: str, kwargs: Dict[str, Any]) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    if backend == "nccl":  # one card a process
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method="file://" + os.path.join(workdir, "rendezvous"), rank=rank,
                            world_size=world)
    try:
        globals()[job](rank, world, workdir, **kwargs)
    finally:
        dist.destroy_process_group()


def spawn(job: str, nprocs: int, workdir: str, backend: str = "gloo", **kwargs) -> None:
    """Run ``job(rank, world, workdir, **kwargs)`` of this module in
    ``nprocs`` fresh processes joined by ``backend`` (gloo; NCCL puts rank
    r on card r) through a ``file://`` rendezvous in ``workdir``; raises if
    any of them fails."""
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    # A parent run from stdin or -c has no main file for the children to
    # import again: hide the name meanwhile (the job lives in this module).
    main = sys.modules["__main__"]
    path = getattr(main, "__file__", None)
    hidden = path is not None and getattr(main, "__spec__", None) is None and not os.path.exists(path)
    if hidden:
        del main.__file__
    try:
        mp.start_processes(_entry, args=(nprocs, job, workdir, backend, kwargs), nprocs=nprocs, join=True,
                           start_method="spawn")
    finally:
        if hidden:
            main.__file__ = path


LIMITS = {"mean_cov_max_abs": 1e-6, "forward_max_abs": 1e-5, "int8_forward_max_abs": 1e-5, "params_max_abs": 1e-5,
          "ema_max_abs": 1e-5, "loss_rel": 1e-5, "checkpoint_params_max_abs": 0.0, "checkpoint_mu_max_abs": 0.0,
          "checkpoint_reload_max_abs": 0.0}
# A pipe mesh's report besides: the pipelined decode against one process,
# the loss and every gradient of pipeline_parallel_value_and_grad, the
# global gradient norm, and the int8 decode (the JAX TestInt8Pipeline's).
PIPE_LIMITS = {**LIMITS, "decode_stage0_max_abs": 1e-5, "decode_masked_m2_max_abs": 1e-5, "decode_masked_m4_max_abs": 1e-5,
               "decode_masked_m8_max_abs": 1e-5, "decode_dense_m2_max_abs": 1e-5, "decode_dense_m4_max_abs": 1e-5,
               "grads_rel_l2": 1e-4, "dz_rel_l2": 1e-4, "grad_norm_rel": 1e-6, "int8_decode_max_abs": 2e-4,
               "checkpoint_ema_max_abs": 0.0}
# Where ``model`` splits the blocks, the row-parallel partial sums add in
# another order, which the first Adam step carries to the parameters.
SPLIT_PARAMS_MAX_ABS = 3e-5


def failures(report: Dict[str, Any], split: bool = False, pipe: bool = False) -> List[str]:
    """The entries of a layout report beyond :data:`LIMITS` (``split``: a
    mesh with ``model``, held to :data:`SPLIT_PARAMS_MAX_ABS`; ``pipe``: a
    mesh with ``pipe``, held to :data:`PIPE_LIMITS`, every error case
    raised)."""
    limits = PIPE_LIMITS if pipe else LIMITS
    limits = {**limits, "params_max_abs": SPLIT_PARAMS_MAX_ABS} if split else limits
    bad = []
    for key, value in report.items():
        if key == "errors":
            bad += [f"errors.{k}" for k, msg in value.items() if msg is None]
        elif isinstance(value, dict):
            bad += [f"{key}.{k}" for k in failures(value, split, pipe)]
        elif key in limits and value > limits[key]:
            bad.append(key)
        elif key in ("metrics", "checkpoint_mu_layout") and value is not True:
            bad.append(key)
    return bad


def launch(n_processes: int = 4, meshes: Optional[Sequence[Dict[str, int]]] = None,
           workdir: Optional[str] = None) -> Dict[str, Any]:
    """Spawn ``n_processes`` gloo workers that each hold every mesh of
    ``meshes`` against the single-process model; returns ``{mesh: [each
    rank's report]}``."""
    meshes = list(meshes or ({"data": n_processes},))
    with tempfile.TemporaryDirectory() as tmp:
        wd = workdir or tmp
        spawn("layouts_job", n_processes, wd, meshes=meshes)
        reports = []
        for r in range(n_processes):
            with open(os.path.join(wd, f"layouts_{r}.json")) as f:
                reports.append(json.load(f))
    return {name: [rep[name] for rep in reports] for name in [mesh_name(m) for m in meshes] + ["metrics"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=4)
    ap.add_argument("--mesh", action="append", default=None,
                    help="a layout, e.g. data=2,fsdp=2 (repeat the flag for several; default data=N)")
    ap.add_argument("--cards", action="store_true",
                    help="instead: the halo exchange and a pipe=N pipeline, one process a card over NCCL")
    args = ap.parse_args(argv)
    if args.cards:
        result = cards_check(args.processes)
        print(json.dumps(result))
        return 0 if result["ok"] else 1
    meshes = [parse_mesh(m) for m in args.mesh] if args.mesh else None
    result = launch(args.processes, meshes)
    bad = {m: sorted({b for rep in reps for b in failures(rep, "model=" in m, "pipe=" in m)})
           for m, reps in result.items()}
    bad = {m: b for m, b in bad.items() if b}
    print(json.dumps({"ok": not bad, "processes": args.processes, "failed": bad, "layouts": result}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
