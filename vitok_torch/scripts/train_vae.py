"""Training CLI: NaFlex tokenizer training, on one device or a mesh of them.

The counterpart of the JAX package's ``scripts/train_vae.py`` with its flags
and defaults: variant, data, pp string, loss stack (masked Charbonnier +
SSIM tiles), schedule, AdamW or Muon (``--optimizer muon``) with clipping
and EMA, gradient accumulation, activation checkpointing with selective
saving (``--checkpoint 1 --remat-save qkv_out,ffn_hid,attn_out``), resume,
periodic and on-preemption checkpoints, a safetensors export at the end,
and the DINO perceptual term
(``--perceptual-weight``, ``--dino-size``, ``--dino-weights``: a frozen DINO
ViT on the SSIM tiles), and the sharding mesh (``--mesh data=D,fsdp=F,model=M``
under ``torchrun``: DDP, FSDP2 and tensor parallelism,
``vitok_torch.parallel``; ``--bs`` is each data shard's batch, the loader
rank-strided, logs, evals' prints and the safetensors export on the first
process, checkpoints written whole by it). ``--mesh pipe=K`` (or
``data=D,pipe=K``) stages the decoder blocks over K processes and trains
through the GPipe schedule of ``vitok_torch.parallel.pipeline`` with
``--pipe-microbatches`` microbatches (default K); each data shard trains
on its first stage's batch, which the step broadcasts over the stages (the
default pp's random crops differ from process to process). Left out:
``--wandb``.

    python -m vitok_torch.scripts.train_vae --variant Ld4-Ld24/1x16x64 \\
        --data /imgs --max-tokens 4096 --sw 1024 --bs 2 --steps 1000
    torchrun --standalone --nproc-per-node 4 -m vitok_torch.scripts.train_vae \\
        --variant Ld4-Ld24/1x16x64 --data /imgs --bs 8 --mesh data=2,fsdp=2
    torchrun --standalone --nproc-per-node 4 -m vitok_torch.scripts.train_vae \\
        --variant Td4-T/1x16x64 --data /imgs --bs 8 --mesh pipe=4 --pipe-microbatches 8

Runs on the card (``--device cuda``, the default; it raises without one);
``--device cpu`` trains on the host, for small models and tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

H100_BF16_PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 tensor-core rate


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # model
    ap.add_argument("--variant", default="Ld2-Ld22/1x16x64")
    ap.add_argument("--checkpoint", type=int, default=0,
                    help="recompute in the backward: 0=off, 1=every block, k=every k-th block")
    ap.add_argument("--remat-save", default="",
                    help="under --checkpoint 1 (or -1), the block intermediates kept across the backward "
                         "(h_norm, qkv_out, ffn_hid, q_rot, k_rot, attn_out; comma-separated); "
                         "the rest is recomputed")
    ap.add_argument("--sw", type=int, default=None, help="sliding window")
    ap.add_argument("--pretrained", default=None, help="pretrained name to finetune from")
    # data
    ap.add_argument("--data", required=True)
    ap.add_argument("--pp", default=None)
    ap.add_argument("--max-tokens", type=int, default=256)
    ap.add_argument("--patch", type=int, default=16)
    ap.add_argument("--bs", type=int, default=32, help="batch size")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="split each bs-sized batch into this many sequential microbatches "
                         "(one optimizer update per step)")
    # optimization
    ap.add_argument("--steps", type=int, default=100_000)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine")
    ap.add_argument("--warmup-frac", type=float, default=0.05)
    ap.add_argument("--wd", type=float, default=1e-4)
    ap.add_argument("--b1", type=float, default=0.9)
    ap.add_argument("--b2", type=float, default=0.99)
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "muon"])
    ap.add_argument("--momentum", type=float, default=0.95, help="muon momentum")
    ap.add_argument("--moment-dtype", default=None, choices=[None, "bf16"],
                    help="store AdamW's first moment (Muon's momentum) in bf16; AdamW's second stays fp32")
    ap.add_argument("--ema-decay", type=float, default=0.999)
    ap.add_argument("--no-ema", action="store_true")
    # losses
    ap.add_argument("--charbonnier-weight", type=float, default=1.0)
    ap.add_argument("--ssim-weight", type=float, default=0.1)
    ap.add_argument("--perceptual-weight", type=float, default=0.0,
                    help="DINO feature loss weight (the reference uses 500.0)")
    ap.add_argument("--tile-size", type=int, default=256)
    ap.add_argument("--n-tiles", type=int, default=2)
    ap.add_argument("--dino-weights", default=None,
                    help="timm-named DINO ViT state dict (.pth/.safetensors); defaults to $VITOK_DINO_WEIGHTS, "
                         "else random init")
    ap.add_argument("--dino-size", default="S", choices=["S", "B"])
    ap.add_argument("--drop-path", type=float, default=0.0)
    # io / cadence
    ap.add_argument("--output-dir", default="./output")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-freq", type=int, default=50)
    ap.add_argument("--eval-freq", type=int, default=0)
    ap.add_argument("--save-freq", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    # parallelism
    ap.add_argument("--mesh", default=None,
                    help="data=D,fsdp=F,model=M or data=D,pipe=K under torchrun (one -1 takes the processes left); "
                         "default: all processes on data")
    ap.add_argument("--pipe-microbatches", type=int, default=None,
                    help="GPipe microbatches for --mesh pipe=K (default K; a multiple of K dividing --bs)")
    return ap


def default_pp(patch: int, max_tokens: int) -> str:
    grid_side = int(math.isqrt(max_tokens))
    return (
        f"random_choice(['random_resized_crop({grid_side * patch})', 'identity'], [0.25, 0.75])"
        f"|flip|to_tensor|normalize(minus_one_to_one)|"
        f"resize_to_token_budget({patch}, {max_tokens})|patchify({patch}, {max_tokens})"
    )


def _to_device(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items() if isinstance(v, np.ndarray)}


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from vitok_torch.data import create_dataloader
    from vitok_torch.losses import psnr as psnr_fn, ssim as ssim_fn
    from vitok_torch.models.ae import AE, AEConfig
    from vitok_torch.train_lib import (
        LossConfig,
        create_optimizer,
        create_schedule,
        create_train_state,
        make_train_step,
        unpatchify_dense_static,
    )
    from vitok_torch.parallel import make_pipeline_train_step, pipeline_parallel_decode, shard_params
    from vitok_torch.parallel.mesh import DATA_AXIS, FSDP_AXIS, MODEL_AXIS, PIPE_AXIS, cli_mesh, parse_mesh
    from vitok_torch.utils.checkpoint import export_safetensors, load_checkpoint, save_checkpoint
    from vitok_torch.utils.device import resolve_device
    from vitok_torch.utils.preemption import PreemptionGuard

    axes = parse_mesh(args.mesh) or {}
    pipe = PIPE_AXIS in axes
    if pipe:
        others = {k: v for k, v in axes.items() if k not in (PIPE_AXIS, DATA_AXIS) and v != 1}
        if others:
            raise SystemExit(f"--mesh pipe=K composes with data=D only (data replicas of the pipe group), got extra "
                             f"{others}")
        if args.drop_path:
            raise SystemExit("--drop-path needs a gate per microbatch and block inside the GPipe schedule; pipeline "
                             "training runs with 0 (the reference's high-resolution finetune regime)")
    elif args.pipe_microbatches is not None:
        raise SystemExit("--pipe-microbatches needs --mesh pipe=K")
    mesh, rank, world, device = cli_mesh(args.mesh, args.device, allowed=(DATA_AXIS, FSDP_AXIS, MODEL_AXIS, PIPE_AXIS),
                                         hint="; sequence parallelism: vitok_torch.scripts.train_highres")
    device = resolve_device(device)
    is_main = rank == 0
    say = print if is_main else (lambda *a, **k: None)
    say(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    if mesh is not None:
        say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}, processes: {world}")

    # --- model + state ---------------------------------------------------
    cfg = AEConfig.from_variant(
        args.variant,
        checkpoint=args.checkpoint,
        remat_save=tuple(s.strip() for s in args.remat_save.split(",") if s.strip()),
        sw=args.sw,
        drop_path_rate=args.drop_path,
    )
    state_dict = None
    if args.pretrained:
        from vitok_torch.pretrained import load_pretrained_params

        _, state_dict = load_pretrained_params(args.pretrained)
    model = AE(**dataclasses.asdict(cfg), state_dict=state_dict, seed=args.seed, device=device,
               param_dtype=torch.float32, trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    layout = shard_params(model, mesh) if mesh is not None else None

    schedule = create_schedule(args.schedule, args.lr, args.steps, args.warmup_frac)
    tx = create_optimizer(
        schedule, weight_decay=args.wd, b1=args.b1, b2=args.b2, grad_clip=args.grad_clip,
        optimizer=args.optimizer, momentum=args.momentum,
        moment_dtype=torch.bfloat16 if args.moment_dtype == "bf16" else None,
    )
    state = create_train_state(model, tx, ema=not args.no_ema)

    ckpt_dir = os.path.join(os.path.abspath(args.output_dir), "last")
    if args.resume and os.path.exists(ckpt_dir):
        state = load_checkpoint(ckpt_dir, target=state)
        say(f"resumed at step {state.step}")

    # --- data ------------------------------------------------------------
    grid_side = int(math.isqrt(args.max_tokens))
    pp = args.pp or default_pp(args.patch, args.max_tokens)
    shard, shards = (layout.data_rank, layout.data_size) if layout is not None else (0, 1)
    loader = create_dataloader(args.data, pp, batch_size=args.bs, seed=args.seed, rank=shard, world=shards,
                               repeat=True)

    loss_cfg = LossConfig(
        charbonnier_weight=args.charbonnier_weight,
        ssim_weight=args.ssim_weight,
        perceptual_weight=args.perceptual_weight,
        tile_size=args.tile_size,
        n_tiles=args.n_tiles,
        patch=args.patch,
        ssim_grid=(grid_side, grid_side) if (args.ssim_weight or args.perceptual_weight) else None,
    )
    # DINO perceptual backbone: frozen, fp32, on the SSIM tiles resized to --tile-size.
    feature_fn = None
    if args.perceptual_weight:
        from vitok_torch.models.vit_features import load_dino_backbone, make_dino_feature_fn

        src = args.dino_weights or os.environ.get("VITOK_DINO_WEIGHTS")
        dino = load_dino_backbone(src, size=args.dino_size, device=device)
        feature_fn = make_dino_feature_fn(dino, target_size=args.tile_size)
        say(f"DINO perceptual: ViT-{args.dino_size} ({'weights=' + src if src else 'RANDOM INIT'})")
    if pipe:  # loss_cfg as it is: --charbonnier-weight holds without the tiles too
        train_step = make_pipeline_train_step(tx, loss_cfg, ema_decay=args.ema_decay, feature_fn=feature_fn,
                                              grad_accum=args.grad_accum, num_microbatches=args.pipe_microbatches)
    else:
        train_step = make_train_step(tx, loss_cfg, ema_decay=args.ema_decay, feature_fn=feature_fn,
                                     grad_accum=args.grad_accum)

    def reconstruct(b):
        if pipe:  # the encoder is whole on every stage; the decoder runs through the stages
            return pipeline_parallel_decode(model, model.encode(b), num_microbatches=args.pipe_microbatches)
        return model(b)

    # --- loop ------------------------------------------------------------
    guard = PreemptionGuard()
    step = state.step
    loader_iter = iter(loader)
    t_log = time.perf_counter()
    data_ms = 0.0

    def next_batch():
        nonlocal loader_iter
        try:
            return next(loader_iter)
        except StopIteration:
            loader_iter = iter(loader)
            return next(loader_iter)

    while step < args.steps:
        t0 = time.perf_counter()
        batch = _to_device(next_batch(), device)
        data_ms += (time.perf_counter() - t0) * 1e3

        state, metrics = train_step(state, batch, args.seed + 1)
        step += 1

        if step % args.log_freq == 0:
            log = {k: float(v) for k, v in metrics.items()}  # reads back: the step has finished
            dt = time.perf_counter() - t_log
            steps_per_s = args.log_freq / dt
            tokens_per_s = steps_per_s * args.bs * shards * args.max_tokens
            log.update({
                "lr": float(schedule(step)),
                "timing/steps_per_s": steps_per_s,
                "timing/tokens_per_s": tokens_per_s,
                "timing/data_ms_per_step": data_ms / args.log_freq,
                "perf/samples_per_s": steps_per_s * args.bs * shards,
            })
            if device.type == "cuda":
                log["perf/mfu"] = 6 * n_params * tokens_per_s / (H100_BF16_PEAK_FLOPS * world)
            if is_main:
                print(f"step {step}: " + json.dumps({k: round(v, 5) for k, v in log.items()}), flush=True)
            t_log = time.perf_counter()
            data_ms = 0.0

        if args.eval_freq and step % args.eval_freq == 0:
            # Quick reconstruction eval on a few batches: SSIM/PSNR of masked reconstructions.
            ssim_vals, psnr_vals = [], []
            eval_iter = iter(loader)
            for _ in range(4):
                try:
                    eb = _to_device(next(eval_iter), device)
                except StopIteration:
                    break
                out = reconstruct(eb)
                rec = unpatchify_dense_static(dict(out), grid_side, grid_side, args.patch)
                ref_img = unpatchify_dense_static(dict(eb), grid_side, grid_side, args.patch)
                ssim_vals.append(float(ssim_fn(ref_img, rec)))
                psnr_vals.append(float(psnr_fn(ref_img, rec)))
            del eval_iter
            if ssim_vals:
                ev = {"eval/ssim": sum(ssim_vals) / len(ssim_vals),
                      "eval/psnr": sum(psnr_vals) / len(psnr_vals)}
                if is_main:
                    print(f"step {step} eval: " + json.dumps({k: round(v, 4) for k, v in ev.items()}), flush=True)

        if args.save_freq and step % args.save_freq == 0:
            save_checkpoint(state, ckpt_dir)
            say(f"saved checkpoint at step {step}")

        if guard.should_stop:
            # Preemption (SIGTERM) or Ctrl-C: save and exit cleanly.
            save_checkpoint(state, ckpt_dir)
            say(f"preempted: checkpoint saved at step {step}")
            guard.restore()
            _finish()
            return

    guard.restore()
    save_checkpoint(state, ckpt_dir)
    export_dir = os.path.join(os.path.abspath(args.output_dir), "safetensors")
    weights = state.ema_params if state.ema_params is not None else model.state_dict()
    if layout is not None:  # whole tensors, gathered by every process
        from vitok_torch.parallel.sharding import local

        weights = layout.full_named(state.ema_params or {n: local(p).detach() for n, p in model.named_parameters()})
    if is_main:
        written = export_safetensors(weights, export_dir)
        print("training done;", "exported:", written)
    _finish()


def _finish() -> None:
    """Every process leaves the group it joined."""
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
