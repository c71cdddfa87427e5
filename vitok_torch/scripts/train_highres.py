"""High-resolution finetune CLI: token-sharded (sequence-parallel) training.

The counterpart of the JAX package's ``scripts/train_highres.py``:
finetuning at 1024p-8192p (4k-262k tokens an image), where one card cannot
hold one image's activations. The token axis splits over the processes of
the ``seq`` group (``vitok_torch.parallel.sequence``): sliding-window
attention exchanges only its ``sw`` boundary keys and values a layer, and
the Charbonnier reconstruction backward runs token-sharded.

The finetune subset of the main trainer: Charbonnier loss only (SSIM tiles
and the perceptual term need whole images, the gather this avoids), AdamW +
EMA, resume. The state layout is ``train_lib.TrainState``'s, so a
``train_vae`` checkpoint loads (``--init-ckpt``: parameters and EMA, a fresh
optimizer and step) and the result exports to the same safetensors.

One host, four cards, one 2048p image a step (16,384 tokens):

    torchrun --standalone --nproc-per-node 4 -m vitok_torch.scripts.train_highres \\
        --data /imgs --seq 4 --sw 1024 --res 2048 --bs 1 --steps 2000 --pretrained vitok-350M

Runs on the card (``--device cuda``, NCCL); ``--device cpu`` over gloo, for
small models and tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

H100_BF16_PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 tensor-core rate


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # model
    ap.add_argument("--variant", default="Ld2-Ld22/1x16x64")
    ap.add_argument("--sw", type=int, required=True,
                    help="sliding window (the halo; required: global attention does not token-shard)")
    ap.add_argument("--checkpoint", type=int, default=0)
    ap.add_argument("--remat-save", default="")
    ap.add_argument("--pretrained", default=None, help="pretrained name to finetune from")
    ap.add_argument("--init-ckpt", default=None,
                    help="a train_vae checkpoint directory to start from (parameters + EMA)")
    # data
    ap.add_argument("--data", required=True)
    ap.add_argument("--pp", default=None)
    ap.add_argument("--res", type=int, default=1024, help="finetune resolution (square crop)")
    ap.add_argument("--patch", type=int, default=16)
    ap.add_argument("--bs", type=int, default=1, help="images a step (every token shard holds all of them)")
    # optimization
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=3e-5)
    ap.add_argument("--schedule", default="cosine")
    ap.add_argument("--warmup-frac", type=float, default=0.05)
    ap.add_argument("--wd", type=float, default=1e-4)
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--ema-decay", type=float, default=0.999)
    ap.add_argument("--no-ema", action="store_true")
    ap.add_argument("--drop-path", type=float, default=0.0)
    # parallelism
    ap.add_argument("--seq", type=int, default=None, help="token shards (default: every process)")
    # io / cadence
    ap.add_argument("--output-dir", default="./output_highres")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-freq", type=int, default=10)
    ap.add_argument("--save-freq", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default, NCCL) or 'cpu' (gloo)")
    return ap


def check_geometry(res: int, patch: int, n_seq: int, sw: int) -> int:
    """The tokens of an image, after the geometry checks: they split evenly
    over the shards, and each shard holds at least the window."""
    tokens = (res // patch) ** 2
    if tokens % n_seq:
        raise SystemExit(f"tokens {tokens} (res {res}, patch {patch}) not divisible by seq={n_seq}")
    if sw > tokens // n_seq:
        raise SystemExit(f"--sw {sw} exceeds tokens per shard {tokens // n_seq}; "
                         "the halo exchange needs sw <= local tokens")
    return tokens


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from vitok_torch.data import create_dataloader
    from vitok_torch.models.ae import AE, AEConfig
    from vitok_torch.parallel import create_mesh, initialize_distributed
    from vitok_torch.parallel.sequence import make_sp_train_step, place_batch_token_sharded
    from vitok_torch.train_lib import create_optimizer, create_schedule, create_train_state
    from vitok_torch.utils.checkpoint import export_safetensors, load_checkpoint, save_checkpoint
    from vitok_torch.utils.device import resolve_device
    from vitok_torch.utils.preemption import PreemptionGuard

    kind = torch.device(args.device).type
    rank, world, local_rank = initialize_distributed(kind)
    device = resolve_device(torch.device("cuda", local_rank) if kind == "cuda" and world > 1 else args.device)
    n_seq = args.seq or world
    if n_seq != world:
        raise SystemExit(f"--seq {n_seq}: the token axis spans every process ({world})")
    mesh = create_mesh({"seq": n_seq}, device=kind)
    is_main = rank == 0
    say = print if is_main else (lambda *a, **k: None)
    tokens = check_geometry(args.res, args.patch, n_seq, args.sw)
    say(f"seq mesh: {n_seq} shards, {tokens} tokens/img ({tokens // n_seq}/shard), sw={args.sw}")

    # --- model + state ---------------------------------------------------
    cfg = AEConfig.from_variant(
        args.variant, checkpoint=args.checkpoint,
        remat_save=tuple(s.strip() for s in args.remat_save.split(",") if s.strip()),
        sw=args.sw, drop_path_rate=args.drop_path)
    state_dict = None
    if args.pretrained:
        from vitok_torch.pretrained import load_pretrained_params

        _, state_dict = load_pretrained_params(args.pretrained)
    model = AE(**dataclasses.asdict(cfg), state_dict=state_dict, seed=args.seed, device=device,
               param_dtype=torch.float32, trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    schedule = create_schedule(args.schedule, args.lr, args.steps, args.warmup_frac)
    tx = create_optimizer(schedule, weight_decay=args.wd, grad_clip=args.grad_clip)
    state = create_train_state(model, tx, ema=not args.no_ema)
    if args.init_ckpt:
        # Warm start: parameters (+ EMA) of a pretraining checkpoint; the
        # optimizer state and the step start fresh for the finetune schedule.
        pre = load_checkpoint(args.init_ckpt)
        model.load_state_dict(pre["params"])
        if state.ema_params is not None and pre["ema_params"]:
            for n, t in state.ema_params.items():
                t.copy_(pre["ema_params"][n])
        say(f"warm-started params from {args.init_ckpt}")
    ckpt_dir = os.path.join(os.path.abspath(args.output_dir), "last")
    if args.resume and os.path.exists(ckpt_dir):
        state = load_checkpoint(ckpt_dir, target=state)
        say(f"resumed at step {state.step}")

    def save():
        if is_main:  # the state is replicated: one process writes it
            save_checkpoint(state, ckpt_dir)
        torch.distributed.barrier()

    # --- data: every shard reads the same images and keeps its tokens ------
    pp = args.pp or (f"random_resized_crop({args.res})|flip|to_tensor|"
                     f"normalize(minus_one_to_one)|patchify({args.patch}, {tokens})")
    loader = create_dataloader(args.data, pp, batch_size=args.bs, seed=args.seed, repeat=True)
    train_step = make_sp_train_step(tx, mesh, ema_decay=args.ema_decay, stochastic=args.drop_path > 0.0)

    # --- loop ------------------------------------------------------------
    guard = PreemptionGuard()
    loader_iter = iter(loader)
    t_log = time.perf_counter()
    while state.step < args.steps:
        try:
            batch = next(loader_iter)
        except StopIteration:
            loader_iter = iter(loader)
            batch = next(loader_iter)
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items() if isinstance(v, np.ndarray)}
        state, metrics = train_step(state, place_batch_token_sharded(batch, mesh), args.seed + 1)
        step = state.step
        if step % args.log_freq == 0:
            log = {k: float(v) for k, v in metrics.items()}  # reads back: the step has finished
            dt = time.perf_counter() - t_log
            steps_per_s = args.log_freq / dt
            tokens_per_s = steps_per_s * args.bs * tokens
            log.update({"lr": float(schedule(step)), "timing/steps_per_s": steps_per_s,
                        "perf/tokens_per_s": tokens_per_s})
            if device.type == "cuda":
                log["perf/mfu"] = 6 * n_params * tokens_per_s / (H100_BF16_PEAK_FLOPS * world)
            say(f"step {step}: " + json.dumps({k: round(v, 5) for k, v in log.items()}), flush=True)
            t_log = time.perf_counter()
        if args.save_freq and step % args.save_freq == 0:
            save()
            say(f"saved checkpoint at step {step}")
        if guard.should_stop:
            save()
            say(f"preempted: checkpoint saved at step {step}")
            break
    else:
        save()
        if is_main:
            written = export_safetensors(state.ema_params if state.ema_params is not None else model.state_dict(),
                                         os.path.join(os.path.abspath(args.output_dir), "safetensors"))
            print("finetune done;", "exported:", written)
    guard.restore()
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
