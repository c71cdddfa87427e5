"""DiT flow-matching training over ViTok latents, on one device or a mesh of them.

The counterpart of the JAX package's ``scripts/train_dit.py`` with its flags
and defaults: the rectified-flow objective
``min E || v_theta(x_sigma, sigma, c) - (eps - z) ||^2`` with
``x_sigma = (1 - sigma) z + sigma eps``, uniform (optionally shifted) sigma,
classifier-free-guidance label dropout to the null class, AdamW or Muon
(``--optimizer muon``, momentum 0.95, as the JAX CLI passes only the name)
with clipping (``train_lib``), EMA, resume and periodic checkpoints, and the
sharding mesh (``--mesh data=D,fsdp=F,model=M`` under ``torchrun``: DDP,
FSDP2 and tensor parallelism over the DiT's blocks, their adaLN ``mod``
whole, ``vitok_torch.parallel``; ``--bs`` is each data shard's batch, the
latent files rank-strided, logs on the first process, checkpoints written
whole by it). ``--mesh pipe=K`` exits: pipeline parallelism stages the AE's
decoder (``train_vae``).

Latents come from a directory of precomputed ``.npy`` latent files (each a
pickled dict with ``z [N, c]`` and ``label``), or on the fly from an image
folder through a frozen AE encoder (``--ae``).

    python -m vitok_torch.scripts.train_dit --dit L/256 --ae Ld4-Ld24/1x16x64 \\
        --data /imgs --bs 64 --steps 100000

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
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def flow_matching_loss(
    dit,
    z: torch.Tensor,
    labels: torch.Tensor,
    num_classes: int,
    cfg_dropout: float = 0.1,
    shift: float = 1.0,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """The rectified-flow training loss of one batch of latents ``z
    [B, N, c]`` with class ``labels [B]``.

    The random draws come from ``generator`` in this order: sigma ~ U(0, 1)
    ``[B]``, eps ~ N(0, 1) of ``z``'s shape, the CFG drop ~ Bernoulli
    (``cfg_dropout``) ``[B]``; ``draws`` (``sigma``, ``eps``, ``drop``)
    replaces them where given. sigma is shifted as
    ``shift * s / (1 + (shift - 1) * s)``; a dropped label becomes the null
    class ``num_classes``; the model sees ``t = 1000 * sigma``.
    """
    dev = getattr(dit, "module", dit).device  # a DDP wrapper holds the DiT as .module
    z = torch.as_tensor(z, dtype=torch.float32).to(dev)
    labels = torch.as_tensor(labels).to(dev).long()
    b = z.shape[0]
    draws = draws or {}
    gdev = generator.device if generator is not None else dev

    def draw(name, make):
        if name in draws:
            return torch.as_tensor(draws[name]).to(dev)
        return make().to(dev)

    sigma = draw("sigma", lambda: torch.rand((b,), generator=generator, device=gdev)).float()
    if shift != 1.0:
        sigma = shift * sigma / (1.0 + (shift - 1.0) * sigma)
    eps = draw("eps", lambda: torch.randn(z.shape, generator=generator, device=gdev)).float()
    drop = draw("drop", lambda: torch.rand((b,), generator=generator, device=gdev) < cfg_dropout).bool()
    x_sigma = (1.0 - sigma[:, None, None]) * z + sigma[:, None, None] * eps
    ctx = torch.where(drop, torch.full_like(labels, num_classes), labels)
    v_pred = dit({"z": x_sigma, "t": sigma * 1000.0, "context": ctx}, deterministic=False)
    return torch.mean((v_pred.float() - (eps - z)) ** 2)


def make_dit_train_step(tx, num_classes: int, cfg_dropout: float = 0.1, shift: float = 1.0,
                        ema_decay: float = 0.9999):
    """Build ``step(state, z, labels, rng=None, draws=None) -> (state, loss)``.

    ``state`` is a ``train_lib.TrainState`` holding the DiT. ``rng`` is a
    ``torch.Generator`` or an integer seed (then each step draws from a fresh
    generator seeded from it and ``state.step``, so a resumed run repeats an
    uninterrupted one). Updates the model, optimizer state and EMA in place;
    the loss is a 0-d tensor on the model's device (nothing is read back).
    Under a layout (``state.layout``: DDP, FSDP2, tensor parallelism) ``z``
    and ``labels`` are this rank's rows, the wrapped model's backward
    reduces the gradients, and the loss is the mean over the batch shards.
    """
    from vitok_torch.parallel.sharding import local
    from vitok_torch.train_lib import update_ema

    def step(state, z, labels, rng=None, draws=None) -> Tuple[Any, torch.Tensor]:
        model, layout = state.model, state.layout
        generator = rng
        if isinstance(rng, int):
            shard = 0 if layout is None else layout.data_rank
            generator = torch.Generator(device=model.device).manual_seed(rng * 1_000_003 + state.step + 7919 * shard)
        params = list(model.parameters())
        loss = flow_matching_loss(model if layout is None else layout.module, z, labels, num_classes, cfg_dropout,
                                  shift, generator=generator, draws=draws)
        loss.backward()  # under DDP and FSDP2 this also reduces the gradients
        grads = [local(p.grad) for p in params]
        for p in params:
            p.grad = None
        tx.update([local(p) for p in params], [g.to(p.dtype) for g, p in zip(grads, params)], state.opt_state,
                  layout=layout)
        if layout is not None:
            loss = layout.mean_over_data(loss)
        if state.ema_params is not None:
            update_ema(state.ema_params, dict(model.named_parameters()), ema_decay)
        state.step += 1
        return state, loss.detach()

    return step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dit", default="Bd4/256")
    ap.add_argument("--ae", default=None,
                    help="AE (pretrained name or variant) to encode images; omit if --data "
                         "holds precomputed .npy latents")
    ap.add_argument("--data", required=True)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--cfg-dropout", type=float, default=0.1)
    ap.add_argument("--shift", type=float, default=1.0,
                    help="sigma-shift of the training noise distribution")
    ap.add_argument("--bs", type=int, default=64)
    ap.add_argument("--checkpoint", type=int, default=0,
                    help="1 = recompute every DiT block in the backward")
    ap.add_argument("--steps", type=int, default=100_000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="cosine")
    ap.add_argument("--warmup-frac", type=float, default=0.05)
    ap.add_argument("--wd", type=float, default=0.0)
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "muon"])
    ap.add_argument("--ema-decay", type=float, default=0.9999)
    ap.add_argument("--max-tokens", type=int, default=256)
    ap.add_argument("--patch", type=int, default=16)
    ap.add_argument("--output-dir", default="./dit_runs")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-freq", type=int, default=50)
    ap.add_argument("--save-freq", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--mesh", default=None,
                    help="data=D,fsdp=F,model=M under torchrun (one -1 takes the processes left); default: all "
                         "processes on data")
    return ap


def _npy_batches(data: str, bs: int, seed: int, rank: int = 0, world: int = 1):
    files = sorted(os.path.join(data, f) for f in os.listdir(data) if f.endswith(".npy"))[rank::world]
    if not files:
        raise SystemExit(
            f"--data {data} has no .npy latent files; pass --ae <name-or-variant> to train "
            "from an image folder (the frozen encoder produces latents on the fly)"
        )
    while True:
        order = list(files)
        np.random.default_rng(seed).shuffle(order)
        buf_z, buf_y = [], []
        for f in order:
            d = np.load(f, allow_pickle=True).item()
            buf_z.append(d["z"])
            buf_y.append(d.get("label", 0))
            if len(buf_z) == bs:
                yield np.stack(buf_z).astype(np.float32), np.asarray(buf_y, np.int64)
                buf_z, buf_y = [], []


def _latent_width(data: str):
    """The code width of the first ``.npy`` latent under ``data`` (None when
    there is none): the JAX CLI assumes 32 without ``--ae``, which refuses
    the latents of a ``x64`` tokenizer."""
    files = sorted(f for f in os.listdir(data) if f.endswith(".npy")) if os.path.isdir(data) else []
    return int(np.load(os.path.join(data, files[0]), allow_pickle=True).item()["z"].shape[-1]) if files else None


def _encoder_batches(encoder, data: str, bs: int, seed: int, patch: int, max_tokens: int, rank: int = 0,
                     world: int = 1):
    from vitok_torch.data import create_dataloader

    side = int(math.isqrt(max_tokens))
    pp = (f"center_crop({side * patch})|to_tensor|normalize(minus_one_to_one)|"
          f"patchify({patch}, {max_tokens})")
    loader = create_dataloader(data, pp, batch_size=bs, seed=seed, rank=rank, world=world, repeat=True,
                               return_labels=True)
    for batch in loader:
        enc = encoder.encode({k: v for k, v in batch.items() if isinstance(v, np.ndarray)})
        yield enc["z"].float(), np.asarray(batch.get("labels", np.zeros(bs)), np.int64)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from vitok_torch.models.dit import DiT, decode_variant as dit_variant
    from vitok_torch.train_lib import create_optimizer, create_schedule, create_train_state
    from vitok_torch.parallel import shard_params
    from vitok_torch.parallel.mesh import DATA_AXIS, FSDP_AXIS, MODEL_AXIS, cli_mesh
    from vitok_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from vitok_torch.utils.device import resolve_device
    from vitok_torch.utils.preemption import PreemptionGuard

    mesh, rank, world, device = cli_mesh(args.mesh, args.device, allowed=(DATA_AXIS, FSDP_AXIS, MODEL_AXIS))
    device = resolve_device(device)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")

    # --- frozen AE encoder (optional) ------------------------------------
    encoder = None
    code_width = None
    if args.ae:
        from vitok_torch.models.ae import AE, AEConfig
        from vitok_torch.pretrained import list_pretrained, load_pretrained_params

        if args.ae in list_pretrained():
            ae_cfg, ae_state = load_pretrained_params(args.ae, component="encoder")
        else:
            ae_cfg, ae_state = AEConfig.from_variant(args.ae, decoder=False), None
        encoder = AE(**dataclasses.asdict(ae_cfg), state_dict=ae_state, seed=0, device=device)
        code_width = ae_cfg.channels_per_token
    else:
        code_width = _latent_width(args.data)

    dit = DiT(**dit_variant(args.dit), code_width=code_width or 32, text_dim=args.num_classes,
              checkpoint=args.checkpoint, seed=args.seed, device=device,
              param_dtype=torch.float32, trainable=True)
    layout = shard_params(dit, mesh) if mesh is not None else None
    shard, shards = (layout.data_rank, layout.data_size) if layout is not None else (0, 1)

    schedule = create_schedule(args.schedule, args.lr, args.steps, args.warmup_frac)
    tx = create_optimizer(schedule, weight_decay=args.wd, grad_clip=args.grad_clip,
                          optimizer=args.optimizer)
    state = create_train_state(dit, tx, ema=True)
    train_step = make_dit_train_step(tx, args.num_classes, args.cfg_dropout, args.shift,
                                     args.ema_decay)

    ckpt_dir = os.path.join(os.path.abspath(args.output_dir), "last")
    if args.resume and os.path.exists(ckpt_dir):
        state = load_checkpoint(ckpt_dir, target=state)
        say(f"resumed at step {state.step}")

    if encoder is None:
        batches = _npy_batches(args.data, args.bs, args.seed, shard, shards)
    else:
        batches = _encoder_batches(encoder, args.data, args.bs, args.seed, args.patch,
                                   args.max_tokens, shard, shards)

    guard = PreemptionGuard()
    t_log = time.perf_counter()
    while state.step < args.steps and not guard.should_stop:
        z, y = next(batches)
        state, loss = train_step(state, z, y, args.seed + 7)
        step = state.step
        if step % args.log_freq == 0:
            dt = time.perf_counter() - t_log
            say(json.dumps({
                "step": step,
                "loss": round(float(loss), 5),  # reads back: the step has finished
                "lr": round(float(schedule(step)), 7),
                "steps_per_s": round(args.log_freq / dt, 3),
            }), flush=True)
            t_log = time.perf_counter()
        if (args.save_freq and step % args.save_freq == 0) or guard.should_stop:
            save_checkpoint(state, ckpt_dir)
            say(f"saved checkpoint at step {step}")
    guard.restore()
    save_checkpoint(state, ckpt_dir)
    say("training done")
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
