"""Class-conditional image generation: DiT flow matching over ViTok latents.

The counterpart of the JAX package's ``scripts/generate.py`` with its flags:
UniPC flow sampling of DiT latents with classifier-free guidance (batch
doubling, null class ``text_dim``), decoded to pixels by the ViTok decoder
and written as PNGs.

    python -m vitok_torch.scripts.generate --ae Ld4-Ld24/1x16x64 \\
        --dit-variant L/256 --classes 207,360 --steps 20 --cfg-scale 4.0 \\
        --out samples/

``--ae`` and the DiT start from random weights unless a pretrained name or
``--dit-checkpoint`` (a directory written by ``scripts.train_dit``) is
given. Runs on the card (``--device cuda``, the default; it raises without
one); ``--device cpu`` samples on the host, for small models and tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch


def _grid(side: int, rows: int, device) -> tuple:
    yy, xx = torch.meshgrid(torch.arange(side, device=device), torch.arange(side, device=device),
                            indexing="ij")
    return yy.reshape(1, -1).repeat(rows, 1), xx.reshape(1, -1).repeat(rows, 1)


def _initial_noise(dit, b, n_tokens, code_width, seed, z0, generator):
    if z0 is not None:
        return torch.as_tensor(z0, dtype=torch.float32).to(dit.device)
    if generator is None:
        generator = torch.Generator(device=dit.device).manual_seed(seed)
    return torch.randn((b, n_tokens, code_width), generator=generator, device=generator.device,
                       dtype=torch.float32).to(dit.device)


def _guided_velocity(dit, z, t, ctx, row, col, cfg_scale: float) -> torch.Tensor:
    """CFG by batch doubling: the conditional and the null-class rows in one
    call. ``t``: a Python number or a 0-d tensor."""
    b = z.shape[0]
    t_in = torch.ones(2 * b, dtype=torch.float32, device=z.device) * t
    v = dit({"z": torch.cat([z, z]), "t": t_in, "context": ctx,
             "row_idx": row, "col_idx": col}).float()
    cond, uncond = v[:b], v[b:]
    return uncond + cfg_scale * (cond - uncond)


def _setup(dit, classes, n_tokens):
    b = len(classes)
    side = int(math.isqrt(n_tokens))
    row, col = _grid(side, 2 * b, dit.device)
    ctx = torch.cat([
        torch.as_tensor(list(classes), dtype=torch.long, device=dit.device),
        torch.full((b,), dit.text_dim, dtype=torch.long, device=dit.device),  # null class
    ])
    return b, row, col, ctx


def sample_latents_device(
    dit,
    scheduler,
    classes: Sequence[int],
    n_tokens: int,
    code_width: int,
    cfg_scale: float = 4.0,
    steps: int = 20,
    seed: int = 0,
    z0=None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The whole UniPC loop on the model's device: the solver's coefficients
    are device tensors and nothing is read back between steps
    (``unipc.sample_flow_unipc_device``). Equal to :func:`sample_latents` to
    float tolerance. Initial noise from ``generator`` (or one seeded with
    ``seed``), or given as ``z0``. Returns ``z [B, N, c]`` fp32."""
    from vitok_torch.unipc import sample_flow_unipc_device

    b, row, col, ctx = _setup(dit, classes, n_tokens)
    z = _initial_noise(dit, b, n_tokens, code_width, seed, z0, generator)
    return sample_flow_unipc_device(
        lambda zz, t: _guided_velocity(dit, zz, t, ctx, row, col, cfg_scale),
        z, scheduler=scheduler, steps=steps,
    )


def sample_latents(
    dit,
    scheduler,
    classes: Sequence[int],
    n_tokens: int,
    code_width: int,
    cfg_scale: float = 4.0,
    steps: int = 20,
    seed: int = 0,
    z0=None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """UniPC sampling with the host scheduler: each step's guided velocity
    and latents go to numpy, through ``scheduler.step`` and back. Returns
    ``z [B, N, c]`` fp32 on the model's device."""
    b, row, col, ctx = _setup(dit, classes, n_tokens)
    z = _initial_noise(dit, b, n_tokens, code_width, seed, z0, generator)
    scheduler.set_timesteps(steps)
    for t in scheduler.timesteps:
        guided = _guided_velocity(dit, z, float(t), ctx, row, col, cfg_scale)
        z = torch.from_numpy(np.asarray(
            scheduler.step(guided.cpu().numpy(), t, z.cpu().numpy()).prev_sample, np.float32
        )).to(dit.device)
    return z


def decode_latents(model, z: torch.Tensor, n_tokens: int):
    """Latents ``[B, N, c]`` of a square grid -> a list of uint8 images
    ``[3, H, W]`` through the AE decoder and ``postprocess``."""
    from vitok_torch.pp.io import postprocess

    b = z.shape[0]
    side = int(math.isqrt(n_tokens))
    dev = model.device
    row, col = _grid(side, b, dev)
    size = torch.full((b,), side * model.cfg.spatial_stride, dtype=torch.int32, device=dev)
    out = model.decode({
        "z": z.to(dev),
        "patch_mask": torch.ones((b, n_tokens), dtype=torch.bool, device=dev),
        "row_idx": row, "col_idx": col, "orig_height": size, "orig_width": size,
    })
    return postprocess(dict(out), output_format="0_255", do_unpack=True,
                       patch=model.cfg.spatial_stride)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ae", default="350M-f16x64", help="pretrained AE name or variant string")
    ap.add_argument("--dit-variant", default="Bd4/256")
    ap.add_argument("--dit-checkpoint", default=None,
                    help="checkpoint directory of scripts.train_dit (random weights if absent)")
    ap.add_argument("--classes", default="0")
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--cfg-scale", type=float, default=4.0)
    ap.add_argument("--shift", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="samples")
    ap.add_argument("--device-loop", action="store_true",
                    help="run the whole UniPC loop on the device (no host round trip "
                         "between steps; same numerics)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from PIL import Image

    from vitok_torch.models.ae import AE, decode_variant
    from vitok_torch.models.dit import DiT, decode_variant as dit_variant
    from vitok_torch.pretrained import list_pretrained, load_pretrained_params
    from vitok_torch.unipc import FlowUniPCMultistepScheduler
    from vitok_torch.utils.checkpoint import load_checkpoint
    from vitok_torch.utils.device import resolve_device

    device = resolve_device(args.device)

    # --- decoder ---------------------------------------------------------
    if args.ae in list_pretrained():
        cfg, state = load_pretrained_params(args.ae, component="decoder")
        model = AE(**dataclasses.asdict(cfg), state_dict=state, device=device)
    else:
        model = AE(**decode_variant(args.ae), encoder=False, seed=args.seed, device=device)
    code_width = model.cfg.channels_per_token

    # --- DiT -------------------------------------------------------------
    dit_state = None
    if args.dit_checkpoint:
        dit_state = load_checkpoint(args.dit_checkpoint)["params"]
    dit = DiT(**dit_variant(args.dit_variant), code_width=code_width, text_dim=1000,
              state_dict=dit_state, seed=args.seed, device=device)

    classes = [int(c) for c in args.classes.split(",")]
    sched = FlowUniPCMultistepScheduler(shift=args.shift)
    sampler = sample_latents_device if args.device_loop else sample_latents
    z = sampler(dit, sched, classes, args.tokens, code_width,
                cfg_scale=args.cfg_scale, steps=args.steps, seed=args.seed)

    # --- decode to pixels ------------------------------------------------
    images = decode_latents(model, z, args.tokens)
    os.makedirs(args.out, exist_ok=True)
    for cls, img in zip(classes, images):
        path = os.path.join(args.out, f"class{cls}_seed{args.seed}.png")
        Image.fromarray(np.asarray(img).transpose(1, 2, 0)).save(path)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
