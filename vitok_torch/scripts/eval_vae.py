"""Evaluation CLI: reconstruction metrics and throughput of a tokenizer.

The counterpart of the JAX package's ``scripts/eval_vae.py``, with its flags
and defaults: loads a tokenizer (a pretrained name from local files, or a
variant with ``--random-weights``), streams a folder of images, runs
encode -> decode between device fences, computes rFID/rFDD/SSIM/PSNR with
``vitok_torch.metrics.MetricCalculator`` and prints a JSON stats dict with the
JAX CLI's keys. Batches have one static token shape (``max_tokens``), or with
``--buckets`` one of a few ``TokenBucketer`` bucket shapes.

    python -m vitok_torch.scripts.eval_vae --model 350M-f16x64 --data /imgs \\
        --metrics ssim,psnr,fid,fdd --max-size 256 --batch-size 64

Runs on the card (``--device cuda``, the default; it raises without one);
``--device cpu`` runs on the host, for small models and tests. The feature
backbones run in fp32 and TF32 is switched off for matmuls and cuDNN, so
that an fp32 feature is an fp32 feature. ``steady_img_per_sec`` subtracts
the first batch's image count (the JAX CLI subtracts ``--batch-size``,
which is wrong when that batch is short).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", required=True, help="pretrained name (e.g. 350M-f16x64) or variant string")
    ap.add_argument("--data", required=True)
    ap.add_argument("--metrics", default="ssim,psnr", help="comma list from ssim,psnr,fid,fdd")
    ap.add_argument("--pp-mode", default="native", choices=["native", "adm_center"])
    ap.add_argument("--max-size", type=int, default=256)
    ap.add_argument("--max-tokens", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--decode-workers", type=int, default=0,
                    help="threaded decode pool; only 0 (serial, one prefetch thread) is ported")
    ap.add_argument("--num-samples", type=int, default=None)
    ap.add_argument("--buckets", default=None,
                    help="comma list of token buckets (e.g. 64,256,1024): each image is padded to the "
                         "smallest bucket that holds it")
    ap.add_argument("--swa-window", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--output", default=None, help="JSON output path")
    ap.add_argument("--random-weights", action="store_true",
                    help="skip the checkpoint load (pipeline smoke and perf runs)")
    ap.add_argument("--quant", action="store_true", help="int8-quantize the block weights (AE.quantize())")
    ap.add_argument("--save-visuals", default=None,
                    help="directory for side-by-side ref/recon PNGs of the first batch")
    ap.add_argument("--feature-backbone", default="backbone", choices=["backbone", "random-proj"],
                    help="fid/fdd features: 'backbone' = InceptionV3/DINO ViT-B/16 (weights from "
                         "VITOK_INCEPTION_WEIGHTS / VITOK_DINO_WEIGHTS, else random with a warning); "
                         "'random-proj' = weight-free random projections (relative numbers only)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap


def build_pp(args, spatial_stride: int) -> str:
    max_tokens = args.max_tokens or ((args.max_size // spatial_stride) ** 2)
    if args.pp_mode == "adm_center":
        crop = f"center_crop({args.max_size})|"
    else:
        crop = f"resize_longest_side({args.max_size})|"
    return (
        crop
        + "to_tensor|normalize(minus_one_to_one)|"
        + f"resize_to_token_budget({spatial_stride}, {max_tokens})|"
        + f"patchify({spatial_stride}, {max_tokens})"
    )


def build_model(args, device):
    """The AE in bf16 on ``device``: a pretrained name's local weights, or
    random weights from ``--seed``; ``--quant`` makes it int8."""
    from vitok_torch.models.ae import AE, AEConfig
    from vitok_torch.pretrained import get_pretrained_info, list_pretrained, load_pretrained_params

    overrides = {"sw": args.swa_window} if args.swa_window else {}
    if args.model in list_pretrained() and not args.random_weights:
        cfg, state_dict = load_pretrained_params(args.model)
        cfg = dataclasses.replace(cfg, **overrides)
    else:
        variant = get_pretrained_info(args.model)[2] if args.model in list_pretrained() else args.model
        cfg, state_dict = AEConfig.from_variant(variant, **overrides), None
    model = AE(**dataclasses.asdict(cfg), state_dict=state_dict, seed=args.seed, device=device)
    return model.quantize() if args.quant else model


def build_metrics(args, device):
    from vitok_torch.metrics import MetricCalculator

    names = [m.strip() for m in args.metrics.split(",") if m.strip()]
    # Without buckets a native-aspect run sees one shape per image: group the
    # feature resizes by bucket shape instead (the same numbers).
    bres = bool(args.pp_mode == "native" and not args.buckets)
    fid_fn = fdd_fn = None
    if args.feature_backbone == "random-proj":
        from vitok_torch.eval_features import random_projection_feature_fn

        if "fid" in names:
            fid_fn = random_projection_feature_fn(dim=64, seed=0, bucketed_resize=bres)
        if "fdd" in names:
            fdd_fn = random_projection_feature_fn(dim=64, seed=1, bucketed_resize=bres)
    else:
        from vitok_torch.eval_features import dino_feature_fn, inception_feature_fn

        if "fid" in names:
            fid_fn = inception_feature_fn(bucketed_resize=bres, device=device)
        if "fdd" in names:
            fdd_fn = dino_feature_fn(bucketed_resize=bres, device=device)
    return MetricCalculator(metrics=names, fid_feature_fn=fid_fn, fdd_feature_fn=fdd_fn)


def build_loader(args, spatial_stride: int):
    """(batch iterable of numpy patch dicts, pp description)."""
    if args.buckets:
        from vitok_torch.data.loaders import iter_samples
        from vitok_torch.pp.registry import build_transform
        from vitok_torch.serving import TokenBucketer

        buckets = tuple(int(b) for b in args.buckets.split(","))
        prefix = (f"center_crop({args.max_size})" if args.pp_mode == "adm_center"
                  else f"resize_longest_side({args.max_size})")
        prefix_fn = build_transform(prefix)
        bucketer = TokenBucketer(patch=spatial_stride, buckets=buckets)
        images = (prefix_fn(img) for img, _ in itertools.islice(
            iter_samples(args.data, seed=args.seed), args.num_samples))
        loader = (batch for _, batch in bucketer.batch_stream(images, batch_size=args.batch_size))
        return loader, f"{prefix}|<bucketed {buckets}>"
    from vitok_torch.data import create_dataloader

    pp = build_pp(args, spatial_stride)
    loader = create_dataloader(args.data, pp, batch_size=args.batch_size, seed=args.seed,
                               num_samples=args.num_samples, decode_workers=args.decode_workers)
    return loader, pp


def _unpack(images: torch.Tensor, orig_h, orig_w) -> list:
    """Each image cropped to its original size, on the images' device."""
    hs, ws = np.asarray(orig_h).reshape(-1), np.asarray(orig_w).reshape(-1)
    return [img[:, : int(h), : int(w)] for img, h, w in zip(images, hs, ws)]


def _save_visuals(directory: str, refs, recons) -> None:
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    for i, (r, x) in enumerate(zip(refs, recons)):
        pair = torch.cat([r.float(), x.float()], dim=2).cpu().numpy()  # side by side
        arr = ((np.clip(pair, -1, 1) + 1) / 2 * 255).astype(np.uint8).transpose(1, 2, 0)
        Image.fromarray(arr).save(os.path.join(directory, f"pair_{i:03d}.png"))


def evaluate(model, loader, calc, save_visuals: Optional[str] = None) -> Dict[str, float]:
    """Encode -> decode -> metrics over every batch of ``loader``.

    Returns ``calc.gather()`` with the wall-clock segments of the loop:
    data (waiting on the loader), device (encode + decode between two
    device fences, after the upload) and post (postprocess on the device,
    metric updates, visuals).
    """
    from vitok_torch.pp.io import postprocess

    device = model.device
    patch = model.cfg.spatial_stride

    def fence():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    n_images = n_batches = 0
    device_time = data_time = post_time = 0.0
    first_batch_wall = None
    first_batch_images = 0
    t_start = time.perf_counter()
    loader_it = iter(loader)
    while True:
        t_batch = time.perf_counter()
        try:
            batch = next(loader_it)
        except StopIteration:
            break
        data_time += time.perf_counter() - t_batch
        tbatch = {k: torch.from_numpy(v).to(device) for k, v in batch.items() if isinstance(v, np.ndarray)}
        fence()  # the upload stays out of the timed window
        t0 = time.perf_counter()
        output = model.decode(model.encode(tbatch))
        fence()
        device_time += time.perf_counter() - t0

        t0 = time.perf_counter()
        refs = _unpack(postprocess(tbatch, do_unpack=False, patch=patch), batch["orig_height"], batch["orig_width"])
        recons = _unpack(postprocess(dict(output), do_unpack=False, patch=patch),
                         batch["orig_height"], batch["orig_width"])
        calc.update(refs, recons)
        if save_visuals and n_images == 0:
            _save_visuals(save_visuals, refs, recons)
        fence()
        post_time += time.perf_counter() - t0
        n_images += len(refs)
        # The first batch absorbs the one-time costs (allocator growth, cuDNN
        # and cuBLAS plans): record it apart so the steady rate reads from one run.
        if first_batch_wall is None:
            first_batch_wall = time.perf_counter() - t_batch
            first_batch_images = len(refs)
        n_batches += 1
    wall = time.perf_counter() - t_start

    stats = calc.gather()
    stats.update({
        # Device-only rate (the reference's headline definition) ...
        "throughput_img_per_sec": n_images / max(device_time, 1e-9),
        "avg_img_latency_ms": device_time / max(n_images, 1) * 1e3,
        # ... and the system rate: the whole loop, host included, with the
        # wall time split into its segments.
        "wall_img_per_sec": n_images / max(wall, 1e-9),
        "wall_time_s": wall,
        "host_data_time_s": data_time,
        "device_time_s": device_time,
        "host_post_time_s": post_time,
        "first_batch_wall_s": first_batch_wall,
        "steady_img_per_sec": (
            (n_images - first_batch_images) / max(wall - first_batch_wall, 1e-9)
            if first_batch_wall is not None and n_batches > 1
            else None
        ),
    })
    return stats


def main(argv=None) -> Dict[str, object]:
    args = build_parser().parse_args(argv)

    from vitok_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    # fp32 features are fp32: no TF32 in the backbones' matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    model = build_model(args, device)
    calc = build_metrics(args, device)
    loader, pp = build_loader(args, model.cfg.spatial_stride)
    stats = evaluate(model, loader, calc, save_visuals=args.save_visuals)
    stats.update({
        "model": args.model,
        "data": args.data,
        "pp": pp,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    })
    print(json.dumps(stats, indent=2), flush=True)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(stats, f, indent=2)
    return stats


if __name__ == "__main__":
    main()
