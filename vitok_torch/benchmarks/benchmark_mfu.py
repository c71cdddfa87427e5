"""Forward and train-step MFU over a variant x token sweep, on the card.

The counterpart of the JAX project's ``benchmarks/benchmark_mfu.py``:
analytic model FLOPs (2 x params x tokens a forward, 6 x params x tokens a
training step; recomputation not counted), timed on CUDA events, MFU against
the H100 peak of the running dtype (``PEAK_FLOPS["h100"]`` in bf16,
``["h100_int8"]`` in int8). One JSON line a run:

    python -m vitok_torch.benchmarks.benchmark_mfu --variants 350M,5B --tokens 256,1024
    python -m vitok_torch.benchmarks.benchmark_mfu --variants 350M --tokens 4096,16384 --sw 1024
    python -m vitok_torch.benchmarks.benchmark_mfu --variants 350M --tokens 4096 --train --batch 2 --sw 1024
    python -m vitok_torch.benchmarks.benchmark_mfu --variants 350M --tokens 256 --train --batch 32 --attn-impl fused
    python -m vitok_torch.benchmarks.benchmark_mfu --variants 350M --tokens 256 --train --batch 32 --attn-impl fused \
        --checkpoint 1 --remat-save qkv_out,ffn_hid,attn_out --optimizer muon

``--device cpu`` runs the kernels' plain versions on the host (no MFU).
"""

from __future__ import annotations

import argparse
import gc
import json
import math

import torch

from vitok_torch.benchmarks import make_batch, measure, resolve_device
from vitok_torch.models.ae import AE, decode_variant
from vitok_torch.utils.profiling import PEAK_KEYS, DeviceTimer, count_params, mfu

VARIANT_ALIASES = {
    "350M": "Ld4-Ld24/1x16x64",
    "5B": "Td4-T/1x16x64",
    "tiny": "w256_d2_h4-w256_d4_h4/1x16x16",
}


def _grid(n_tokens: int):
    side = math.isqrt(n_tokens)
    if side * side != n_tokens:
        raise ValueError(f"--tokens {n_tokens}: a square grid is timed")
    return side, side


def run_one(variant: str, n_tokens: int, batch: int, iters: int, sw: int = 0, dtype: str = "bf16",
            device="cuda") -> dict:
    """Forward (encode + decode) MFU of one variant at ``n_tokens`` a
    sample, bf16 or int8 (``AE.quantize()``), with a sliding window ``sw``."""
    device = torch.device(device)
    kw = decode_variant(VARIANT_ALIASES.get(variant, variant))
    if sw:
        kw["sw"] = sw
    model = AE(**kw, seed=0, device=device)
    n_params = count_params(model)
    if dtype == "int8":
        model.quantize()
    data = make_batch(batch, n_tokens, _grid(n_tokens), model.cfg.pixels_per_token, device=device)
    m = measure(lambda pt: model.decode(model.encode(dict(data, patches=pt)))["patches"], data["patches"],
                batch, iters, device)
    dt = batch / m["img_per_s"]  # seconds a call
    model_flops = 2.0 * n_params * n_tokens * batch
    return {
        "variant": variant, "tokens": n_tokens, "batch": batch, "sw": sw or None, "dtype": dtype,
        "ms_per_img": m["ms_per_img"], "img_per_s": m["img_per_s"], "ms_spread": m["ms_spread"],
        "model_flops_per_call": model_flops, "effective_tflops": model_flops / dt / 1e12,
        "mfu": mfu(n_params, n_tokens * batch / dt, peak=PEAK_KEYS[dtype], training=False)
        if device.type == "cuda" else None,
        "n_params": n_params, "device": str(device),
    }


def run_train(variant: str, n_tokens: int, batch: int, iters: int, checkpoint: int, moment_dtype=None,
              optimizer: str = "adamw", remat_save: tuple = (), attn_impl: str = "auto", sw: int = 0,
              device="cuda") -> dict:
    """Train-step MFU: the port's ``train_lib`` step (Charbonnier loss, AdamW
    or Muon with clipping, EMA), fp32 master weights and bf16 compute,
    recomputation per ``checkpoint`` and ``remat_save``, one warm-up step,
    then ``iters`` steps between two CUDA events. ``first_loss`` is the
    warm-up step's (the same initial weights under every recomputation
    policy), ``peak_gb`` the card's peak allocation over the steps (params,
    optimizer state and EMA included; None on the host). Garbage that an
    earlier caller left in reference cycles is collected first: otherwise
    its card memory counts towards this run's peak until the collector
    happens to run, which varies from process to process."""
    from vitok_torch.train_lib import (LossConfig, create_optimizer, create_schedule, create_train_state,
                                       make_train_step)

    device = torch.device(device)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    kw = decode_variant(VARIANT_ALIASES.get(variant, variant))
    if sw:
        kw["sw"] = sw
    tx = create_optimizer(create_schedule("constant", 1e-4, 1000, 0.0), optimizer=optimizer,
                          moment_dtype=moment_dtype)
    model = AE(**kw, checkpoint=checkpoint, remat_save=remat_save, attn_impl=attn_impl, seed=0, device=device,
               param_dtype=torch.float32, trainable=True)
    n_params = count_params(model)
    state = create_train_state(model, tx, ema=True)
    data = make_batch(batch, n_tokens, _grid(n_tokens), model.cfg.pixels_per_token, device=device)
    step = make_train_step(tx, LossConfig())
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state, metrics = step(state, data, 1)  # warm-up
    first_loss = float(metrics["loss/total"])
    timer = DeviceTimer(device)
    with timer:
        for _ in range(iters):
            state, metrics = step(state, data, 1)
    loss = float(metrics["loss/total"])
    if not math.isfinite(loss):
        raise FloatingPointError(f"train step loss {loss}")
    dt = timer.times[0] / iters
    model_flops = 6.0 * n_params * n_tokens * batch
    return {
        "variant": variant, "mode": "train", "tokens": n_tokens, "batch": batch, "checkpoint": checkpoint,
        "sw": sw or None, "attn_impl": attn_impl, "remat_save": ",".join(remat_save), "optimizer": optimizer,
        "moment_dtype": "bf16" if moment_dtype is not None else "f32",
        "ms_per_step": dt * 1e3, "img_per_s": batch / dt, "loss": loss, "first_loss": first_loss,
        "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None,
        "model_flops_per_step": model_flops, "effective_tflops": model_flops / dt / 1e12,
        "mfu": mfu(n_params, n_tokens * batch / dt, peak=PEAK_KEYS["bf16"]) if device.type == "cuda" else None,
        "n_params": n_params, "device": str(device),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="tiny")
    ap.add_argument("--tokens", default="256")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--train", action="store_true", help="benchmark the full train step instead of forward")
    ap.add_argument("--checkpoint", type=int, default=0, help="remat granularity for --train (0 = no remat)")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "muon"])
    ap.add_argument("--moment-dtype", default=None, choices=[None, "bf16"])
    ap.add_argument("--remat-save", default="",
                    help="with --checkpoint 1: the block intermediates kept across the backward "
                         "(e.g. qkv_out,ffn_hid,attn_out)")
    ap.add_argument("--attn-impl", default="auto", help="attention impl for --train (auto/xla/fused)")
    ap.add_argument("--sw", type=int, default=0, help="sliding attention window")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "int8"],
                    help="block weight dtype (forward mode only)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    remat_save = tuple(s.strip() for s in args.remat_save.split(",") if s.strip())
    results = []
    for v in args.variants.split(","):
        for t in args.tokens.split(","):
            if args.train:
                r = run_train(v.strip(), int(t), args.batch, args.iters, args.checkpoint,
                              torch.bfloat16 if args.moment_dtype == "bf16" else None, args.optimizer,
                              remat_save, args.attn_impl, sw=args.sw, device=device)
            else:
                r = run_one(v.strip(), int(t), args.batch, args.iters, sw=args.sw, dtype=args.dtype,
                            device=device)
            print(json.dumps({k: (round(x, 5) if isinstance(x, float) else x) for k, x in r.items()}), flush=True)
            results.append(r)
    return results


if __name__ == "__main__":
    main()
