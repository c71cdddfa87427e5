#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vitok_torch``) on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card (``nvidia-smi``) and the torch/CUDA versions, and builds
   every CUDA kernel of the main path from ``vitok_torch/csrc`` with ``nvcc``;
2. holds each kernel against its plain PyTorch version on the card in bf16
   at the main path's shapes and at the 5B width, and times the kernel, the
   plain version and one PyTorch library call for the same function;
3. drives the main path, preprocess -> AE.encode -> AE.decode -> postprocess,
   for 350M-f16x64 (``Ld4-Ld24/1x16x64``) at full width and depth with
   random weights from a seed, at 256p (batch 64) and 512p (batch 16),
   counts the kernel launches of that run, checks the output, compares it
   with the same model on the unfused attention path, times it, and
   profiles one step (device time by kernel group, the device's busy share);
4. prints a JSON line describing each kernel, the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 tensor-core flop/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

KERNEL_MAX_ABS = 2e-2   # both sides round P to bf16 before PV, but the online
KERNEL_MEAN_ABS = 2e-3  # softmax rescales at running maxima, in another order
MODEL_REL_L2 = 2e-2     # decoded patches, fused kernel vs unfused path, bf16

VARIANT = "Ld4-Ld24/1x16x64"  # 350M-f16x64
RESOLUTIONS = (  # (name, pp max tokens, batch, image sizes cycled over the batch)
    ("256p", 256, 64, [(256, 256), (240, 200), (192, 256), (256, 160), (100, 130), (224, 224)]),
    ("512p", 1024, 16, [(512, 512), (480, 360), (304, 512), (512, 384), (200, 330), (448, 448)]),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

KERNEL_SHAPES = (  # (label, B, N, C, H)
    ("350M@256p main", 64, 256, 1024, 16),
    ("350M@512p main", 16, 1024, 1024, 16),
    ("350M width", 4, 256, 1024, 16),
    ("350M width", 2, 1024, 1024, 16),
    ("5B width", 2, 256, 3072, 24),
    ("5B width", 1, 1024, 3072, 24),
)
KERNEL_CASES = (("none", False, None), ("tail", True, None), ("sw64", False, 64), ("tail+sw64", True, 64))


def _attention_inputs(rng, b, n, c, h, masked, device):
    import torch
    from vitok_torch.ops.rope import compute_2d_freqs_cis

    d = c // h
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * c), dtype=np.float32))
    qs = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
    ks = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
    side = int(round(n ** 0.5))
    idx = np.arange(n)
    row = torch.from_numpy(np.tile(idx // side, (b, 1)))
    col = torch.from_numpy(np.tile(idx % side, (b, 1)))
    cos, sin = compute_2d_freqs_cis(row, col, d)
    mask = None
    if masked:  # a different tail-suffix valid count per sample
        valid = [n - (i * n) // (b + 2) - (n // 4 if b == 1 else 0) for i in range(b)]
        mask = torch.from_numpy(idx[None, :] < np.array(valid)[:, None])
    to = lambda t: None if t is None else t.to(device)
    return (to(qkv).to(torch.bfloat16), to(qs), to(ks), to(cos), to(sin), to(mask))


def _needed_pairs(b, mask, n, sw) -> int:
    """(query, key) pairs the function needs on this data, over the batch:
    valid keys inside each row's window; a row with none averages over all N."""
    valid = np.ones((b, n), bool) if mask is None else mask.cpu().numpy()
    idx = np.arange(n)
    window = np.ones((n, n), bool) if sw is None else (np.abs(idx[:, None] - idx[None, :]) <= sw)
    per_row = np.stack([(window & v[None, :]).sum(1) for v in valid])
    return int(np.where(per_row > 0, per_row, n).sum())


def _bound(b, n, c, h, mask, sw):
    """Least time on the card: each input read once and the output written
    once over HBM bandwidth, or the needed QK^T and PV flops over the bf16
    tensor-core peak, whichever is larger. Returns (ms, "bytes"|"operations")."""
    d = c // h
    nbytes = b * n * 3 * c * 2 + b * n * c * 2 + 2 * b * n * (d // 2) * 4 + 2 * d * 4
    nbytes += 0 if mask is None else b * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4.0 * h * d * _needed_pairs(b, mask, n, sw) / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(device) -> dict:
    import torch
    import torch.nn.functional as F
    from vitok_torch.ops import fused_attention as fa
    from vitok_torch.ops.attention import make_attention_mask
    from vitok_torch.ops.norms import rms_norm
    from vitok_torch.ops.rope import apply_rotary_emb

    rng = np.random.default_rng(0)
    rows, worst = [], 0.0
    log("kernel phase: fused_attention (CUDA) vs fused_qkv_attention_plain, bf16")
    log(f"{'shape':16s} {'B':>3s} {'N':>5s} {'C':>5s} {'H':>3s} {'case':10s} "
        f"{'max_abs':>9s} {'mean_abs':>9s} {'max_all':>9s} {'ms':>8s} {'plain_ms':>9s} {'sdpa_ms':>8s} {'bound_ms':>9s}")
    for label, b, n, c, h in KERNEL_SHAPES:
        for case, masked, sw in KERNEL_CASES:
            qkv, qs, ks, cos, sin, mask = _attention_inputs(rng, b, n, c, h, masked, device)
            kw = dict(num_heads=h, sliding_window=sw)
            kernel = lambda: fa.fused_qkv_attention(qkv, qs, ks, cos, sin, mask, impl="fused", **kw)
            plain = lambda: fa.fused_qkv_attention_plain(qkv, qs, ks, cos, sin, mask, **kw)
            got, want = kernel().float(), plain().float()
            torch.cuda.synchronize()
            err_all = (got - want).abs()
            err = err_all if mask is None else err_all[mask]  # valid rows
            max_abs, mean_abs = err.max().item(), err.mean().item()
            # Padded rows follow the same function (key-side mask) but may
            # see only a few valid keys, so |out| nears max|v| where one bf16
            # step is 2^-7 * |out|: hold them to the bound relative to |out|.
            max_all = err_all.max().item()
            rel_all = (err_all / want.abs().clamp(min=1.0)).max().item()
            if not (max_abs <= KERNEL_MAX_ABS and mean_abs <= KERNEL_MEAN_ABS
                    and rel_all <= KERNEL_MAX_ABS):
                raise AssertionError(
                    f"kernel disagrees with its plain version at {label} B={b} N={n} C={c} "
                    f"H={h} {case}: valid rows max {max_abs:.3e} mean {mean_abs:.3e} (limits "
                    f"{KERNEL_MAX_ABS}, {KERNEL_MEAN_ABS}); all rows max {max_all:.3e}, "
                    f"max |err|/max(1,|out|) {rel_all:.3e} (limit {KERNEL_MAX_ABS})"
                )
            # Library yardstick: SDPA on pre-normed, pre-rotated q/k/v.
            d = c // h
            q, k, v = qkv.view(b, n, 3, h, d).unbind(2)
            q, k = apply_rotary_emb(rms_norm(q, qs), rms_norm(k, ks), cos, sin, convention="half")
            q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            am = None
            if mask is not None or sw is not None:
                am = make_attention_mask(None, n, sw, device)
                if mask is not None:
                    key_ok = mask[:, None, None, :]
                    am = key_ok if am is None else (am & key_ok)
            library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am)
            ms, plain_ms, lib_ms = time_ms(kernel), time_ms(plain), time_ms(library)
            bound, bound_by = _bound(b, n, c, h, mask, sw)
            worst = max(worst, max_abs)
            row = dict(shape=label, B=b, N=n, C=c, H=h, case=case, max_abs_err=max_abs,
                       mean_abs_err=mean_abs, max_abs_err_all_rows=max_all, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound, bound_by=bound_by)
            rows.append(row)
            log(f"{label:16s} {b:3d} {n:5d} {c:5d} {h:3d} {case:10s} {max_abs:9.2e} "
                f"{mean_abs:9.2e} {max_all:9.2e} {ms:8.4f} {plain_ms:9.4f} {lib_ms:8.4f} {bound:9.5f}")
    return dict(rows=rows, max_abs_err=worst)


# ---------------------------------------------------------------------------
# Main path phase
# ---------------------------------------------------------------------------


def _images(rng, sizes, batch):
    from PIL import Image

    out = []
    for i in range(batch):
        w, h = sizes[i % len(sizes)]
        out.append(Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)))
    return out


def main_path_phase(device, card: str) -> dict:
    import torch
    from vitok_torch import AE, decode_variant, postprocess, preprocess
    from vitok_torch.ops import fused_attention as fa

    cfg_kw = decode_variant(VARIANT)
    model = AE(**cfg_kw, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    with torch.no_grad():  # LayerScale gains ~ U(0.5, 1.5): blocks matter
        for blk in [*model.encoder_blocks, *model.decoder_blocks]:
            g = blk.layer_scale.gamma
            g.copy_(0.5 + torch.rand(g.shape, generator=gen, device=device))
    reference = AE(**{**cfg_kw, "attn_impl": "xla"}, state_dict=model.state_dict(), device=device)
    depth = model.cfg.encoder_depth + model.cfg.decoder_depth
    n_params = sum(p.numel() for p in model.parameters())
    log(f"main path: {VARIANT} ({n_params / 1e6:.1f}M params), bf16, {depth} blocks, device={device}")

    rng = np.random.default_rng(0)
    results = []
    fa.LAUNCHES = 0
    for name, max_tokens, batch, sizes in RESOLUTIONS:
        pp = f"to_tensor|normalize(minus_one_to_one)|patchify(16, {max_tokens})"
        images = _images(rng, sizes, batch)
        inputs = preprocess(images, pp=pp, device=device)
        before = fa.LAUNCHES
        out = model.decode(model.encode(inputs))
        torch.cuda.synchronize()
        per_forward = fa.LAUNCHES - before
        if per_forward != depth:
            raise AssertionError(f"{name}: {per_forward} fused kernel launches, expected {depth}")
        results.append((name, max_tokens, batch, images, inputs, out))
    launches = fa.LAUNCHES  # the main path's run, read before any timing

    rows = []
    for name, max_tokens, batch, images, inputs, out in results:
        patches = out["patches"]
        if tuple(patches.shape) != (batch, max_tokens, 768) or not torch.isfinite(patches).all():
            raise AssertionError(f"{name}: bad decoder output {tuple(patches.shape)} or non-finite")
        recon = postprocess(out, output_format="0_255", do_unpack=True)
        for img, r in zip(images, recon):
            if tuple(r.shape) != (3, img.size[1], img.size[0]):
                raise AssertionError(f"{name}: unpacked {tuple(r.shape)} for a {img.size} image")
        ident = postprocess(dict(inputs), output_format="0_255", do_unpack=True)
        for img, r in zip(images, ident):
            if not np.array_equal(r.numpy().transpose(1, 2, 0), np.asarray(img)):
                raise AssertionError(f"{name}: postprocess of the input is not the input image")
        ref = reference.decode(reference.encode(inputs))["patches"]
        valid = inputs["patch_mask"]
        a, r_ = patches[valid].float(), ref[valid].float()
        rel = ((a - r_).norm() / r_.norm()).item()
        if not rel <= MODEL_REL_L2:
            raise AssertionError(f"{name}: rel L2 vs unfused path {rel:.3e} > {MODEL_REL_L2}")
        ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=5, warmup=1)
        ref_ms = time_ms(lambda: reference.decode(reference.encode(inputs)), runs=5, warmup=1)
        row = dict(res=name, tokens=max_tokens, batch=batch, rel_l2_vs_unfused=rel,
                   ms_per_img=ms / batch, img_per_s=batch / ms * 1e3,
                   unfused_ms_per_img=ref_ms / batch, card=card)
        rows.append(row)
        log(f"  {name}: batch {batch}, {max_tokens} tokens: rel L2 vs unfused {rel:.3e}; "
            f"encode+decode {ms / batch:.4f} ms/img, {batch / ms * 1e3:.1f} img/s "
            f"(unfused attention: {ref_ms / batch:.4f} ms/img) on {card}")
        profile_step(name, lambda: model.decode(model.encode(inputs)))
    return dict(rows=rows, launches=launches)


def profile_step(name: str, step) -> None:
    """Where one encode+decode spends the card's time: device kernel time by
    group (the fused attention kernel, matrix products, everything else) from
    ``torch.profiler``, and the device's busy share of the step's wall time
    (CUDA events around the profiled step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    total = sum(by_name.values())
    if total <= 0:
        log(f"  {name} profile: the profiler recorded no device time (not measured)")
        return
    groups = {"fused_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for kname, t in by_name.items():
        low = kname.lower()
        if "fused_attention_kernel" in low:
            groups["fused_attention"] += t
        elif any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
            groups["matmul"] += t
        else:
            groups["other"] += t
    shares = ", ".join(f"{g} {t:.3f} ms ({t / total:.1%})" for g, t in groups.items())
    log(f"  {name} profile: device kernels {total:.3f} ms in a {wall_ms:.3f} ms step "
        f"(busy {total / wall_ms:.1%}): {shares}")
    for kname, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {t:9.3f} ms  {kname[:110]}")


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "vitok_torch")):
        print("chip_smoke.py must run from a checkout of the repository (no vitok_torch/ here)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on an NVIDIA H100", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vitok_torch.ops import _build

    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.time()
    _build.build(["fused_attention"])
    log(f"built CUDA kernels in {time.time() - t0:.1f} s")
    device = torch.device("cuda")

    kern = kernel_phase(device)
    main_path = main_path_phase(device, card)

    head = next(r for r in kern["rows"] if r["shape"] == "350M@512p main" and r["case"] == "tail")
    entry = {
        "name": "fused_attention",
        "route": "cuda",
        "source": "vitok_torch/csrc/fused_attention.cu",
        "replaces": "vitok_tpu/ops/fused_attention.py:317",
        "launches": main_path["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    }
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card, flush=True)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
