#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vitok_torch``) on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card (``nvidia-smi``) and the torch/CUDA versions, and builds
   every CUDA kernel of the main path from ``vitok_torch/csrc`` with ``nvcc``
   (one process per source, all at once);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes its path gives it, at the 5B width and at a ragged size, and times
   the kernel, the plain version and, where there is one, a PyTorch library
   call for the same function (for the fused FFN: ``torch._int_mm`` on its
   fc1 product alone);
3. drives the main path, preprocess -> AE.encode -> AE.decode -> postprocess,
   for 350M-f16x64 (``Ld4-Ld24/1x16x64``) at full width and depth with
   random weights from a seed, at 256p (batch 64) and 512p (batch 16), in
   bf16 and then int8 (``AE.quantize()``), and an int8 run at a width the
   fused FFN refuses (``Gd2-Gd2/1x16x64``), which takes the SwiGLU +
   quantize kernel. Each run sets every launch count to 0 before it and
   reads them after it; each checks the output, compares it with the same
   model on the plain path (unfused attention for bf16, the quantize
   kernels' plain versions for int8), is timed, and has one step profiled
   (device time by kernel group, the device's busy share);
4. serves an ordered stream of twelve mixed-size images through
   ``ServingPipeline`` over the default buckets (64 to 4096 tokens) with the
   bf16 350M model: every image back in order at its size, both attention
   kernels launched;
5. drives the high-resolution path: 350M with a sliding window of 1024 at
   1024p (batch 2) and 2048p (batch 1), bf16 and int8, where every block's
   attention takes the flash kernel; bf16 against the unfused composition
   at 1024p and against the flash kernel's plain version at 2048p, int8
   against its plain quantize kernels; then both once at 4096p;
6. holds the two flash backward kernels (dq, dk/dv) against their plain
   version on the forward kernel's shapes, and trains: 350M at full width
   and depth, fp32 master weights, bf16 compute, sliding window 1024,
   1024p (batch 2, 4096 tokens), Charbonnier + SSIM, AdamW + EMA, five
   steps on one batch (28 forward, 28 dq and 28 dk/dv launches a step, a
   falling loss, the first step's gradients against the same step on the
   plain backward), a step with every block recomputed (56 forward
   launches, the same loss), and one step at 2048p (16384 tokens);
7. prints a JSON line describing each kernel, the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core flop/s and
# int8 tensor-core op/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12

KERNEL_MAX_ABS = 2e-2   # both sides round P to bf16 before PV, but the online
KERNEL_MEAN_ABS = 2e-3  # softmax rescales at running maxima, in another order
MODEL_REL_L2 = 2e-2     # decoded patches, fused kernel vs unfused path, bf16
CODE_SHARE = 1e-3       # quantize kernels: codes differ by <= 1 step in <= 0.1% of entries
SCALE_RTOL = 1e-5       # ... and per-token scales agree to this

VARIANT = "Ld4-Ld24/1x16x64"  # 350M-f16x64
SILU_VARIANT = "Gd2-Gd2/1x16x64"  # width 1728: the fused FFN's gate refuses it
SILU_BATCH = 8  # at 256p
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
# Quantize kernels: rmsnorm_quant (#9), ffn_int8 (#7), silu_quant (#8)
# ---------------------------------------------------------------------------

QUANT_SHAPES = (  # (label, B, N, C, F): M = B * N token rows; F is padded to F' = 128k
    ("350M@256p main", 64, 256, 1024, 2736),
    ("350M@512p main", 16, 1024, 1024, 2736),
    ("5B width", 16, 256, 3072, 8208),
    ("ragged M", 1, 1000, 1024, 2736),  # a multiple of 8, not of the 128-row tile
)
SILU_MAIN = ("G@256p main", SILU_BATCH, 256, 1728, 4608)  # Gd2-Gd2: what its path gives it
FP32_OPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
# fp32 operations per element of the row kernels (norm or gate, absmax,
# divide, round, clip), for their operation bound.
ROW_KERNEL_OPS = 8


def _bound_ms(nbytes: float, ops: float, ops_per_s: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _compare_codes(what, got, want, pad_from=None) -> dict:
    """Codes within one step in at most CODE_SHARE of the entries, scales
    within SCALE_RTOL, and pad columns exactly 0."""
    (q, s), (q_ref, s_ref) = got, want
    diff = (q.int() - q_ref.int()).abs()
    max_diff = int(diff.max().item())
    share = (diff > 0).float().mean().item()
    rel = ((s - s_ref).abs() / s_ref.abs()).max().item()
    pad_zero = pad_from is None or not q[..., pad_from:].any().item()
    if not (max_diff <= 1 and share <= CODE_SHARE and rel <= SCALE_RTOL and pad_zero):
        raise AssertionError(
            f"{what}: kernel disagrees with its plain version: max code diff {max_diff}, "
            f"share {share:.2e} (limits 1, {CODE_SHARE}), scale rel err {rel:.2e} "
            f"(limit {SCALE_RTOL}), pad columns zero: {pad_zero}")
    return dict(max_abs_err=max_diff, code_mismatch_share=share, scale_max_rel_err=rel)


def quant_kernel_phase(device) -> dict:
    import torch
    from vitok_torch.ops import quant

    gen = torch.Generator(device=device).manual_seed(2)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=device)
    rows = {"rmsnorm_quant": [], "ffn_int8": [], "silu_quant": []}
    log("kernel phase: rmsnorm_quant, ffn_int8, silu_quant (CUDA) vs their plain versions")
    log(f"{'kernel':14s} {'shape':16s} {'M':>6s} {'C':>5s} {'Fp':>5s} {'code_err':>8s} {'share':>9s} "
        f"{'scale_rel':>9s} {'ms':>8s} {'plain_ms':>9s} {'bound_ms':>9s} {'int_mm_ms':>9s}")

    def record(kernel, label, m, c, fp, err, ms, plain_ms, bound, extra=None):
        row = dict(shape=label, M=m, C=c, Fp=fp, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                   bound_by=bound[1], library_ms=None, **err, **(extra or {}))
        rows[kernel].append(row)
        lib = (extra or {}).get("int_mm_fc1_ms")
        log(f"{kernel:14s} {label:16s} {m:6d} {c:5d} {fp:5d} {err['max_abs_err']:8d} "
            f"{err['code_mismatch_share']:9.2e} {err['scale_max_rel_err']:9.2e} {ms:8.4f} "
            f"{plain_ms:9.4f} {bound[0]:9.5f} {'' if lib is None else f'{lib:9.4f}'}")

    for label, b, n, c, f in (SILU_MAIN,) + QUANT_SHAPES:
        m, fp = b * n, quant.pad_ffn_dim(f)
        # #9: the residual stream [B, N, C] -> int8 + per-token scales.
        x = (randn(b, n, c) * 2).to(torch.bfloat16)
        gain = 0.5 + torch.rand(c, generator=gen, device=device)
        err = _compare_codes(f"rmsnorm_quant {label}", quant.fused_rmsnorm_quant(x, gain),
                             quant.fused_rmsnorm_quant_plain(x, gain))
        record("rmsnorm_quant", label, m, c, c, err,
               time_ms(lambda: quant.fused_rmsnorm_quant(x, gain)),
               time_ms(lambda: quant.fused_rmsnorm_quant_plain(x, gain)),
               _bound_ms(m * c * 2 + c * 4 + m * c + m * 4, ROW_KERNEL_OPS * m * c, FP32_OPS_PER_S))
        del x

        # #8: the bf16 fc1 output [M, 2F'] (pad columns of both halves 0).
        hid = torch.zeros(m, 2 * fp, dtype=torch.bfloat16, device=device)
        hid[:, :f] = randn(m, f).to(torch.bfloat16)
        hid[:, fp:fp + f] = (2 * randn(m, f)).to(torch.bfloat16)
        err = _compare_codes(f"silu_quant {label}", quant.fused_silu_quant(hid),
                             quant.fused_silu_quant_plain(hid), pad_from=f)
        record("silu_quant", label, m, c, fp, err,
               time_ms(lambda: quant.fused_silu_quant(hid)),
               time_ms(lambda: quant.fused_silu_quant_plain(hid)),
               _bound_ms(m * 2 * fp * 2 + m * fp + m * 4, ROW_KERNEL_OPS * m * fp, FP32_OPS_PER_S))
        del hid

        if not quant.can_fuse_ffn(m, c, 2 * fp):
            continue  # the G width: its path takes silu_quant instead
        # #7: int8 activations x the padded int8 fc1 weight.
        hq, hs = quant.quantize_activation(randn(m, c))
        w, ws = quant.quantize_weight(quant.pad_fc1_weight(0.05 * randn(2 * f, c)))
        err = _compare_codes(f"ffn_int8 {label}", quant.fused_ffn_int8(hq, hs, w, ws),
                             quant.fused_ffn_int8_plain(hq, hs, w, ws), pad_from=f)
        nbytes = m * c + m * 4 + 2 * fp * c + 2 * fp * 4 + m * fp + m * 4
        record("ffn_int8", label, m, c, fp, err,
               time_ms(lambda: quant.fused_ffn_int8(hq, hs, w, ws)),
               time_ms(lambda: quant.fused_ffn_int8_plain(hq, hs, w, ws)),
               _bound_ms(nbytes, 2.0 * m * c * 2 * fp, INT8_OPS_PER_S),
               dict(int_mm_fc1_ms=time_ms(lambda: torch._int_mm(hq, w.t()))))
        del hq, hs, w, ws
    log("  (int_mm_ms: torch._int_mm on the fc1 product only, no SwiGLU or requantize)")
    return rows


# ---------------------------------------------------------------------------
# Flash attention kernel (#4)
# ---------------------------------------------------------------------------

FLASH_SW = 1024  # the high-resolution runs' sliding window
FLASH_SHAPES = (  # (label, B, N, H, D, cases)
    ("350M@1024p", 2, 4096, 16, 64, ("none", "tail", "sw1024", "tail+sw1024")),
    ("350M@2048p", 1, 16384, 16, 64, ("sw1024", "tail+sw1024")),
    ("5B width", 1, 4096, 24, 128, ("none", "tail+sw1024")),
    ("ragged", 3, 2100, 16, 64, ("tail", "tail+sw1024")),  # sample 2 all padding
)
# Valid-row limits, about four and six times the worst readings over every
# shape below on an H100 (max 1.95e-3, mean 3.3e-5): a typical output value
# is about 0.03 here, so #1's limits would hide a window one key too wide.
FLASH_MAX_ABS = 8e-3
FLASH_MEAN_ABS = 2e-4
LSE_ATOL = 1e-3  # fp32 row sums in another order, exp2 against exp
# Backward kernels, each gradient's error on valid rows relative to its
# largest entry: about four and five times the worst readings over every
# shape below on an H100 (max 2.81e-3, mean 1.30e-6). The outputs are bf16
# (one rounding step is 2^-8 of a value) and most entries are far smaller
# than the largest, hence the small mean.
FLASH_BWD_MAX_REL = 1e-2
FLASH_BWD_MEAN_REL = 6e-6


def _flash_inputs(gen, b, n, h, d, masked, device):
    """bf16 q, k, v as views of one ``[B, N, 3, H, D]`` tensor (v strided as
    the model hands it over), and the tail-suffix valid count per sample: all
    N, or fewer per sample, and none in the third sample of three."""
    import torch

    qkv = torch.randn((b, n, 3, h, d), generator=gen, device=device).to(torch.bfloat16)
    valid = [n] * b
    mask = None
    if masked:
        valid = [n - (i * n) // (b + 2) - (n // 4 if b == 1 else 0) for i in range(b)]
        if b >= 3:
            valid[2] = 0
        mask = torch.arange(n, device=device)[None, :] < torch.tensor(valid, device=device)[:, None]
    return (*qkv.unbind(2), mask, valid)


def _flash_pairs(valid, n, sw) -> int:
    """(query, key) pairs the function needs on this data: each valid query
    row (the first ``valid`` of its sample) times the valid keys inside its
    window. Padded rows and rows with no live key come out 0 and need none."""
    total = 0
    for vb in valid:
        rows = np.arange(vb)
        if sw is None:
            total += vb * vb
        else:
            total += int(np.clip(np.minimum(vb, rows + sw + 1) - np.maximum(0, rows - sw), 0, None).sum())
    return total


def flash_kernel_phase(device) -> dict:
    import torch
    import torch.nn.functional as F
    from vitok_torch.ops import flash_attention as fl
    from vitok_torch.ops.attention import make_attention_mask

    gen = torch.Generator(device=device).manual_seed(3)
    rows, worst = [], 0.0
    log("kernel phase: flash_attention (CUDA) vs flash_attention_plain, bf16")
    log(f"{'shape':12s} {'B':>2s} {'N':>6s} {'H':>3s} {'D':>4s} {'case':12s} {'max_abs':>9s} "
        f"{'mean_abs':>9s} {'lse_err':>9s} {'ms':>8s} {'plain_ms':>9s} {'sdpa_ms':>8s} {'bound_ms':>9s}")
    for label, b, n, h, d, cases in FLASH_SHAPES:
        for case in cases:
            q, k, v, mask, valid = _flash_inputs(gen, b, n, h, d, "tail" in case, device)
            sw = FLASH_SW if "sw" in case else None
            got, lse = fl.flash_attention(q, k, v, mask, sw, return_lse=True)
            want, want_lse = fl.flash_attention_plain(q, k, v, mask, sw, return_lse=True)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if mask is not None:
                if got[~mask].any() or want[~mask].any():
                    raise AssertionError(f"flash {label} {case}: padded rows are not exactly 0")
                err = err[mask]
            live = want_lse < 1e29
            lse_err = (lse[live] - want_lse[live]).abs().max().item() if live.any() else 0.0
            dead_ok = torch.equal(lse < 1e29, live) and bool((lse[~live] == 1e30).all())
            max_abs, mean_abs = err.max().item(), err.mean().item()
            if not (max_abs <= FLASH_MAX_ABS and mean_abs <= FLASH_MEAN_ABS
                    and lse_err <= LSE_ATOL and dead_ok):
                raise AssertionError(
                    f"flash kernel disagrees with its plain version at {label} B={b} N={n} H={h} "
                    f"D={d} {case}: valid rows max {max_abs:.3e} mean {mean_abs:.3e} (limits "
                    f"{FLASH_MAX_ABS}, {FLASH_MEAN_ABS}); lse {lse_err:.3e} (limit {LSE_ATOL}), "
                    f"dead rows +1e30 on both sides: {dead_ok}")
            del got, lse, want, want_lse, err
            # Library yardstick: SDPA with the equivalent boolean mask.
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            am = make_attention_mask(None, n, sw, device)
            if mask is not None:
                key_ok = mask[:, None, None, :]
                am = key_ok if am is None else (am & key_ok)
            ms = time_ms(lambda: fl.flash_attention(q, k, v, mask, sw))
            plain_ms = time_ms(lambda: fl.flash_attention_plain(q, k, v, mask, sw), runs=3, warmup=1)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am), runs=3)
            del qt, kt, vt, am
            nbytes = 4 * b * n * h * d * 2 + (0 if mask is None else b * n)
            bound, bound_by = _bound_ms(nbytes, 4.0 * h * d * _flash_pairs(valid, n, sw), BF16_FLOPS_PER_S)
            worst = max(worst, max_abs)
            rows.append(dict(shape=label, B=b, N=n, H=h, D=d, case=case, max_abs_err=max_abs,
                             mean_abs_err=mean_abs, lse_max_abs_err=lse_err, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=bound_by))
            log(f"{label:12s} {b:2d} {n:6d} {h:3d} {d:4d} {case:12s} {max_abs:9.2e} {mean_abs:9.2e} "
                f"{lse_err:9.2e} {ms:8.4f} {plain_ms:9.4f} {lib_ms:8.4f} {bound:9.5f}")
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


def launch_counts() -> dict:
    from vitok_torch.ops import flash_attention as fl
    from vitok_torch.ops import fused_attention as fa
    from vitok_torch.ops import quant

    return {"fused_attention": fa.LAUNCHES, "flash_attention": fl.LAUNCHES,
            "flash_attention_dq": fl.DQ_LAUNCHES, "flash_attention_dkv": fl.DKV_LAUNCHES,
            **quant.LAUNCHES}


def reset_counts() -> None:
    from vitok_torch.ops import flash_attention as fl
    from vitok_torch.ops import fused_attention as fa
    from vitok_torch.ops import quant

    fa.LAUNCHES = 0
    fl.LAUNCHES = fl.DQ_LAUNCHES = fl.DKV_LAUNCHES = 0
    for k in quant.LAUNCHES:
        quant.LAUNCHES[k] = 0


def _expect(**counts) -> dict:
    """Expected launches of one run: the named counts, every other kernel 0."""
    return {k: counts.get(k, 0) for k in launch_counts()}


@contextlib.contextmanager
def plain_quant_kernels():
    """The quantize kernels' wrappers swapped for their plain versions: the
    int8 reference run (a switch of this script, not of the package)."""
    from vitok_torch.ops import quant

    names = ("fused_rmsnorm_quant", "fused_ffn_int8", "fused_silu_quant")
    saved = {n: getattr(quant, n) for n in names}
    for n in names:
        setattr(quant, n, getattr(quant, n + "_plain"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(quant, n, fn)


def _random_gates(model, device) -> None:
    """LayerScale gains ~ U(0.5, 1.5) from a seed: every block matters."""
    import torch

    gen = torch.Generator(device=device).manual_seed(1)
    with torch.no_grad():
        for blk in [*model.encoder_blocks, *model.decoder_blocks]:
            g = blk.layer_scale.gamma
            g.copy_(0.5 + torch.rand(g.shape, generator=gen, device=device))


def main_path_cases(device, resolutions=RESOLUTIONS, seed=0) -> list:
    """(name, max tokens, batch, images, NaFlex batch on the card) per resolution."""
    from vitok_torch import preprocess

    rng = np.random.default_rng(seed)
    cases = []
    for name, max_tokens, batch, sizes in resolutions:
        pp = f"to_tensor|normalize(minus_one_to_one)|patchify(16, {max_tokens})"
        images = _images(rng, sizes, batch)
        cases.append((name, max_tokens, batch, images, preprocess(images, pp=pp, device=device)))
    return cases


def _run_counted(model, cases, expect: dict, what: str) -> tuple:
    """Every count set to 0, the model run once per case, and the counts read:
    each case must add ``expect`` launches. Returns (outputs, counts)."""
    import torch

    reset_counts()
    outs = []
    for name, _, _, _, inputs in cases:
        before = launch_counts()
        outs.append(model.decode(model.encode(inputs)))
        torch.cuda.synchronize()
        per_forward = {k: v - before[k] for k, v in launch_counts().items()}
        if per_forward != expect:
            raise AssertionError(f"{what} {name}: launches per forward {per_forward}, expected {expect}")
    return outs, launch_counts()


def _check_output(name, max_tokens, batch, images, inputs, out) -> None:
    """Shape and finiteness, each unpacked image at its original size, and the
    postprocessed input patches bit for bit the input images."""
    import torch
    from vitok_torch import postprocess

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


def _valid_rel_l2(out, ref, inputs) -> float:
    valid = inputs["patch_mask"]
    a, r = out["patches"][valid].float(), ref["patches"][valid].float()
    return ((a - r).norm() / r.norm()).item()


def main_path_phase(device, card: str, cases) -> dict:
    from vitok_torch import AE, decode_variant

    cfg_kw = decode_variant(VARIANT)
    model = AE(**cfg_kw, seed=0, device=device)
    _random_gates(model, device)
    reference = AE(**{**cfg_kw, "attn_impl": "xla"}, state_dict=model.state_dict(), device=device)
    depth = model.cfg.encoder_depth + model.cfg.decoder_depth
    n_params = sum(p.numel() for p in model.parameters())
    log(f"main path: {VARIANT} ({n_params / 1e6:.1f}M params), bf16, {depth} blocks, device={device}")

    outs, launches = _run_counted(model, cases, _expect(fused_attention=depth), "bf16")  # the main path's run

    rows = []
    for (name, max_tokens, batch, images, inputs), out in zip(cases, outs):
        _check_output(name, max_tokens, batch, images, inputs, out)
        rel = _valid_rel_l2(out, reference.decode(reference.encode(inputs)), inputs)
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
    del reference
    return dict(rows=rows, launches=launches["fused_attention"], model=model, outputs=outs)


def int8_path_phase(device, card: str, cases, bf16: dict) -> dict:
    """The same 350M model, ``AE.quantize()``d, through the same batches."""
    from vitok_torch import AE, decode_variant

    model = AE(**decode_variant(VARIANT), state_dict=bf16["model"].state_dict(), device=device)
    model.quantize()
    depth = model.cfg.encoder_depth + model.cfg.decoder_depth
    log(f"int8 path: {VARIANT} after AE.quantize(), {depth} blocks, device={device}")
    expect = _expect(fused_attention=depth, rmsnorm_quant=depth, ffn_int8=depth)
    outs, launches = _run_counted(model, cases, expect, "int8")  # the int8 path's run

    rows = []
    for (name, max_tokens, batch, images, inputs), out, bf_out, bf_row in zip(
            cases, outs, bf16["outputs"], bf16["rows"]):
        _check_output(name, max_tokens, batch, images, inputs, out)
        with plain_quant_kernels():
            rel = _valid_rel_l2(out, model.decode(model.encode(inputs)), inputs)
        if not rel <= MODEL_REL_L2:
            raise AssertionError(f"int8 {name}: rel L2 vs the plain versions {rel:.3e} > {MODEL_REL_L2}")
        # For information: the int8 reconstruction against the bf16 one.
        valid = inputs["patch_mask"]
        mse = (out["patches"][valid].float() - bf_out["patches"][valid].float()).square().mean().item()
        psnr = 10 * np.log10(4.0 / mse) if mse > 0 else float("inf")  # pixels in [-1, 1]
        rel_bf16 = _valid_rel_l2(out, bf_out, inputs)
        ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=5, warmup=1)
        row = dict(res=name, tokens=max_tokens, batch=batch, rel_l2_vs_plain=rel,
                   rel_l2_vs_bf16=rel_bf16, psnr_vs_bf16=psnr, ms_per_img=ms / batch,
                   img_per_s=batch / ms * 1e3, bf16_ms_per_img=bf_row["ms_per_img"], card=card)
        rows.append(row)
        log(f"  int8 {name}: batch {batch}: rel L2 vs plain versions {rel:.3e}; vs bf16 rel L2 "
            f"{rel_bf16:.3e}, PSNR {psnr:.2f} dB; encode+decode {ms / batch:.4f} ms/img, "
            f"{batch / ms * 1e3:.1f} img/s (bf16 {bf_row['ms_per_img']:.4f} ms/img, "
            f"{bf_row['img_per_s']:.1f} img/s) on {card}")
        profile_step(f"int8 {name}", lambda: model.decode(model.encode(inputs)))
    return dict(rows=rows, launches=launches)


def silu_path_phase(device, card: str) -> dict:
    """An int8 model at a width the fused FFN's gate refuses (C % 128 != 0):
    its blocks take the int8 fc1 product and then the SwiGLU + quantize
    kernel. Head dim 72, so attention takes the unfused composition."""
    from vitok_torch import AE, decode_variant

    model = AE(**decode_variant(SILU_VARIANT), seed=0, device=device)
    _random_gates(model, device)
    model.quantize()
    depth = model.cfg.encoder_depth + model.cfg.decoder_depth
    name, max_tokens, _, sizes = RESOLUTIONS[0]
    cases = main_path_cases(device, [(name, max_tokens, SILU_BATCH, sizes)], seed=1)
    log(f"int8 SwiGLU-quantize path: {SILU_VARIANT} after AE.quantize(), {depth} blocks, "
        f"{name} batch {SILU_BATCH}")
    expect = _expect(rmsnorm_quant=depth, silu_quant=depth)
    (out,), launches = _run_counted(model, cases, expect, "int8 G")
    name, max_tokens, batch, images, inputs = cases[0]
    _check_output(name, max_tokens, batch, images, inputs, out)
    with plain_quant_kernels():
        rel = _valid_rel_l2(out, model.decode(model.encode(inputs)), inputs)
    if not rel <= MODEL_REL_L2:
        raise AssertionError(f"int8 G {name}: rel L2 vs the plain versions {rel:.3e} > {MODEL_REL_L2}")
    ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=5, warmup=1)
    log(f"  int8 G {name}: rel L2 vs plain versions {rel:.3e}; encode+decode {ms / batch:.4f} "
        f"ms/img on {card}")
    return dict(launches=launches, rel_l2_vs_plain=rel, ms_per_img=ms / batch)


# ---------------------------------------------------------------------------
# High-resolution path (flash attention) and bucketed serving
# ---------------------------------------------------------------------------

HIGHRES = (  # (name, pp max tokens, batch, image sizes): 350M with sw=FLASH_SW
    ("1024p", 4096, 2, [(1024, 1024), (960, 800)]),
    ("2048p", 16384, 1, [(2048, 1920)]),
)
HIGHRES_MAX = ("4096p", 65536, 1, [(4096, 3840)])  # counted, checked and timed, no reference run
# Up to this many tokens the bf16 reference is the unfused composition (about
# 2 GB of fp32 logits a block at 1024p, batch 2); beyond it, the same model
# with the flash wrapper swapped for its plain version.
UNFUSED_REF_MAX_TOKENS = 4096
SERVING_BATCH = 4
SERVING_SIZES = [  # (width, height): four in the 64-token bucket, three in 256 and 1024, two in 4096
    (128, 128), (512, 512), (100, 80), (256, 256), (1024, 1024), (200, 240),
    (480, 360), (64, 64), (256, 192), (800, 600), (96, 128), (512, 384),
]


@contextlib.contextmanager
def plain_flash_kernel():
    """The attention router's flash wrapper swapped for its plain version:
    the bf16 reference run beyond ``UNFUSED_REF_MAX_TOKENS``."""
    from vitok_torch.ops import attention
    from vitok_torch.ops import flash_attention as fl

    saved = attention.flash_attention
    attention.flash_attention = fl.flash_attention_plain
    try:
        yield
    finally:
        attention.flash_attention = saved


def highres_phase(device, card: str) -> dict:
    """350M-f16x64 with ``sw=FLASH_SW`` at 1024p and 2048p, and at 4096p
    without a reference, bf16 and int8: every block's attention goes to the
    flash kernel."""
    import torch
    from vitok_torch import AE, decode_variant

    cfg_kw = {**decode_variant(VARIANT), "sw": FLASH_SW}
    model = AE(**cfg_kw, seed=0, device=device)
    _random_gates(model, device)
    depth = model.cfg.encoder_depth + model.cfg.decoder_depth
    cases = main_path_cases(device, HIGHRES, seed=2)
    log(f"high-resolution path: {VARIANT}, sw={FLASH_SW}, bf16, {depth} blocks")
    outs, launches = _run_counted(model, cases, _expect(flash_attention=depth), "bf16 high-res")

    rows = []
    for (name, max_tokens, batch, images, inputs), out in zip(cases, outs):
        _check_output(name, max_tokens, batch, images, inputs, out)
        if max_tokens <= UNFUSED_REF_MAX_TOKENS:
            what = "unfused attention"
            reference = AE(**{**cfg_kw, "attn_impl": "xla"}, state_dict=model.state_dict(), device=device)
            ref = reference.decode(reference.encode(inputs))
            del reference
        else:
            what = "flash plain version"
            with plain_flash_kernel():
                ref = model.decode(model.encode(inputs))
        rel = _valid_rel_l2(out, ref, inputs)
        del ref
        if not rel <= MODEL_REL_L2:
            raise AssertionError(f"bf16 {name}: rel L2 vs the {what} {rel:.3e} > {MODEL_REL_L2}")
        step = lambda: model.decode(model.encode(inputs))
        ms = time_ms(step, runs=3, warmup=1)
        rows.append(dict(res=name, tokens=max_tokens, batch=batch, dtype="bf16", reference=what,
                         rel_l2=rel, ms_per_img=ms / batch, card=card))
        log(f"  bf16 {name}: batch {batch}, {max_tokens} tokens: rel L2 vs the {what} {rel:.3e}; "
            f"encode+decode {ms / batch:.4f} ms/img on {card}")
        profile_step(f"bf16 {name}", step)
    del outs

    (big,) = main_path_cases(device, [HIGHRES_MAX], seed=3)
    rows.append(_largest_run(model, big, _expect(flash_attention=depth), "bf16", card))

    qmodel = AE(**cfg_kw, state_dict=model.state_dict(), device=device).quantize()
    del model
    torch.cuda.empty_cache()
    log(f"high-resolution path: {VARIANT}, sw={FLASH_SW}, int8 after AE.quantize()")
    expect = _expect(flash_attention=depth, rmsnorm_quant=depth, ffn_int8=depth)
    outs, int8_launches = _run_counted(qmodel, cases, expect, "int8 high-res")
    for (name, max_tokens, batch, images, inputs), out in zip(cases, outs):
        _check_output(name, max_tokens, batch, images, inputs, out)
        with plain_quant_kernels():  # the flash kernel stays: see PERF.md
            rel = _valid_rel_l2(out, qmodel.decode(qmodel.encode(inputs)), inputs)
        if not rel <= MODEL_REL_L2:
            raise AssertionError(f"int8 {name}: rel L2 vs the plain quantize kernels {rel:.3e} > {MODEL_REL_L2}")
        step = lambda: qmodel.decode(qmodel.encode(inputs))
        ms = time_ms(step, runs=3, warmup=1)
        rows.append(dict(res=name, tokens=max_tokens, batch=batch, dtype="int8",
                         reference="plain quantize kernels", rel_l2=rel, ms_per_img=ms / batch, card=card))
        log(f"  int8 {name}: batch {batch}: rel L2 vs the plain quantize kernels {rel:.3e}; "
            f"encode+decode {ms / batch:.4f} ms/img on {card}")
        profile_step(f"int8 {name}", step)
    del outs
    rows.append(_largest_run(qmodel, big, expect, "int8", card))
    return dict(rows=rows, launches=launches, int8_launches=int8_launches)


def _largest_run(model, case, expect: dict, dtype: str, card: str) -> dict:
    """One counted, checked and timed forward at ``HIGHRES_MAX`` (no
    reference run: the unfused composition cannot hold it, the plain flash
    version would take minutes)."""
    name, max_tokens, batch, _, inputs = case
    (out,), _ = _run_counted(model, [case], expect, f"{dtype} {name}")
    _check_output(*case, out)
    del out
    ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=2, warmup=1)
    log(f"  {dtype} {name}: batch {batch}, {max_tokens} tokens: finite, {ms / batch:.4f} ms/img on {card}")
    return dict(res=name, tokens=max_tokens, batch=batch, dtype=dtype, reference=None,
                rel_l2=None, ms_per_img=ms / batch, card=card)


def serving_phase(device, card: str, model) -> dict:
    """``ServingPipeline`` over the default buckets with the bf16 350M model
    (no window): an ordered stream of mixed sizes that uses every bucket,
    two images in the 4096-token one (the flash kernel)."""
    import torch
    from vitok_torch import ServingPipeline
    from vitok_torch.serving import DEFAULT_BUCKETS, bucket_for_tokens

    images = _images(np.random.default_rng(4), SERVING_SIZES, len(SERVING_SIZES))
    buckets = [bucket_for_tokens(-(-w // 16) * -(-h // 16), DEFAULT_BUCKETS) for w, h in SERVING_SIZES]
    if set(buckets) != set(DEFAULT_BUCKETS) or buckets.count(max(DEFAULT_BUCKETS)) != 2:
        raise AssertionError(f"serving stream buckets {buckets} do not cover {DEFAULT_BUCKETS}")
    pipe = ServingPipeline(model, buckets=DEFAULT_BUCKETS, batch_size=SERVING_BATCH)
    log(f"serving: {VARIANT} bf16, buckets {DEFAULT_BUCKETS}, batch {SERVING_BATCH}, "
        f"{len(images)} images")
    reset_counts()
    got = list(pipe.stream(images, ordered=True))
    torch.cuda.synchronize()
    launches = launch_counts()
    if [i for i, _ in got] != list(range(len(images))):
        raise AssertionError(f"serving: stream order {[i for i, _ in got]}")
    for (i, recon), img in zip(got, images):
        if tuple(recon.shape) != (3, img.size[1], img.size[0]) or not torch.isfinite(recon).all():
            raise AssertionError(f"serving: image {i} {img.size} came back {tuple(recon.shape)} or non-finite")
    if not (launches["flash_attention"] > 0 and launches["fused_attention"] > 0):
        raise AssertionError(f"serving: launches {launches}: both attention kernels must run")
    t0 = time.perf_counter()
    n = sum(1 for _ in pipe.stream(images, ordered=True))
    seconds = time.perf_counter() - t0
    log(f"  serving: {n} images in order at their sizes, launches {launches}; for information "
        f"only (a functional stream, too short to measure throughput): {n / seconds:.2f} img/s "
        f"host clock, preprocessing included, on {card}")
    return dict(launches=launches, img_per_s=n / seconds, stats=pipe.stats)


# ---------------------------------------------------------------------------
# Flash attention backward kernels (#5 dq, #6 dk/dv) and the training path
# ---------------------------------------------------------------------------


def flash_bwd_kernel_phase(device) -> dict:
    """The dq and dk/dv kernels against ``flash_attention_bwd_plain`` on the
    forward phase's shapes; the library yardstick is SDPA's backward with
    the boolean mask (forward + backward, minus the forward)."""
    import torch
    import torch.nn.functional as F
    from vitok_torch.ops import flash_attention as fl
    from vitok_torch.ops.attention import make_attention_mask

    gen = torch.Generator(device=device).manual_seed(5)
    rows, worst = [], {"dq": 0.0, "dkv": 0.0}
    log("kernel phase: flash attention backward, dq and dk/dv (CUDA) vs flash_attention_bwd_plain, bf16")
    log(f"{'shape':12s} {'B':>2s} {'N':>6s} {'H':>3s} {'D':>4s} {'case':12s} {'dq max/mean rel':>17s} "
        f"{'dk max/mean rel':>17s} {'dv max/mean rel':>17s} {'dq_ms':>8s} {'dkv_ms':>8s} {'plain_ms':>9s} "
        f"{'sdpa_bwd':>9s} {'dq_bound':>9s} {'dkv_bound':>9s}")
    for label, b, n, h, d, cases in FLASH_SHAPES:
        for case in cases:
            q, k, v, mask, valid = _flash_inputs(gen, b, n, h, d, "tail" in case, device)
            sw = FLASH_SW if "sw" in case else None
            out, lse = fl.flash_attention(q, k, v, mask, sw, return_lse=True)
            # The cotangent as the model hands it over: a [B, N, C] tensor viewed per head.
            g = torch.randn((b, n, h * d), generator=gen, device=device).to(torch.bfloat16).view(b, n, h, d)
            dq, delta = fl.flash_dq_cuda(q, k, v, out, lse, g, mask, sw)
            dk, dv = fl.flash_dkv_cuda(q, k, v, lse, delta, g, mask, sw)
            again = fl.flash_attention_bwd(q, k, v, out, lse, g, mask, sw)
            want = fl.flash_attention_bwd_plain(q, k, v, out, lse, g, mask, sw)
            torch.cuda.synchronize()
            errs = {}
            for name, a, a2, r in zip(("dq", "dk", "dv"), (dq, dk, dv), again, want):
                if not torch.equal(a, a2):
                    raise AssertionError(f"flash backward {label} {case}: {name} differs between two runs")
                if mask is not None and (a[~mask].any() or r[~mask].any()):
                    raise AssertionError(f"flash backward {label} {case}: padded rows of {name} are not exactly 0")
                err = (a.float() - r.float()).abs()
                scale = r.float().abs().max().item()
                if mask is not None:
                    err = err[mask]
                errs[name] = (err.max().item() / scale, err.mean().item() / scale,
                              err.max().item(), bool(torch.isfinite(a).all()))
            bad = {name: e for name, e in errs.items()
                   if not (e[3] and e[0] <= FLASH_BWD_MAX_REL and e[1] <= FLASH_BWD_MEAN_REL)}
            if bad:
                raise AssertionError(
                    f"flash backward kernels disagree with their plain version at {label} B={b} N={n} "
                    f"H={h} D={d} {case}: (max rel, mean rel, max abs, finite) {bad} (limits "
                    f"{FLASH_BWD_MAX_REL}, {FLASH_BWD_MEAN_REL} of the gradient's largest entry)")
            del again, want, dq, dk, dv
            dq_ms = time_ms(lambda: fl.flash_dq_cuda(q, k, v, out, lse, g, mask, sw))
            dkv_ms = time_ms(lambda: fl.flash_dkv_cuda(q, k, v, lse, delta, g, mask, sw))
            plain_ms = time_ms(lambda: fl.flash_attention_bwd_plain(q, k, v, out, lse, g, mask, sw),
                               runs=2, warmup=1)
            # Library yardstick: SDPA forward + backward with the equivalent
            # boolean mask, minus its forward.
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
            gt = g.transpose(1, 2).contiguous()
            am = make_attention_mask(None, n, sw, device)
            if mask is not None:
                key_ok = mask[:, None, None, :]
                am = key_ok if am is None else (am & key_ok)

            def sdpa_step():
                o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
                torch.autograd.grad(o, (qt, kt, vt), gt)

            with torch.no_grad():
                fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am), runs=3)
            lib_ms = time_ms(sdpa_step, runs=3) - fwd_ms
            del qt, kt, vt, gt, am
            pairs = _flash_pairs(valid, n, sw)
            tensor, vec = b * n * h * d * 2, b * h * n * 4
            mask_bytes = 0 if mask is None else b * n
            # dq: q, k, v, dO, O in, dq out, lse in; three products a pair.
            dq_bound = _bound_ms(6 * tensor + vec + mask_bytes, 3 * 2.0 * h * d * pairs, BF16_FLOPS_PER_S)
            # dk/dv: q, k, v, dO in, dk and dv out, lse and delta in; four products a pair.
            dkv_bound = _bound_ms(6 * tensor + 2 * vec + mask_bytes, 4 * 2.0 * h * d * pairs, BF16_FLOPS_PER_S)
            worst["dq"] = max(worst["dq"], errs["dq"][2])
            worst["dkv"] = max(worst["dkv"], errs["dk"][2], errs["dv"][2])
            rows.append(dict(shape=label, B=b, N=n, H=h, D=d, case=case,
                             **{f"{name}_max_rel_err": e[0] for name, e in errs.items()},
                             **{f"{name}_mean_rel_err": e[1] for name, e in errs.items()},
                             **{f"{name}_max_abs_err": e[2] for name, e in errs.items()},
                             dq_ms=dq_ms, dkv_ms=dkv_ms, plain_ms=plain_ms, library_ms=lib_ms,
                             dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1],
                             dkv_bound_ms=dkv_bound[0], dkv_bound_by=dkv_bound[1]))
            rel = lambda name: f"{errs[name][0]:8.2e}/{errs[name][1]:8.2e}"
            log(f"{label:12s} {b:2d} {n:6d} {h:3d} {d:4d} {case:12s} {rel('dq')} {rel('dk')} {rel('dv')} "
                f"{dq_ms:8.4f} {dkv_ms:8.4f} {plain_ms:9.4f} {lib_ms:9.4f} {dq_bound[0]:9.5f} {dkv_bound[0]:9.5f}")
    log("  (plain_ms: dq, dk and dv together; sdpa_bwd: SDPA forward + backward minus its forward)")
    return dict(rows=rows, max_abs_err=worst)


@contextlib.contextmanager
def plain_flash_backward():
    """The autograd Function's backward swapped for the plain version (the
    forward kernel stays): the reference for the training gradients."""
    from vitok_torch.ops import flash_attention as fl

    saved = fl.flash_attention_bwd
    fl.flash_attention_bwd = fl.flash_attention_bwd_plain
    try:
        yield
    finally:
        fl.flash_attention_bwd = saved


TRAIN = ("1024p", 4096, 2, [(1024, 1024), (960, 800)])  # the high-resolution run's first batch shape
TRAIN_BIG = ("2048p", 16384, 1, [(2048, 1920)])          # one step, every block recomputed
TRAIN_STEPS = 5
TRAIN_LR = 2e-5
TRAIN_GRAD_REL_L2 = 2e-2  # all parameter gradients, backward kernels vs the plain backward


def _with_checkpoint(model, every: int) -> None:
    model.cfg = dataclasses.replace(model.cfg, checkpoint=every)


def training_phase(device, card: str) -> dict:
    """Train 350M-f16x64 at full width and depth with ``sw=FLASH_SW``: fp32
    master weights, bf16 compute, 4096-token batches, Charbonnier 1.0 + SSIM
    0.1 on two 256-tiles, AdamW + EMA, every activation stored."""
    import torch
    from vitok_torch import AE, decode_variant
    from vitok_torch.train_lib import (LossConfig, compute_loss, create_optimizer, create_schedule,
                                       create_train_state, make_train_step)

    cfg_kw = {**decode_variant(VARIANT), "sw": FLASH_SW}
    model = AE(**cfg_kw, seed=0, device=device, param_dtype=torch.float32, trainable=True)
    _random_gates(model, device)
    depth = model.cfg.encoder_depth + model.cfg.decoder_depth
    params = list(model.parameters())
    n_params = sum(p.numel() for p in params)
    (case,) = main_path_cases(device, [TRAIN], seed=5)
    name, max_tokens, batch, _, inputs = case
    side = int(max_tokens ** 0.5)
    loss_cfg = LossConfig(ssim_weight=0.1, tile_size=256, n_tiles=2, ssim_grid=(side, side))
    log(f"training path: {VARIANT} ({n_params / 1e6:.1f}M fp32 master params), sw={FLASH_SW}, bf16 compute, "
        f"{name} batch {batch} ({max_tokens} tokens), Charbonnier 1.0 + SSIM 0.1, AdamW lr {TRAIN_LR} + EMA")

    def grads_of(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        loss, _ = compute_loss(model, inputs, loss_cfg, gen)
        return loss.detach(), torch.autograd.grad(loss, params)

    def rel_l2(got, want):
        num = sum((a.double() - b.double()).square().sum() for a, b in zip(got, want))
        return (num / sum(b.double().square().sum() for b in want)).sqrt().item()

    # The first step's gradients: backward kernels against the plain backward.
    loss_k, g_kernel = grads_of(11)
    with plain_flash_backward():
        loss_p, g_plain = grads_of(11)
    torch.cuda.synchronize()
    grad_rel = rel_l2(g_kernel, g_plain)
    finite = all(bool(torch.isfinite(g).all()) for g in g_kernel)
    if not (finite and loss_k.item() == loss_p.item() and grad_rel <= TRAIN_GRAD_REL_L2):
        raise AssertionError(
            f"training: gradients with the backward kernels vs the plain backward: rel L2 {grad_rel:.3e} "
            f"(limit {TRAIN_GRAD_REL_L2}), finite {finite}, loss {loss_k.item()} vs {loss_p.item()}")
    del g_kernel, g_plain
    log(f"  first-step gradients, kernels vs plain backward: rel L2 {grad_rel:.3e} over all parameters")

    tx = create_optimizer(create_schedule("constant", TRAIN_LR, TRAIN_STEPS, warmup_frac=0.0))
    state = create_train_state(model, tx)
    train_step = make_train_step(tx, loss_cfg)
    per_step = _expect(flash_attention=depth, flash_attention_dq=depth, flash_attention_dkv=depth)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the training path's run
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        before = launch_counts()
        t0 = time.perf_counter()
        state, metrics = train_step(state, inputs, 3)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        got = {k: v - before[k] for k, v in launch_counts().items()}
        if got != per_step:
            raise AssertionError(f"training step {i + 1}: launches {got}, expected {per_step}")
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    totals = [m["loss/total"] for m in losses]
    if not (all(np.isfinite(list(m.values())).all() for m in losses) and totals[-1] < totals[0]):
        raise AssertionError(f"training: losses {totals} must be finite and fall from the first to the fifth step")
    ema_gap = max((state.ema_params[n] - p.detach()).abs().max().item() for n, p in model.named_parameters())
    if not ema_gap > 0:
        raise AssertionError("training: the EMA equals the parameters after five steps")
    ms = float(np.median(step_ms[1:]))
    log(f"  {TRAIN_STEPS} steps: loss " + " -> ".join(f"{t:.5f}" for t in totals)
        + f" (charbonnier {losses[0]['loss/charbonnier']:.5f} -> {losses[-1]['loss/charbonnier']:.5f}, ssim "
        f"{losses[0]['loss/ssim']:.5f} -> {losses[-1]['loss/ssim']:.5f}), grad norm "
        f"{losses[0]['grad_norm']:.4f} -> {losses[-1]['grad_norm']:.4f}; launches a step {per_step}")
    log(f"  {ms:.3f} ms/step (host clock, median of steps 2-{TRAIN_STEPS}; first step {step_ms[0]:.3f}), "
        f"{batch * max_tokens / ms * 1e3:.1f} tokens/s, peak memory {peak_gb:.3f} GB, "
        f"max |EMA - params| {ema_gap:.3e} on {card}")
    profile_step(f"train {name}", lambda: train_step(state, inputs, 3))

    # Every block recomputed in the backward: twice the forward launches, the same loss.
    with torch.no_grad():
        want_loss, _ = compute_loss(model, inputs, loss_cfg,
                                    torch.Generator(device=device).manual_seed(3 * 1_000_003 + state.step))
    _with_checkpoint(model, 1)
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    t0 = time.perf_counter()
    state, metrics = train_step(state, inputs, 3)
    torch.cuda.synchronize()
    remat_ms = (time.perf_counter() - t0) * 1e3
    got = {k: v - before[k] for k, v in launch_counts().items()}
    expect = _expect(flash_attention=2 * depth, flash_attention_dq=depth, flash_attention_dkv=depth)
    if got != expect or float(metrics["loss/total"]) != want_loss.item():
        raise AssertionError(f"training with checkpoint=1: launches {got} (expected {expect}), loss "
                             f"{float(metrics['loss/total'])} vs {want_loss.item()} with every activation stored")
    remat_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  checkpoint=1: launches {got}, loss {want_loss.item():.5f} as with every activation stored; "
        f"{remat_ms:.3f} ms/step, peak memory {remat_peak:.3f} GB on {card}")

    # One step at 2048p (16384 tokens), every block recomputed.
    (big,) = main_path_cases(device, [TRAIN_BIG], seed=6)
    bname, btokens, bbatch, _, binputs = big
    bside = int(btokens ** 0.5)
    big_step = make_train_step(tx, LossConfig(ssim_weight=0.1, tile_size=256, n_tiles=2, ssim_grid=(bside, bside)))
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    t0 = time.perf_counter()
    state, metrics = big_step(state, binputs, 3)
    torch.cuda.synchronize()
    big_ms = (time.perf_counter() - t0) * 1e3
    got = {k: v - before[k] for k, v in launch_counts().items()}
    big_loss = float(metrics["loss/total"])
    if got != expect or not np.isfinite(big_loss) or not np.isfinite(float(metrics["grad_norm"])):
        raise AssertionError(f"training {bname}: launches {got} (expected {expect}), loss {big_loss}")
    big_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {bname} batch {bbatch} ({btokens} tokens), checkpoint=1: loss {big_loss:.5f}, launches {got}; "
        f"{big_ms:.3f} ms (one step), {bbatch * btokens / big_ms * 1e3:.1f} tokens/s, peak memory "
        f"{big_peak:.3f} GB on {card}")
    return dict(launches=launches, losses=totals, grad_rel_l2=grad_rel, ms_per_step=ms,
                tokens_per_s=batch * max_tokens / ms * 1e3, peak_gb=peak_gb, remat_ms=remat_ms,
                big_ms=big_ms, big_peak_gb=big_peak)


def flash_bwd_entries(bkern: dict, training: dict) -> list:
    """The kernels-line entries of the two backward kernels: launches from
    the training run, times at 2048p with the window (B = 1)."""
    row = next(r for r in bkern["rows"] if r["shape"] == "350M@2048p" and r["case"] == "sw1024")
    entries = []
    for name, key, line in (("flash_attention_dq", "dq", 427), ("flash_attention_dkv", "dkv", 556)):
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "vitok_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"vitok_tpu/ops/flash_attention.py:{line}",
            "launches": training["launches"][name],
            "max_abs_err": bkern["max_abs_err"][key],
            "ms": row[f"{key}_ms"],
            "plain_ms": row["plain_ms"],     # dq, dk and dv together
            "bound_ms": row[f"{key}_bound_ms"],
            "bound_by": row[f"{key}_bound_by"],
            "library_ms": row["library_ms"],  # SDPA's whole backward (dq, dk and dv)
        })
    return entries


# Profile groups: each port kernel by its exact __global__ name, then the
# library's matrix products (cuBLAS/cuBLASLt, torch._int_mm included) by
# markers in their names, then everything else.
PORT_KERNEL_GROUPS = {
    "fused_attention_kernel": "fused_attention",
    "flash_attention_kernel": "flash_attention",
    "flash_bwd_delta_kernel": "flash_attention_dq",  # dq's prologue
    "flash_bwd_dq_kernel": "flash_attention_dq",
    "flash_bwd_dkv_kernel": "flash_attention_dkv",
    "rmsnorm_quant_kernel": "rmsnorm_quant",
    "ffn_int8_gemm_kernel": "ffn_int8",
    "ffn_int8_quant_kernel": "ffn_int8",
    "silu_quant_kernel": "silu_quant",
}
MATMUL_MARKERS = ("gemm", "xmma", "cutlass", "nvjet", "matmul", "imma")


def kernel_base_name(name: str) -> str:
    """``void (anonymous namespace)::ffn_int8_gemm_kernel<2>(signed char...)``
    -> ``ffn_int8_gemm_kernel``."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    return re.split(r"[<(]", name, maxsplit=1)[0].rsplit("::", 1)[-1].strip()


def kernel_group(name: str) -> str:
    group = PORT_KERNEL_GROUPS.get(kernel_base_name(name))
    if group is not None:
        return group
    return "matmul" if any(w in name.lower() for w in MATMUL_MARKERS) else "other"


def profile_step(name: str, step) -> None:
    """Where one encode+decode spends the card's time: device kernel time by
    group (each port kernel, matrix products, everything else) from
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
    groups = dict.fromkeys([*dict.fromkeys(PORT_KERNEL_GROUPS.values()), "matmul", "other"], 0.0)
    for kname, t in by_name.items():
        groups[kernel_group(kname)] += t
    shares = ", ".join(f"{g} {t:.3f} ms ({t / total:.1%})" for g, t in groups.items() if t > 0)
    log(f"  {name} profile: device kernels {total:.3f} ms in a {wall_ms:.3f} ms step "
        f"(busy {total / wall_ms:.1%}): {shares}")
    for kname, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {t:9.3f} ms  [{kernel_group(kname)}] {kname[:110]}")


def kernel_entries(kern, qkern, fkern, main_path, int8_path, silu_path, highres) -> list:
    """The kernels line: one entry per kernel, its launches from its path's run."""
    head = next(r for r in kern["rows"] if r["shape"] == "350M@512p main" and r["case"] == "tail")
    entries = [{
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
    }]
    flash = next(r for r in fkern["rows"] if r["shape"] == "350M@2048p" and r["case"] == "sw1024")
    entries.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "vitok_torch/csrc/flash_attention.cu",
        "replaces": "vitok_tpu/ops/flash_attention.py:67",
        "launches": highres["launches"]["flash_attention"],
        "max_abs_err": fkern["max_abs_err"],
        "ms": flash["ms"],
        "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
    })
    for name, replaces, shape, launches in (
        ("rmsnorm_quant", "vitok_tpu/ops/quant.py:385", "350M@512p main", int8_path["launches"]),
        ("ffn_int8", "vitok_tpu/ops/quant.py:130", "350M@512p main", int8_path["launches"]),
        ("silu_quant", "vitok_tpu/ops/quant.py:317", SILU_MAIN[0], silu_path["launches"]),
    ):
        rows = qkern[name]
        row = next(r for r in rows if r["shape"] == shape)
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"vitok_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "code_mismatch_share": max(r["code_mismatch_share"] for r in rows),
        }
        if "int_mm_fc1_ms" in row:
            entry["int_mm_fc1_ms"] = row["int_mm_fc1_ms"]  # torch._int_mm, the fc1 product only
        entries.append(entry)
    return entries


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

    started = time.time()
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.time()
    _build.build(["fused_attention", "flash_attention", "flash_attention_bwd", "rmsnorm_quant",
                  "ffn_int8", "silu_quant"])
    log(f"built CUDA kernels in {time.time() - t0:.1f} s")
    device = torch.device("cuda")

    kern = kernel_phase(device)
    qkern = quant_kernel_phase(device)
    fkern = flash_kernel_phase(device)
    cases = main_path_cases(device)
    main_path = main_path_phase(device, card, cases)
    int8_path = int8_path_phase(device, card, cases, main_path)
    silu_path = silu_path_phase(device, card)
    serving_phase(device, card, main_path["model"])
    del cases, main_path["model"], main_path["outputs"]
    highres = highres_phase(device, card)
    torch.cuda.empty_cache()
    bkern = flash_bwd_kernel_phase(device)
    training = training_phase(device, card)

    entries = kernel_entries(kern, qkern, fkern, main_path, int8_path, silu_path, highres)
    entries[2:2] = flash_bwd_entries(bkern, training)
    log(f"chip_smoke.py ran for {time.time() - started:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
