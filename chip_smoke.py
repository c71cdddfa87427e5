#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vitok_torch``) on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card (``nvidia-smi``) and the torch/CUDA versions, and builds
   every CUDA kernel of the main path from ``vitok_torch/csrc`` with ``nvcc``
   (one process per source, all at once);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes its paths give it (the 5B bench phase's too), at the 5B width and at a ragged size, and times
   the kernel, the plain version and, where there is one, a PyTorch library
   call for the same function (for the fused FFN: ``torch._int_mm`` on its
   fc1 product alone; the FFN kernel's codes and scales, and those of the
   two row kernels (RMSNorm + quantize, SwiGLU + quantize) in bf16 and in
   fp32, must equal the plain versions' bit for bit, and the row kernels are
   timed chained, with the host ahead and on the host's clock, beside their
   plans, registers and resident blocks); the fused forward is the q/k prologue and the wgmma
   kernel (with its row log-sum-exp against the plain one), timed beside the
   kept mma.sync forward; the flash forward is also timed against
   FlexAttention (a yardstick built here, never called by the port), and
   the fold from the flat QKV (the q/k prologue, then the flash kernel)
   against its plain version and the eager route it replaces;
3. drives the main path, preprocess -> AE.encode -> AE.decode -> postprocess,
   for 350M-f16x64 (``Ld4-Ld24/1x16x64``) at full width and depth with
   random weights from a seed, at 256p (batch 64) and 512p (batch 16), in
   bf16 and then int8 (``AE.quantize()``), and an int8 run at a width the
   fused FFN refuses (``Gd2-Gd2/1x16x64``), which takes the SwiGLU +
   quantize kernel, in bf16 and again in fp32. Each run sets every launch count to 0 before it and
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
   attention takes the fold (the q/k prologue, then the flash kernel); bf16
   against the unfused composition at 1024p and against the fold's plain
   version at 2048p (both references launch no attention kernel), int8
   against its plain quantize kernels; then both once at 4096p;
6. holds the two flash backward kernels (dq, dk/dv) against their plain
   version on the forward kernel's shapes, and trains: 350M at full width
   and depth, fp32 master weights, bf16 compute, sliding window 1024,
   1024p (batch 2, 4096 tokens), Charbonnier + SSIM, AdamW + EMA, five
   steps on one batch (28 forward, 28 dq and 28 dk/dv launches a step, a
   falling loss, the first step's gradients against the same step on the
   plain backward), a step with every block recomputed (56 forward
   launches, the same loss), and one step at 2048p (16384 tokens);
7. holds the fused attention's backward (the prologue, then the wgmma dq
   and dk/dv kernels, given the forward's output and log-sum-exp) and its
   int8-epilogue kernel (the prologue, then the redesigned body with the
   quantize) against their plain versions (and the epilogue's codes and
   scales against ``quantize_activation`` of the redesigned forward's
   output, bit for bit);
   trains 350M at 256 tokens, batch 32, on the fused kernel and its backward
   kernel (28 + 28 launches a step) beside the unfused composition under
   autograd; runs the int8 350M path with the quantize epilogue switched on;
   samples DiT-L/256 latents with 20 UniPC steps under classifier-free
   guidance (host loop and device loop), decodes them to 256 x 256 images
   with the 350M decoder, repeats a call after ``DiT.quantize()``; and
   takes three flow-matching training steps of DiT-L on the fused kernels;
8. runs the 5B model (``Td4-T/1x16x64``, width 3072, 24 heads of 128, 44
   blocks) end to end through ``bench_torch.bench_config`` at 256p, batch
   16, in bf16 and after ``quantize()``: finite outputs, 44 launches of #1
   and its prologue a forward, and of RMSNorm + quantize and the fused FFN
   in int8, and the int8 reconstructions at SSIM >= 0.99 against the bf16
   ones;
9. holds the A/B kernels of ``vitok_torch.benchmarks`` (batch blocks,
   packs, int8 input, all heads of a tile) and the fp32 forward against the
   forward whose body each runs (int8 input: the mma.sync forward; bf16: the
   redesigned forward; fp32: the fp32 walker with one cell a block), bit for
   bit, and against their plain versions, the mma.sync forward's bf16 and
   FMA fp32 instances too, at the JAX A/B scripts' recorded shapes and at
   the 350M width with a dead image; runs the 350M AE in fp32 on the fp32
   forward against the unfused composition, and the same AE ``quantize()``d
   (the fp32 forward, the fp32 RMSNorm + quantize and the fused FFN a block)
   against its run on the quantize kernels' plain versions; and runs both A/B entry points
   at the recorded shapes with fewer timed calls;
10. runs the eval CLI's ``main`` (``vitok_torch.scripts.eval_vae``) in this
   process on 256 seeded images up to 256 px: 350M-f16x64 with random
   weights at full width and depth, batch 64, SSIM, PSNR, FID (the full
   InceptionV3 at 299²) and FDD (the full DINO ViT-B/16 at 512²), in bf16
   and with ``--quant``, then a ``--buckets 64,256,1024`` run over 32 images
   up to 512 px: each batch's launches (#1 and its prologue, and #9 and #7
   in int8), finite statistics, a few images' features against the same
   backbones on the CPU, the references' FID against themselves, the int8
   SSIM beside the bf16 one; and takes three 350M training steps with the
   DINO perceptual term (a random ViT-S on 256² tiles) on #1 and #3, the
   first step's gradients against the plain backward's;
11. prints a JSON line describing each kernel, the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
if os.path.isdir(os.path.join(REPO, "vitok_torch")):  # else main() says so and exits 2
    sys.path.insert(0, REPO)
    from vitok_torch.utils.profiling import PORT_KERNEL_GROUPS, card_line, device_ms, kernel_group, time_ms

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core flop/s and
# int8 tensor-core op/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12

KERNEL_MAX_ABS = 2e-2   # both sides round P to bf16 before PV, but the online
KERNEL_MEAN_ABS = 2e-3  # softmax rescales at running maxima, in another order
# The prologue's normed q/k against the plain version's: the same bf16
# rounding points, but the kernel's rsqrtf and sum order may move a value by
# one bf16 step (2^-5 at |x| < 8) in a few entries.
PROLOGUE_MAX_ABS = 2 ** -5
PROLOGUE_DIFFER_SHARE = 1e-3
MODEL_REL_L2 = 2e-2     # decoded patches, fused kernel vs unfused path, bf16

VARIANT = "Ld4-Ld24/1x16x64"  # 350M-f16x64
SILU_VARIANT = "Gd2-Gd2/1x16x64"  # width 1728: the fused FFN's gate refuses it
SILU_BATCH = 8  # at 256p
RESOLUTIONS = (  # (name, pp max tokens, batch, image sizes cycled over the batch)
    ("256p", 256, 64, [(256, 256), (240, 200), (192, 256), (256, 160), (100, 130), (224, 224)]),
    ("512p", 1024, 16, [(512, 512), (480, 360), (304, 512), (512, 384), (200, 330), (448, 448)]),
)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

KERNEL_SHAPES = (  # (label, B, N, C, H)
    ("350M@256p main", 64, 256, 1024, 16),
    ("350M@512p main", 16, 1024, 1024, 16),
    ("5B@256p main", 16, 256, 3072, 24),  # what the 5B bench phase gives #1 and its prologue
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


def _normed_qkv(qkv, qs, ks, cos, sin, b, n, h, d):
    """q, k normalised and rotated, and v, as ``[B, H, N, D]`` for SDPA."""
    from vitok_torch.ops.norms import rms_norm
    from vitok_torch.ops.rope import apply_rotary_emb

    q, k, v = qkv.view(b, n, 3, h, d).unbind(2)
    q, k = apply_rotary_emb(rms_norm(q, qs), rms_norm(k, ks), cos, sin, convention="half")
    return tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))


def _sdpa_mask(mask, n, sw, device):
    from vitok_torch.ops.attention import make_attention_mask

    am = make_attention_mask(None, n, sw, device) if sw is not None else None
    if mask is not None:
        key_ok = mask[:, None, None, :]
        am = key_ok if am is None else (am & key_ok)
    return am


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


def _prologue_bound(b, n, c, d):
    """The forward's prologue's least time: k read, its normed copy written,
    the tables and the gain read once, over HBM bandwidth (it does a few
    operations a byte)."""
    nbytes = 2 * b * n * c * 2 + 2 * b * n * (d // 2) * 4 + d * 4
    return _bound_ms(nbytes, 0.0, BF16_FLOPS_PER_S)


def kernel_phase(device) -> dict:
    """The redesigned forward (the prologue, then the wgmma kernel) against
    ``fused_qkv_attention_plain``, its log-sum-exp (asked for under grad)
    against the plain one, the prologue against its plain version, and the
    kept mma.sync forward against the same plain version; each timed beside
    the bound and SDPA."""
    import torch
    import torch.nn.functional as F
    from vitok_torch.ops import fused_attention as fa

    rng = np.random.default_rng(0)
    rows, worst = [], {"fused_attention": 0.0, "fused_attention_mma": 0.0, "fused_qk_prologue": 0.0}
    log("kernel phase: fused attention (prologue + wgmma kernel, and the kept mma.sync kernel) vs "
        "fused_qkv_attention_plain, bf16")
    log(f"{'shape':16s} {'B':>3s} {'N':>5s} {'C':>5s} {'H':>3s} {'case':10s} {'max_abs':>9s} {'mean_abs':>9s} "
        f"{'max_all':>9s} {'lse_err':>9s} {'mma_max':>9s} {'pro_max':>9s} {'ms':>8s} {'dev_ms':>8s} {'kern_ms':>8s} "
        f"{'pro_ms':>8s} {'mma_ms':>8s} {'plain_ms':>9s} {'sdpa_ms':>8s} {'sdpa_dev':>8s} {'bound_ms':>9s}")

    def check(what, got, want, mask, label, b, n, c, h, case):
        err_all = (got.float() - want.float()).abs()
        err = err_all if mask is None else err_all[mask]  # valid rows
        max_abs, mean_abs = err.max().item(), err.mean().item()
        # Padded rows follow the same function (key-side mask) but may see
        # only a few valid keys, so |out| nears max|v| where one bf16 step is
        # 2^-7 * |out|: hold them to the bound relative to |out|.
        max_all = err_all.max().item()
        rel_all = (err_all / want.float().abs().clamp(min=1.0)).max().item()
        if not (max_abs <= KERNEL_MAX_ABS and mean_abs <= KERNEL_MEAN_ABS and rel_all <= KERNEL_MAX_ABS):
            raise AssertionError(
                f"{what} disagrees with its plain version at {label} B={b} N={n} C={c} H={h} {case}: valid "
                f"rows max {max_abs:.3e} mean {mean_abs:.3e} (limits {KERNEL_MAX_ABS}, {KERNEL_MEAN_ABS}); all "
                f"rows max {max_all:.3e}, max |err|/max(1,|out|) {rel_all:.3e} (limit {KERNEL_MAX_ABS})")
        return max_abs, mean_abs, max_all

    for label, b, n, c, h in KERNEL_SHAPES:
        d = c // h
        for case, masked, sw in KERNEL_CASES:
            qkv, qs, ks, cos, sin, mask = _attention_inputs(rng, b, n, c, h, masked, device)
            kw = dict(num_heads=h, sliding_window=sw)
            kernel = lambda: fa.fused_qkv_attention(qkv, qs, ks, cos, sin, mask, impl="fused", **kw)
            plain = lambda: fa.fused_qkv_attention_plain(qkv, qs, ks, cos, sin, mask, **kw)
            mma = lambda: fa.fused_qkv_attention_mma(qkv, qs, ks, cos, sin, mask, **kw)
            # The forward's prologue: k alone (the backward's also writes q and delta).
            prologue = lambda: fa.fused_qk_prologue(qkv, qs, ks, cos, sin, num_heads=h, with_q=False)
            prologue_plain = lambda: fa.fused_qk_prologue_plain(qkv, qs, ks, cos, sin, num_heads=h, with_q=False)
            got = kernel()
            got_l, lse = fa._fused_cuda(qkv, qs, ks, cos, sin, mask, h, sw, want_lse=True)
            want, want_lse = fa.fused_qkv_attention_plain(qkv, qs, ks, cos, sin, mask, return_lse=True, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, got_l):
                raise AssertionError(f"fused forward at {label} {case}: the output moved when lse was asked for")
            max_abs, mean_abs, max_all = check("fused forward", got, want, mask, label, b, n, c, h, case)
            valid = torch.ones(b, n, dtype=torch.bool, device=device) if mask is None else mask
            lse_err = (lse - want_lse).abs().transpose(1, 2)[valid].max().item()
            if not (lse_err <= LSE_ATOL and bool((lse.transpose(1, 2)[~valid] == 1e30).all())):
                raise AssertionError(f"fused forward lse at {label} {case}: max |err| {lse_err:.3e} on valid rows "
                                     f"(limit {LSE_ATOL}), padded rows 1e30: "
                                     f"{bool((lse.transpose(1, 2)[~valid] == 1e30).all())}")
            mma_max = check("mma.sync forward", mma(), want, mask, label, b, n, c, h, case)[0]
            qk, _ = prologue()
            qk_want, _ = prologue_plain()
            pro_err = (qk.float() - qk_want.float()).abs()
            pro_max, pro_share = pro_err.max().item(), (pro_err > 0).float().mean().item()
            if not (pro_max <= PROLOGUE_MAX_ABS and pro_share <= PROLOGUE_DIFFER_SHARE):
                raise AssertionError(f"prologue at {label}: normed q/k max |err| {pro_max:.3e} (limit "
                                     f"{PROLOGUE_MAX_ABS}), {pro_share:.2e} of entries differ (limit "
                                     f"{PROLOGUE_DIFFER_SHARE})")
            del got, got_l, lse, want, want_lse
            # Library yardstick: SDPA on pre-normed, pre-rotated q/k/v.
            q, k, v = _normed_qkv(qkv, qs, ks, cos, sin, b, n, h, d)
            am = _sdpa_mask(mask, n, sw, device)
            library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am)
            ms, pro_ms, mma_ms = time_ms(kernel), time_ms(prologue), time_ms(mma)
            kern_ms = time_ms(lambda: fa._attend_sm90(qkv, qk, qs, cos, sin, mask, h, sw))
            plain_ms, lib_ms, pro_plain_ms = time_ms(plain), time_ms(library), time_ms(prologue_plain)
            dev_ms, lib_dev_ms = device_ms(kernel), device_ms(library)
            bound, bound_by = _bound(b, n, c, h, mask, sw)
            pro_bound = _prologue_bound(b, n, c, d)
            for key, err in (("fused_attention", max_abs), ("fused_attention_mma", mma_max),
                             ("fused_qk_prologue", pro_max)):
                worst[key] = max(worst[key], err)
            row = dict(shape=label, B=b, N=n, C=c, H=h, case=case, max_abs_err=max_abs,
                       mean_abs_err=mean_abs, max_abs_err_all_rows=max_all, lse_max_abs_err=lse_err,
                       ms=ms, kernel_ms=kern_ms, prologue_ms=pro_ms, plain_ms=plain_ms, library_ms=lib_ms,
                       device_ms=dev_ms, library_device_ms=lib_dev_ms,
                       bound_ms=bound, bound_by=bound_by, mma_ms=mma_ms, mma_max_abs_err=mma_max,
                       prologue_max_abs_err=pro_max, prologue_differ_share=pro_share, prologue_plain_ms=pro_plain_ms,
                       prologue_bound_ms=pro_bound[0], prologue_bound_by=pro_bound[1])
            rows.append(row)
            log(f"{label:16s} {b:3d} {n:5d} {c:5d} {h:3d} {case:10s} {max_abs:9.2e} {mean_abs:9.2e} "
                f"{max_all:9.2e} {lse_err:9.2e} {mma_max:9.2e} {pro_max:9.2e} {ms:8.4f} {dev_ms:8.4f} {kern_ms:8.4f} "
                f"{pro_ms:8.4f} {mma_ms:8.4f} {plain_ms:9.4f} {lib_ms:8.4f} {lib_dev_ms:8.4f} {bound:9.5f}")
            del q, k, v, qk, qk_want
    log("  (ms: the prologue and the wgmma kernel, as the wrapper launches them, CUDA events around chained calls; "
        "dev_ms the same calls' device time (profiler); kern_ms the wgmma kernel alone; pro_ms the prologue alone "
        "(k); mma_ms the kept mma.sync kernel, which norms q/k itself; sdpa_dev SDPA's device time)")
    return dict(rows=rows, max_abs_err=worst["fused_attention"], worst=worst)


# ---------------------------------------------------------------------------
# Quantize kernels: rmsnorm_quant (#9), ffn_int8 (#7), silu_quant (#8)
# ---------------------------------------------------------------------------

QUANT_SHAPES = (  # (label, B, N, C, F): M = B * N token rows; F is padded to F' = 128k
    ("350M@256p main", 64, 256, 1024, 2736),
    ("350M@512p main", 16, 1024, 1024, 2736),
    ("5B width", 16, 256, 3072, 8208),
    ("E width", 16, 256, 4096, 10944),  # F' 11008: a cluster of 16
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


def _exact_codes(what, got, want, pad_from=None) -> dict:
    """Codes and per-token scales equal to the plain version's bit for bit,
    and pad columns exactly 0 (the rule #7, #8 and #9 are held to)."""
    (q, s), (q_ref, s_ref) = got, want
    n_codes, n_scales = int((q != q_ref).sum().item()), int((s != s_ref).sum().item())
    pad_zero = pad_from is None or not q[..., pad_from:].any().item()
    if n_codes or n_scales or not pad_zero:
        raise AssertionError(f"{what}: {n_codes} codes and {n_scales} scales differ from the plain version "
                             f"(expected 0); pad columns zero: {pad_zero}")
    return dict(max_abs_err=0, code_mismatch_share=0.0, scale_max_rel_err=0.0, codes_differ=0, scales_differ=0)


def _row_kernel_row(kernel, n, dtype, m, kernel_fn, plain_fn, nbytes, elems, src) -> dict:
    """Times of one #9 or #8 call (chained, ``dev`` with the host ahead, the
    wrapper's host microseconds), its plan, its instance's registers, spills
    and resident blocks, and, as the rate this card moves such bytes at, the
    card's time for a copy of the input ``src`` (``copy_``: its bytes read
    and written; not the same function, so no library column)."""
    import torch
    from vitok_torch.benchmarks import host_ahead_ms, host_us
    from vitok_torch.ops import quant

    plan = quant.row_quant_plan(kernel, m, n, dtype, src.device)
    attrs = quant.row_quant_attributes(kernel, plan, n, dtype)
    bound = _bound_ms(nbytes, ROW_KERNEL_OPS * elems, FP32_OPS_PER_S)
    dst = torch.empty_like(src)
    copy_ms = host_ahead_ms(lambda: dst.copy_(src))
    return dict(ms=time_ms(kernel_fn), dev_ms=host_ahead_ms(kernel_fn), host_us=host_us(kernel_fn),
                plain_ms=time_ms(plain_fn), bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                copy_dev_ms=copy_ms, copy_tb_per_s=2 * src.numel() * src.element_size() / copy_ms / 1e9,
                plan=plan._asdict(), **attrs)


def quant_kernel_phase(device) -> dict:
    import torch
    from vitok_torch.benchmarks import host_ahead_ms
    from vitok_torch.ops import quant

    gen = torch.Generator(device=device).manual_seed(2)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=device)
    rows = {"rmsnorm_quant": [], "ffn_int8": [], "silu_quant": []}
    log("kernel phase: rmsnorm_quant, ffn_int8, silu_quant (CUDA) vs their plain versions; #9 and #8 in bf16 and "
        "fp32, codes and scales bit for bit")
    log(f"{'kernel':14s} {'shape':16s} {'dtype':8s} {'M':>6s} {'C':>5s} {'Fp':>5s} {'code_err':>8s} {'ms':>8s} "
        f"{'dev_ms':>8s} {'host_us':>8s} {'plain_ms':>9s} {'bound_ms':>9s} {'int_mm_ms':>9s}")

    def record(kernel, label, dtype, m, c, fp, err, row):
        row = dict(shape=label, dtype=str(dtype).replace("torch.", ""), M=m, C=c, Fp=fp, **err, **row)
        rows[kernel].append(row)
        lib = row.get("int_mm_fc1_ms")
        log(f"{kernel:14s} {label:16s} {row['dtype']:8s} {m:6d} {c:5d} {fp:5d} {err['max_abs_err']:8d} "
            f"{row['ms']:8.4f} {row['dev_ms']:8.4f} {row.get('host_us', float('nan')):8.2f} {row['plain_ms']:9.4f} "
            f"{row['bound_ms']:9.5f} {'' if lib is None else f'{lib:9.4f}'}")
        if "plan" in row:
            plan = row["plan"]
            log(f"{'':14s} {label:16s} plan: {plan['lanes']} lanes a row, {plan['per']} chunks of {plan['vec']} a "
                f"lane, {plan['rows_per_block']} rows a block of {plan['threads']}, {plan['stages']} slots, grid "
                f"{plan['grid']} ({plan['blocks_per_sm']} an SM), {plan['smem_bytes']} shared bytes; "
                f"{row['registers']} registers, {row['spill_bytes']} spilled, {row['blocks_per_sm']} blocks an SM; "
                f"copy_ of the input {row['copy_dev_ms']:.4f} ms dev, {row['copy_tb_per_s']:.3f} TB/s")

    for label, b, n, c, f in (SILU_MAIN,) + QUANT_SHAPES:
        m, fp = b * n, quant.pad_ffn_dim(f)
        for dtype in (torch.bfloat16, torch.float32):
            # #9: the residual stream [B, N, C] -> int8 + per-token scales.
            x = (randn(b, n, c) * 2).to(dtype)
            gain = 0.5 + torch.rand(c, generator=gen, device=device)
            err = _exact_codes(f"rmsnorm_quant {label} {dtype}", quant.fused_rmsnorm_quant(x, gain),
                               quant.fused_rmsnorm_quant_plain(x, gain))
            isz = x.element_size()
            record("rmsnorm_quant", label, dtype, m, c, c, err, _row_kernel_row(
                "rmsnorm_quant", c, dtype, m,
                lambda: quant.fused_rmsnorm_quant(x, gain), lambda: quant.fused_rmsnorm_quant_plain(x, gain),
                m * c * isz + c * 4 + m * c + m * 4, m * c, x))
            del x

            # #8: the fc1 output [M, 2F'] (pad columns of both halves 0).
            hid = torch.zeros(m, 2 * fp, dtype=dtype, device=device)
            hid[:, :f] = randn(m, f).to(dtype)
            hid[:, fp:fp + f] = (2 * randn(m, f)).to(dtype)
            err = _exact_codes(f"silu_quant {label} {dtype}", quant.fused_silu_quant(hid),
                               quant.fused_silu_quant_plain(hid), pad_from=f)
            record("silu_quant", label, dtype, m, c, fp, err, _row_kernel_row(
                "silu_quant", fp, dtype, m,
                lambda: quant.fused_silu_quant(hid), lambda: quant.fused_silu_quant_plain(hid),
                m * 2 * fp * isz + m * fp + m * 4, m * fp, hid))
            del hid

        if not quant.can_fuse_ffn(m, c, 2 * fp):
            continue  # the G width: its path takes silu_quant instead
        # #7: int8 activations x the padded int8 fc1 weight; its codes and
        # scales are the plain version's bit for bit (exact int32 sums, the
        # same IEEE ops).
        hq, hs = quant.quantize_activation(randn(m, c))
        w, ws = quant.quantize_weight(quant.pad_fc1_weight(0.05 * randn(2 * f, c)))
        got, want = quant.fused_ffn_int8(hq, hs, w, ws), quant.fused_ffn_int8_plain(hq, hs, w, ws)
        err = _exact_codes(f"ffn_int8 {label}", got, want, pad_from=f)
        del got, want
        plan = quant.ffn_int8_plan(m, c, fp)
        attrs = quant.ffn_int8_attributes(plan, fp)
        kernel = lambda: quant.fused_ffn_int8(hq, hs, w, ws)
        nbytes = m * c + m * 4 + 2 * fp * c + 2 * fp * 4 + m * fp + m * 4
        bound = _bound_ms(nbytes, 2.0 * m * c * 2 * fp, INT8_OPS_PER_S)
        record("ffn_int8", label, torch.int8, m, c, fp, err, dict(
            ms=time_ms(kernel), dev_ms=host_ahead_ms(kernel),
            plain_ms=time_ms(lambda: quant.fused_ffn_int8_plain(hq, hs, w, ws)), bound_ms=bound[0],
            bound_by=bound[1], library_ms=None, int_mm_fc1_ms=time_ms(lambda: torch._int_mm(hq, w.t())),
            rows=plan.rows, cluster=plan.cluster, stages=plan.stages, **attrs))
        log(f"{'':14s} {label:16s} ffn_int8 plan: {plan.rows} rows, a cluster of {plan.cluster}, {plan.stages} "
            f"stages, {attrs['smem_bytes']} bytes of shared memory; {attrs['registers']} registers, "
            f"{attrs['spill_bytes']} spilled, {attrs['max_active_clusters']} clusters resident")
        del hq, hs, w, ws
    log("  (ms: chained through the wrapper; dev_ms: the card's time with the host ahead; host_us: the wrapper's host "
        "time a call; int_mm_ms: torch._int_mm on the fc1 product only, no SwiGLU or requantize)")
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


# FlexAttention (a library yardstick, timed beside #4-#6 and called nowhere
# in the port) at these rows, and the fold (the q/k prologue, then #4, from
# the flat QKV) against its plain version and the route it replaces (the
# eager q/k norm and rotation, then #4) at these.
FLEX_ROWS = (("350M@1024p", "tail+sw1024"), ("350M@2048p", "sw1024"), ("350M@2048p", "tail+sw1024"),
             ("5B width", "tail+sw1024"))
FOLD_ROWS = (("350M@1024p", "tail+sw1024"), ("350M@2048p", "sw1024"), ("350M@2048p", "tail+sw1024"))


def _flex_call(q, k, v, mask, sw):
    """``torch.compile``d FlexAttention on q, k, v ``[B, N, H, D]`` with a
    block mask built once from the key validity (a key below its sample's
    valid count: the NaFlex tail mask, asserted) and ``|i - j| <= sw``:
    returns a call that gives ``[B, H, N, D]`` (and, under grad, a graph).
    Each shape, window and grad mode compiles once (no dynamic shapes; the
    recompile limit raised so that no row falls back to eager)."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    global _FLEX
    if "_FLEX" not in globals():
        torch._dynamo.config.recompile_limit = max(64, torch._dynamo.config.recompile_limit)
        _FLEX = torch.compile(flex_attention, dynamic=False)
    b, n = q.shape[:2]
    idx = torch.arange(n, device=q.device)
    kv_len = torch.full((b,), n, device=q.device) if mask is None else mask.sum(1)
    if mask is not None and not torch.equal(mask, idx[None] < kv_len[:, None]):
        raise ValueError("FlexAttention's yardstick takes a tail-suffix mask")
    reach = n if sw is None else sw

    def mask_mod(bi, hi, qi, ki):
        return (ki < kv_len[bi]) & ((qi - ki).abs() <= reach)

    block_mask = create_block_mask(mask_mod, b, None, n, n, device=q.device)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: _FLEX(qt, kt, vt, block_mask=block_mask)


def _check_flash_rows(what, got, want, mask):
    """Valid rows within the flash limits; padded rows exactly 0 on both
    sides. Returns (max, mean) abs error on valid rows."""
    err = (got.float() - want.float()).abs()
    if mask is not None:
        if got[~mask].any() or want[~mask].any():
            raise AssertionError(f"{what}: padded rows are not exactly 0")
        err = err[mask]
    max_abs, mean_abs = err.max().item(), err.mean().item()
    if not (max_abs <= FLASH_MAX_ABS and mean_abs <= FLASH_MEAN_ABS):
        raise AssertionError(f"{what}: valid rows max {max_abs:.3e} mean {mean_abs:.3e} (limits "
                             f"{FLASH_MAX_ABS}, {FLASH_MEAN_ABS})")
    return max_abs, mean_abs


def _eager_route(qkv, qs, ks, cos, sin, mask, h, sw):
    """The route the fold replaces: q and k normed and rotated by eager
    PyTorch (``unfused_qkv_attention``'s glue), then the flash kernel."""
    from vitok_torch.ops import flash_attention as fl
    from vitok_torch.ops.norms import rms_norm
    from vitok_torch.ops.rope import apply_rotary_emb

    b, n, c3 = qkv.shape
    q, k, v = qkv.view(b, n, 3, h, -1).unbind(2)
    q, k = apply_rotary_emb(rms_norm(q, qs), rms_norm(k, ks), cos, sin, convention="half")
    return fl.flash_attention(q, k, v, mask, sw).reshape(b, n, c3 // 3)


def _fold_row(label, b, n, h, d, masked, sw, device) -> dict:
    """The fold from flat QKV against its plain version (valid rows within
    the flash limits, padded rows 0), timed beside the prologue alone, the
    eager route it replaces and its bound: the flat QKV, the RoPE tables and
    the mask read and the output written, or the pairs' products, whichever
    is larger."""
    from vitok_torch.benchmarks import host_ahead_ms
    from vitok_torch.ops import fused_attention as fa

    qkv, qs, ks, cos, sin, mask = _attention_inputs(np.random.default_rng(9), b, n, h * d, h, masked, device)
    args = (qkv, qs, ks, cos, sin, mask)
    kw = dict(num_heads=h, sliding_window=sw)
    got = fa.flash_qkv_attention(*args, **kw)
    want = fa.flash_qkv_attention_plain(*args, **kw)
    max_abs, mean_abs = _check_flash_rows(f"fold {label} sw={sw} masked={masked}", got, want, mask)
    del got, want
    ms = time_ms(lambda: fa.flash_qkv_attention(*args, **kw))
    dev_ms = host_ahead_ms(lambda: fa.flash_qkv_attention(*args, **kw))
    prologue_ms = time_ms(lambda: fa.fused_qk_prologue(qkv, qs, ks, cos, sin, num_heads=h, with_q=True))
    eager_ms = time_ms(lambda: _eager_route(*args, h, sw))
    eager_dev_ms = host_ahead_ms(lambda: _eager_route(*args, h, sw))
    plain_ms = time_ms(lambda: fa.flash_qkv_attention_plain(*args, **kw), runs=2, warmup=1)
    valid = [n] * b if mask is None else mask.sum(1).tolist()
    tensor = b * n * h * d * 2
    nbytes = 3 * tensor + tensor + 2 * b * n * (d // 2) * 4 + (0 if mask is None else b * n)
    bound, bound_by = _bound_ms(nbytes, 4.0 * h * d * _flash_pairs(valid, n, sw), BF16_FLOPS_PER_S)
    return dict(fold_max_abs_err=max_abs, fold_mean_abs_err=mean_abs, fold_ms=ms, fold_dev_ms=dev_ms,
                fold_prologue_ms=prologue_ms, eager_route_ms=eager_ms, eager_route_dev_ms=eager_dev_ms,
                fold_plain_ms=plain_ms, fold_bound_ms=bound, fold_bound_by=bound_by)


def flash_kernel_phase(device) -> dict:
    """#4 against ``flash_attention_plain`` at every ``FLASH_SHAPES`` case,
    timed beside its plain version, SDPA with the boolean mask and, at
    ``FLEX_ROWS``, FlexAttention (held to the same limits on valid rows);
    at ``FOLD_ROWS`` the fold from flat QKV (``_fold_row``). ``dev_ms``: the
    card's time with the host ahead (``host_ahead_ms``), where ``ms`` (chained
    calls) may read the host's."""
    import torch
    import torch.nn.functional as F
    from vitok_torch.benchmarks import host_ahead_ms
    from vitok_torch.ops import flash_attention as fl

    gen = torch.Generator(device=device).manual_seed(3)
    rows, worst = [], 0.0
    log("kernel phase: flash_attention (CUDA) vs flash_attention_plain, bf16; FlexAttention and the fold "
        "(prologue + #4 from flat QKV) at some rows")
    log(f"{'shape':12s} {'B':>2s} {'N':>6s} {'H':>3s} {'D':>4s} {'case':12s} {'max_abs':>9s} "
        f"{'mean_abs':>9s} {'lse_err':>9s} {'ms':>8s} {'dev_ms':>8s} {'plain_ms':>9s} {'sdpa_ms':>8s} "
        f"{'flex_ms':>8s} {'flex_dev':>8s} {'flex_err':>9s} {'bound_ms':>9s}")
    for label, b, n, h, d, cases in FLASH_SHAPES:
        for case in cases:
            q, k, v, mask, valid = _flash_inputs(gen, b, n, h, d, "tail" in case, device)
            sw = FLASH_SW if "sw" in case else None
            got, lse = fl.flash_attention(q, k, v, mask, sw, return_lse=True)
            want, want_lse = fl.flash_attention_plain(q, k, v, mask, sw, return_lse=True)
            torch.cuda.synchronize()
            what = f"flash kernel vs its plain version at {label} B={b} N={n} H={h} D={d} {case}"
            max_abs, mean_abs = _check_flash_rows(what, got, want, mask)
            live = want_lse < 1e29
            lse_err = (lse[live] - want_lse[live]).abs().max().item() if live.any() else 0.0
            dead_ok = torch.equal(lse < 1e29, live) and bool((lse[~live] == 1e30).all())
            if not (lse_err <= LSE_ATOL and dead_ok):
                raise AssertionError(f"{what}: lse {lse_err:.3e} (limit {LSE_ATOL}), dead rows +1e30 on both "
                                     f"sides: {dead_ok}")
            flex = flex_ms = flex_err = None
            if (label, case) in FLEX_ROWS:
                flex = _flex_call(q, k, v, mask, sw)
                flex_err, _ = _check_flash_rows(f"FlexAttention vs the plain version at {label} {case}",
                                                flex().transpose(1, 2) * (1 if mask is None else mask[..., None, None]),
                                                want, mask)
            del got, lse, want, want_lse
            # Library yardsticks: SDPA with the equivalent boolean mask, FlexAttention.
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            am = _sdpa_mask(mask, n, sw, device)
            ms = time_ms(lambda: fl.flash_attention(q, k, v, mask, sw))
            dev_ms = host_ahead_ms(lambda: fl.flash_attention(q, k, v, mask, sw))
            plain_ms = time_ms(lambda: fl.flash_attention_plain(q, k, v, mask, sw), runs=3, warmup=1)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am), runs=3)
            flex_dev_ms = None
            if flex is not None:
                flex_ms = time_ms(flex)
                flex_dev_ms = host_ahead_ms(flex)
            del qt, kt, vt, am, flex
            nbytes = 4 * b * n * h * d * 2 + (0 if mask is None else b * n)
            bound, bound_by = _bound_ms(nbytes, 4.0 * h * d * _flash_pairs(valid, n, sw), BF16_FLOPS_PER_S)
            worst = max(worst, max_abs)
            row = dict(shape=label, B=b, N=n, H=h, D=d, case=case, max_abs_err=max_abs, mean_abs_err=mean_abs,
                       lse_max_abs_err=lse_err, ms=ms, dev_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                       flex_ms=flex_ms, flex_dev_ms=flex_dev_ms, flex_max_abs_err=flex_err, bound_ms=bound,
                       bound_by=bound_by)
            fmt = lambda x, w, p: f"{x:{w}.{p}}" if x is not None else f"{'-':>{w}s}"
            log(f"{label:12s} {b:2d} {n:6d} {h:3d} {d:4d} {case:12s} {max_abs:9.2e} {mean_abs:9.2e} "
                f"{lse_err:9.2e} {ms:8.4f} {dev_ms:8.4f} {plain_ms:9.4f} {lib_ms:8.4f} {fmt(flex_ms, 8, '4f')} "
                f"{fmt(flex_dev_ms, 8, '4f')} {fmt(flex_err, 9, '2e')} {bound:9.5f}")
            if (label, case) in FOLD_ROWS:
                row.update(_fold_row(label, b, n, h, d, "tail" in case, sw, device))
                log(f"  fold (prologue + #4 from flat QKV): max {row['fold_max_abs_err']:.2e} mean "
                    f"{row['fold_mean_abs_err']:.2e} vs its plain version; {row['fold_ms']:.4f} ms (dev "
                    f"{row['fold_dev_ms']:.4f}; the prologue alone {row['fold_prologue_ms']:.4f}), the eager route it "
                    f"replaces {row['eager_route_ms']:.4f} (dev {row['eager_route_dev_ms']:.4f}), plain "
                    f"{row['fold_plain_ms']:.4f}, bound {row['fold_bound_ms']:.5f} ({row['fold_bound_by']})")
            rows.append(row)
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
    from vitok_torch.benchmarks import ab_batch_block as abb
    from vitok_torch.benchmarks import ab_q8_input as ab8
    from vitok_torch.ops import flash_attention as fl
    from vitok_torch.ops import fused_attention as fa
    from vitok_torch.ops import quant

    return {"fused_attention": fa.LAUNCHES, "fused_qk_prologue": fa.PROLOGUE_LAUNCHES,
            "fused_attention_bwd": fa.BWD_LAUNCHES, "fused_attention_q8": fa.Q8_LAUNCHES,
            "fused_attention_mma": fa.MMA_LAUNCHES, "fused_attention_f32": fa.F32_LAUNCHES,
            "fused_attention_mma_f32": fa.F32_MMA_LAUNCHES,
            "flash_attention": fl.LAUNCHES,
            "flash_attention_dq": fl.DQ_LAUNCHES, "flash_attention_dkv": fl.DKV_LAUNCHES,
            **quant.LAUNCHES, **abb.LAUNCHES, **ab8.LAUNCHES}


def reset_counts() -> None:
    from vitok_torch.benchmarks import ab_batch_block as abb
    from vitok_torch.benchmarks import ab_q8_input as ab8
    from vitok_torch.ops import flash_attention as fl
    from vitok_torch.ops import fused_attention as fa
    from vitok_torch.ops import quant

    fa.LAUNCHES = fa.PROLOGUE_LAUNCHES = fa.BWD_LAUNCHES = fa.Q8_LAUNCHES = 0
    fa.MMA_LAUNCHES = fa.F32_LAUNCHES = fa.F32_MMA_LAUNCHES = 0
    fl.LAUNCHES = fl.DQ_LAUNCHES = fl.DKV_LAUNCHES = 0
    for counts in (quant.LAUNCHES, abb.LAUNCHES, ab8.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _expect(**counts) -> dict:
    """Expected launches of one run: the named counts, every other kernel 0.
    The q/k prologue runs before every launch of the wgmma forward and of the
    backward, unless its count is named."""
    counts.setdefault("fused_qk_prologue", counts.get("fused_attention", 0) + counts.get("fused_attention_bwd", 0))
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
        for blk in [*getattr(model, "encoder_blocks", ()), *getattr(model, "decoder_blocks", ())]:
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
    return dict(rows=rows, launches=launches["fused_attention"], prologue_launches=launches["fused_qk_prologue"],
                model=model, outputs=outs)


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


def silu_path_phase(device, card: str, dtype: str = "bfloat16") -> dict:
    """An int8 model at a width the fused FFN's gate refuses (C % 128 != 0):
    its blocks take the int8 fc1 product and then the SwiGLU + quantize
    kernel, in ``dtype`` (bf16, or fp32, #8's and #9's fp32 instances). Head
    dim 72, so attention takes the unfused composition."""
    import torch
    from vitok_torch import AE, decode_variant

    model = AE(**decode_variant(SILU_VARIANT), seed=0, device=device, compute_dtype=getattr(torch, dtype))
    _random_gates(model, device)
    model.quantize()
    depth = model.cfg.encoder_depth + model.cfg.decoder_depth
    name, max_tokens, _, sizes = RESOLUTIONS[0]
    cases = main_path_cases(device, [(name, max_tokens, SILU_BATCH, sizes)], seed=1)
    log(f"int8 SwiGLU-quantize path: {SILU_VARIANT} after AE.quantize(), {dtype}, {depth} blocks, "
        f"{name} batch {SILU_BATCH}")
    expect = _expect(rmsnorm_quant=depth, silu_quant=depth)
    (out,), launches = _run_counted(model, cases, expect, f"int8 G {dtype}")
    name, max_tokens, batch, images, inputs = cases[0]
    _check_output(name, max_tokens, batch, images, inputs, out)
    if out["patches"].dtype != model.compute_dtype:
        raise AssertionError(f"int8 G {dtype}: decoded {out['patches'].dtype}")
    with plain_quant_kernels():
        rel = _valid_rel_l2(out, model.decode(model.encode(inputs)), inputs)
    if not rel <= MODEL_REL_L2:
        raise AssertionError(f"int8 G {dtype} {name}: rel L2 vs the plain versions {rel:.3e} > {MODEL_REL_L2}")
    ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=5, warmup=1)
    log(f"  int8 G {dtype} {name}: rel L2 vs plain versions {rel:.3e}; encode+decode {ms / batch:.4f} "
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
    """The attention router's flash wrapper and the fold swapped for their
    plain versions: the bf16 reference run beyond ``UNFUSED_REF_MAX_TOKENS``
    launches no kernel of the attention."""
    from vitok_torch.ops import attention
    from vitok_torch.ops import flash_attention as fl
    from vitok_torch.ops import fused_attention as fa

    saved = attention.flash_attention, fa.flash_qkv_attention
    attention.flash_attention = fl.flash_attention_plain
    fa.flash_qkv_attention = fa.flash_qkv_attention_plain
    try:
        yield
    finally:
        attention.flash_attention, fa.flash_qkv_attention = saved


def highres_phase(device, card: str) -> dict:
    """350M-f16x64 with ``sw=FLASH_SW`` at 1024p and 2048p, and at 4096p
    without a reference, bf16 and int8: every block's attention goes to the
    fold (the q/k prologue, then the flash kernel). The counted runs go under
    ``torch.inference_mode()``, the usual serving context; the references
    launch no kernel of the attention."""
    import torch
    from vitok_torch import AE, decode_variant

    cfg_kw = {**decode_variant(VARIANT), "sw": FLASH_SW}
    model = AE(**cfg_kw, seed=0, device=device)
    _random_gates(model, device)
    depth = model.cfg.encoder_depth + model.cfg.decoder_depth
    cases = main_path_cases(device, HIGHRES, seed=2)
    log(f"high-resolution path: {VARIANT}, sw={FLASH_SW}, bf16, {depth} blocks")
    expect = _expect(flash_attention=depth, fused_qk_prologue=depth)
    with torch.inference_mode():
        outs, launches = _run_counted(model, cases, expect, "bf16 high-res")

    rows = []
    for (name, max_tokens, batch, images, inputs), out in zip(cases, outs):
        _check_output(name, max_tokens, batch, images, inputs, out)
        before = launch_counts()
        if max_tokens <= UNFUSED_REF_MAX_TOKENS:
            what = "unfused attention"
            reference = AE(**{**cfg_kw, "attn_impl": "xla"}, state_dict=model.state_dict(), device=device)
            ref = reference.decode(reference.encode(inputs))
            del reference
        else:
            what = "fold's plain version"
            with plain_flash_kernel():
                ref = model.decode(model.encode(inputs))
        torch.cuda.synchronize()
        if launch_counts() != before:
            raise AssertionError(f"bf16 {name}: the reference run launched kernels: {launch_counts()} vs {before}")
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
    rows.append(_largest_run(model, big, expect, "bf16", card))

    qmodel = AE(**cfg_kw, state_dict=model.state_dict(), device=device).quantize()
    del model
    torch.cuda.empty_cache()
    log(f"high-resolution path: {VARIANT}, sw={FLASH_SW}, int8 after AE.quantize()")
    expect = _expect(flash_attention=depth, fused_qk_prologue=depth, rmsnorm_quant=depth, ffn_int8=depth)
    with torch.inference_mode():
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


# The fold's backward (the q/k prologue, then #5 and #6 in their fold
# instances) at these rows, against its plain version and the route it
# replaces under autograd. Limits: #3's (FUSED_BWD_*), whose function and
# rounding points these are.
FOLD_BWD_ROWS = (("350M@1024p", "tail+sw1024"), ("350M@2048p", "sw1024"), ("5B width", "tail+sw1024"))


def _fold_bwd_row(label, b, n, h, d, masked, sw, device) -> dict:
    """``_FlashQKVAttention`` forward + backward (``torch.autograd.grad``)
    against ``flash_qkv_attention_bwd_plain`` given the kernels' forward
    output and log-sum-exp: dqkv within ``FUSED_BWD_MAX_REL`` /
    ``FUSED_BWD_MEAN_REL`` of its largest entry on valid rows (padded rows
    exactly 0), the gains' gradients within ``FUSED_BWD_GAIN_REL``, two runs
    bit for bit. Timed: the fold's backward alone beside its plain version
    and bound, and forward + backward beside the route it replaces (the
    eager q/k norm and rotation, then ``_FlashAttention``, and their autograd
    backward) on the same inputs, in the same call."""
    import torch
    from vitok_torch.benchmarks import host_ahead_ms
    from vitok_torch.ops import fused_attention as fa

    qkv, qs, ks, cos, sin, mask = _attention_inputs(np.random.default_rng(10), b, n, h * d, h, masked, device)
    gen = torch.Generator(device=device).manual_seed(11)
    dout = torch.randn((b, n, h * d), generator=gen, device=device).to(torch.bfloat16)
    kw = dict(num_heads=h, sliding_window=sw)

    def grads(route):
        x, a, k = (t.detach().clone().requires_grad_(True) for t in (qkv, qs, ks))
        if route == "fold":
            out = fa.flash_qkv_attention(x, a, k, cos, sin, mask, **kw)
        else:
            out = _eager_route(x, a, k, cos, sin, mask, h, sw)
        return torch.autograd.grad(out, (x, a, k), dout)

    got, again = grads("fold"), grads("fold")
    out, lse = fa._flash_fold_cuda(qkv, qs, ks, cos, sin, mask, h, sw, want_lse=True)
    want = fa.flash_qkv_attention_bwd_plain(qkv, qs, ks, cos, sin, mask, dout, out=out, lse=lse, **kw)
    torch.cuda.synchronize()
    what = f"fold backward {label} {'tail+' if masked else ''}sw={sw}"
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{what}: two runs differ")
    rows_ok = None if mask is None else mask[..., None].expand_as(qkv)
    if rows_ok is not None and (got[0][~rows_ok].any() or want[0][~rows_ok].any()):
        raise AssertionError(f"{what}: padded rows of dqkv are not exactly 0")
    err = (got[0].float() - want[0].float()).abs()
    scale = want[0].float().abs().max().item()
    err = err if rows_ok is None else err[rows_ok]
    max_rel, mean_rel = err.max().item() / scale, err.mean().item() / scale
    gain_rel = max(((a - r).abs().max() / r.abs().max()).item() for a, r in zip(got[1:], want[1:]))
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    if not (finite and max_rel <= FUSED_BWD_MAX_REL and mean_rel <= FUSED_BWD_MEAN_REL
            and gain_rel <= FUSED_BWD_GAIN_REL):
        raise AssertionError(f"{what}: dqkv max/mean rel {max_rel:.3e}/{mean_rel:.3e} (limits {FUSED_BWD_MAX_REL}, "
                             f"{FUSED_BWD_MEAN_REL}), gains {gain_rel:.3e} (limit {FUSED_BWD_GAIN_REL}), "
                             f"finite {finite}")
    del got, again, want
    hold = 200_000_000  # cycles (about 0.1 s): the host enqueues five autograd steps of the eager route
    bwd = lambda: fa.flash_qkv_attention_bwd(qkv, qs, ks, cos, sin, mask, dout, out=out, lse=lse, **kw)
    bwd_ms, bwd_dev = time_ms(bwd), host_ahead_ms(bwd, hold_cycles=hold)
    plain_ms = time_ms(lambda: fa.flash_qkv_attention_bwd_plain(qkv, qs, ks, cos, sin, mask, dout, out=out,
                                                                lse=lse, **kw), runs=2, warmup=1)
    step_ms, step_dev = time_ms(lambda: grads("fold")), host_ahead_ms(lambda: grads("fold"), hold_cycles=hold)
    eager_ms, eager_dev = time_ms(lambda: grads("eager")), host_ahead_ms(lambda: grads("eager"), hold_cycles=hold)
    valid = [n] * b if mask is None else mask.sum(1).tolist()
    tensor = b * n * h * d * 2
    # qkv, out, dO and the RoPE tables read, dqkv written; seven products a pair (dq three, dk/dv four).
    nbytes = 3 * tensor + 2 * tensor + 3 * tensor + 2 * b * n * (d // 2) * 4 + b * h * n * 4
    bound, bound_by = _bound_ms(nbytes, 7 * 2.0 * h * d * _flash_pairs(valid, n, sw), BF16_FLOPS_PER_S)
    log(f"  fold backward (prologue + #5 + #6 fold instances): dqkv max/mean rel {max_rel:.2e}/{mean_rel:.2e}, "
        f"gains {gain_rel:.2e} vs its plain version; {bwd_ms:.4f} ms (dev {bwd_dev:.4f}), plain {plain_ms:.4f}, "
        f"bound {bound:.5f} ({bound_by}); forward + backward {step_ms:.4f} (dev {step_dev:.4f}) against the "
        f"eager route it replaces {eager_ms:.4f} (dev {eager_dev:.4f})")
    return dict(fold_bwd_max_rel_err=max_rel, fold_bwd_mean_rel_err=mean_rel, fold_bwd_gain_rel_err=gain_rel,
                fold_bwd_ms=bwd_ms, fold_bwd_dev_ms=bwd_dev, fold_bwd_plain_ms=plain_ms, fold_bwd_bound_ms=bound,
                fold_bwd_bound_by=bound_by, fold_step_ms=step_ms, fold_step_dev_ms=step_dev,
                eager_step_ms=eager_ms, eager_step_dev_ms=eager_dev)


def flash_bwd_kernel_phase(device) -> dict:
    """The dq and dk/dv kernels against ``flash_attention_bwd_plain`` on the
    forward phase's shapes; the library yardsticks are SDPA's backward with
    the boolean mask and, at ``FLEX_ROWS``, FlexAttention's (forward +
    backward, minus the forward). ``dev``: the kernel's time with the host
    ahead (``host_ahead_ms``). At ``FOLD_BWD_ROWS`` also the fold's
    backward (``_fold_bwd_row``)."""
    import torch
    import torch.nn.functional as F
    from vitok_torch.benchmarks import host_ahead_ms
    from vitok_torch.ops import flash_attention as fl

    gen = torch.Generator(device=device).manual_seed(5)
    rows, worst = [], {"dq": 0.0, "dkv": 0.0}
    for which in ("dq", "dkv"):
        for d in (64, 128):
            log(f"  {which} kernel at d = {d}: {fl.flash_bwd_attributes(which, d)}")
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
            dq_dev = host_ahead_ms(lambda: fl.flash_dq_cuda(q, k, v, out, lse, g, mask, sw))
            dkv_dev = host_ahead_ms(lambda: fl.flash_dkv_cuda(q, k, v, lse, delta, g, mask, sw))
            plain_ms = time_ms(lambda: fl.flash_attention_bwd_plain(q, k, v, out, lse, g, mask, sw),
                               runs=2, warmup=1)
            # Library yardstick: SDPA forward + backward with the equivalent
            # boolean mask, minus its forward.
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
            gt = g.transpose(1, 2).contiguous()
            am = _sdpa_mask(mask, n, sw, device)

            def sdpa_step():
                o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
                torch.autograd.grad(o, (qt, kt, vt), gt)

            with torch.no_grad():
                fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am), runs=3)
            lib_ms = time_ms(sdpa_step, runs=3) - fwd_ms
            flex_ms = None
            if (label, case) in FLEX_ROWS:  # FlexAttention forward + backward, minus its forward
                flex = _flex_call(*(t.transpose(1, 2) for t in (qt, kt, vt)), mask, sw)
                with torch.no_grad():
                    flex_fwd_ms = time_ms(flex, runs=3)
                flex_ms = time_ms(lambda: torch.autograd.grad(flex(), (qt, kt, vt), gt), runs=3) - flex_fwd_ms
                del flex
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
                             dq_ms=dq_ms, dkv_ms=dkv_ms, dq_dev_ms=dq_dev, dkv_dev_ms=dkv_dev, plain_ms=plain_ms,
                             library_ms=lib_ms, flex_ms=flex_ms,
                             dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1],
                             dkv_bound_ms=dkv_bound[0], dkv_bound_by=dkv_bound[1]))
            rel = lambda name: f"{errs[name][0]:8.2e}/{errs[name][1]:8.2e}"
            log(f"{label:12s} {b:2d} {n:6d} {h:3d} {d:4d} {case:12s} {rel('dq')} {rel('dk')} {rel('dv')} "
                f"{dq_ms:8.4f} {dkv_ms:8.4f} {plain_ms:9.4f} {lib_ms:9.4f} {dq_bound[0]:9.5f} {dkv_bound[0]:9.5f}"
                f"  dev {dq_dev:.4f} / {dkv_dev:.4f}")
            if (label, case) in FOLD_BWD_ROWS:
                rows[-1].update(_fold_bwd_row(label, b, n, h, d, "tail" in case, sw, device))
    log("  (plain_ms: dq, dk and dv together; sdpa_bwd: SDPA forward + backward minus its forward; dev: dq / "
        "dk/dv with the host ahead)")
    for r in rows:
        if r["flex_ms"] is not None:
            log(f"  {r['shape']} {r['case']}: FlexAttention forward + backward minus its forward {r['flex_ms']:.4f} ms")
    return dict(rows=rows, max_abs_err=worst)


@contextlib.contextmanager
def plain_flash_backward():
    """The autograd Functions' backwards swapped for their plain versions
    (the flash kernel's and the fold's; the forward kernels stay): the
    reference for the training gradients."""
    from vitok_torch.ops import flash_attention as fl
    from vitok_torch.ops import fused_attention as fa

    saved = fl.flash_attention_bwd, fa.flash_qkv_attention_bwd
    fl.flash_attention_bwd = fl.flash_attention_bwd_plain
    fa.flash_qkv_attention_bwd = fa.flash_qkv_attention_bwd_plain
    try:
        yield
    finally:
        fl.flash_attention_bwd, fa.flash_qkv_attention_bwd = saved


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
    0.1 on two 256-tiles, AdamW + EMA, every activation stored. Every block's
    attention takes the fold under autograd: the q/k prologue and #4
    forward, the prologue again and #5 and #6 in their fold instances
    backward; no eager q/k norm or rotation."""
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
    per_step = _expect(flash_attention=depth, fused_qk_prologue=2 * depth, flash_attention_dq=depth,
                       flash_attention_dkv=depth)
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

    # Every block recomputed in the backward: twice the forward launches (#4
    # and its prologue), the same loss. The loss to match is taken under
    # grad, as the step takes it.
    want_loss = compute_loss(model, inputs, loss_cfg,
                             torch.Generator(device=device).manual_seed(3 * 1_000_003 + state.step))[0].detach()
    _with_checkpoint(model, 1)
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    t0 = time.perf_counter()
    state, metrics = train_step(state, inputs, 3)
    torch.cuda.synchronize()
    remat_ms = (time.perf_counter() - t0) * 1e3
    got = {k: v - before[k] for k, v in launch_counts().items()}
    expect = _expect(flash_attention=2 * depth, fused_qk_prologue=3 * depth, flash_attention_dq=depth,
                     flash_attention_dkv=depth)
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
            "flex_ms": row["flex_ms"],        # FlexAttention's whole backward, the same inputs
            "dev_ms": row[f"{key}_dev_ms"],
        })
    return entries


# ---------------------------------------------------------------------------
# The fused attention's backward kernel (#3) and int8-epilogue instance (#2)
# ---------------------------------------------------------------------------

FUSED_BWD_SHAPES = (  # (label, B, N, C, H): the last is ragged, N a multiple of 8 and not of 64
    ("350M@256t", 32, 256, 1024, 16),
    ("350M@1024t", 8, 1024, 1024, 16),
    ("5B@256t", 8, 256, 3072, 24),
    ("ragged", 3, 200, 1024, 16),
)
FUSED_BWD_SW = 64
# Each gradient's error on valid rows relative to its largest entry, about
# three times the worst first readings on an H100 (dq/dk/dv max 1.5e-2, mean
# 5.2e-4; gain gradients 8.9e-3). Kernel and plain version round p, ds and the
# outputs to bf16 at the same points but form p by another route (exp2 of an
# online max/sum against exp of the full row), and the gradients are sums of
# cancelling bf16-rounded terms, so the noise is that of bf16 products; the
# phase prints both sides' distance from the fp32 gradient beside it.
FUSED_BWD_MAX_REL = 4e-2
FUSED_BWD_MEAN_REL = 1.5e-3
FUSED_BWD_GAIN_REL = 3e-2


def _tail_mask(b, n, device, dead_last: bool):
    """A different tail-suffix valid count per sample; with ``dead_last`` the
    last sample is all padding."""
    import torch

    valid = [n - (i * n) // (b + 2) - (n // 4 if b == 1 else 0) for i in range(b)]
    if dead_last:
        valid[-1] = 0
    mask = torch.arange(n, device=device)[None, :] < torch.tensor(valid, device=device)[:, None]
    return mask, valid


FUSED_BWD_CASES = ("none", "tail", "sw", "tail+sw")


def fused_bwd_kernel_phase(device, shapes=FUSED_BWD_SHAPES, cases=FUSED_BWD_CASES) -> dict:
    """The fused backward (the prologue, then the dq and dk/dv kernels), given
    the forward kernel's output and log-sum-exp, against
    ``fused_qkv_attention_bwd_plain`` given the same output: dqkv plane by
    plane and the two gain gradients, padded rows exactly 0, two runs
    bit-identical. The library yardstick is SDPA forward + backward on the
    already normalised and rotated q/k: it computes less (no norm, no RoPE,
    nor their backward)."""
    import torch
    import torch.nn.functional as F
    from vitok_torch.ops import fused_attention as fa

    rng = np.random.default_rng(7)
    gen = torch.Generator(device=device).manual_seed(7)
    rows, worst = [], 0.0
    log("kernel phase: fused attention backward (prologue + dq + dk/dv kernels, given the forward's output and "
        "lse) vs fused_qkv_attention_bwd_plain given the same output, bf16")
    log(f"{'shape':11s} {'B':>3s} {'N':>5s} {'C':>5s} {'H':>3s} {'case':10s} {'dq max/mean rel':>17s} "
        f"{'dk max/mean rel':>17s} {'dv max/mean rel':>17s} {'dqs rel':>8s} {'dks rel':>8s} {'ms':>8s} "
        f"{'dev_ms':>8s} {'plain_ms':>9s} {'sdpa_fb':>8s} {'fb_dev':>8s} {'bound_ms':>9s}")
    for label, b, n, c, h in shapes:
        d = c // h
        for case in cases:
            qkv, qs, ks, cos, sin, _ = _attention_inputs(rng, b, n, c, h, False, device)
            mask, valid = (None, [n] * b)
            if "tail" in case:
                mask, valid = _tail_mask(b, n, device, dead_last=b >= 3)
            sw = FUSED_BWD_SW if "sw" in case else None
            g = torch.randn((b, n, c), generator=gen, device=device).to(torch.bfloat16)
            kw = dict(num_heads=h, sliding_window=sw)
            out, lse = fa._fused_cuda(qkv, qs, ks, cos, sin, mask, h, sw, want_lse=True)
            kernel = lambda: fa.fused_qkv_attention_bwd(qkv, qs, ks, cos, sin, mask, g, out=out, lse=lse, **kw)
            plain = lambda: fa.fused_qkv_attention_bwd_plain(qkv, qs, ks, cos, sin, mask, g, out=out, **kw)
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            ms = time_ms(kernel, runs=20, warmup=3)  # before the plain version's multi-GB temporaries
            want = plain()
            torch.cuda.synchronize()
            if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
                raise AssertionError(f"fused backward {label} {case}: two runs differ")
            if mask is not None and (got[0][~mask].any() or want[0][~mask].any()):
                raise AssertionError(f"fused backward {label} {case}: padded rows of dqkv are not exactly 0")
            errs = {}
            for i, name in enumerate(("dq", "dk", "dv")):
                a, r = got[0][..., i * c:(i + 1) * c].float(), want[0][..., i * c:(i + 1) * c].float()
                err = (a - r).abs() if mask is None else (a - r).abs()[mask]
                scale = r.abs().max().item()
                errs[name] = (err.max().item() / scale, err.mean().item() / scale, err.max().item(),
                              bool(torch.isfinite(a).all()))
            gains = {}
            for i, name in ((1, "dqs"), (2, "dks")):
                gains[name] = ((got[i] - want[i]).abs().max() / want[i].abs().max()).item()
            bad = {k_: e for k_, e in errs.items()
                   if not (e[3] and e[0] <= FUSED_BWD_MAX_REL and e[1] <= FUSED_BWD_MEAN_REL)}
            bad.update({k_: e for k_, e in gains.items() if not e <= FUSED_BWD_GAIN_REL})
            if bad:
                raise AssertionError(
                    f"fused backward kernel disagrees with its plain version at {label} B={b} N={n} C={c} "
                    f"H={h} {case}: {bad} (limits: dqkv max {FUSED_BWD_MAX_REL}, mean {FUSED_BWD_MEAN_REL}, "
                    f"gain gradients {FUSED_BWD_GAIN_REL}, of each gradient's largest entry)")
            del got, again, want
            plain_ms = time_ms(plain, runs=3, warmup=1)
            q, k, v = (t.requires_grad_(True) for t in _normed_qkv(qkv, qs, ks, cos, sin, b, n, h, d))
            gt = g.view(b, n, h, d).transpose(1, 2).contiguous()
            am = _sdpa_mask(mask, n, sw, device)

            def sdpa_step():
                o = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
                torch.autograd.grad(o, (q, k, v), gt)

            lib_ms = time_ms(sdpa_step, runs=5)
            dev_ms, lib_dev_ms = device_ms(kernel), device_ms(sdpa_step)
            del q, k, v, gt, am, out, lse
            nbytes = 7 * b * n * c * 2 + 2 * b * n * (d // 2) * 4 + (0 if mask is None else b * n)
            bound = _bound_ms(nbytes, 10.0 * h * d * _flash_pairs(valid, n, sw), BF16_FLOPS_PER_S)
            worst = max(worst, *(e[2] for e in errs.values()))
            rows.append(dict(shape=label, B=b, N=n, C=c, H=h, case=case,
                             **{f"{k_}_max_rel_err": e[0] for k_, e in errs.items()},
                             **{f"{k_}_mean_rel_err": e[1] for k_, e in errs.items()},
                             **{f"{k_}_rel_err": e for k_, e in gains.items()},
                             ms=ms, plain_ms=plain_ms, library_ms=lib_ms, device_ms=dev_ms,
                             library_device_ms=lib_dev_ms, bound_ms=bound[0], bound_by=bound[1]))
            rel = lambda k_: f"{errs[k_][0]:8.2e}/{errs[k_][1]:8.2e}"
            log(f"{label:11s} {b:3d} {n:5d} {c:5d} {h:3d} {case:10s} {rel('dq')} {rel('dk')} {rel('dv')} "
                f"{gains['dqs']:8.2e} {gains['dks']:8.2e} {ms:8.4f} {dev_ms:8.4f} {plain_ms:9.4f} {lib_ms:8.4f} "
                f"{lib_dev_ms:8.4f} {bound[0]:9.5f}")
        if label in ("350M@256t", "5B@256t"):
            _fused_bwd_vs_fp32(fa, rng, gen, label, min(b, 4), n, c, h, device)
    log("  (ms: the prologue, dq and dk/dv kernels, CUDA events around chained calls; dev_ms their device time "
        "(profiler); sdpa_fb: SDPA forward + backward on already normalised q/k: no norm, no RoPE, nor their "
        "backward; fb_dev its device time)")
    return dict(rows=rows, max_abs_err=worst)


def _fused_bwd_vs_fp32(fa, rng, gen, label, b, n, c, h, device) -> None:
    """For information: kernel and plain version (both given the forward
    kernel's output) each against the fp32 gradient of the same bf16 inputs
    (the plain version run in fp32)."""
    import torch

    qkv, qs, ks, cos, sin, _ = _attention_inputs(rng, b, n, c, h, False, device)
    g = torch.randn((b, n, c), generator=gen, device=device).to(torch.bfloat16)
    kw = dict(num_heads=h, sliding_window=None)
    exact = fa.fused_qkv_attention_bwd_plain(qkv.float(), qs, ks, cos, sin, None, g.float(), **kw)[0]
    top = exact.abs().max().item()
    dist = lambda t: ((t.float() - exact).abs().mean().item() / top, (t.float() - exact).abs().max().item() / top)
    out, lse = fa._fused_cuda(qkv, qs, ks, cos, sin, None, h, None, want_lse=True)
    kern = dist(fa.fused_qkv_attention_bwd(qkv, qs, ks, cos, sin, None, g, out=out, lse=lse, **kw)[0])
    plain = dist(fa.fused_qkv_attention_bwd_plain(qkv, qs, ks, cos, sin, None, g, out=out, **kw)[0])
    log(f"  {label} B={b}: distance of dqkv from the fp32 gradient (mean, max of its largest entry): "
        f"kernel {kern[0]:.2e}, {kern[1]:.2e}; plain version {plain[0]:.2e}, {plain[1]:.2e}")


Q8_SHAPES = (  # (label, B, N, C, H)
    ("350M@256t main", 64, 256, 1024, 16),
    ("350M@1024t", 16, 1024, 1024, 16),
    ("5B@256t", 16, 256, 3072, 24),
)
Q8_DEQUANT_MAX_ABS = 3e-2   # #1's limits against its plain version (2e-2, 2e-3)
Q8_DEQUANT_MEAN_ABS = 3e-3  # plus half a quantization step
Q8_SCALE_RTOL = 2e-2        # a scale is a row's largest |value| / 127


def q8_kernel_phase(device, shapes=Q8_SHAPES) -> dict:
    """The int8-epilogue kernel (the prologue, then the redesigned body with
    the quantize): codes and scales equal to ``quantize_activation`` of the
    redesigned forward's output bit for bit (one attention body), and its
    dequantized values against the plain version's. Timed (chained, and the
    card's time with the host ahead) beside the redesigned forward plus the
    eager quantize it replaces, the redesigned forward alone and the
    mma.sync forward (for information)."""
    import torch
    from vitok_torch.benchmarks import host_ahead_ms
    from vitok_torch.ops import fused_attention as fa
    from vitok_torch.ops.quant import quantize_activation

    rng = np.random.default_rng(8)
    rows, worst = [], 0.0
    log("kernel phase: fused attention + int8 epilogue (CUDA) vs quantize_activation(redesigned forward) "
        "and vs fused_qkv_attention_q8_plain")
    log(f"{'shape':15s} {'B':>3s} {'N':>5s} {'C':>5s} {'H':>3s} {'case':5s} {'codes!=':>8s} {'scales!=':>8s} "
        f"{'deq max':>9s} {'deq mean':>9s} {'ms':>8s} {'dev_ms':>8s} {'fwd+quant':>9s} {'fwd_ms':>8s} "
        f"{'mma_ms':>8s} {'plain_ms':>9s} {'bound_ms':>9s}")
    for label, b, n, c, h in shapes:
        for case in ("none", "tail"):
            qkv, qs, ks, cos, sin, mask = _attention_inputs(rng, b, n, c, h, case == "tail", device)
            kw = dict(num_heads=h, sliding_window=None)
            kernel = lambda: fa.fused_qkv_attention_q8(qkv, qs, ks, cos, sin, mask, **kw)
            mma = lambda: fa.fused_qkv_attention_mma(qkv, qs, ks, cos, sin, mask, **kw)
            fwd = lambda: fa.fused_qkv_attention(qkv, qs, ks, cos, sin, mask, impl="fused", **kw)
            chain = lambda: quantize_activation(fwd())
            codes, scales = kernel()
            ref_codes, ref_scales = chain()
            p_codes, p_scales = fa.fused_qkv_attention_q8_plain(qkv, qs, ks, cos, sin, mask, **kw)
            torch.cuda.synchronize()
            n_codes = int((codes != ref_codes).sum().item())
            n_scales = int((scales != ref_scales).sum().item())
            deq = (codes.float() * scales - p_codes.float() * p_scales).abs()
            srel = ((scales - p_scales).abs() / p_scales)
            if mask is not None:
                deq, srel = deq[mask], srel[mask]
            deq_max, deq_mean, srel_max = deq.max().item(), deq.mean().item(), srel.max().item()
            if not (n_codes == 0 and n_scales == 0 and deq_max <= Q8_DEQUANT_MAX_ABS
                    and deq_mean <= Q8_DEQUANT_MEAN_ABS and srel_max <= Q8_SCALE_RTOL):
                raise AssertionError(
                    f"q8 kernel at {label} B={b} N={n} C={c} H={h} {case}: {n_codes} codes and {n_scales} "
                    f"scales differ from quantize_activation of the redesigned forward's output (expected 0); "
                    f"dequantized vs the plain version max {deq_max:.3e} mean "
                    f"{deq_mean:.3e} (limits {Q8_DEQUANT_MAX_ABS}, {Q8_DEQUANT_MEAN_ABS}), scales rel "
                    f"{srel_max:.3e} (limit {Q8_SCALE_RTOL})")
            del codes, scales, ref_codes, ref_scales, p_codes, p_scales, deq, srel
            ms, dev_ms, chain_ms, fwd_ms = time_ms(kernel), host_ahead_ms(kernel), time_ms(chain), time_ms(fwd)
            mma_ms = time_ms(mma)
            plain_ms = time_ms(lambda: fa.fused_qkv_attention_q8_plain(qkv, qs, ks, cos, sin, mask, **kw),
                               runs=3, warmup=1)
            d = c // h
            nbytes = (b * n * 3 * c * 2 + b * n * (c + 4) + 2 * b * n * (d // 2) * 4 + 2 * d * 4
                      + (0 if mask is None else b * n))
            bound = _bound_ms(nbytes, 4.0 * h * d * _needed_pairs(b, mask, n, None), BF16_FLOPS_PER_S)
            worst = max(worst, deq_max)
            rows.append(dict(shape=label, B=b, N=n, C=c, H=h, case=case, codes_differ=n_codes,
                             scales_differ=n_scales, max_abs_err=deq_max, mean_abs_err=deq_mean, ms=ms,
                             dev_ms=dev_ms, fused_plus_quantize_ms=chain_ms, fused_ms=fwd_ms,
                             mma_ms=mma_ms, plain_ms=plain_ms, bound_ms=bound[0],
                             bound_by=bound[1], cluster=fa._q8_cluster_size(h, d)))
            log(f"{label:15s} {b:3d} {n:5d} {c:5d} {h:3d} {case:5s} {n_codes:8d} {n_scales:8d} "
                f"{deq_max:9.2e} {deq_mean:9.2e} {ms:8.4f} {dev_ms:8.4f} {chain_ms:9.4f} {fwd_ms:8.4f} "
                f"{mma_ms:8.4f} {plain_ms:9.4f} "
                f"{bound[0]:9.5f}")
    log("  (ms: the prologue and the epilogue kernel, as the wrapper launches them, chained; dev_ms the card's time "
        "with the host ahead; codes!=, scales!=: against quantize_activation of the redesigned forward, whose body "
        "the epilogue kernel runs; fwd+quant: the redesigned forward and the eager quantize_activation the "
        "epilogue replaces; mma_ms: the mma.sync forward, for information)")
    return dict(rows=rows, max_abs_err=worst)


# ---------------------------------------------------------------------------
# Training on the fused kernel and its backward; int8 with the epilogue
# ---------------------------------------------------------------------------

FUSED_TRAIN = ("256p", 256, 32, RESOLUTIONS[0][3])  # 8192 tokens a step, as TRAIN


def _set_attn_impl(model, impl: str) -> None:
    model.cfg = dataclasses.replace(model.cfg, attn_impl=impl)


def _timed_steps(train_step, state, inputs, steps: int):
    """``steps`` train steps on one batch: (state, metrics per step, host ms
    per step each ending in a synchronise, launches per step)."""
    import torch

    metrics_all, step_ms, per_step = [], [], []
    for _ in range(steps):
        before = launch_counts()
        t0 = time.perf_counter()
        state, metrics = train_step(state, inputs, 3)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: v - before[k] for k, v in launch_counts().items()})
        metrics_all.append({k: float(v) for k, v in metrics.items()})
    return state, metrics_all, step_ms, per_step


def fused_training_phase(device, card: str) -> dict:
    """Train 350M-f16x64 at 256 tokens, batch 32 (8192 tokens a step), no
    window, fp32 master weights, with ``attn_impl="fused"``: the fused kernel
    forward and its backward kernel in every block; then the same steps with
    ``"auto"`` (the unfused composition under autograd) beside it."""
    import torch
    from vitok_torch import AE, decode_variant
    from vitok_torch.train_lib import (LossConfig, compute_loss, create_optimizer, create_schedule,
                                       create_train_state, make_train_step)

    model = AE(**{**decode_variant(VARIANT), "attn_impl": "fused"}, seed=0, device=device,
               param_dtype=torch.float32, trainable=True)
    _random_gates(model, device)
    depth = model.cfg.encoder_depth + model.cfg.decoder_depth
    params = list(model.parameters())
    (case,) = main_path_cases(device, [FUSED_TRAIN], seed=7)
    name, max_tokens, batch, _, inputs = case
    side = int(max_tokens ** 0.5)
    loss_cfg = LossConfig(ssim_weight=0.1, tile_size=256, n_tiles=2, ssim_grid=(side, side))
    log(f"fused training path: {VARIANT}, fp32 master weights, bf16 compute, {name} batch {batch} "
        f"({batch * max_tokens} tokens a step), attn_impl='fused', Charbonnier 1.0 + SSIM 0.1, AdamW lr {TRAIN_LR} + EMA")

    def grads_of(impl):
        _set_attn_impl(model, impl)
        gen = torch.Generator(device=device).manual_seed(11)
        loss, _ = compute_loss(model, inputs, loss_cfg, gen)
        return loss.detach(), torch.autograd.grad(loss, params)

    def rel_l2(got, want):
        num = sum((a.double() - b.double()).square().sum() for a, b in zip(got, want))
        return (num / sum(b.double().square().sum() for b in want)).sqrt().item()

    # The first step's gradients: the fused kernels against the unfused composition under autograd.
    reset_counts()
    loss_f, g_fused = grads_of("fused")
    first = launch_counts()
    loss_a, g_auto = grads_of("auto")
    torch.cuda.synchronize()
    grad_rel = rel_l2(g_fused, g_auto)
    finite = all(bool(torch.isfinite(g).all()) for g in g_fused)
    loss_gap = abs(loss_f.item() - loss_a.item()) / abs(loss_a.item())
    want_first = _expect(fused_attention=depth, fused_attention_bwd=depth)
    if not (finite and first == want_first and launch_counts() == want_first
            and grad_rel <= TRAIN_GRAD_REL_L2 and loss_gap <= 1e-2):
        raise AssertionError(
            f"fused training: gradients vs attn_impl='auto': rel L2 {grad_rel:.3e} (limit {TRAIN_GRAD_REL_L2}), "
            f"finite {finite}, loss {loss_f.item()} vs {loss_a.item()}, launches {first} then {launch_counts()} "
            f"(expected {want_first}, and none more under 'auto')")
    del g_fused, g_auto
    log(f"  first-step gradients, fused kernels vs the unfused composition under autograd: rel L2 "
        f"{grad_rel:.3e} over all parameters; loss {loss_f.item():.5f} vs {loss_a.item():.5f}")

    _set_attn_impl(model, "fused")
    tx = create_optimizer(create_schedule("constant", TRAIN_LR, 2 * TRAIN_STEPS, warmup_frac=0.0))
    state = create_train_state(model, tx)
    train_step = make_train_step(tx, loss_cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the fused training path's run
    state, metrics, step_ms, per_step = _timed_steps(train_step, state, inputs, TRAIN_STEPS)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(got != want_first for got in per_step):
        raise AssertionError(f"fused training: launches per step {per_step}, expected {want_first}")
    totals = [m["loss/total"] for m in metrics]
    if not (all(np.isfinite(list(m.values())).all() for m in metrics) and totals[-1] < totals[0]):
        raise AssertionError(f"fused training: losses {totals} must be finite and fall from the first to the fifth step")
    ms = float(np.median(step_ms[1:]))
    tokens = batch * max_tokens
    log(f"  'fused', {TRAIN_STEPS} steps: loss " + " -> ".join(f"{t:.5f}" for t in totals)
        + f"; launches a step {want_first}")
    log(f"  'fused': {ms:.3f} ms/step (host clock, median of steps 2-{TRAIN_STEPS}; first {step_ms[0]:.3f}), "
        f"{tokens / ms * 1e3:.1f} tokens/s, peak memory {peak_gb:.3f} GB on {card}")
    profile_step(f"fused train {name}", lambda: train_step(state, inputs, 3))

    # Every block recomputed in the backward: twice the forward launches.
    _with_checkpoint(model, 1)
    torch.cuda.reset_peak_memory_stats()
    state, remat_metrics, remat_ms, remat_launches = _timed_steps(train_step, state, inputs, 1)
    expect = _expect(fused_attention=2 * depth, fused_attention_bwd=depth)
    if remat_launches[0] != expect or not np.isfinite(remat_metrics[0]["loss/total"]):
        raise AssertionError(f"fused training with checkpoint=1: launches {remat_launches[0]} (expected {expect}), "
                             f"loss {remat_metrics[0]['loss/total']}")
    remat_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  'fused', checkpoint=1: launches {remat_launches[0]}, loss {remat_metrics[0]['loss/total']:.5f}; "
        f"{remat_ms[0]:.3f} ms (one step), peak memory {remat_peak:.3f} GB on {card}")
    _with_checkpoint(model, 0)

    # The same steps on the unfused composition under autograd.
    _set_attn_impl(model, "auto")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    state, auto_metrics, auto_step_ms, _ = _timed_steps(train_step, state, inputs, TRAIN_STEPS - 1)
    if launch_counts() != before or not all(np.isfinite(m["loss/total"]) for m in auto_metrics):
        raise AssertionError(f"training with attn_impl='auto': launches moved to {launch_counts()} or a loss is not finite")
    auto_peak = torch.cuda.max_memory_allocated() / 1e9
    auto_ms = float(np.median(auto_step_ms[1:]))
    log(f"  'auto' (unfused attention under autograd, no kernel launch): {auto_ms:.3f} ms/step (median of "
        f"steps 2-{TRAIN_STEPS - 1}; first {auto_step_ms[0]:.3f}), {tokens / auto_ms * 1e3:.1f} tokens/s, "
        f"peak memory {auto_peak:.3f} GB on {card}")
    profile_step(f"auto train {name}", lambda: train_step(state, inputs, 3))
    return dict(launches=launches, losses=totals, grad_rel_l2=grad_rel, ms_per_step=ms, peak_gb=peak_gb,
                auto_ms_per_step=auto_ms, auto_peak_gb=auto_peak, remat_ms=remat_ms[0], remat_peak_gb=remat_peak)


@contextlib.contextmanager
def q8_epilogue(on: bool):
    """The opt-in of the int8 epilogue (``VITOK_Q8_EPILOGUE``, read when the
    package is imported) set for a run of this script."""
    from vitok_torch.ops import fused_attention as fa

    saved, fa._ENABLE_Q8 = fa._ENABLE_Q8, on
    try:
        yield
    finally:
        fa._ENABLE_Q8 = saved


def q8_path_phase(device, card: str) -> dict:
    """The int8 350M path with the quantize epilogue switched on: where the
    gate opens (256 tokens; it stays closed at 1024, as in the JAX package)
    every block's attention is one launch of the q/k prologue and one of the
    int8-epilogue kernel and none of the forward kernel, and the output is
    held to the run with the opt-in off, whose redesigned forward runs the
    same attention body (an int8 model is held only against itself with one
    kernel swapped: a code flipped at a rounding tie grows over 28 blocks)."""
    from vitok_torch import AE, decode_variant
    from vitok_torch.ops import fused_attention as fa

    model = AE(**decode_variant(VARIANT), seed=0, device=device)
    _random_gates(model, device)
    model.quantize()
    depth = model.cfg.encoder_depth + model.cfg.decoder_depth
    cases = main_path_cases(device, RESOLUTIONS)
    log(f"int8 path with the quantize epilogue (VITOK_Q8_EPILOGUE on): {VARIANT} after AE.quantize()")
    rows, launches = [], None
    for case in cases:
        name, max_tokens, batch, images, inputs = case
        with q8_epilogue(True):
            opened = fa.can_fuse_q8(max_tokens, model.cfg.encoder_width, model.cfg.encoder_heads)
            attn = (dict(fused_attention_q8=depth, fused_qk_prologue=depth) if opened
                    else dict(fused_attention=depth))
            expect = _expect(rmsnorm_quant=depth, ffn_int8=depth, **attn)
            (out,), counts = _run_counted(model, [case], expect, "int8 + epilogue")
            ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=5, warmup=1)
        if opened and launches is None:
            launches = counts  # the epilogue path's run
        _check_output(name, max_tokens, batch, images, inputs, out)
        with q8_epilogue(False):
            off = model.decode(model.encode(inputs))
            off_ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=5, warmup=1)
        rel = _valid_rel_l2(out, off, inputs)
        if not rel <= MODEL_REL_L2:
            raise AssertionError(f"int8 + epilogue {name}: rel L2 vs the opt-in off on the same attention "
                                 f"{rel:.3e} > {MODEL_REL_L2}")
        rows.append(dict(res=name, batch=batch, gate_open=opened, rel_l2_vs_off=rel, ms_per_img=ms / batch,
                         off_ms_per_img=off_ms / batch))
        log(f"  int8 + epilogue {name}: batch {batch}: gate {'open' if opened else 'closed'}, launches a "
            f"forward {attn}; rel L2 vs the opt-in off on the same attention {rel:.3e}; encode+decode "
            f"{ms / batch:.4f} ms/img (opt-in off {off_ms / batch:.4f} ms/img) on {card}")
    if launches is None:
        raise AssertionError("int8 + epilogue: the gate opened at no resolution")
    return dict(rows=rows, launches=launches)


# ---------------------------------------------------------------------------
# Generation: DiT-L + UniPC + the 350M decoder; DiT training
# ---------------------------------------------------------------------------

DIT_VARIANT = "L/256"  # width 1024, 24 blocks, 16 heads of 64
DIT_CODE_WIDTH = 64    # the 350M-f16x64 latent
DIT_CLASSES = (1, 207, 360, 417, 555, 812, 933, 999)
DIT_TOKENS = 256
DIT_STEPS = 20
DIT_SHIFT = 3.0
DIT_CFG_SCALE = 4.0
DIT_CALL_REL_L2 = 2e-2    # one guided DiT call, fused kernel vs unfused attention
DIT_SAMPLE_REL_L2 = 1e-1  # 20 solver steps apart: loops and attention paths
DIT_TRAIN_BATCH = 64
DIT_TRAIN_STEPS = 3


def _random_mod(dit, device, seed: int = 1) -> None:
    """adaLN-zero starts every block's ``mod`` at zero, which closes its
    residual gate: draw them from a seed so that every block matters."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for blk in dit.blocks:
            w, bias = blk.mod.weight, blk.mod.bias
            w.copy_(0.02 * torch.randn(w.shape, generator=gen, device=device))
            bias.zero_()
            c = bias.shape[0] // 3
            bias[2 * c:].copy_(0.2 + 0.4 * torch.rand(c, generator=gen, device=device))  # the gate


def generation_phase(device, card: str) -> dict:
    """Class-conditional generation: DiT-L/256 over 64-channel latents, 8
    classes with classifier-free guidance (16 rows a call), 256 tokens, 20
    UniPC steps with shift 3.0, host loop and device loop, then the 350M
    decoder and ``postprocess`` to 256 x 256 images; then ``DiT.quantize()``."""
    import torch
    from vitok_torch import AE, decode_variant
    from vitok_torch.models.dit import DiT, decode_variant as dit_variant
    from vitok_torch.scripts.generate import (_guided_velocity, _setup, decode_latents, sample_latents,
                                              sample_latents_device)
    from vitok_torch.unipc import FlowUniPCMultistepScheduler

    kw = dict(**dit_variant(DIT_VARIANT), code_width=DIT_CODE_WIDTH, text_dim=1000)
    dit = DiT(**kw, seed=0, device=device)
    _random_mod(dit, device)
    depth, b = dit.cfg.depth, len(DIT_CLASSES)
    unfused = DiT(**kw, attn_impl="xla", state_dict=dit.state_dict(), device=device)
    decoder = AE(**decode_variant(VARIANT), encoder=False, seed=0, device=device)
    _random_gates(decoder, device)
    log(f"generation: DiT-{DIT_VARIANT} ({dit.num_params() / 1e6:.1f}M params), bf16, {depth} blocks, "
        f"{b} classes with CFG {DIT_CFG_SCALE} ({2 * b} rows a call), {DIT_TOKENS} tokens, "
        f"{DIT_STEPS} UniPC steps, shift {DIT_SHIFT}; decoder {VARIANT}")
    z0 = torch.randn((b, DIT_TOKENS, DIT_CODE_WIDTH), device=device,
                     generator=torch.Generator(device=device).manual_seed(9))
    sample_kw = dict(cfg_scale=DIT_CFG_SCALE, steps=DIT_STEPS, z0=z0)
    sched = lambda: FlowUniPCMultistepScheduler(shift=DIT_SHIFT)
    rel = lambda a, r: ((a.float() - r.float()).norm() / r.float().norm()).item()

    # One DiT call (16 rows): 24 launches of the fused kernel, against the unfused attention.
    # The raw prediction is compared: guidance multiplies the difference of two rows by its scale.
    _, row, col, ctx = _setup(dit, DIT_CLASSES, DIT_TOKENS)
    call_in = {"z": torch.cat([z0, z0]), "t": torch.full((2 * b,), 500.0, device=device), "context": ctx,
               "row_idx": row, "col_idx": col}
    reset_counts()
    v_raw = dit(call_in)
    torch.cuda.synchronize()
    per_call = launch_counts()
    call_rel = rel(v_raw, unfused(call_in))
    log(f"  one DiT call: launches {per_call['fused_attention']} of the fused kernel; rel L2 vs unfused "
        f"attention {call_rel:.3e} (limit {DIT_CALL_REL_L2})")
    if per_call != _expect(fused_attention=depth) or not call_rel <= DIT_CALL_REL_L2:
        raise AssertionError(f"generation: one DiT call launched {per_call} (expected {depth} of the fused "
                             f"kernel); rel L2 vs unfused attention {call_rel:.3e} (limit {DIT_CALL_REL_L2})")
    v = _guided_velocity(dit, z0, 500.0, ctx, row, col, DIT_CFG_SCALE)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    reset_counts()  # the generation path's run
    z_host, host_ms = timed(lambda: sample_latents(dit, sched(), DIT_CLASSES, DIT_TOKENS, DIT_CODE_WIDTH, **sample_kw))
    host_launches = launch_counts()
    z_dev, dev_ms = timed(lambda: sample_latents_device(dit, sched(), DIT_CLASSES, DIT_TOKENS, DIT_CODE_WIDTH, **sample_kw))
    launches = launch_counts()
    want = _expect(fused_attention=depth * DIT_STEPS)
    if host_launches != want or launches != _expect(fused_attention=2 * depth * DIT_STEPS):
        raise AssertionError(f"generation: launches {host_launches} after the host loop, {launches} after both "
                             f"(expected {depth} of the fused kernel per DiT call, {DIT_STEPS} calls a loop)")
    z_unf = sample_latents_device(unfused, sched(), DIT_CLASSES, DIT_TOKENS, DIT_CODE_WIDTH, **sample_kw)
    loop_rel, path_rel = rel(z_dev, z_host), rel(z_dev, z_unf)
    log(f"  sampled latents: device loop vs host loop rel L2 {loop_rel:.3e}; fused vs unfused attention "
        f"{path_rel:.3e} (limit {DIT_SAMPLE_REL_L2} after {DIT_STEPS} steps)")
    if not (torch.isfinite(z_dev).all() and loop_rel <= DIT_SAMPLE_REL_L2 and path_rel <= DIT_SAMPLE_REL_L2):
        raise AssertionError(f"generation: device loop vs host loop rel L2 {loop_rel:.3e}, fused vs unfused "
                             f"attention {path_rel:.3e} (limit {DIT_SAMPLE_REL_L2}), finite "
                             f"{bool(torch.isfinite(z_dev).all())}")
    # A second, warm timing of each loop.
    _, host_ms2 = timed(lambda: sample_latents(dit, sched(), DIT_CLASSES, DIT_TOKENS, DIT_CODE_WIDTH, **sample_kw))
    _, dev_ms2 = timed(lambda: sample_latents_device(dit, sched(), DIT_CLASSES, DIT_TOKENS, DIT_CODE_WIDTH, **sample_kw))
    host_ms, dev_ms = min(host_ms, host_ms2), min(dev_ms, dev_ms2)

    images, decode_ms = timed(lambda: decode_latents(decoder, z_dev, DIT_TOKENS))
    _, decode_ms2 = timed(lambda: decode_latents(decoder, z_dev, DIT_TOKENS))
    decode_ms = min(decode_ms, decode_ms2)
    side = int(DIT_TOKENS ** 0.5) * 16
    for img in images:
        if tuple(img.shape) != (3, side, side) or img.dtype != torch.uint8:
            raise AssertionError(f"generation: image {tuple(img.shape)} {img.dtype}, expected (3, {side}, {side}) uint8")
    if len(images) != b or len({bytes(i.numpy().tobytes()) for i in images}) != b:
        raise AssertionError("generation: the decoded images are not 8 distinct images")
    log(f"  host loop {host_ms / DIT_STEPS:.3f} ms per sample step, device loop {dev_ms / DIT_STEPS:.3f} ms "
        f"(host clock, best of two); decode + postprocess {decode_ms:.3f} ms; {(dev_ms + decode_ms) / b:.3f} "
        f"ms per {side}x{side} image with the device loop, {(host_ms + decode_ms) / b:.3f} with the host loop, on {card}")
    profile_step("generation, one guided DiT call", lambda: _guided_velocity(dit, z0, 500.0, ctx, row, col, DIT_CFG_SCALE))

    # int8: DiT.quantize(), the AE's int8 recipe inside the DiT block.
    dit.quantize()
    reset_counts()
    vq = _guided_velocity(dit, z0, 500.0, ctx, row, col, DIT_CFG_SCALE)
    torch.cuda.synchronize()
    q_call = launch_counts()
    q_rel = rel(vq, v)
    if q_call != _expect(fused_attention=depth, ffn_int8=depth) or not torch.isfinite(vq).all():
        raise AssertionError(f"generation after DiT.quantize(): one call launched {q_call} (expected {depth} each "
                             f"of the fused attention and the fused int8 FFN), finite {bool(torch.isfinite(vq).all())}")
    with plain_quant_kernels():
        q_plain_rel = rel(vq, _guided_velocity(dit, z0, 500.0, ctx, row, col, DIT_CFG_SCALE))
    if not q_plain_rel <= MODEL_REL_L2:
        raise AssertionError(f"generation int8: rel L2 vs the plain quantize kernels {q_plain_rel:.3e} > {MODEL_REL_L2}")
    sample_latents_device(dit, sched(), DIT_CLASSES, DIT_TOKENS, DIT_CODE_WIDTH, **sample_kw)
    zq, q_ms = timed(lambda: sample_latents_device(dit, sched(), DIT_CLASSES, DIT_TOKENS, DIT_CODE_WIDTH, **sample_kw))
    if not torch.isfinite(zq).all():
        raise AssertionError("generation int8: sampled latents are not finite")
    log(f"  after DiT.quantize(): one call launches {q_call['fused_attention']} fused attention + "
        f"{q_call['ffn_int8']} fused int8 FFN; rel L2 vs the plain quantize kernels {q_plain_rel:.3e}, vs the "
        f"bf16 call {q_rel:.3e}; device loop {q_ms / DIT_STEPS:.3f} ms per sample step on {card}")
    return dict(launches=launches, host_ms_per_step=host_ms / DIT_STEPS, device_ms_per_step=dev_ms / DIT_STEPS,
                ms_per_image=(dev_ms + decode_ms) / b, int8_ms_per_step=q_ms / DIT_STEPS)


def dit_training_phase(device, card: str) -> dict:
    """Three flow-matching steps of DiT-L/256 on a batch of 64 seeded latents
    (16384 tokens a step) with ``attn_impl="fused"``: 24 forward and 24
    backward launches of the fused kernels a step; then a step with
    ``"auto"``."""
    import torch
    from vitok_torch.models.dit import DiT, decode_variant as dit_variant
    from vitok_torch.scripts.train_dit import make_dit_train_step
    from vitok_torch.train_lib import create_optimizer, create_schedule, create_train_state

    dit = DiT(**dit_variant(DIT_VARIANT), code_width=DIT_CODE_WIDTH, text_dim=1000, attn_impl="fused",
              seed=0, device=device, param_dtype=torch.float32, trainable=True)
    _random_mod(dit, device)
    depth = dit.cfg.depth
    gen = torch.Generator(device=device).manual_seed(12)
    z = torch.randn((DIT_TRAIN_BATCH, DIT_TOKENS, DIT_CODE_WIDTH), generator=gen, device=device)
    labels = torch.randint(0, 1000, (DIT_TRAIN_BATCH,), generator=gen, device=device)
    tx = create_optimizer(create_schedule("constant", 1e-4, 2 * DIT_TRAIN_STEPS, warmup_frac=0.0), weight_decay=0.0)
    state = create_train_state(dit, tx)
    step = make_dit_train_step(tx, num_classes=1000, cfg_dropout=0.1, shift=1.0)
    tokens = DIT_TRAIN_BATCH * DIT_TOKENS
    log(f"DiT training: DiT-{DIT_VARIANT}, fp32 master weights, bf16 compute, batch {DIT_TRAIN_BATCH} of seeded "
        f"latents ({tokens} tokens a step), rectified flow + CFG dropout 0.1, AdamW lr 1e-4 + EMA, attn_impl='fused'")

    def run(steps):
        losses, step_ms, per_step = [], [], []
        nonlocal state
        for _ in range(steps):
            before = launch_counts()
            t0 = time.perf_counter()
            state, loss = step(state, z, labels, 5)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            per_step.append({k: v_ - before[k] for k, v_ in launch_counts().items()})
            losses.append(float(loss))
        return losses, step_ms, per_step

    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the DiT training path's run
    losses, step_ms, per_step = run(DIT_TRAIN_STEPS)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = _expect(fused_attention=depth, fused_attention_bwd=depth)
    if any(got != want for got in per_step) or not np.isfinite(losses).all():
        raise AssertionError(f"DiT training: launches per step {per_step} (expected {want}), losses {losses}")
    ms = float(np.median(step_ms[1:]))
    log(f"  'fused', {DIT_TRAIN_STEPS} steps: loss " + " -> ".join(f"{t:.5f}" for t in losses)
        + f"; launches a step {want}; {ms:.3f} ms/step (host clock, median of steps 2-{DIT_TRAIN_STEPS}; first "
        f"{step_ms[0]:.3f}), {tokens / ms * 1e3:.1f} tokens/s, peak memory {peak_gb:.3f} GB on {card}")
    profile_step("DiT train, 'fused'", lambda: step(state, z, labels, 5))

    _set_attn_impl(dit, "auto")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    auto_losses, auto_ms, _ = run(2)
    if launch_counts() != before or not np.isfinite(auto_losses).all():
        raise AssertionError(f"DiT training with attn_impl='auto': launches moved to {launch_counts()} or losses {auto_losses}")
    auto_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  'auto' (unfused attention under autograd): loss {auto_losses[-1]:.5f}; {auto_ms[-1]:.3f} ms (second "
        f"step; first {auto_ms[0]:.3f}), {tokens / auto_ms[-1] * 1e3:.1f} tokens/s, peak memory {auto_peak:.3f} GB on {card}")
    return dict(launches=launches, losses=losses, ms_per_step=ms, peak_gb=peak_gb, auto_ms=auto_ms[-1])


BENCH_5B = ("Td4-T/1x16x64", 256, 256, (16, 16), 16)  # variant, res, tokens, grid, batch
SSIM_GATE = 0.99  # the reference's quantized-inference gate (BASELINE.md)


def bench_5b_phase(device, card: str) -> dict:
    """The 5B model (``Td4-T/1x16x64``: width 3072, 24 heads of 128, 4 + 40
    blocks) end to end through ``bench_torch.bench_config`` at 256p, batch
    16, one timed repeat: bf16, then ``quantize()``d in place, each output
    finite, 44 launches of #1 and its prologue a forward, and of #9 and #7 a
    forward in int8, and the int8 reconstructions within the SSIM gate of
    the bf16 ones (LayerScale gains U(0.5, 1.5)). The kernel phase holds #1
    and its prologue against their plain versions at this shape (row "5B@256p
    main"), the quantize phase #9 and #7 (row "5B width")."""
    import bench_torch
    from vitok_torch.models.ae import AEConfig

    variant, res, tokens, grid, batch = BENCH_5B
    cfg = AEConfig.from_variant(variant)
    depth = cfg.encoder_depth + cfg.decoder_depth
    log(f"5B bench: {variant} (width {cfg.encoder_width}, {depth} blocks) @{res}p, batch {batch}, bf16 then int8, "
        f"through bench_torch.bench_config")
    reset_counts()  # the 5B path's run
    rows, n_params = bench_torch.bench_config(variant, res, tokens, grid, batch=batch, iters=1, with_gate=True,
                                              device=device)
    launches = launch_counts()
    bf, q = rows
    want = _expect(fused_attention=depth * (bf["forwards"] + q["forwards"]), rmsnorm_quant=depth * q["forwards"],
                   ffn_int8=depth * q["forwards"])
    if launches != want:
        raise AssertionError(f"5B bench: launches {launches} over {bf['forwards']} bf16 and {q['forwards']} int8 "
                             f"forwards, expected {want} ({depth} of each kernel a forward)")
    if not q["ssim_vs_bf16"] >= SSIM_GATE:
        raise AssertionError(f"5B bench: int8 ssim_vs_bf16 {q['ssim_vs_bf16']} < {SSIM_GATE}")
    for r in rows:
        log(f"  {r['dtype']}: {r['ms_per_img']:.4f} ms/img, {r['img_per_s']:.2f} img/s, MFU {r['mfu']} "
            f"({r['forwards']} forwards, {depth} blocks each)"
            + (f"; ssim_vs_bf16 {r['ssim_vs_bf16']}, psnr {r['psnr_vs_bf16_db']} dB" if r["dtype"] == "int8" else "")
            + f" on {card}")
    log(f"  {n_params / 1e9:.3f}B params; launches {dict((k, v) for k, v in launches.items() if v)}")
    return dict(rows=rows, launches=launches)


def fused_family_entries(q8kern: dict, q8_path: dict, fbkern: dict, fused_training: dict) -> list:
    """The kernels-line entries of the int8-epilogue instance (launches from
    the int8 run with the epilogue on, times at 256 tokens with a tail mask)
    and of the fused backward kernel (launches from the fused training run,
    times at 256 tokens, batch 32, with a tail mask: the training shape)."""
    q8 = next(r for r in q8kern["rows"] if r["shape"] == "350M@256t main" and r["case"] == "tail")
    bw = next(r for r in fbkern["rows"] if r["shape"] == "350M@256t" and r["case"] == "tail")
    return [{
        "name": "fused_attention_q8",
        "route": "cuda",
        "source": "vitok_torch/csrc/fused_attention_sm90.cu",
        "replaces": "vitok_tpu/ops/fused_attention.py:340",
        "launches": q8_path["launches"]["fused_attention_q8"],
        "max_abs_err": q8kern["max_abs_err"],  # dequantized, against the plain version
        "codes_differ_from_quantized_forward": max(r["codes_differ"] for r in q8kern["rows"]),
        "ms": q8["ms"],  # the prologue and the epilogue kernel, as the wrapper launches them
        "dev_ms": q8["dev_ms"],
        "plain_ms": q8["plain_ms"],
        "bound_ms": q8["bound_ms"],
        "bound_by": q8["bound_by"],
        "library_ms": None,
        "fused_plus_quantize_ms": q8["fused_plus_quantize_ms"],  # the redesigned forward + the eager quantize
    }, {
        "name": "fused_attention_bwd",
        "route": "cuda",
        "source": "vitok_torch/csrc/fused_attention_bwd.cu",
        "replaces": "vitok_tpu/ops/fused_attention.py:645",
        "launches": fused_training["launches"]["fused_attention_bwd"],
        "max_abs_err": fbkern["max_abs_err"],
        "ms": bw["ms"],
        "plain_ms": bw["plain_ms"],
        "bound_ms": bw["bound_ms"],
        "bound_by": bw["bound_by"],
        "library_ms": bw["library_ms"],  # SDPA forward + backward on normalised q/k: computes less
        "device_ms": bw["device_ms"],
        "library_device_ms": bw["library_device_ms"],
    }]


# ---------------------------------------------------------------------------
# The A/B kernels of vitok_torch.benchmarks (#10-#13) and the fp32 instance
# ---------------------------------------------------------------------------

AB_SHAPES = (  # (label, B, N, C, H, dtype, mask): the two recorded invocations, then 350M width
    ("5B@256t bf16", 64, 256, 3072, 24, "bfloat16", "ones"),
    ("5B@64t fp32", 256, 64, 3072, 24, "float32", "ones"),
    ("350M@256t bf16", 16, 256, 1024, 16, "bfloat16", "tail+dead"),
    ("350M@256t fp32", 16, 256, 1024, 16, "float32", "tail+dead"),
)
AB_F32_MAX_REL = 1e-5  # fp32 kernels against their plain version (tf32 off): of the largest entry
AB_ENTRY = (3072, 24, (("bfloat16", 256, 64), ("float32", 64, 256)))  # C, H, (dtype, N, B) recorded
AB_ENTRY_ARGS = ("--iters", "2", "--layers", "16")
F32_AE = ("256p", 256, 16, RESOLUTIONS[0][3])
F32_MODEL_REL_L2 = 1e-4  # fp32 AE on the fp32 forward against the unfused composition


def _ab_inputs(gen, b, n, c, h, dtype, mask_kind, device):
    """qkv N(0, 1) in ``dtype``, gains U(0.5, 1.5), 2D RoPE tables; the mask
    all ones (as the A/B scripts pass it) or a tail per sample with the last
    sample all masked."""
    import torch
    from vitok_torch.ops.rope import compute_2d_freqs_cis

    d = c // h
    qkv = torch.randn(b, n, 3 * c, generator=gen, device=device).to(getattr(torch, dtype))
    qs = 0.5 + torch.rand(d, generator=gen, device=device)
    ks = 0.5 + torch.rand(d, generator=gen, device=device)
    side = int(round(n ** 0.5))
    idx = torch.arange(n, device=device)
    cos, sin = compute_2d_freqs_cis((idx // side).expand(b, n), (idx % side).expand(b, n), d)
    valid = torch.full((b,), n, device=device)
    if mask_kind == "tail+dead":
        valid = torch.tensor([n - (i * n) // (b + 2) for i in range(b)], device=device)
        valid[-1] = 0
    return qkv, qs, ks, cos, sin, idx[None, :] < valid[:, None]


def _ab_bound(b, n, c, h, mask, isz, in_bytes=None, pairs=None, split=False):
    """Least time: qkv read (``in_bytes`` a token; 3C elements of ``isz``
    bytes by default), out written, tables, gains and mask read once; or the
    needed QK^T and PV products over the peak for the type (bf16 tensor
    cores, fp32 FMA; with ``split``, the fp32 walker's, six bf16 products on
    the tensor cores for each fp32 one)."""
    d = c // h
    in_bytes = 3 * c * isz if in_bytes is None else in_bytes
    nbytes = b * n * (in_bytes + c * isz) + 2 * b * n * (d // 2) * 4 + 2 * d * 4 + b * n
    pairs = _needed_pairs(b, mask, n, None) if pairs is None else pairs
    ops = 4.0 * h * d * pairs
    if split:
        return _bound_ms(nbytes, 6 * ops, BF16_FLOPS_PER_S)
    return _bound_ms(nbytes, ops, FP32_OPS_PER_S if isz == 4 else BF16_FLOPS_PER_S)


def _pack_pairs(mask, n, bb) -> int:
    """Pairs the pack needs: a row's own valid keys, or all bb*N keys of its
    pack where its image has none."""
    per_image = mask.sum(1).cpu().numpy()
    return int(np.where(per_image > 0, per_image, bb * n).sum() * n)


def _check_ab(what, got, want, rows, f32) -> float:
    """fp32: within AB_F32_MAX_REL of the largest entry on every row; bf16:
    #1's limits on ``rows``. Returns the largest |error|."""
    err_all = (got.float() - want.float()).abs()
    if f32:
        top = want.float().abs().max().item()
        max_abs = err_all.max().item()
        if not max_abs <= AB_F32_MAX_REL * top:
            raise AssertionError(f"{what}: fp32 max |err| {max_abs:.3e} > {AB_F32_MAX_REL} x {top:.3f}")
        return max_abs
    err = err_all[rows]
    max_abs, mean_abs = err.max().item(), err.mean().item()
    if not (max_abs <= KERNEL_MAX_ABS and mean_abs <= KERNEL_MEAN_ABS):
        raise AssertionError(f"{what}: max {max_abs:.3e} mean {mean_abs:.3e} against the plain version "
                             f"(limits {KERNEL_MAX_ABS}, {KERNEL_MEAN_ABS})")
    return max_abs


def _one_launch(name: str, fn):
    """``fn()`` with the launch count ``name`` going up by exactly one."""
    before = launch_counts()[name]
    out = fn()
    if launch_counts()[name] != before + 1:
        raise AssertionError(f"{name}: {launch_counts()[name] - before} launches counted for one call")
    return out


def ab_kernel_phase(device, shapes=AB_SHAPES) -> dict:
    """#10 (every arm of ab_batch_block), #11, #12 and #13 against the
    forward whose body each runs, bit for bit: #10 and #11 (on images with a
    valid key) in bf16 and #13 in bf16 the redesigned forward (the wgmma
    body); #1, #10, #11 and #13 in fp32 the fp32 walker with one cell a block
    (W), itself within AB_F32_MAX_REL of the fp32 instance of the mma.sync
    forward (FMA, kept off the main path); #12 (on the assembled tensor) the
    redesigned forward, with its own times (with the host ahead, the kernel
    alone at its plan's split and at every split of up to four images, the
    int8 prologue alone, the chain it replaces: assemble + the redesigned
    forward). Each against its plain version, the mma.sync forward
    too; times beside bounds, SDPA and the redesigned forward (bf16) or the
    FMA instance (fp32), with device times, the walkers alone (bf16: on the
    prologue's k) for #10's arm D2, #11 and #13, and the q/k prologue's (k
    alone, as #1, #10, #11 and #13 run it; q and k, the walkers' rejected
    feed). Where the shape refuses arm P2 (C = 1024), the pack runs at bb = 2
    with half the heads ("P2h"). The device times of #1 and #13 in fp32 are
    CUDA events with the host ahead (``host_ahead_ms``), beside the
    profiler's reading and how many of its five kernel records it kept."""
    import torch
    import torch.nn.functional as F
    from vitok_torch.benchmarks import ab_batch_block as abb
    from vitok_torch.benchmarks import ab_q8_input as ab8
    from vitok_torch.benchmarks import host_ahead_ms, profiler_records, walk_f32, walk_sm90
    from vitok_torch.ops import fused_attention as fa

    def fp32_device(call, key, row):
        """``row[key]``: host_ahead_ms; ``row[key + "_profiler"]``: the
        profiler's ms and its record count over five calls of one launch."""
        records = profiler_records(call)
        row[key] = host_ahead_ms(call)
        row[key + "_profiler"] = (sum(records) / 5, len(records))

    gen = torch.Generator(device=device).manual_seed(10)
    rows = []
    log("kernel phase: A/B kernels (fused_attention_ab_sm90.cu for #10, #11 and #13 in bf16, "
        "fused_attention_ab_f32_sm90.cu for #1, #10, #11 and #13 in fp32, fused_attention_q8in_sm90.cu for #12) vs "
        "the forward whose body each runs (bit for bit) and vs their plain versions; the mma.sync forward's "
        "instances vs their plain version")
    for label, b, n, c, h, dtype, mask_kind in shapes:
        qkv, qs, ks, cos, sin, mask = _ab_inputs(gen, b, n, c, h, dtype, mask_kind, device)
        d, f32 = c // h, dtype == "float32"
        isz = qkv.element_size()
        args = (qkv, qs, ks, cos, sin, mask)
        fwd = lambda: fa.fused_qkv_attention_mma(*args, num_heads=h)
        ref = fwd()
        new = lambda: fa.fused_qkv_attention(*args, num_heads=h, impl="fused")
        plain = fa.fused_qkv_attention_plain(*args, num_heads=h)
        live = mask.any(1)  # images with a valid key
        # rows held to #1's limits: valid rows, and every row of an image with
        # no valid key (each is the mean of v there: over N, or over the pack)
        valid = mask | ~live[:, None]
        errs = {"fused_attention_mma_f32" if f32 else "fused_attention_mma": _check_ab(f"#1 mma.sync {label}", ref,
                                                                                      plain, valid, f32)}
        if f32:  # the fp32 walker with one cell a block (W): every fp32 walker's bits, within 1e-5 of the FMA forward
            new_ref = _one_launch("fused_attention_bb_f32",
                                  lambda: abb.fused_attention_bb(*args, num_heads=h, bb=1, cg=d))
            walker_vs_b = _check_ab(f"fp32 walker vs #1 mma.sync {label}", new_ref, ref, valid, True)
            got = _one_launch("fused_attention_f32", new)  # #1 in fp32 at the split f32_walk_split picks
            if not torch.equal(got, new_ref):
                raise AssertionError(f"#1 fp32 at {label}: not bit-identical to the fp32 walker with one cell a block")
            errs["fused_attention_f32"] = _check_ab(f"#1 fp32 {label}", got, plain, valid, True)
            del got
        else:
            new_ref = new()
        q, k, v = _normed_qkv(qkv, qs, ks, cos, sin, b, n, h, d)
        am = mask[:, None, None, :]
        library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am)
        library_ms = time_ms(library)
        library_dev_ms = device_ms(library)
        del q, k, v
        plain_ms = time_ms(lambda: fa.fused_qkv_attention_plain(*args, num_heads=h), runs=3, warmup=1)
        bound = _ab_bound(b, n, c, h, mask, isz, split=f32)  # fp32: the walker's products
        row = dict(shape=label, B=b, N=n, C=c, H=h, dtype=dtype, mask=mask_kind, fused_ms=time_ms(fwd),
                   fused_plain_ms=plain_ms, library_ms=library_ms, library_device_ms=library_dev_ms,
                   bound_ms=bound[0], bound_by=bound[1], arms={})
        if f32:
            row["walker_max_abs_vs_mma"] = walker_vs_b
            row["fused_bound_ms"], row["fused_bound_by"] = _ab_bound(b, n, c, h, mask, isz)  # FMA products
            sms = torch.cuda.get_device_properties(device).multi_processor_count if device.type == "cuda" else 132
            row["f32_split"] = fa.f32_walk_split(b, n, h, d, sms)
            row["f32_ms"] = time_ms(new)
            fp32_device(new, "f32_device_ms", row)
            walk = lambda **kw: walk_f32(qkv, qs.float(), ks.float(), cos.float(), sin.float(), mask, h, **kw)
            # the forward's kernel alone at every split of up to four images: what f32_walk_split is held to
            row["f32_splits_ms"] = {f"{bb}x{hpb}": time_ms(lambda: walk(bb=bb, hpb=hpb, kind="fwd"))
                                    for bb in (1, 2, 4) if b % bb == 0 for hpb in range(1, h + 1) if h % hpb == 0}
        else:  # the redesigned forward, its prologue and its wgmma kernel alone beside the arms
            row["redesigned_max_abs_vs_mma"] = (new_ref.float() - ref.float()).abs()[valid].max().item()
            row.update(redesigned_ms=time_ms(new), redesigned_device_ms=device_ms(new),
                       redesigned_host_ahead_ms=host_ahead_ms(new))  # #12's yardstick: both by the same clock
            # the prologue as #1, #10, #11 and #13 run it (k alone), and with q, the rejected way to feed the walkers
            prologue = lambda with_q: fa.fused_qk_prologue(qkv, qs, ks, cos, sin, num_heads=h, with_q=with_q)
            row.update(prologue_qk_ms=time_ms(lambda: prologue(True)), prologue_k_ms=time_ms(lambda: prologue(False)))
            kn, _ = prologue(False)
            row["redesigned_kernel_ms"] = time_ms(lambda: fa._attend_sm90(qkv, kn, qs, cos, sin, mask, h, None))
            walk = lambda **kw: walk_sm90(qkv, kn, qs.float(), cos.float(), sin.float(), mask, h, **kw)
        # #10, every arm of ab_batch_block that this shape takes (B is #1 itself), and #11
        splits = [(name, bb, cg) for name, bb, cg, _ in abb.arm_defs(c, d, n, b, h) if cg is not None]
        try:
            abb.check_arm(qkv.shape, h, 2, 1536, pack=True)
        except ValueError:
            splits.append(("P2h", 2, c // 2))
        for name, bb, cg in splits:
            pack = name.startswith("P")
            try:
                abb.check_arm(qkv.shape, h, bb, cg, pack=pack)
            except ValueError:
                continue
            kname = ("fused_attention_pack" if pack else "fused_attention_bb") + ("_f32" if f32 else "")
            call = lambda: abb.fused_attention_bb(*args, num_heads=h, bb=bb, cg=cg, pack=pack)
            got = _one_launch(kname, call)
            rows_eq = live if pack else slice(None)
            if not torch.equal(got[rows_eq], new_ref[rows_eq]):
                raise AssertionError(f"{kname} {name} at {label}: not bit-identical to the "
                                     f"{'fp32 walker with one cell a block' if f32 else 'redesigned forward'}")
            want = plain if not pack else abb.fused_attention_bb_plain(*args, num_heads=h, bb=bb, cg=cg, pack=True)
            err = _check_ab(f"{kname} {name} {label}", got, want, valid, f32)
            errs[kname] = max(errs.get(kname, 0.0), err)
            arm = dict(bb=bb, cg=cg, ms=time_ms(call), max_abs_err=err)
            if pack or name == "D2":  # #11 and #10's recorded arm: device time, the walker alone, plain, bound
                arm["device_ms"] = host_ahead_ms(call) if f32 else device_ms(call)
                arm["kernel_ms"] = time_ms(lambda: walk(bb=bb, hpb=cg // d, pack=pack))
                arm["plain_ms"] = plain_ms if not pack else time_ms(
                    lambda: abb.fused_attention_bb_plain(*args, num_heads=h, bb=bb, cg=cg, pack=True), runs=3,
                    warmup=1)
                arm["bound_ms"], arm["bound_by"] = (bound if not pack else _ab_bound(
                    b, n, c, h, mask, isz, pairs=_pack_pairs(mask, n, bb), split=f32))
            row["arms"][name] = arm
            del got
        # #13
        kname = "fused_attention_contig_f32" if f32 else "fused_attention_contig"
        call = lambda: ab8.fused_attention_contig(*args, num_heads=h)
        got = _one_launch(kname, call)
        if not torch.equal(got, new_ref):
            raise AssertionError(f"{kname} at {label}: not bit-identical to the "
                                 f"{'fp32 walker with one cell a block' if f32 else 'redesigned forward'}")
        errs[kname] = _check_ab(f"contig {label}", got, plain, valid, f32)
        row["contig_ms"] = time_ms(call)
        if f32:
            fp32_device(call, "contig_device_ms", row)
        else:
            row["contig_device_ms"] = device_ms(call)
            row["contig_kernel_ms"] = time_ms(lambda: walk())
            del kn
        # #12, bf16 only: the int8 prologue (k), then the walk over int8 q and v tiles
        if not f32:
            codes, scale = ab8.quantize_qkv(qkv)
            q8args = (codes, scale, qs, ks, cos, sin, mask)
            call = lambda: ab8.fused_attention_q8in(*q8args, num_heads=h)
            got = _one_launch("fused_attention_q8in_prologue", lambda: _one_launch("fused_attention_q8in", call))
            # the chain it replaces: assemble the bf16 tensor, then the redesigned forward (X)
            chain = lambda: fa.fused_qkv_attention(ab8.assemble_q8in(codes, scale), qs, ks, cos, sin, mask,
                                                   num_heads=h, impl="fused")
            if not torch.equal(got, chain()):
                raise AssertionError(f"fused_attention_q8in at {label}: not bit-identical to the redesigned forward "
                                     "on the assembled tensor")
            q8plain = lambda: ab8.fused_attention_q8in_plain(*q8args, num_heads=h)
            errs["fused_attention_q8in"] = _check_ab(f"q8in {label}", got, q8plain(), valid, False)
            del got
            split = ab8.q8in_plan(b, n, c, h, fa._sm_count(device.index) if device.type == "cuda" else 132)
            prologue8 = lambda: ab8.q8in_k_prologue(codes, ks, cos, sin, num_heads=h)
            kn8 = prologue8()
            walk8 = lambda bb, hpb: ab8.walk_q8in(codes, scale, kn8, qs.float(), cos.float(), sin.float(), mask, h,
                                                  bb=bb, hpb=hpb)
            row.update(q8in_ms=time_ms(call), q8in_device_ms=host_ahead_ms(call),
                       q8in_kernel_ms=time_ms(lambda: walk8(*split)), q8in_prologue_ms=time_ms(prologue8),
                       q8in_plain_ms=time_ms(q8plain, runs=3, warmup=1), q8in_chain_ms=time_ms(chain),
                       q8in_split=split)
            # the kernel alone at every split of up to four images: what q8in_plan is held to
            row["q8in_splits_ms"] = {f"{bb}x{hpb}": time_ms(lambda: walk8(bb, hpb))
                                     for bb in (1, 2, 4) if b % bb == 0 for hpb in range(1, h + 1) if h % hpb == 0}
            del kn8
            row["q8in_bound_ms"], row["q8in_bound_by"] = _ab_bound(b, n, c, h, mask, 2, in_bytes=3 * c + 4)
        row["max_abs_err"] = errs
        rows.append(row)
        arms = ", ".join(f"{k} {a['ms']:.4f}" + (f" (dev {a['device_ms']:.4f}, plain {a['plain_ms']:.4f}, bound "
                                                     f"{a['bound_ms']:.5f}" + (f", walker alone {a['kernel_ms']:.4f}"
                                                                               if "kernel_ms" in a else "") + ")"
                                                     if "plain_ms" in a else "")
                         for k, a in row["arms"].items())
        log(f"  {label} (B={b} N={n} C={c} H={h}, mask {mask_kind}): mma.sync forward {row['fused_ms']:.4f} ms"
            + (f", redesigned {row['redesigned_ms']:.4f} (dev {row['redesigned_device_ms']:.4f}, wgmma kernel alone "
               f"{row['redesigned_kernel_ms']:.4f}; max |diff| {row['redesigned_max_abs_vs_mma']:.2e}; prologue k "
               f"{row['prologue_k_ms']:.4f}, q+k {row['prologue_qk_ms']:.4f})" if not f32 else
               f" (bound {row['fused_bound_ms']:.5f}, {row['fused_bound_by']}), fp32 walker (one cell a block) "
               f"max |diff| {row['walker_max_abs_vs_mma']:.2e}; #1 fp32 on the walker {row['f32_ms']:.4f} (split bb, "
               f"hpb {row['f32_split']}; dev {row['f32_device_ms']:.4f}, profiler {row['f32_device_ms_profiler'][0]:.4f} "
               f"from {row['f32_device_ms_profiler'][1]} of 5 records); its kernel alone by split bbxhpb ("
               + ", ".join(f"{k} {v:.4f}" for k, v in sorted(row["f32_splits_ms"].items(), key=lambda kv: kv[1])) + ")")
            + f", plain {plain_ms:.4f}, SDPA {library_ms:.4f} (dev {library_dev_ms:.4f}), bound {bound[0]:.5f} "
            f"({bound[1]}); contig {row['contig_ms']:.4f} (dev {row['contig_device_ms']:.4f}"
            + (f", walker alone {row['contig_kernel_ms']:.4f}" if not f32 else
               f", profiler {row['contig_device_ms_profiler'][0]:.4f} from {row['contig_device_ms_profiler'][1]} of 5 "
               f"records") + f"); arms (ms): {arms}"
            + (f"; q8in {row['q8in_ms']:.4f} (dev {row['q8in_device_ms']:.4f}, kernel alone at split bb, hpb "
               f"{row['q8in_split']} {row['q8in_kernel_ms']:.4f}, int8 prologue {row['q8in_prologue_ms']:.4f}, plain "
               f"{row['q8in_plain_ms']:.4f}, assemble + redesigned {row['q8in_chain_ms']:.4f}, the redesigned "
               f"forward with the host ahead {row['redesigned_host_ahead_ms']:.4f}, bound "
               f"{row['q8in_bound_ms']:.5f}; kernel alone by split bbxhpb: "
               + ", ".join(f"{k} {v:.4f}" for k, v in sorted(row["q8in_splits_ms"].items(), key=lambda kv: kv[1]))
               + ")" if not f32 else ""))
        log(f"    max |err| vs plain: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        del qkv, plain, ref, new_ref
        torch.cuda.empty_cache()
    attributes = {}
    if device.type == "cuda":  # what the compiler and the card make of each walker instance
        from vitok_torch.benchmarks import WALKER_KINDS, sm90_attributes

        for d in (64, 128):
            for kind in WALKER_KINDS:
                attributes[f"{kind} d{d}"] = sm90_attributes(d, kind, bb=2)
        log("  walkers, bb = 2 (registers, local bytes a thread, blocks an SM, shared bytes a block): "
            + "; ".join(f"{k} {a['registers']}, {a['local_bytes']}, {a['blocks_per_sm']}, {a['smem_bytes']}"
                        for k, a in attributes.items()))
    return dict(rows=rows, sm90_attributes=attributes)


def ab_entry_phase(device) -> dict:
    """Both A/B entry points at the recorded invocations' shapes with fewer
    timed runs (``AB_ENTRY_ARGS``): every arm builds, every numeric leg reads
    0 against the reference it names (in bf16 every arm but B the redesigned
    forward, X, as C of ab_q8_input; in fp32 the fp32 walker with one cell a
    block, W; A X on the assembled tensor), the
    reference's row is within its limit of arm B (X: #1's; W: AB_F32_MAX_REL
    of B's largest entry), and each kernel is launched exactly as often as
    the runs call it. Neither entry point runs #13 in fp32 (ab_q8_input is
    bf16 only), so its wrapper is then called ``--layers`` times at the
    recorded fp32 shape."""
    import torch
    from vitok_torch.benchmarks import ab_batch_block as abb
    from vitok_torch.benchmarks import ab_q8_input as ab8
    from vitok_torch.benchmarks import rope_inputs

    iters, layers = int(AB_ENTRY_ARGS[1]), int(AB_ENTRY_ARGS[3])
    per_arm = 1 + layers * (1 + iters)  # the numeric call, the warm-up run, the timed runs
    c, h, runs_at = AB_ENTRY
    reset_counts()
    runs = {}
    for dtype, n, b in runs_at:
        flags = ["--c", str(c), "--heads", str(h), "--tokens", str(n), "--batch", str(b), "--dtype", dtype,
                 *AB_ENTRY_ARGS]
        log(f"entry point: python -m vitok_torch.benchmarks.ab_batch_block {' '.join(flags)}")
        res = abb.main([*flags, "--device", device.type])
        ref = "X" if dtype == "bfloat16" else "W"
        if (res["skipped"] or len(res["arms"]) != 11 or any(v != 0.0 for v in res["numeric"].values())
                or set(res["references"]) != set(res["arms"]) - {"B"}
                or any(not r.startswith(ref) for r in res["references"].values())):
            raise AssertionError(f"ab_batch_block {dtype}: skipped {res['skipped']}, arms {list(res['arms'])}, "
                                 f"numeric {res['numeric']}, references {res['references']}")
        _check_reference_row(f"ab_batch_block {dtype}", res, dtype == "bfloat16")
        runs[f"ab_batch_block {dtype}"] = res
    _, n, b = runs_at[0]
    flags = ["--c", str(c), "--heads", str(h), "--tokens", str(n), "--batch", str(b), *AB_ENTRY_ARGS]
    log(f"entry point: python -m vitok_torch.benchmarks.ab_q8_input {' '.join(flags)}")
    res = ab8.main([*flags, "--device", device.type])
    if (res["numeric"]["A_assembled"] != 0.0 or res["numeric"]["C"] != 0.0
            or not res["references"]["C"].startswith("X") or not res["references"]["A_assembled"].startswith("X")):
        raise AssertionError(f"ab_q8_input numeric legs {res['numeric']}, references {res['references']}")
    _check_reference_row("ab_q8_input", res, True)
    runs["ab_q8_input"] = res
    f32_runs = [(n, b) for dtype, n, b in runs_at if dtype == "float32"]
    for n, b in f32_runs:
        gen = torch.Generator().manual_seed(0)
        qkv = torch.randn(b, n, 3 * c, generator=gen).to(device)
        q_scale, k_scale, cos, sin = rope_inputs(b, n, c // h, device, gen)
        mask = torch.ones(b, n, dtype=torch.bool, device=device)
        log(f"#13 in fp32 through its wrapper, {layers} calls at C {c}, N {n}, B {b}")
        for _ in range(layers):
            ab8.fused_attention_contig(qkv, q_scale, k_scale, cos, sin, mask, num_heads=h)
        torch.cuda.synchronize()
        del qkv
    launches = launch_counts()
    # per ab_batch_block run: B on the mma.sync forward (its FMA instance in fp32), nine arms on #10
    # and P2 on #11 (bf16: the wgmma walker after the q/k prologue; fp32: the fp32 walker), and the
    # reference: in bf16 the redesigned forward's row, in fp32 one call of the fp32 walker with one
    # cell a block; ab_q8_input: one arm each (A after its int8 prologue, C after the prologue), the
    # redesigned forward once more on the assembled tensor, and the redesigned forward's row; then
    # #13 in fp32
    bf16_runs = sum(dtype == "bfloat16" for dtype, _, _ in runs_at)
    f32_bb_runs = len(runs_at) - bf16_runs
    walkers = bf16_runs * 10 * per_arm + per_arm  # the bf16 #10, #11 and #13 launches, each after a prologue
    expect = _expect(fused_attention_bb=bf16_runs * 9 * per_arm, fused_attention_pack=bf16_runs * per_arm,
                     fused_attention_bb_f32=f32_bb_runs * (9 * per_arm + 1),
                     fused_attention_pack_f32=f32_bb_runs * per_arm,
                     fused_attention_mma=bf16_runs * per_arm + per_arm,
                     fused_attention_mma_f32=f32_bb_runs * per_arm,
                     fused_attention=(bf16_runs + 1) * per_arm + 1, fused_attention_q8in=per_arm,
                     fused_attention_q8in_prologue=per_arm,
                     fused_attention_contig=per_arm, fused_attention_contig_f32=len(f32_runs) * layers,
                     fused_qk_prologue=(bf16_runs + 1) * per_arm + 1 + walkers)
    if launches != expect:
        raise AssertionError(f"A/B entry points: launches {launches}, expected {expect}")
    log(f"  launches: {dict((k, v) for k, v in launches.items() if v)}")
    return dict(runs=runs, launches=launches)


def _check_reference_row(what, res, bf16: bool) -> None:
    """An entry point's reference against arm B: in bf16 the redesigned
    forward's timed row, within #1's limit; in fp32 (ab_batch_block) the fp32
    walker's, within AB_F32_MAX_REL of B's largest entry. Neither in the
    other type."""
    row, walker = res.get("redesigned"), res.get("walker_f32")
    if bf16:
        ok = walker is None and row is not None and row["max_abs_vs_B"] <= KERNEL_MAX_ABS
    else:
        ok = row is None and walker is not None and walker["max_abs_vs_B"] <= AB_F32_MAX_REL * walker["max_abs_B"]
    if not ok:
        raise AssertionError(f"{what}: reference rows {row}, {walker} (bf16: the redesigned forward's, max |X-B| <= "
                             f"{KERNEL_MAX_ABS}; fp32: the fp32 walker's, max |W-B| <= {AB_F32_MAX_REL} x max |B|)")


def f32_ae_phase(device, card: str) -> dict:
    """350M in fp32 at 256p: every block's attention on the fp32 forward (the
    fp32 walker), by the launch count and by the kernels the profiler
    records in one forward, decoded patches within F32_MODEL_REL_L2 of the
    same weights on the unfused composition."""
    import torch
    from vitok_torch import AE, decode_variant

    name, max_tokens, batch, sizes = F32_AE
    cases = main_path_cases(device, resolutions=(F32_AE,), seed=3)
    cfg_kw = decode_variant(VARIANT)
    model = AE(**cfg_kw, seed=0, device=device, compute_dtype=torch.float32)
    _random_gates(model, device)
    reference = AE(**{**cfg_kw, "attn_impl": "xla"}, state_dict=model.state_dict(), device=device,
                   compute_dtype=torch.float32)
    depth = model.cfg.encoder_depth + model.cfg.decoder_depth
    log(f"fp32 path: {VARIANT} with compute_dtype float32, {name} batch {batch}")
    outs, launches = _run_counted(model, cases, _expect(fused_attention_f32=depth), "fp32")
    inputs = cases[0][4]
    out = outs[0]
    if out["patches"].dtype != torch.float32:
        raise AssertionError(f"fp32 AE decoded {out['patches'].dtype}")
    _check_output(name, max_tokens, batch, cases[0][3], inputs, out)
    rel = _valid_rel_l2(out, reference.decode(reference.encode(inputs)), inputs)
    if not rel <= F32_MODEL_REL_L2:
        raise AssertionError(f"fp32 AE: rel L2 vs the unfused composition {rel:.3e} > {F32_MODEL_REL_L2}")
    ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=3, warmup=1)
    ref_ms = time_ms(lambda: reference.decode(reference.encode(inputs)), runs=3, warmup=1)
    log(f"  {depth} launches of the fp32 forward a forward; rel L2 vs unfused {rel:.3e} (limit "
        f"{F32_MODEL_REL_L2}); encode+decode {ms / batch:.4f} ms/img (unfused {ref_ms / batch:.4f}) on {card}")
    # The profiler may keep only some of a session's kernel records (PERF.md section 7): no attention
    # kernel but the fp32 forward's may appear, and one of three profiles must show all its launches.
    for _ in range(3):
        profiled = profile_step(f"fp32 {name}", lambda: model.decode(model.encode(inputs)))
        attention = {g: k for g, k in profiled.items() if g.startswith("fused_attention")}
        if set(attention) - {"fused_attention_f32"}:
            raise AssertionError(f"fp32 AE: the profiler recorded the attention kernels {attention} in one forward")
        if attention == {"fused_attention_f32": depth}:
            break
    else:
        raise AssertionError(f"fp32 AE: no profile recorded fused_attention_f32_sm90_kernel {depth} times in one "
                             f"forward (last: {attention})")
    del model, reference
    return dict(launches=launches["fused_attention_f32"], rel_l2=rel, ms_per_img=ms / batch,
                unfused_ms_per_img=ref_ms / batch, profiled_launches=attention)


def f32_int8_phase(device, card: str, f32_ae: dict) -> dict:
    """350M with fp32 compute, ``AE.quantize()``d, at the fp32 AE's cell: each
    block one fp32 forward (#1 on the fp32 walker), one RMSNorm + quantize
    (#9's fp32 instance) and one fused FFN (#7, int8 in and out); decoded
    patches within MODEL_REL_L2 of the same model on the quantize kernels'
    plain versions."""
    import torch
    from vitok_torch import AE, decode_variant

    name, max_tokens, batch, sizes = F32_AE
    cases = main_path_cases(device, resolutions=(F32_AE,), seed=3)
    model = AE(**decode_variant(VARIANT), seed=0, device=device, compute_dtype=torch.float32)
    _random_gates(model, device)
    model.quantize()
    depth = model.cfg.encoder_depth + model.cfg.decoder_depth
    log(f"fp32 int8 path: {VARIANT} with compute_dtype float32 after AE.quantize(), {name} batch {batch}")
    expect = _expect(fused_attention_f32=depth, rmsnorm_quant=depth, ffn_int8=depth)
    (out,), launches = _run_counted(model, cases, expect, "fp32 int8")
    inputs = cases[0][4]
    if out["patches"].dtype != torch.float32:
        raise AssertionError(f"fp32 int8 AE decoded {out['patches'].dtype}")
    _check_output(name, max_tokens, batch, cases[0][3], inputs, out)
    with plain_quant_kernels():
        rel = _valid_rel_l2(out, model.decode(model.encode(inputs)), inputs)
    if not rel <= MODEL_REL_L2:
        raise AssertionError(f"fp32 int8 AE: rel L2 vs the plain versions {rel:.3e} > {MODEL_REL_L2}")
    ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=3, warmup=1)
    log(f"  fp32 int8 {name}: {depth} launches each of the fp32 forward, rmsnorm_quant and ffn_int8 a forward; rel "
        f"L2 vs plain versions {rel:.3e}; encode+decode {ms / batch:.4f} ms/img (the fp32 AE "
        f"{f32_ae['ms_per_img']:.4f}) on {card}")
    profile_step(f"fp32 int8 {name}", lambda: model.decode(model.encode(inputs)))
    del model
    return dict(launches=launches, rel_l2_vs_plain=rel, ms_per_img=ms / batch, f32_ms_per_img=f32_ae["ms_per_img"])


def ab_entries(abkern: dict, ab_runs: dict, f32_ae: dict, kern: dict) -> list:
    """Kernels-line entries of #10-#13 (times at the recorded bf16 shape, C =
    3072, N = 256, B = 64; #10 the D2 arm, every arm beside it; #10, #11 and
    #13 in bf16 with their device times, the walkers alone on the prologue's
    k, the q/k prologue they run first, and the walker instances' registers,
    spills and blocks an SM), of #10, #11 and #13 in fp32 on the fp32 walker
    (times at the recorded fp32 shape, N = 64, B = 256), of #12 (the int8
    prologue and the walk over int8 q and v tiles: its device time, the
    kernel alone at its plan's split and at every split, the prologue alone,
    the chain it replaces as its library column, the 350M width beside it),
    of the mma.sync forward (arm B; times at the 512p main shape, as #1's),
    of the fp32 forward #1 on the fp32 walker (the recorded fp32 shape, and
    the 350M fp32 shape beside it) and of the kept FMA instance of the
    mma.sync forward (the same shapes); launches from the A/B entry points'
    runs, the fp32 forward's from the fp32 AE."""
    bf = next(r for r in abkern["rows"] if r["shape"] == "5B@256t bf16")
    f32 = next(r for r in abkern["rows"] if r["shape"] == "5B@64t fp32")
    f32_350m = next(r for r in abkern["rows"] if r["shape"] == "350M@256t fp32")
    q8_350m = next(r for r in abkern["rows"] if r["shape"] == "350M@256t bf16")
    errs = {}
    for r in abkern["rows"]:
        for k, v in r["max_abs_err"].items():
            errs[k] = max(errs.get(k, 0.0), v)
    launches = ab_runs["launches"]
    src = "vitok_torch/csrc/fused_attention_q8in_sm90.cu"
    src_sm90, src_f32 = "vitok_torch/csrc/fused_attention_ab_sm90.cu", "vitok_torch/csrc/fused_attention_ab_f32_sm90.cu"
    bb, pack, bb32, pack32 = bf["arms"]["D2"], bf["arms"]["P2"], f32["arms"]["D2"], f32["arms"]["P2"]
    head = next(r for r in kern["rows"] if r["shape"] == "350M@512p main" and r["case"] == "tail")
    walker = dict(prologue_k_ms=bf["prologue_k_ms"], prologue_qk_ms=bf["prologue_qk_ms"],
                  redesigned_forward_ms=bf["redesigned_ms"], redesigned_forward_device_ms=bf["redesigned_device_ms"],
                  redesigned_kernel_ms=bf["redesigned_kernel_ms"], library_device_ms=bf["library_device_ms"])
    attributes = lambda kind: {k: a for k, a in abkern["sm90_attributes"].items() if k.startswith(kind + " ")}
    arm_entry = lambda arm, row: {
        "ms": arm["ms"], "device_ms": arm["device_ms"], "kernel_ms": arm["kernel_ms"], "plain_ms": arm["plain_ms"],
        "bound_ms": arm["bound_ms"], "bound_by": arm["bound_by"], "library_ms": row["library_ms"]}
    return [{
        "name": "fused_attention_mma", "route": "cuda", "source": "vitok_torch/csrc/fused_attention.cu",
        "replaces": "vitok_tpu/ops/fused_attention.py:317", "launches": launches["fused_attention_mma"],
        "max_abs_err": kern["worst"]["fused_attention_mma"], "ms": head["mma_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "ab_bf16_ms": bf["fused_ms"], "ab_bf16_redesigned_ms": bf["redesigned_ms"],
    }, {
        "name": "fused_attention_bb", "route": "cuda", "source": src_sm90,
        "replaces": "benchmarks/ab_batch_block.py:78", "launches": launches["fused_attention_bb"],
        "max_abs_err": errs["fused_attention_bb"], **arm_entry(bb, bf), **walker,
        "arm": "D2 (bb=2, cg=1536)", "arms_ms": {k: a["ms"] for k, a in bf["arms"].items()},
        "attributes": attributes("bb"),
    }, {
        "name": "fused_attention_bb_f32", "route": "cuda", "source": src_f32,
        "replaces": "benchmarks/ab_batch_block.py:78", "launches": launches["fused_attention_bb_f32"],
        "max_abs_err": errs["fused_attention_bb_f32"], **arm_entry(bb32, f32),
        "arm": "D2 (bb=2, cg=1536)", "arms_ms": {k: a["ms"] for k, a in f32["arms"].items()},
        "max_abs_vs_fused_attention_f32": f32["walker_max_abs_vs_mma"], "attributes": attributes("bb_f32"),
    }, {
        "name": "fused_attention_pack", "route": "cuda", "source": src_sm90,
        "replaces": "benchmarks/ab_batch_block.py:105", "launches": launches["fused_attention_pack"],
        "max_abs_err": errs["fused_attention_pack"], **arm_entry(pack, bf), **walker,
        "attributes": attributes("pack"),
    }, {
        "name": "fused_attention_pack_f32", "route": "cuda", "source": src_f32,
        "replaces": "benchmarks/ab_batch_block.py:105", "launches": launches["fused_attention_pack_f32"],
        "max_abs_err": errs["fused_attention_pack_f32"], **arm_entry(pack32, f32),
        "attributes": attributes("pack_f32"),
    }, {
        "name": "fused_attention_q8in", "route": "cuda", "source": src,
        "replaces": "benchmarks/ab_q8_input.py:64", "launches": launches["fused_attention_q8in"],
        "prologue_launches": launches["fused_attention_q8in_prologue"],  # the q/k prologue's int8 instance
        "max_abs_err": errs["fused_attention_q8in"], "ms": bf["q8in_ms"], "device_ms": bf["q8in_device_ms"],
        "kernel_ms": bf["q8in_kernel_ms"], "prologue_ms": bf["q8in_prologue_ms"], "split": bf["q8in_split"],
        "splits_ms": bf["q8in_splits_ms"], "plain_ms": bf["q8in_plain_ms"],
        "bound_ms": bf["q8in_bound_ms"], "bound_by": bf["q8in_bound_by"],
        "library_ms": bf["q8in_chain_ms"],  # no one library call: assemble + the redesigned forward, which it replaces
        "redesigned_forward_ms": bf["redesigned_ms"], "redesigned_forward_device_ms": bf["redesigned_host_ahead_ms"],
        "attributes": attributes("q8in"),
        **{k + "_350m": q8_350m[k2] for k, k2 in (("ms", "q8in_ms"), ("device_ms", "q8in_device_ms"),
                                                 ("kernel_ms", "q8in_kernel_ms"), ("prologue_ms", "q8in_prologue_ms"),
                                                 ("library_ms", "q8in_chain_ms"), ("bound_ms", "q8in_bound_ms"),
                                                 ("redesigned_forward_ms", "redesigned_ms"),
                                                 ("redesigned_forward_device_ms", "redesigned_host_ahead_ms"),
                                                 ("split", "q8in_split"), ("splits_ms", "q8in_splits_ms"))},
    }, {
        "name": "fused_attention_contig", "route": "cuda", "source": src_sm90,
        "replaces": "benchmarks/ab_q8_input.py:164", "launches": launches["fused_attention_contig"],
        "max_abs_err": errs["fused_attention_contig"], "ms": bf["contig_ms"], "device_ms": bf["contig_device_ms"],
        "kernel_ms": bf["contig_kernel_ms"],
        "plain_ms": bf["fused_plain_ms"], "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
        "library_ms": bf["library_ms"], **walker,
        "attributes": attributes("contig"),
    }, {
        "name": "fused_attention_contig_f32", "route": "cuda", "source": src_f32,
        "replaces": "benchmarks/ab_q8_input.py:164", "launches": launches["fused_attention_contig_f32"],
        "max_abs_err": errs["fused_attention_contig_f32"], "ms": f32["contig_ms"],
        "device_ms": f32["contig_device_ms"], "profiler_ms_records": f32["contig_device_ms_profiler"],
        "plain_ms": f32["fused_plain_ms"], "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"], "fma_forward_ms": f32["fused_ms"], "attributes": attributes("contig_f32"),
        "ms_350m": f32_350m["contig_ms"],
    }, {
        "name": "fused_attention_f32", "route": "cuda", "source": src_f32,
        "replaces": "vitok_tpu/ops/fused_attention.py:317", "launches": f32_ae["launches"],
        "profiled_launches": f32_ae["profiled_launches"],
        "max_abs_err": errs["fused_attention_f32"], "ms": f32["f32_ms"], "device_ms": f32["f32_device_ms"],
        "profiler_ms_records": f32["f32_device_ms_profiler"], "split": f32["f32_split"],
        "plain_ms": f32["fused_plain_ms"], "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"], "fma_forward_ms": f32["fused_ms"],
        "fastest_arm_ms": min(a["ms"] for k, a in f32["arms"].items() if not k.startswith("P")),
        "attributes": attributes("fwd_f32"),
        "splits_ms": f32["f32_splits_ms"], "splits_ms_350m": f32_350m["f32_splits_ms"],
        "ms_350m": f32_350m["f32_ms"], "split_350m": f32_350m["f32_split"],
        "device_ms_350m": f32_350m["f32_device_ms"], "bound_ms_350m": f32_350m["bound_ms"],
        "bound_by_350m": f32_350m["bound_by"], "plain_ms_350m": f32_350m["fused_plain_ms"],
        "library_ms_350m": f32_350m["library_ms"], "fma_forward_ms_350m": f32_350m["fused_ms"],
        "ae_ms_per_img": f32_ae["ms_per_img"], "ae_unfused_ms_per_img": f32_ae["unfused_ms_per_img"],
    }, {
        "name": "fused_attention_mma_f32", "route": "cuda", "source": "vitok_torch/csrc/fused_attention.cu",
        "replaces": "vitok_tpu/ops/fused_attention.py:317", "launches": launches["fused_attention_mma_f32"],
        "max_abs_err": errs["fused_attention_mma_f32"], "ms": f32["fused_ms"], "plain_ms": f32["fused_plain_ms"],
        "bound_ms": f32["fused_bound_ms"], "bound_by": f32["fused_bound_by"], "library_ms": f32["library_ms"],
        "ms_350m": f32_350m["fused_ms"], "bound_ms_350m": f32_350m["fused_bound_ms"],
    }]


# ---------------------------------------------------------------------------
# Eval: the eval CLI in-process, and the perceptual training step
# ---------------------------------------------------------------------------

EVAL_MODEL = "350M-f16x64"  # the released name; its variant is VARIANT, with random weights
EVAL_IMAGES = 256
EVAL_BATCH = 64
EVAL_SIZES = [(256, 256), (240, 200), (192, 256), (256, 160), (100, 130), (224, 224), (256, 96), (180, 256)]
EVAL_BUCKET_IMAGES = 32  # a second folder, sizes up to 512 px: every bucket of 64, 256 and 1024 tokens
EVAL_BUCKET_SIZES = [(512, 512), (480, 360), (304, 512), (200, 330), (256, 256), (100, 130), (64, 64), (48, 80)]
EVAL_ARGS = ("--random-weights", "--metrics", "ssim,psnr,fid,fdd")
EVAL_FEATURE_CHECK = 4  # images whose InceptionV3 and DINO features are held against the CPU's
FEATURE_REL_L2 = 1e-4   # fp32 features, TF32 off: card against host
# The references' FID against themselves, over the trace of their covariance: the
# fp64 sqrtm of the square of a rank-255 covariance in 2048 dimensions leaves about
# 1e-6 of the trace (-1.06e-6 on the host for these images' random-init features).
SELF_FID_REL = 1e-5
INT8_SSIM_GAP = 1e-2    # int8 run's SSIM against its references, beside the bf16 run's
PERCEPTUAL = ("256p", 256, 8, RESOLUTIONS[0][3])  # 350M trainer, 2048 tokens a step
PERCEPTUAL_STEPS = 3


def _write_folder(root: str, n: int, sizes, seed: int) -> str:
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    for i, img in enumerate(_images(np.random.default_rng(seed), sizes, n)):
        img.save(os.path.join(root, f"img_{i:04d}.png"))
    return root


@contextlib.contextmanager
def _eval_instruments(rec: dict):
    """Records, for one eval run: the launch counts of each batch (encode to
    decode), each backbone's feature seconds and images, and ``gather()``'s
    seconds and the calculator (a switch of this script, not of the package)."""
    import torch
    from vitok_torch import eval_features as ef
    from vitok_torch import metrics
    from vitok_torch.models.ae import AE

    saved = AE.encode, AE.decode, ef.inception_feature_fn, ef.dino_feature_fn, metrics.MetricCalculator.gather
    enc, dec, inc, dino, gather = saved
    before: list = []

    def encode(self, d):
        torch.cuda.synchronize()
        before[:] = [launch_counts()]
        return enc(self, d)

    def decode(self, d):
        out = dec(self, d)
        torch.cuda.synchronize()
        rec["batches"].append({k: v - before[0][k] for k, v in launch_counts().items()})
        return out

    def timed(name, factory):
        def make(*a, **kw):
            fn = factory(*a, **kw)

            def features(images):
                t0 = time.perf_counter()
                out = fn(images)  # numpy: the card has finished
                seconds, count = rec["features"].get(name, (0.0, 0))
                rec["features"][name] = (seconds + time.perf_counter() - t0, count + len(images))
                return out
            return features
        return make

    def timed_gather(self):
        t0 = time.perf_counter()
        out = gather(self)
        rec["gather_s"], rec["calc"] = time.perf_counter() - t0, self
        return out

    rec.update(batches=[], features={})
    AE.encode, AE.decode = encode, decode
    ef.inception_feature_fn, ef.dino_feature_fn = timed("inception", inc), timed("dino", dino)
    metrics.MetricCalculator.gather = timed_gather
    try:
        yield rec
    finally:
        AE.encode, AE.decode, ef.inception_feature_fn, ef.dino_feature_fn, metrics.MetricCalculator.gather = saved


def _eval_run(what: str, argv: list, per_batch: dict, card: str) -> dict:
    """One ``eval_vae.main(argv)``: every count 0 before it, each batch's
    launches ``per_batch``, finite statistics; logs the rates and segments."""
    from vitok_torch.scripts import eval_vae

    rec: dict = {}
    reset_counts()  # the eval path's run
    t0 = time.perf_counter()
    with _eval_instruments(rec):
        stats = eval_vae.main(argv)
    seconds = time.perf_counter() - t0
    bad = [i for i, got in enumerate(rec["batches"]) if got != per_batch]
    if bad or not rec["batches"]:
        raise AssertionError(f"eval {what}: launches of batch {bad[:1]}: "
                             f"{rec['batches'][bad[0]] if bad else 'no batch'}, expected {per_batch}")
    numbers = {k: v for k, v in stats.items() if k in ("ssim", "psnr", "fid", "fdd")}
    if not all(np.isfinite(v) for v in numbers.values()):
        raise AssertionError(f"eval {what}: statistics {numbers} must be finite")
    feats = ", ".join(f"{name} {s / n * 1e3:.4f} ms/img ({n} images)" for name, (s, n) in rec["features"].items())
    log(f"  eval {what}: {int(stats['n_images'])} images in {len(rec['batches'])} batches, "
        + ", ".join(f"{k} {v:.6g}" for k, v in numbers.items())
        + f"; device {stats['throughput_img_per_sec']:.1f} img/s, wall {stats['wall_img_per_sec']:.1f} img/s "
        f"(steady {stats['steady_img_per_sec'] or float('nan'):.1f}); segments: data {stats['host_data_time_s']:.3f} s, "
        f"device {stats['device_time_s']:.3f} s, post {stats['host_post_time_s']:.3f} s of {stats['wall_time_s']:.3f} s; "
        f"features: {feats}; gather() {rec['gather_s']:.3f} s; main() {seconds:.1f} s on {card}")
    return dict(stats=stats, batches=len(rec["batches"]), launches=launch_counts(), calc=rec["calc"],
                features={k: s / n * 1e3 for k, (s, n) in rec["features"].items()}, gather_s=rec["gather_s"],
                seconds=seconds)


def _features_vs_cpu(folder: str, device, card: str) -> dict:
    """The first images' InceptionV3 and DINO ViT-B/16 features on the card
    against the same modules and weights on the CPU (TF32 off)."""
    import torch
    import warnings
    from PIL import Image
    from vitok_torch import eval_features as ef

    names = sorted(os.listdir(folder))[:EVAL_FEATURE_CHECK]
    images = [torch.from_numpy(np.asarray(Image.open(os.path.join(folder, n)), np.float32)
                               .transpose(2, 0, 1) / 127.5 - 1.0) for n in names]
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-init warnings, logged once by the eval runs
        for name, factory in (("inception", ef.inception_feature_fn), ("dino", ef.dino_feature_fn)):
            got = factory(device=device)([x.to(device) for x in images])
            want = factory(device="cpu")(images)
            rel = float(np.linalg.norm(got.astype(np.float64) - want) / np.linalg.norm(want))
            if not rel <= FEATURE_REL_L2:
                raise AssertionError(f"eval {name} features, card vs CPU: rel L2 {rel:.3e} > {FEATURE_REL_L2}")
            out[name] = rel
    log(f"  features of {len(images)} images, card vs CPU (fp32, TF32 off): "
        + ", ".join(f"{k} rel L2 {v:.3e}" for k, v in out.items()) + f" on {card}")
    return out


def eval_phase(device, card: str) -> dict:
    """``vitok_torch.scripts.eval_vae.main`` in this process: the full-width
    350M model (random weights) over 256 seeded images at 256p, batch 64,
    with SSIM, PSNR, FID (the full InceptionV3) and FDD (the full DINO
    ViT-B/16 at 512²), in bf16 and with ``--quant``; then a ``--buckets``
    run over 32 images that takes #1 at 64, 256 and 1024 tokens."""
    import tempfile
    from vitok_torch import AEConfig
    from vitok_torch.metrics import calculate_frechet_distance

    from vitok_torch.pretrained import get_pretrained_info

    cfg = AEConfig.from_variant(get_pretrained_info(EVAL_MODEL)[2] if EVAL_MODEL[0].isdigit() else EVAL_MODEL)
    depth = cfg.encoder_depth + cfg.decoder_depth
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        folder = _write_folder(os.path.join(tmp, "eval"), EVAL_IMAGES, EVAL_SIZES, seed=21)
        bucket_folder = _write_folder(os.path.join(tmp, "buckets"), EVAL_BUCKET_IMAGES, EVAL_BUCKET_SIZES, seed=22)
        log(f"eval path: {EVAL_IMAGES} images up to 256 px, 350M-f16x64 ({VARIANT}) random weights, "
            f"batch {EVAL_BATCH}, SSIM/PSNR/FID/FDD (InceptionV3 at 299², DINO ViT-B/16 at 512², random inits); "
            f"wrote the images in {time.time() - t0:.1f} s")
        base = ["--model", EVAL_MODEL, "--data", folder, *EVAL_ARGS, "--max-size", "256",
                "--batch-size", str(EVAL_BATCH), "--device", str(device)]
        bf16 = _eval_run("bf16", base, _expect(fused_attention=depth), card)
        int8 = _eval_run("int8", [*base, "--quant"],
                         _expect(fused_attention=depth, rmsnorm_quant=depth, ffn_int8=depth), card)
        buckets = _eval_run("buckets", ["--model", EVAL_MODEL, "--data", bucket_folder, "--random-weights",
                                        "--metrics", "ssim,psnr,fdd", "--buckets", "64,256,1024",
                                        "--max-size", "512", "--batch-size", str(EVAL_BATCH),
                                        "--device", str(device)],
                            _expect(fused_attention=depth), card)
        feature_rel = _features_vs_cpu(folder, device, card)

    for run in (bf16, int8):
        if run["stats"]["n_images"] != EVAL_IMAGES:
            raise AssertionError(f"eval: {run['stats']['n_images']} images, expected {EVAL_IMAGES}")
    if buckets["stats"]["n_images"] != EVAL_BUCKET_IMAGES or buckets["batches"] != 3:
        raise AssertionError(f"eval --buckets: {buckets['stats']['n_images']} images in {buckets['batches']} "
                             f"batches, expected {EVAL_BUCKET_IMAGES} in 3 (one per bucket)")
    t1 = time.perf_counter()
    mu, cov = bf16["calc"]._frechet["fid"][0].finalize()
    self_fid = calculate_frechet_distance(mu, cov, mu, cov)
    self_fid_s = time.perf_counter() - t1
    if not abs(self_fid) <= SELF_FID_REL * np.trace(cov):
        raise AssertionError(f"eval: FID of the references against themselves {self_fid:.3e} > "
                             f"{SELF_FID_REL} x trace {np.trace(cov):.3e}")
    gap = abs(int8["stats"]["ssim"] - bf16["stats"]["ssim"])
    if not gap <= INT8_SSIM_GAP:
        raise AssertionError(f"eval: int8 SSIM {int8['stats']['ssim']:.5f} vs bf16 {bf16['stats']['ssim']:.5f}")
    log(f"  references' FID against themselves {self_fid:.3e} (trace of their covariance {np.trace(cov):.3e}; "
        f"{self_fid_s:.3f} s); int8 SSIM {int8['stats']['ssim']:.6f} vs bf16 {bf16['stats']['ssim']:.6f}")
    for run in (bf16, int8, buckets):
        del run["calc"]
    return dict(bf16=bf16, int8=int8, buckets=buckets, feature_rel_l2=feature_rel, self_fid=self_fid,
                seconds=time.time() - t0)


@contextlib.contextmanager
def plain_fused_backward():
    """The fused autograd Function's backward swapped for its plain version
    (the forward kernel stays): the reference for the gradients."""
    from vitok_torch.ops import fused_attention as fa

    saved = fa.fused_qkv_attention_bwd
    fa.fused_qkv_attention_bwd = lambda *a, lse=None, **kw: fa.fused_qkv_attention_bwd_plain(*a, **kw)
    try:
        yield
    finally:
        fa.fused_qkv_attention_bwd = saved


def perceptual_phase(device, card: str) -> dict:
    """The 350M trainer with the DINO perceptual term: 256 tokens, batch 8,
    ``attn_impl="fused"``, Charbonnier + SSIM 0.1 + perceptual 500 on 256²
    tiles through a random DINO ViT-S, three steps."""
    import torch
    import warnings
    from vitok_torch import AE, decode_variant
    from vitok_torch.models.vit_features import load_dino_backbone, make_dino_feature_fn
    from vitok_torch.train_lib import (LossConfig, compute_loss, create_optimizer, create_schedule,
                                       create_train_state, make_train_step)

    t0 = time.time()
    model = AE(**{**decode_variant(VARIANT), "attn_impl": "fused"}, seed=0, device=device,
               param_dtype=torch.float32, trainable=True)
    _random_gates(model, device)
    depth = model.cfg.encoder_depth + model.cfg.decoder_depth
    params = list(model.parameters())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dino = load_dino_backbone(None, size="S", device=device)
    feature_fn = make_dino_feature_fn(dino, target_size=256)
    (case,) = main_path_cases(device, [PERCEPTUAL], seed=9)
    name, max_tokens, batch, _, inputs = case
    side = int(max_tokens ** 0.5)
    loss_cfg = LossConfig(ssim_weight=0.1, perceptual_weight=500.0, tile_size=256, n_tiles=2, ssim_grid=(side, side))
    log(f"perceptual training: {VARIANT}, fp32 master weights, bf16 compute, {name} batch {batch}, "
        f"attn_impl='fused', Charbonnier 1.0 + SSIM 0.1 + perceptual 500 (DINO ViT-S/16 random init, fp32, 256² tiles)")

    def grads_of():
        gen = torch.Generator(device=device).manual_seed(13)
        loss, metrics = compute_loss(model, inputs, loss_cfg, gen, feature_fn=feature_fn)
        return loss.detach(), metrics, torch.autograd.grad(loss, params)

    def rel_l2(got, want):
        num = sum((a.double() - b.double()).square().sum() for a, b in zip(got, want))
        return (num / sum(b.double().square().sum() for b in want)).sqrt().item()

    reset_counts()
    loss_k, metrics_k, g_kernel = grads_of()
    first = launch_counts()
    with plain_fused_backward():
        loss_p, _, g_plain = grads_of()
    torch.cuda.synchronize()
    grad_rel = rel_l2(g_kernel, g_plain)
    want = _expect(fused_attention=depth, fused_attention_bwd=depth)
    frozen = all(p.grad is None and not p.requires_grad for p in dino.parameters())
    if not (first == want and grad_rel <= TRAIN_GRAD_REL_L2 and frozen and float(metrics_k["loss/perceptual"]) > 0
            and abs(loss_k.item() - loss_p.item()) <= 1e-6 * abs(loss_p.item())):
        raise AssertionError(
            f"perceptual training: launches {first} (expected {want}), gradients vs the plain backward rel L2 "
            f"{grad_rel:.3e} (limit {TRAIN_GRAD_REL_L2}), DINO frozen {frozen}, perceptual "
            f"{float(metrics_k['loss/perceptual'])}, loss {loss_k.item()} vs {loss_p.item()}")
    del g_kernel, g_plain
    log(f"  first-step gradients, kernels vs plain backward: rel L2 {grad_rel:.3e}; loss {loss_k.item():.5f} "
        f"(perceptual {float(metrics_k['loss/perceptual']):.6f}); no DINO parameter has a gradient")

    tx = create_optimizer(create_schedule("constant", TRAIN_LR, PERCEPTUAL_STEPS, warmup_frac=0.0))
    train_step = make_train_step(tx, loss_cfg, feature_fn=feature_fn)
    reset_counts()  # the perceptual training path's run
    state, metrics, step_ms, per_step = _timed_steps(train_step, create_train_state(model, tx), inputs,
                                                     PERCEPTUAL_STEPS)
    if any(got != want for got in per_step):
        raise AssertionError(f"perceptual training: launches per step {per_step}, expected {want}")
    if not all(np.isfinite(list(m.values())).all() and m["loss/perceptual"] > 0 for m in metrics):
        raise AssertionError(f"perceptual training: metrics {metrics} must be finite, with a perceptual term > 0")
    log(f"  {PERCEPTUAL_STEPS} steps: loss " + " -> ".join(f"{m['loss/total']:.5f}" for m in metrics)
        + ", perceptual " + " -> ".join(f"{m['loss/perceptual']:.6f}" for m in metrics)
        + f"; {float(np.median(step_ms[1:])):.3f} ms/step (host clock, median of steps 2-{PERCEPTUAL_STEPS}; "
        f"first {step_ms[0]:.3f}) on {card}; phase {time.time() - t0:.1f} s")
    return dict(launches=launch_counts(), grad_rel_l2=grad_rel, losses=[m["loss/total"] for m in metrics],
                ms_per_step=float(np.median(step_ms[1:])))


def profile_step(name: str, step) -> dict:
    """Where one encode+decode spends the card's time: device kernel time by
    group (each port kernel, matrix products, everything else) from
    ``torch.profiler``, and the device's busy share of the step's wall time
    (CUDA events around the profiled step). Returns the kernels the profiler
    recorded, counted by group ({} where it recorded no device time)."""
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
    launches: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
            group = kernel_group(e.name)
            launches[group] = launches.get(group, 0) + 1
    total = sum(by_name.values())
    if total <= 0:
        log(f"  {name} profile: the profiler recorded no device time (not measured)")
        return {}
    groups = dict.fromkeys([*dict.fromkeys(PORT_KERNEL_GROUPS.values()), "matmul", "other"], 0.0)
    for kname, t in by_name.items():
        groups[kernel_group(kname)] += t
    shares = ", ".join(f"{g} {t:.3f} ms ({t / total:.1%})" for g, t in groups.items() if t > 0)
    log(f"  {name} profile: device kernels {total:.3f} ms in a {wall_ms:.3f} ms step "
        f"(busy {total / wall_ms:.1%}): {shares}")
    for kname, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {t:9.3f} ms  [{kernel_group(kname)}] {kname[:110]}")
    return launches


def kernel_entries(kern, qkern, fkern, main_path, int8_path, silu_path, highres, f32_int8, f32_silu) -> list:
    """The kernels line: one entry per kernel, its launches from its path's run."""
    head = next(r for r in kern["rows"] if r["shape"] == "350M@512p main" and r["case"] == "tail")
    entries = [{
        "name": "fused_attention",
        "route": "cuda",
        "source": "vitok_torch/csrc/fused_attention_sm90.cu",
        "replaces": "vitok_tpu/ops/fused_attention.py:317",
        "launches": main_path["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": head["ms"],  # the prologue and the wgmma kernel, as the wrapper launches them
        "kernel_ms": head["kernel_ms"],
        "device_ms": head["device_ms"],
        "library_device_ms": head["library_device_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "lse_max_abs_err": max(r["lse_max_abs_err"] for r in kern["rows"]),
    }, {
        "name": "fused_qk_prologue",
        "route": "cuda",
        "source": "vitok_torch/csrc/fused_attention_sm90.cu",
        "replaces": "vitok_tpu/ops/fused_attention.py:124",  # _norm_rope_half inside #1 (:317) and #3 (:645)
        "launches": main_path["prologue_launches"],
        "max_abs_err": kern["worst"]["fused_qk_prologue"],
        "ms": head["prologue_ms"],
        "plain_ms": head["prologue_plain_ms"],
        "bound_ms": head["prologue_bound_ms"],
        "bound_by": head["prologue_bound_by"],
        "library_ms": None,
        "differ_share": max(r["prologue_differ_share"] for r in kern["rows"]),
    }]
    flash = next(r for r in fkern["rows"] if r["shape"] == "350M@2048p" and r["case"] == "sw1024")
    tail = next(r for r in fkern["rows"] if r["shape"] == "350M@2048p" and r["case"] == "tail+sw1024")
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
        "library_ms": flash["library_ms"],  # SDPA with the boolean mask
        "dev_ms": flash["dev_ms"],          # the card's time, the host ahead
        "flex_ms": flash["flex_ms"],        # FlexAttention with the block mask, the same inputs
        "flex_dev_ms": flash["flex_dev_ms"],
        "flex_max_abs_err": max(r["flex_max_abs_err"] for r in fkern["rows"] if r["flex_max_abs_err"] is not None),
        "tail_ms": tail["ms"],
        "tail_dev_ms": tail["dev_ms"],
        "tail_bound_ms": tail["bound_ms"],
        "tail_flex_dev_ms": tail["flex_dev_ms"],
        "fold_ms": flash["fold_ms"],            # the prologue and #4 from the flat QKV
        "fold_dev_ms": flash["fold_dev_ms"],
        "fold_max_abs_err": max(r["fold_max_abs_err"] for r in fkern["rows"] if "fold_max_abs_err" in r),
        "eager_route_dev_ms": flash["eager_route_dev_ms"],  # the eager q/k norm and rotation, then #4
    })
    for name, replaces, shape, launches in (
        ("rmsnorm_quant", "vitok_tpu/ops/quant.py:385", "350M@512p main", int8_path["launches"]),
        ("ffn_int8", "vitok_tpu/ops/quant.py:130", "350M@512p main", int8_path["launches"]),
        ("silu_quant", "vitok_tpu/ops/quant.py:317", SILU_MAIN[0], silu_path["launches"]),
    ):
        rows = qkern[name]
        row = next(r for r in rows if r["shape"] == shape and r["dtype"] in ("bfloat16", "int8"))
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
            "dev_ms": row["dev_ms"],  # the card's time, the host ahead
            "codes_differ": max(r["codes_differ"] + r["scales_differ"] for r in rows),
        }
        if "int_mm_fc1_ms" in row:
            entry["int_mm_fc1_ms"] = row["int_mm_fc1_ms"]  # torch._int_mm, the fc1 product only
        else:  # #9 and #8: the wrapper's host time, the plan's instance, and the fp32 instance's times
            f32 = next(r for r in rows if r["shape"] == shape and r["dtype"] == "float32")
            entry.update(host_us=row["host_us"], copy_dev_ms=row["copy_dev_ms"], registers=row["registers"],
                         spill_bytes=row["spill_bytes"],
                         blocks_per_sm=row["blocks_per_sm"], plan=row["plan"], fp32_ms=f32["ms"],
                         fp32_dev_ms=f32["dev_ms"], fp32_bound_ms=f32["bound_ms"],
                         fp32_launches=(f32_int8 if name == "rmsnorm_quant" else f32_silu)["launches"][name])
        entries.append(entry)
    return entries


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "vitok_torch")):
        print("chip_smoke.py must run from a checkout of the repository (no vitok_torch/ here)",
              file=sys.stderr)
        return 2
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
    _build.build(["fused_attention_sm90", "fused_attention", "fused_attention_bwd", "flash_attention",
                  "flash_attention_bwd", "rmsnorm_quant", "ffn_int8", "silu_quant", "fused_attention_q8in_sm90",
                  "fused_attention_ab_sm90", "fused_attention_ab_f32_sm90"])  # the last: the fp32 walker
    log(f"built CUDA kernels in {time.time() - t0:.1f} s")
    device = torch.device("cuda")

    kern = kernel_phase(device)
    qkern = quant_kernel_phase(device)
    fkern = flash_kernel_phase(device)
    cases = main_path_cases(device)
    main_path = main_path_phase(device, card, cases)
    int8_path = int8_path_phase(device, card, cases, main_path)
    silu_path = silu_path_phase(device, card)
    f32_silu = silu_path_phase(device, card, "float32")
    serving_phase(device, card, main_path["model"])
    del cases, main_path["model"], main_path["outputs"]
    highres = highres_phase(device, card)
    torch.cuda.empty_cache()
    bkern = flash_bwd_kernel_phase(device)
    training = training_phase(device, card)
    torch.cuda.empty_cache()
    fbkern = fused_bwd_kernel_phase(device)
    q8kern = q8_kernel_phase(device)
    fused_training = fused_training_phase(device, card)
    torch.cuda.empty_cache()
    q8_path = q8_path_phase(device, card)
    generation_phase(device, card)
    torch.cuda.empty_cache()
    dit_training_phase(device, card)
    torch.cuda.empty_cache()
    t0 = time.time()
    bench_5b = bench_5b_phase(device, card)
    torch.cuda.empty_cache()
    log(f"5B bench phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    abkern = ab_kernel_phase(device)
    log(f"A/B kernel phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    f32_ae = f32_ae_phase(device, card)
    log(f"fp32 path: {time.time() - t0:.1f} s")
    t0 = time.time()
    f32_int8 = f32_int8_phase(device, card, f32_ae)
    log(f"fp32 int8 path: {time.time() - t0:.1f} s")
    t0 = time.time()
    ab_runs = ab_entry_phase(device)
    log(f"A/B entry points: {time.time() - t0:.1f} s")
    t0 = time.time()
    evals = eval_phase(device, card)
    torch.cuda.empty_cache()
    perceptual = perceptual_phase(device, card)
    torch.cuda.empty_cache()
    log(f"eval and perceptual phases: {time.time() - t0:.1f} s")
    log("eval summary: " + json.dumps({
        run: {k: evals[run]["stats"][k] for k in ("n_images", "ssim", "psnr", "fid", "fdd", "throughput_img_per_sec",
                                                  "wall_img_per_sec", "steady_img_per_sec", "host_data_time_s",
                                                  "device_time_s", "host_post_time_s", "wall_time_s")
              if k in evals[run]["stats"]}
        | {"feature_ms_per_img": evals[run]["features"], "gather_s": evals[run]["gather_s"]}
        for run in ("bf16", "int8", "buckets")} | {"card": card}))

    entries = kernel_entries(kern, qkern, fkern, main_path, int8_path, silu_path, highres, f32_int8, f32_silu)
    entries[2:2] = flash_bwd_entries(bkern, training)
    entries[1:1] = fused_family_entries(q8kern, q8_path, fbkern, fused_training)
    entries += ab_entries(abkern, ab_runs, f32_ae, kern)
    for e in entries:  # the 5B run's, the eval runs' and the perceptual steps' launches beside each path's own
        if bench_5b["launches"].get(e["name"]):
            e["launches_5b_bench"] = bench_5b["launches"][e["name"]]
        eval_launches = sum(evals[run]["launches"].get(e["name"], 0) for run in ("bf16", "int8", "buckets"))
        if eval_launches:
            e["launches_eval"] = eval_launches
        if perceptual["launches"].get(e["name"]):
            e["launches_perceptual"] = perceptual["launches"][e["name"]]
    log(f"chip_smoke.py ran for {time.time() - started:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
