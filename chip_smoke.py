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
   against its run on the quantize kernels' plain versions; holds the fp32
   instances of #4, #5 and #6 (plain and fold), the q/k prologue, the fp32
   forward's lse instance and #3 against their plain versions (TF32 off) at
   the high-resolution and 256/1024-token shapes, timed beside SDPA in fp32;
   runs the 350M AE in fp32 at 1024p on them against the unfused
   composition and trains it in fp32 compute (1024p on the fold's fp32
   instances, 256 tokens with ``attn_impl="fused"`` on the lse instance and
   #3); and runs both A/B entry points at the recorded shapes with fewer
   timed calls;
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
11. runs the training-data slice on seeded JPEGs in local tar shards with
   ``.cls`` labels: the loader's three host rates (serial with the numpy
   collate, serial with the native collate, the native collate with eight
   decode workers) on equal batches; ``train_vae.main`` in this process
   with Muon and ``checkpoint=1`` + ``remat_save`` at 1024p (each step's
   #4-#6 launches, the first step's gradients against the plain backward,
   the first Muon update against the CPU's, the update's time beside
   AdamW's); peak memory and ms/step under three recomputation policies at
   256 and 4096 tokens through ``benchmark_mfu.run_train``; three DiT-L
   Muon steps through ``train_dit.main``; and ``tokenize_data.main``
   encoding the shards in bf16 and int8 and decoding them back to PNGs at
   their sizes;
12. holds #2's fp32 instance (the fp32 walker, then the row quantize)
   against ``quantize_activation`` of the fp32 forward bit for bit, and the
   instances past the widths of #7 (t through a device scratch, F' 20,480),
   #8 (F' 20,480) and #9 (C 12,288) against their plain versions bit for
   bit, each timed; runs the int8 350M model on fp32 compute at 256 tokens
   with the epilogue on (#2 f32 in every block) and two int8 models wide
   enough to take the wide instances (C 12,288 and C 6,208, one block each
   side);
13. runs the distributed slice as a world of one over NCCL: one 350M
   training step at 256 tokens on the fused kernels under ``data=1``
   (DDP), ``fsdp=1`` (FSDP2) and ``model=1`` (tensor parallelism), and one
   token-sharded step at 1024p under ``seq=1`` (the halo route), each
   against the unwrapped step (rel L2 1e-6); then ``data=2`` in two
   processes on the one card over gloo, against the unwrapped step's two
   microbatches;
14. runs pipeline parallelism at full width and depth: 350M ``pipe=1`` as a
   world of one over NCCL (the decode at 256 tokens, B 16, in four
   microbatches, and one training step on #1 and #3 with Charbonnier, SSIM
   and a random DINO ViT-S term), then ``pipe=2`` as two processes on the
   one card over gloo (the same decode, a training step, and the 5B decode
   in bf16 and int8, 20 blocks a stage), each against the unwrapped model on
   the same microbatches, every rank's launches read;
15. runs the last entry points: ``bench_fused_ffn`` at the 350M and 5B
   shapes (#7 and the unfused chain each bit for bit their plain versions,
   both timed), ``ab_q8_epilogue`` at 350M, and ``entry()``;
16. runs head dims 192 and 256 at the 5B width (C 3072): the q/k prologue,
   #1, #2 and #4 (plain and behind the prologue) in bf16 against their
   plain versions at the paths' shapes, each timed beside its bound, its
   plain version and a library call, #2's cluster layouts timed; then
   ``Td4h12-Th12/1x16x64`` (12 heads of 256, 4 + 40 blocks) and
   ``Td4h16-Td8h16/1x16x64`` (16 heads of 192, the decoder cut to 8 blocks)
   through encode -> decode in bf16 at 256p and 512p (B 16) and at 1024p
   with sw 1024 (the fold), against the unfused composition, and in int8 at
   256p with the epilogue off and on; then the backward's instances at these
   head dims (the prologue with delta, #3 at 256 and 1024 tokens, #5 and #6
   plain and fold at 4096 tokens with sw 1024) against their plain
   versions, each timed beside its bound, its plain version and SDPA's (and
   FlexAttention's) backward; and
   training steps of ``Td2h12-Td4h12/1x16x64`` and ``Td2h16-Td4h16/1x16x64``
   (3072 wide, about 0.7B parameters) at 256 tokens B 8 with
   ``attn_impl="fused"`` (#1, then #3) and at 1024p B 1 with sw 1024 (the
   fold, then #5/#6), the first step's gradients against the plain
   backward's and each step's launches read;
17. runs the fp32 forward at head dims 192 and 256 at the 5B width, TF32
   off: the fp32 walker (#1 f32, its splits timed), #2 f32 (the walker, then
   the row quantize: ``quantize_activation`` of #1 bit for bit), the fp32
   q/k prologue and #4's fp32 instance (plain and behind the prologue, also
   against float64) within 1e-5 of their plain versions' largest entry,
   each timed beside its bound, its plain version and SDPA (and
   FlexAttention) in fp32; then the two training models above with
   ``compute_dtype=torch.float32`` through encode -> decode at 256p and
   512p (B 16, the walker) and at 1024p with sw 1024 (the fp32 prologue and
   #4), against the unfused composition, and ``quantize()``d at 256p with
   the epilogue off and on (#2 f32); #1 f32 with the tail mask within
   twice its plain version's error from float64;
18. runs the fp32 backward at head dims 192 and 256 at the 5B width, TF32
   off: the fp32 walker's lse instance (also against float64), the fp32
   prologue with delta and #3's fp32 instance at 256 and 1024 tokens, #4,
   #5 and #6 plain (each against float64) and the fold's backward at B 1,
   N 4096, sw 1024, each within its limit of its plain version and timed;
   then trains the two models above in fp32 (compute and master weights)
   three steps on each route, the first step's gradients against the
   unfused composition and each step's launches read;
19. holds the A/B kernels #10-#13 at head dims 192 and 256 (C 3072, 16 and
   12 heads) bit for bit against the reference of their own body: in bf16
   #10, #11 and #13 #1 at that width, #12 #1 on the assembled tensor and
   its int8 q/k prologue the bf16 one on bf16(code), in fp32 the fp32
   walker with one cell a block; each within its limits of its plain
   version and timed beside its bound and SDPA; then runs both A/B entry
   points at each width, every arm built but the JAX entry's skipped ones,
   every numeric leg 0, the launches counted;
20. prints a JSON line describing each kernel, the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import collections
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
            "fused_attention_q8_f32": fa.Q8_F32_LAUNCHES,
            "fused_attention_mma": fa.MMA_LAUNCHES, "fused_attention_f32": fa.F32_LAUNCHES,
            "fused_attention_mma_f32": fa.F32_MMA_LAUNCHES, "fused_attention_f32_lse": fa.F32_LSE_LAUNCHES,
            "fused_qk_prologue_f32": fa.PROLOGUE_F32_LAUNCHES, "fused_attention_bwd_f32": fa.BWD_F32_LAUNCHES,
            "flash_attention": fl.LAUNCHES,
            "flash_attention_dq": fl.DQ_LAUNCHES, "flash_attention_dkv": fl.DKV_LAUNCHES,
            "flash_attention_f32": fl.F32_LAUNCHES, "flash_attention_dq_f32": fl.DQ_F32_LAUNCHES,
            "flash_attention_dkv_f32": fl.DKV_F32_LAUNCHES,
            **quant.LAUNCHES, **abb.LAUNCHES, **ab8.LAUNCHES}


def reset_counts() -> None:
    from vitok_torch.benchmarks import ab_batch_block as abb
    from vitok_torch.benchmarks import ab_q8_input as ab8
    from vitok_torch.ops import flash_attention as fl
    from vitok_torch.ops import fused_attention as fa
    from vitok_torch.ops import quant

    fa.LAUNCHES = fa.PROLOGUE_LAUNCHES = fa.BWD_LAUNCHES = fa.Q8_LAUNCHES = fa.Q8_F32_LAUNCHES = 0
    fa.MMA_LAUNCHES = fa.F32_LAUNCHES = fa.F32_MMA_LAUNCHES = 0
    fa.F32_LSE_LAUNCHES = fa.PROLOGUE_F32_LAUNCHES = fa.BWD_F32_LAUNCHES = 0
    fl.LAUNCHES = fl.DQ_LAUNCHES = fl.DKV_LAUNCHES = 0
    fl.F32_LAUNCHES = fl.DQ_F32_LAUNCHES = fl.DKV_F32_LAUNCHES = 0
    for counts in (quant.LAUNCHES, abb.LAUNCHES, ab8.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _expect(**counts) -> dict:
    """Expected launches of one run: the named counts, every other kernel 0.
    The q/k prologue runs before every launch of the wgmma forward and before
    every backward (two launches: dq, then dk/dv), unless its count is
    named."""
    counts.setdefault("fused_qk_prologue",
                      counts.get("fused_attention", 0) + counts.get("fused_attention_bwd", 0) // 2)
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
    """LayerScale gains ~ U(0.5, 1.5) from a seed: every block matters (the
    same draws as the pipeline phase's stage processes)."""
    from vitok_torch.scripts.dryrun_multiprocess import random_gates

    random_gates(model, device)


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


def flash_bwd_kernel_phase(device, shapes=FLASH_SHAPES, dims=(64, 128), flex_rows=FLEX_ROWS,
                           fold_rows=FOLD_BWD_ROWS) -> dict:
    """The dq and dk/dv kernels against ``flash_attention_bwd_plain`` at
    ``shapes`` (the forward phase's), their instances at head dims ``dims``
    described; the library yardsticks are SDPA's backward with the boolean
    mask and, at ``flex_rows``, FlexAttention's (forward + backward, minus
    the forward). ``dev``: the kernel's time with the host ahead
    (``host_ahead_ms``). At ``fold_rows`` also the fold's backward
    (``_fold_bwd_row``)."""
    import torch
    import torch.nn.functional as F
    from vitok_torch.benchmarks import host_ahead_ms
    from vitok_torch.ops import flash_attention as fl

    gen = torch.Generator(device=device).manual_seed(5)
    rows, worst = [], {"dq": 0.0, "dkv": 0.0}
    for which in ("dq", "dkv"):
        for d in dims:
            log(f"  {which} kernel at d = {d}: {fl.flash_bwd_attributes(which, d)}")
    log("kernel phase: flash attention backward, dq and dk/dv (CUDA) vs flash_attention_bwd_plain, bf16")
    log(f"{'shape':12s} {'B':>2s} {'N':>6s} {'H':>3s} {'D':>4s} {'case':12s} {'dq max/mean rel':>17s} "
        f"{'dk max/mean rel':>17s} {'dv max/mean rel':>17s} {'dq_ms':>8s} {'dkv_ms':>8s} {'plain_ms':>9s} "
        f"{'sdpa_bwd':>9s} {'dq_bound':>9s} {'dkv_bound':>9s}")
    for label, b, n, h, d, cases in shapes:
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
            if (label, case) in flex_rows:  # FlexAttention forward + backward, minus its forward
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
            if (label, case) in fold_rows:
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
    want_first = _expect(fused_attention=depth, fused_attention_bwd=2 * depth)
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
    expect = _expect(fused_attention=2 * depth, fused_attention_bwd=2 * depth)
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
    want = _expect(fused_attention=depth, fused_attention_bwd=2 * depth)
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


def _one_launch(name: str, fn, times: int = 1):
    """``fn()`` with the launch count ``name`` going up by exactly ``times``."""
    before = launch_counts()[name]
    out = fn()
    if launch_counts()[name] != before + times:
        raise AssertionError(f"{name}: {launch_counts()[name] - before} launches counted for one call, not {times}")
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


# ---------------------------------------------------------------------------
# The fp32 instances: #4, #5 and #6 (plain and fold), the q/k prologue, the
# fp32 walker's lse instance (#1 under autograd) and #3; the fp32 AE at
# 1024p and fp32-compute training on them
# ---------------------------------------------------------------------------

F32_FLASH_ROWS = (  # (label, B, N, H, D, masked, sw): the fp32 AE's high-resolution shapes
    ("350M@1024p", 2, 4096, 16, 64, True, FLASH_SW),
    ("5B width", 1, 2048, 24, 128, False, FLASH_SW),
)
F32_FUSED_ROWS = (  # (label, B, N, C, H, masked): #3's rows in PERF.md, no window
    ("350M@256p", 32, 256, 1024, 16, True),
    ("350M@1024", 8, 1024, 1024, 16, False),
)
F32_OUT_REL = 1e-5   # fp32 outputs against their plain versions (TF32 off), of the largest entry
F32_GRAD_REL = 1e-4  # fp32 gradients against their plain versions, of each one's largest entry
F32_F64_FACTOR = 2.0  # #4-#6's (and at d 192/256 #1's) error against float64 within this times their plain versions'
F32_TRAIN = ("1024p", 4096, 1, [(1024, 1024)])
F32_FUSED_TRAIN = ("256p", 256, 32, RESOLUTIONS[0][3])
F32_TRAIN_STEPS = 3
F32_TRAIN_GRAD_REL_L2 = 1e-3  # all parameter gradients, kernels against the plain backward, fp32 compute


def _f32_inputs(seed, b, n, c, h, masked, device):
    """``_attention_inputs``' gains, tables and tail mask with an fp32 qkv
    drawn in fp32 (bf16 values would leave the split's second and third
    pieces 0)."""
    import torch

    _, qs, ks, cos, sin, mask = _attention_inputs(np.random.default_rng(seed), b, n, c, h, masked, device)
    qkv = np.random.default_rng(seed + 100).standard_normal((b, n, 3 * c), dtype=np.float32)
    return torch.from_numpy(qkv).to(device), qs, ks, cos, sin, mask


def _f32_err(what, got, want, limit) -> tuple:
    """(max abs error, its share of want's largest entry), within ``limit``
    of that entry and finite, or raise."""
    import torch

    top = want.abs().max().item()
    err = (got - want).abs().max().item()
    if got.dtype != torch.float32 or not (bool(torch.isfinite(got).all()) and err <= limit * top):
        raise AssertionError(f"{what}: {got.dtype} max |err| {err:.3e} > {limit} x {top:.3e}")
    return err, err / top


def _f32_timed(row: dict, key: str, fn, plain=None) -> None:
    """``row[key + "ms"]`` (chained CUDA events) and ``[key + "dev_ms"]`` (the
    host ahead), and the plain version's ``[key + "plain_ms"]``."""
    from vitok_torch.benchmarks import host_ahead_ms

    row[f"{key}ms"], row[f"{key}dev_ms"] = time_ms(fn), host_ahead_ms(fn)
    if plain is not None:
        row[f"{key}plain_ms"] = time_ms(plain, runs=2, warmup=1)


def _sdpa_bwd_ms(q, k, v, am, g) -> float:
    """SDPA's backward alone (fp32, the boolean mask) on ``[B, N, H, D]``."""
    import torch
    import torch.nn.functional as F

    xs = [t.transpose(1, 2).detach().clone().requires_grad_() for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*xs, attn_mask=am)
    gt = g.transpose(1, 2)
    ms = time_ms(lambda: torch.autograd.grad(o, xs, gt, retain_graph=True), runs=3, warmup=1)
    del o, xs
    return ms


def _attention_f64(q, k, v, mask, sw, g) -> tuple:
    """``(out, dq, dk, dv)`` of attention over ``[B, N, H, D]`` in float64
    with autograd, a sample at a time: scale 1/sqrt(d), keys outside the mask
    or the window |i - j| <= sw take no weight, the cotangent ``g`` zeroed
    on padded query rows. A query row with no live key (padding past the
    window) attends to itself: its output is not compared and its zero
    cotangent moves nothing."""
    import torch

    b, n, h, d = q.shape
    idx = torch.arange(n, device=q.device)
    near = None if sw is None else (idx[:, None] - idx[None, :]).abs() <= sw
    res = []
    for i in range(b):
        x = [t[i].double().transpose(0, 1).detach().requires_grad_() for t in (q, k, v)]  # [H, N, D]
        live = torch.ones((n, n), dtype=torch.bool, device=q.device) if mask is None else mask[i][None, :].expand(n, n)
        live = live if near is None else live & near
        live = live | (~live.any(1, keepdim=True) & torch.eye(n, dtype=torch.bool, device=q.device))
        s = (x[0] @ x[1].transpose(1, 2) / d ** 0.5).masked_fill(~live, float("-inf"))
        o = torch.softmax(s, -1) @ x[2]
        gi = g[i].double().transpose(0, 1)
        if mask is not None:
            gi = gi * mask[i][None, :, None]
        grads = torch.autograd.grad(o, x, gi)
        res.append([o.detach().transpose(0, 1)] + [t.transpose(0, 1) for t in grads])
        del x, s, o, grads
    return tuple(torch.stack(z) for z in zip(*res))


def _f32_flash_row(label, b, n, h, d, masked, sw, device, flex, flex_bwd=False) -> dict:
    """The q/k prologue's fp32 instance, #4 on its views, #5 and #6 (plain
    instances) and the fold's backward (the prologue, then #5 and #6 in
    their fold instances) against their plain versions, each timed beside
    its plain version, its bound and SDPA (fp32, the boolean mask; with
    ``flex`` FlexAttention's forward too, with ``flex_bwd`` its backward:
    forward + backward less the forward); #4-#6 and their plain versions
    also against float64 (``_attention_f64``), each kernel within
    F32_F64_FACTOR of its plain version's error there."""
    import torch
    import torch.nn.functional as F
    from vitok_torch.ops import flash_attention as fl
    from vitok_torch.ops import fused_attention as fa

    c = h * d
    qkv, qs, ks, cos, sin, mask = _f32_inputs(20, b, n, c, h, masked, device)
    what = f"fp32 {label} {'tail+' if masked else ''}sw={sw}"
    valid = [n] * b if mask is None else mask.sum(1).tolist()
    pairs = _flash_pairs(valid, n, sw)
    tensor, rows = b * n * c * 4, b * h * n * 4  # one fp32 [B, N, C] tensor; one fp32 [B, H, N]
    tables, mbytes = 2 * b * n * (d // 2) * 4, (0 if mask is None else b * n)
    pair_flops = 2.0 * h * d * pairs  # one product over the live pairs
    row = dict(shape=label, case=f"{'tail+' if masked else ''}sw{sw}")

    prologue = lambda: fa.fused_qk_prologue(qkv, qs, ks, cos, sin, num_heads=h)
    qk, _ = _one_launch("fused_qk_prologue_f32", prologue)
    want = fa.fused_qk_prologue_plain(qkv, qs, ks, cos, sin, num_heads=h)[0]
    row["prologue_max_abs_err"], row["prologue_rel_err"] = _f32_err(f"{what} prologue", qk, want, F32_OUT_REL)
    del want
    _f32_timed(row, "prologue_", prologue, lambda: fa.fused_qk_prologue_plain(qkv, qs, ks, cos, sin, num_heads=h))
    row["prologue_bound_ms"], row["prologue_bound_by"] = _bound_ms(4 * tensor + tables + 2 * d * 4, 0.0,
                                                                   BF16_FLOPS_PER_S)

    q, k = qk.view(b, n, 2, h, d).unbind(2)  # what the fold hands #4: views of the prologue's scratch
    v = qkv.view(b, n, 3, h, d)[:, :, 2]
    fwd = lambda: fl.flash_attention(q, k, v, mask, sw, return_lse=True)
    out, lse = _one_launch("flash_attention_f32", fwd)
    want, want_lse = fl.flash_attention_plain(q, k, v, mask, sw, return_lse=True)
    row["max_abs_err"], row["rel_err"] = _f32_err(f"{what} #4", out, want, F32_OUT_REL)
    live = want_lse < 1e29
    row["lse_max_abs_err"] = (lse[live] - want_lse[live]).abs().max().item()
    if not (row["lse_max_abs_err"] <= LSE_ATOL and torch.equal(lse >= 1e29, ~live)):
        raise AssertionError(f"{what} #4: lse max |err| {row['lse_max_abs_err']:.3e} (limit {LSE_ATOL}) or dead rows")
    if mask is not None and out[~mask].any():
        raise AssertionError(f"{what} #4: padded rows are not exactly 0")
    del want, want_lse
    _f32_timed(row, "", fwd, lambda: fl.flash_attention_plain(q, k, v, mask, sw, return_lse=True))
    row["bound_ms"], row["bound_by"] = _bound_ms(4 * tensor + mbytes + rows, 6 * 2 * pair_flops, BF16_FLOPS_PER_S)
    am = _sdpa_mask(mask, n, sw, device)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am), runs=3, warmup=1)
    row["flex_ms"] = row["flex_rel_err"] = None
    if flex:
        call = _flex_call(q, k, v, mask, sw)
        got = call().transpose(1, 2).float()
        ref = fl.flash_attention_plain(q, k, v, mask, sw)
        keep = torch.ones((b, n), dtype=torch.bool, device=device) if mask is None else mask
        row["flex_rel_err"] = ((got - ref)[keep].abs().max() / ref[keep].abs().max()).item()
        row["flex_ms"] = time_ms(call)
        del got, ref

    gen = torch.Generator(device=device).manual_seed(21)
    g = torch.randn((b, n, h, d), generator=gen, device=device)
    dq_call = lambda: fl.flash_dq_cuda(q, k, v, out, lse, g, mask, sw)
    dq, delta = _one_launch("flash_attention_dq_f32", dq_call)
    dkv_call = lambda: fl.flash_dkv_cuda(q, k, v, lse, delta, g, mask, sw)
    dk, dv = _one_launch("flash_attention_dkv_f32", dkv_call)
    want = fl.flash_attention_bwd_plain(q, k, v, out, lse, g, mask, sw)
    errs = [_f32_err(f"{what} {name}", a, r, F32_GRAD_REL) for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), want)]
    row["dq_max_abs_err"], row["dq_rel_err"] = errs[0]
    row["dkv_max_abs_err"], row["dkv_rel_err"] = max(errs[1][0], errs[2][0]), max(errs[1][1], errs[2][1])
    # The kernels' and the plain versions' own errors: each against float64 (its max |err| of the largest entry).
    ref = _attention_f64(q, k, v, mask, sw, g)
    keep = slice(None) if mask is None else mask
    top = lambda a, r: ((a[keep].double() - r[keep]).abs().max() / r[keep].abs().max()).item()
    row["f64_rel_err"] = top(out, ref[0])
    row["f64_plain_rel_err"] = top(fl.flash_attention_plain(q, k, v, mask, sw), ref[0])
    for key, got_, want_, ref_ in (("dq_", (dq,), want[:1], ref[1:2]), ("dkv_", (dk, dv), want[1:], ref[2:])):
        rel = [(top(a, r), top(p, r)) for a, p, r in zip(got_, want_, ref_)]
        row[f"{key}f64_rel_err"], row[f"{key}f64_plain_rel_err"] = max(x[0] for x in rel), max(x[1] for x in rel)
    for key, name in (("", "#4"), ("dq_", "#5"), ("dkv_", "#6")):
        if not row[f"{key}f64_rel_err"] <= F32_F64_FACTOR * row[f"{key}f64_plain_rel_err"]:
            raise AssertionError(f"{what} {name}: {row[f'{key}f64_rel_err']:.3e} of the largest entry from float64, "
                                 f"over {F32_F64_FACTOR} x its plain version's {row[f'{key}f64_plain_rel_err']:.3e}")
    del want, dq, dk, dv, ref
    _f32_timed(row, "dq_", dq_call)
    _f32_timed(row, "dkv_", dkv_call, lambda: fl.flash_attention_bwd_plain(q, k, v, out, lse, g, mask, sw))
    row["bwd_plain_ms"] = row.pop("dkv_plain_ms")  # dq, dk and dv together
    row["dq_bound_ms"], row["dq_bound_by"] = _bound_ms(6 * tensor + 2 * rows + mbytes, 6 * 3 * pair_flops,
                                                       BF16_FLOPS_PER_S)
    row["dkv_bound_ms"], row["dkv_bound_by"] = _bound_ms(6 * tensor + 2 * rows + mbytes, 6 * 4 * pair_flops,
                                                         BF16_FLOPS_PER_S)
    row["bwd_library_ms"] = _sdpa_bwd_ms(q, k, v, am, g)
    row["bwd_flex_ms"] = None
    if flex_bwd:
        xs = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        call = _flex_call(*(t.transpose(1, 2) for t in xs), mask, sw)
        with torch.no_grad():
            flex_fwd_ms = time_ms(call, runs=3)
        row["bwd_flex_ms"] = time_ms(lambda: torch.autograd.grad(call(), xs, g.transpose(1, 2)), runs=3) - flex_fwd_ms
        del xs, call
    del out, lse, am

    # The fold's backward: the prologue (qrot, krot, delta), then #5 and #6 in their fold instances.
    args, kw = (qkv, qs, ks, cos, sin, mask), dict(num_heads=h, sliding_window=sw)
    fout, flse = fa._flash_fold_cuda(*args, h, sw, want_lse=True)
    dout = g.reshape(b, n, c) if mask is None else g.reshape(b, n, c) * mask[..., None]
    bwd = lambda: fa.flash_qkv_attention_bwd(*args, dout, out=fout, lse=flse, **kw)
    before = launch_counts()
    got, again = bwd(), bwd()
    moved = {k_: v_ - before[k_] for k_, v_ in launch_counts().items() if v_ != before[k_]}
    if moved != {"fused_qk_prologue_f32": 2, "flash_attention_dq_f32": 2, "flash_attention_dkv_f32": 2}:
        raise AssertionError(f"{what} fold backward: launches {moved} for two calls")
    want = fa.flash_qkv_attention_bwd_plain(*args, dout, out=fout, lse=flse, **kw)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{what} fold backward: two runs differ")
    errs = [_f32_err(f"{what} fold {name}", a, r, F32_GRAD_REL) for name, a, r in zip(("dqkv", "dq_scale", "dk_scale"),
                                                                                     got, want)]
    row["fold_bwd_max_abs_err"], row["fold_bwd_rel_err"] = max(e[0] for e in errs), max(e[1] for e in errs)
    del got, again, want
    _f32_timed(row, "fold_bwd_", bwd, lambda: fa.flash_qkv_attention_bwd_plain(*args, dout, out=fout, lse=flse, **kw))
    row["fold_bwd_bound_ms"], row["fold_bwd_bound_by"] = _bound_ms(
        8 * tensor + tables + rows + mbytes, 6 * 7 * pair_flops, BF16_FLOPS_PER_S)
    # The fold instances alone, on the prologue's scratch and delta.
    qk2, delta2 = fa.fused_qk_prologue(qkv, qs, ks, cos, sin, num_heads=h, out=fout, dout=dout)
    maskb = None if mask is None else mask.bool().contiguous()
    counts = None if maskb is None else fl.key_counts(maskb)
    dqkv = torch.empty_like(qkv)
    part = torch.empty((b, h, -(-n // 64), d), dtype=torch.float32, device=device)
    swi = -1 if sw is None else sw
    fold_call = lambda fn, gain: lambda: fn(qkv, qk2, gain, cos, sin, maskb, counts, dout, flse, delta2, dqkv, part, h,
                                            swi)
    _f32_timed(row, "fold_dq_", fold_call(fl.flash_dq_fold_cuda, qs))
    _f32_timed(row, "fold_dkv_", fold_call(fl.flash_dkv_fold_cuda, ks))
    log(f"  fp32 {label} {row['case']}: prologue {row['prologue_ms']:.4f} ms (plain {row['prologue_plain_ms']:.4f}, "
        f"bound {row['prologue_bound_ms']:.4f}); #4 {row['ms']:.4f} ms (dev {row['dev_ms']:.4f}, plain "
        f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} {row['bound_by']}, SDPA {row['library_ms']:.4f}, flex "
        f"{row['flex_ms']}), rel err {row['rel_err']:.2e}, lse {row['lse_max_abs_err']:.2e}; #5 {row['dq_ms']:.4f} "
        f"(bound {row['dq_bound_ms']:.4f}), #6 {row['dkv_ms']:.4f} (bound {row['dkv_bound_ms']:.4f}), plain "
        f"{row['bwd_plain_ms']:.4f}, SDPA bwd {row['bwd_library_ms']:.4f}, flex bwd {row['bwd_flex_ms']}, rel err "
        f"{row['dq_rel_err']:.2e}/"
        f"{row['dkv_rel_err']:.2e}; against float64: #4 {row['f64_rel_err']:.2e} (plain "
        f"{row['f64_plain_rel_err']:.2e}), #5 {row['dq_f64_rel_err']:.2e} ({row['dq_f64_plain_rel_err']:.2e}), #6 "
        f"{row['dkv_f64_rel_err']:.2e} ({row['dkv_f64_plain_rel_err']:.2e}); fold bwd {row['fold_bwd_ms']:.4f} ms "
        f"(#5 {row['fold_dq_ms']:.4f}, #6 "
        f"{row['fold_dkv_ms']:.4f}; plain {row['fold_bwd_plain_ms']:.4f}, bound {row['fold_bwd_bound_ms']:.4f}), "
        f"rel err {row['fold_bwd_rel_err']:.2e}")
    return row


def _f32_fused_row(label, b, n, c, h, masked, device, f64=False) -> dict:
    """The fp32 walker's lse instance (#1 under autograd) and #3's fp32
    instance (the prologue, then the fp32 dq and dk/dv fold instances at
    the walker's log2 lse) against their plain versions, timed beside them,
    their bounds and SDPA (fp32, the boolean mask, on q and k normed and
    rotated); with ``f64`` the lse instance's output also against float64
    attention on the plain prologue's q and k (valid rows), within
    F32_F64_FACTOR of its plain version's error there."""
    import torch
    import torch.nn.functional as F
    from vitok_torch.ops import fused_attention as fa

    d = c // h
    qkv, qs, ks, cos, sin, mask = _f32_inputs(30, b, n, c, h, masked, device)
    args = (qkv, qs, ks, cos, sin, mask)
    what = f"fp32 fused {label} {'tail' if masked else 'none'}"
    valid = [n] * b if mask is None else mask.sum(1).tolist()
    tensor, rows = b * n * c * 4, b * h * n * 4
    tables, mbytes = 2 * b * n * (d // 2) * 4, (0 if mask is None else b * n)
    row = dict(shape=label, case="tail" if masked else "none", B=b, N=n)

    fwd = lambda: fa._fused_cuda(*args, h, None, want_lse=True)
    out, lse = _one_launch("fused_attention_f32_lse", fwd)
    want, want_lse = fa.fused_qkv_attention_plain(*args, num_heads=h, return_lse=True)
    row["max_abs_err"], row["rel_err"] = _f32_err(f"{what} #1 lse instance", out, want, F32_OUT_REL)
    keep = (torch.ones((b, n), dtype=torch.bool, device=device) if mask is None else mask)[:, None, :].expand_as(lse)
    row["lse_max_abs_err"] = (lse[keep] - want_lse[keep]).abs().max().item()
    if not (row["lse_max_abs_err"] <= LSE_ATOL and bool((lse[~keep] == 1e30).all())):
        raise AssertionError(f"{what}: lse max |err| {row['lse_max_abs_err']:.3e} (limit {LSE_ATOL}) or padded rows")
    if f64:
        qn, kn = fa.fused_qk_prologue_plain(qkv, qs, ks, cos, sin, num_heads=h)[0].view(b, n, 2, h, d).unbind(2)
        v4 = qkv.view(b, n, 3, h, d)[:, :, 2]
        rows_ = slice(None) if mask is None else mask
        ref = _attention_f64(qn, kn, v4, mask, None, torch.zeros_like(v4))[0].reshape(b, n, c)[rows_]
        top = lambda a: ((a[rows_].double() - ref).abs().max() / ref.abs().max()).item()
        row["f64_rel_err"], row["f64_plain_rel_err"] = top(out), top(want)
        del qn, kn, v4, ref
        if not row["f64_rel_err"] <= F32_F64_FACTOR * row["f64_plain_rel_err"]:
            raise AssertionError(f"{what} #1 lse instance: {row['f64_rel_err']:.3e} of the largest entry from float64, "
                                 f"over {F32_F64_FACTOR} x its plain version's {row['f64_plain_rel_err']:.3e}")
    del want, want_lse
    _f32_timed(row, "", fwd, lambda: fa.fused_qkv_attention_plain(*args, num_heads=h, return_lse=True))
    row["bound_ms"], row["bound_by"] = _bound_ms(4 * tensor + tables + mbytes + rows + 2 * d * 4,
                                                 6 * 4.0 * h * d * _needed_pairs(b, mask, n, None),
                                                 BF16_FLOPS_PER_S)
    qn, kn, vn = _normed_qkv(qkv, qs, ks, cos, sin, b, n, h, d)  # [B, H, N, D]
    am = _sdpa_mask(mask, n, None, device)
    row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qn, kn, vn, attn_mask=am), runs=3, warmup=1)

    gen = torch.Generator(device=device).manual_seed(31)
    dout = torch.randn((b, n, c), generator=gen, device=device)
    bwd = lambda: fa.fused_qkv_attention_bwd(*args, dout, num_heads=h, out=out, lse=lse)
    got = _one_launch("fused_attention_bwd_f32", bwd, times=2)  # its dq and dk/dv launches
    again = bwd()
    want = fa.fused_qkv_attention_bwd_plain(*args, dout, num_heads=h, out=out)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{what} #3: two runs differ")
    errs = [_f32_err(f"{what} #3 {name}", a, r, F32_GRAD_REL) for name, a, r in zip(("dqkv", "dq_scale", "dk_scale"),
                                                                                   got, want)]
    row["bwd_max_abs_err"], row["bwd_rel_err"] = max(e[0] for e in errs), max(e[1] for e in errs)
    del got, again, want
    _f32_timed(row, "bwd_", bwd, lambda: fa.fused_qkv_attention_bwd_plain(*args, dout, num_heads=h, out=out))
    row["bwd_bound_ms"], row["bwd_bound_by"] = _bound_ms(8 * tensor + tables + rows + mbytes,
                                                         6 * 7 * 2.0 * h * d * _flash_pairs(valid, n, None),
                                                         BF16_FLOPS_PER_S)
    g = dout.view(b, n, h, d) if mask is None else (dout * mask[..., None]).view(b, n, h, d)
    row["bwd_library_ms"] = _sdpa_bwd_ms(*(t.transpose(1, 2) for t in (qn, kn, vn)), am, g)
    log(f"  fp32 fused {label} B {b} N {n} {row['case']}: #1 lse instance {row['ms']:.4f} ms (dev {row['dev_ms']:.4f}, "
        f"plain {row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} {row['bound_by']}, SDPA {row['library_ms']:.4f}), "
        f"rel err {row['rel_err']:.2e}, lse {row['lse_max_abs_err']:.2e}"
        + (f", from float64 {row['f64_rel_err']:.2e} (plain {row['f64_plain_rel_err']:.2e})" if f64 else "")
        + f"; #3 {row['bwd_ms']:.4f} ms (dev "
        f"{row['bwd_dev_ms']:.4f}, plain {row['bwd_plain_ms']:.4f}, bound {row['bwd_bound_ms']:.4f} "
        f"{row['bwd_bound_by']}, SDPA bwd {row['bwd_library_ms']:.4f}), rel err {row['bwd_rel_err']:.2e}")
    return row


def _f32_first_grads(model, inputs, loss_cfg, reference, device) -> float:
    """rel L2 over all parameters of the first step's gradients, the kernels
    against the same step with the backward swapped for its plain version
    (``reference``: a context manager); the losses must agree exactly."""
    import torch
    from vitok_torch.train_lib import compute_loss

    params = list(model.parameters())

    def grads():
        gen = torch.Generator(device=device).manual_seed(11)
        loss, _ = compute_loss(model, inputs, loss_cfg, gen)
        return loss.detach(), torch.autograd.grad(loss, params)

    loss_k, got = grads()
    with reference():
        loss_p, want = grads()
    torch.cuda.synchronize()
    num = sum((a.double() - b.double()).square().sum() for a, b in zip(got, want))
    rel = (num / sum(b.double().square().sum() for b in want)).sqrt().item()
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    if not (finite and loss_k.item() == loss_p.item() and rel <= F32_TRAIN_GRAD_REL_L2):
        raise AssertionError(f"fp32 training: first-step gradients rel L2 {rel:.3e} (limit {F32_TRAIN_GRAD_REL_L2}), "
                             f"finite {finite}, loss {loss_k.item()} vs {loss_p.item()}")
    return rel


def _f32_steps(what, train_step, state, inputs, steps, per_step, card) -> tuple:
    """``steps`` steps from counts set to 0: each must launch ``per_step``;
    losses finite and falling. Returns (state, result dict)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # this path's run
    state, metrics, step_ms, launches = _timed_steps(train_step, state, inputs, steps)
    counted = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(got != per_step for got in launches):
        raise AssertionError(f"{what}: launches per step {launches}, expected {per_step}")
    totals = [m["loss/total"] for m in metrics]
    if not (all(np.isfinite(list(m.values())).all() for m in metrics) and totals[-1] < totals[0]):
        raise AssertionError(f"{what}: losses {totals} must be finite and fall")
    ms = float(np.median(step_ms[1:]))
    log(f"  {what}: {steps} steps, loss " + " -> ".join(f"{t:.5f}" for t in totals)
        + f"; {ms:.3f} ms/step (median of steps 2-{steps}; first {step_ms[0]:.3f}), peak memory {peak_gb:.3f} GB; "
        f"launches a step {_nonzero(per_step)} on {card}")
    return state, dict(launches=counted, losses=totals, ms_per_step=ms, first_ms=step_ms[0], peak_gb=peak_gb)


def f32_training_phase(device, card: str) -> dict:
    """The fp32 instances end to end. (a) Each against its plain version on
    the card with TF32 off (``F32_FLASH_ROWS``, ``F32_FUSED_ROWS``); (b) the
    350M AE in fp32 at 1024p with sw 1024: every block one fp32 prologue and
    one fp32 #4, decoded patches within F32_MODEL_REL_L2 of the unfused
    composition; (c) fp32-compute training of that model through
    ``make_train_step`` with AdamW: at 1024p (the prologue and #4 forward,
    the prologue, #5 and #6 fold instances backward; then ``checkpoint=1``)
    and at 256 tokens, batch 32, with ``attn_impl="fused"`` (the walker's
    lse instance forward, #3 backward), each step's launches counted, losses
    finite and falling, the first step's gradients within
    F32_TRAIN_GRAD_REL_L2 of the plain backward's."""
    import torch
    from vitok_torch import AE, decode_variant
    from vitok_torch.train_lib import LossConfig, create_optimizer, create_schedule, create_train_state, make_train_step

    t0 = time.time()
    saved_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        flash = [_f32_flash_row(*r, device, flex=i == 0) for i, r in enumerate(F32_FLASH_ROWS)]
        fused = [_f32_fused_row(*r, device) for r in F32_FUSED_ROWS]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved_tf32
    torch.cuda.empty_cache()
    log(f"  fp32 kernel rows: {time.time() - t0:.1f} s")

    cfg_kw = {**decode_variant(VARIANT), "sw": FLASH_SW}
    model = AE(**cfg_kw, seed=0, device=device, compute_dtype=torch.float32, param_dtype=torch.float32,
               trainable=True)
    _random_gates(model, device)
    depth = model.cfg.encoder_depth + model.cfg.decoder_depth
    (case,) = main_path_cases(device, [F32_TRAIN], seed=8)
    name, max_tokens, batch, images, inputs = case
    reference = AE(**{**cfg_kw, "attn_impl": "xla"}, state_dict=model.state_dict(), device=device,
                   compute_dtype=torch.float32)
    log(f"fp32 training path: {VARIANT} with fp32 compute and master weights, sw={FLASH_SW}, {name} batch {batch}")
    with torch.no_grad():
        (out,), ae_launches = _run_counted(model, [case], _expect(flash_attention_f32=depth,
                                                                   fused_qk_prologue_f32=depth), "fp32 AE")
        _check_output(name, max_tokens, batch, images, inputs, out)
        rel = _valid_rel_l2(out, reference.decode(reference.encode(inputs)), inputs)
        if not (out["patches"].dtype == torch.float32 and rel <= F32_MODEL_REL_L2):
            raise AssertionError(f"fp32 AE {name}: rel L2 vs the unfused composition {rel:.3e} > {F32_MODEL_REL_L2}")
        ae_ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=3, warmup=1)
        ref_ms = time_ms(lambda: reference.decode(reference.encode(inputs)), runs=2, warmup=1)
    del reference, out
    torch.cuda.empty_cache()
    log(f"  fp32 AE {name}: {depth} launches each of the fp32 prologue and #4 a forward; rel L2 vs unfused "
        f"{rel:.3e} (limit {F32_MODEL_REL_L2}); encode+decode {ae_ms / batch:.3f} ms/img (unfused "
        f"{ref_ms / batch:.3f}) on {card}")

    side = int(max_tokens ** 0.5)
    loss_cfg = LossConfig(ssim_weight=0.1, tile_size=256, n_tiles=2, ssim_grid=(side, side))
    grad_rel = _f32_first_grads(model, inputs, loss_cfg, plain_flash_backward, device)
    log(f"  fp32 {name} first-step gradients, kernels vs plain backward: rel L2 {grad_rel:.3e} over all parameters")
    tx = create_optimizer(create_schedule("constant", TRAIN_LR, 2 * F32_TRAIN_STEPS + 1, warmup_frac=0.0))
    state = create_train_state(model, tx)
    train_step = make_train_step(tx, loss_cfg)
    per_step = _expect(flash_attention_f32=depth, fused_qk_prologue_f32=2 * depth, flash_attention_dq_f32=depth,
                       flash_attention_dkv_f32=depth)
    state, flash_run = _f32_steps(f"fp32 train {name}", train_step, state, inputs, F32_TRAIN_STEPS, per_step, card)
    _with_checkpoint(model, 1)
    torch.cuda.reset_peak_memory_stats()
    state, _, remat_ms, remat_launches = _timed_steps(train_step, state, inputs, 1)
    remat_expect = _expect(flash_attention_f32=2 * depth, fused_qk_prologue_f32=3 * depth,
                           flash_attention_dq_f32=depth, flash_attention_dkv_f32=depth)
    if remat_launches[0] != remat_expect:
        raise AssertionError(f"fp32 training with checkpoint=1: launches {remat_launches[0]}, expected {remat_expect}")
    remat_peak = torch.cuda.max_memory_allocated() / 1e9
    _with_checkpoint(model, 0)
    log(f"  fp32 train {name}, checkpoint=1: launches {_nonzero(remat_launches[0])}; {remat_ms[0]:.3f} ms (one "
        f"step), peak memory {remat_peak:.3f} GB on {card}")

    (fcase,) = main_path_cases(device, [F32_FUSED_TRAIN], seed=7)
    fname, ftokens, fbatch, _, finputs = fcase
    fside = int(ftokens ** 0.5)
    floss = LossConfig(ssim_weight=0.1, tile_size=256, n_tiles=2, ssim_grid=(fside, fside))
    _set_attn_impl(model, "fused")
    fused_rel = _f32_first_grads(model, finputs, floss, plain_fused_backward, device)
    log(f"  fp32 'fused' {fname} batch {fbatch} first-step gradients, #3 vs its plain version: rel L2 "
        f"{fused_rel:.3e} over all parameters")
    fused_step = make_train_step(tx, floss)
    fused_expect = _expect(fused_attention_f32_lse=depth, fused_attention_bwd_f32=2 * depth,
                           fused_qk_prologue_f32=depth)
    state, fused_run = _f32_steps(f"fp32 train 'fused' {fname} batch {fbatch}", fused_step, state, finputs,
                                  F32_TRAIN_STEPS, fused_expect, card)
    del model, state
    torch.cuda.empty_cache()
    log(f"fp32 training phase: {time.time() - t0:.1f} s")
    return dict(flash_rows=flash, fused_rows=fused, ae_launches=ae_launches, ae_rel_l2=rel,
                ae_ms_per_img=ae_ms / batch, ae_unfused_ms_per_img=ref_ms / batch, grad_rel_l2=grad_rel,
                fused_grad_rel_l2=fused_rel, flash_run=flash_run, fused_run=fused_run, remat_ms=remat_ms[0],
                remat_peak_gb=remat_peak, seconds=time.time() - t0)


def f32_training_entries(f32t: dict) -> list:
    """Kernels-line entries of the fp32 instances: launches from the fp32
    training runs (#4-#6 and the prologue at 1024p, the walker's lse
    instance and #3 at 256 tokens); times at the 350M 1024p row (#4-#6, the
    prologue) and the 256-token row (the lse instance, #3), the other rows'
    times beside them."""
    flash, fused = f32t["flash_rows"], f32t["fused_rows"]
    main, top = flash[0], fused[0]
    fl_run, fu_run = f32t["flash_run"]["launches"], f32t["fused_run"]["launches"]
    src_fl, src_sm90 = "vitok_torch/csrc/flash_attention_f32.cu", "vitok_torch/csrc/fused_attention_sm90.cu"
    others = lambda rows, *keys: [{"shape": r["shape"], "case": r["case"], **{k: r[k] for k in keys}} for r in rows]

    def entry(name, source, replaces, launches, row, key, err, library, plain=None, **more):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": row[err], "ms": row[f"{key}ms"], "plain_ms": row[plain or f"{key}plain_ms"],
                "bound_ms": row[f"{key}bound_ms"], "bound_by": row[f"{key}bound_by"],
                "library_ms": None if library is None else row[library], "dev_ms": row[f"{key}dev_ms"], **more}

    return [
        entry("flash_attention_f32", src_fl, "vitok_tpu/ops/flash_attention.py:67", fl_run["flash_attention_f32"],
              main, "", "max_abs_err", "library_ms", flex_ms=main["flex_ms"], flex_rel_err=main["flex_rel_err"],
              lse_max_abs_err=max(r["lse_max_abs_err"] for r in flash),
              rows=others(flash, "ms", "dev_ms", "plain_ms", "bound_ms", "library_ms", "f64_rel_err",
                          "f64_plain_rel_err")),
        entry("flash_attention_dq_f32", src_fl, "vitok_tpu/ops/flash_attention.py:427",
              fl_run["flash_attention_dq_f32"], main, "dq_", "dq_max_abs_err", "bwd_library_ms", plain="bwd_plain_ms",
              fold_ms=main["fold_dq_ms"], fold_dev_ms=main["fold_dq_dev_ms"],
              rows=others(flash, "dq_ms", "dq_dev_ms", "fold_dq_ms", "bwd_plain_ms", "dq_bound_ms", "bwd_library_ms",
                          "dq_f64_rel_err", "dq_f64_plain_rel_err")),
        entry("flash_attention_dkv_f32", src_fl, "vitok_tpu/ops/flash_attention.py:556",
              fl_run["flash_attention_dkv_f32"], main, "dkv_", "dkv_max_abs_err", "bwd_library_ms",
              plain="bwd_plain_ms", fold_ms=main["fold_dkv_ms"], fold_dev_ms=main["fold_dkv_dev_ms"],
              fold_bwd_ms=main["fold_bwd_ms"], fold_bwd_plain_ms=main["fold_bwd_plain_ms"],
              fold_bwd_bound_ms=main["fold_bwd_bound_ms"], fold_bwd_max_abs_err=main["fold_bwd_max_abs_err"],
              rows=others(flash, "dkv_ms", "dkv_dev_ms", "fold_dkv_ms", "dkv_bound_ms", "fold_bwd_ms",
                          "dkv_f64_rel_err", "dkv_f64_plain_rel_err")),
        entry("fused_qk_prologue_f32", src_sm90, "vitok_tpu/ops/fused_attention.py:124",
              fl_run["fused_qk_prologue_f32"] + fu_run["fused_qk_prologue_f32"], main, "prologue_",
              "prologue_max_abs_err", None,
              rows=others(flash, "prologue_ms", "prologue_dev_ms", "prologue_plain_ms", "prologue_bound_ms")),
        entry("fused_attention_f32_lse", "vitok_torch/csrc/fused_attention_ab_f32_sm90.cu",
              "vitok_tpu/ops/fused_attention.py:317", fu_run["fused_attention_f32_lse"], top, "", "max_abs_err",
              "library_ms", lse_max_abs_err=max(r["lse_max_abs_err"] for r in fused),
              rows=others(fused, "ms", "dev_ms", "plain_ms", "bound_ms", "library_ms")),
        entry("fused_attention_bwd_f32", src_fl, "vitok_tpu/ops/fused_attention.py:645",
              fu_run["fused_attention_bwd_f32"], top, "bwd_", "bwd_max_abs_err", "bwd_library_ms",
              rows=others(fused, "bwd_ms", "bwd_dev_ms", "bwd_plain_ms", "bwd_bound_ms", "bwd_library_ms")),
    ]


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
    want = _expect(fused_attention=depth, fused_attention_bwd=2 * depth)
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


# ---------------------------------------------------------------------------
# The training-data slice: tar shards, the decode pool and the native collate;
# Muon and remat_save through the trainer CLI; peak memory under three
# recomputation policies; DiT Muon steps; the bulk tokenizer
# ---------------------------------------------------------------------------

SLICE_SHARDS = 4           # shards-{0000..0003}.tar
LOADER_IMAGES = 256
LOADER_BATCH = 64
LOADER_WORKERS = 8
LOADER_PP = "to_tensor|normalize(minus_one_to_one)|patchify(16, 256)"  # the fused native tail at 256p
LOADER_SIZES = EVAL_SIZES  # (width, height), all within 256 px
HIGHRES_SHARD_IMAGES = 12  # 1024-px JPEGs for the trainer
REMAT_SAVE = ("qkv_out", "ffn_hid", "attn_out")  # the JAX package's measured-best policy
MUON_STEPS = 5
MUON_ARGS = ("--variant", VARIANT, "--sw", "1024", "--max-tokens", "4096", "--bs", "2",
             "--steps", str(MUON_STEPS), "--optimizer", "muon", "--checkpoint", "1",
             "--remat-save", ",".join(REMAT_SAVE), "--lr", str(TRAIN_LR), "--log-freq", "1", "--save-freq", "0")
# The first Muon update on the card against the CPU's from the same gradients,
# on these parameters (three matrices, Adam's gains and a bias): bf16
# Newton-Schulz carries last-digit differences of the fp32 Gram matrix to ~1%
# of the direction (vitok_torch/muon.py; the CPU tests measure the same
# against the JAX package).
MUON_CPU_PARAMS = ("encoder_blocks.0.attn.out_proj.weight", "to_code.weight", "decoder_embed.weight",
                   "encoder_blocks.0.norm1.weight", "encoder_blocks.0.attn.norm_q.weight",
                   "decoder_blocks.0.layer_scale.gamma", "patch_embed.bias")
MUON_CPU_REL = 5e-2
REMAT_CELLS = (  # (label, variant, tokens, batch, attn_impl, sw): benchmark_mfu.run_train cells
    ("350M@256 tokens B32 fused", "350M", 256, 32, "fused", 0),
    ("350M@4096 tokens B2 sw1024", "350M", 4096, 2, "auto", 1024),
)
REMAT_ITERS = 3
REMAT_POLICIES = (("checkpoint=0", 0, ()), ("checkpoint=1", 1, ()), ("checkpoint=1+remat_save", 1, REMAT_SAVE))
# The worst rel L2 of one parameter's gradient, a recomputing policy's against
# checkpoint=0's: the replay runs the same kernels (no atomics) on the same
# inputs, so they differ at most in the order of a library product's sums. A
# gradient 1% off (a wrong replay's product, tried on the CPU) reads 1e-2.
REMAT_GRAD_REL = 5e-3
DIT_MUON_STEPS = 3
TOKENIZE_MODEL = EVAL_MODEL
TOKENIZE_ARGS = ("--random-weights", "--max-size", "256", "--batch-size", str(LOADER_BATCH),
                 "--decode-workers", str(LOADER_WORKERS))


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _photo(rng, w: int, h: int) -> np.ndarray:
    """A photograph-like RGB array: smooth gradients, a wave and mild noise
    (pure noise would overstate JPEG decode)."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    a, b, fx, fy = rng.uniform(0.3, 1.0), rng.uniform(0.3, 1.0), rng.uniform(1, 5), rng.uniform(1, 5)
    base = a * xx + b * yy + 0.3 * np.sin(2 * np.pi * (fx * xx + fy * yy))
    img = base[..., None] * rng.uniform(0.4, 1.0, 3)[None, None]
    img = (img - img.min()) / (np.ptp(img) + 1e-9)
    return (img * 255 + rng.normal(0, 5, img.shape)).clip(0, 255).astype(np.uint8)


def _write_shards(root: str, n: int, sizes, seed: int) -> tuple:
    """``n`` seeded JPEGs (quality 90) with ``.cls`` labels over
    ``SLICE_SHARDS`` tar shards; returns the brace pattern and the sizes."""
    import io
    import tarfile
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    per = -(-n // SLICE_SHARDS)
    written = []
    for s in range(SLICE_SHARDS):
        with tarfile.open(os.path.join(root, f"shards-{s:04d}.tar"), "w") as tf:
            for i in range(s * per, min(n, (s + 1) * per)):
                w, h = sizes[i % len(sizes)]
                buf = io.BytesIO()
                Image.fromarray(_photo(rng, w, h)).save(buf, format="JPEG", quality=90)
                for ext, data in (("jpg", buf.getvalue()), ("cls", str(i % 1000).encode())):
                    info = tarfile.TarInfo(name=f"{i:06d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
                written.append((w, h))
    return os.path.join(root, "shards-{0000..%04d}.tar" % (SLICE_SHARDS - 1)), written


def loader_phase(pattern: str, card: str) -> dict:
    """The 256p pp over the shards, batch 64, three host rates: serial with
    the numpy collate, serial with the native collate, the native collate
    with ``LOADER_WORKERS`` decode workers. The pool's batches equal the
    serial ones bit for bit; the native collate's are within 1e-5 of numpy's
    in ``patches`` and equal elsewhere."""
    from vitok_torch.data import create_dataloader
    from vitok_torch.native import native_available

    t0 = time.perf_counter()
    if not native_available():
        raise AssertionError("loader: VITOK_DISABLE_NATIVE is set; the native collate is measured here")
    build_s = time.perf_counter() - t0
    runs = {}
    for name, numpy_collate, workers in (("serial, numpy collate", True, 0), ("serial, native collate", False, 0),
                                         (f"native collate, {LOADER_WORKERS} decode workers", False, LOADER_WORKERS)):
        if numpy_collate:
            os.environ["VITOK_DISABLE_NATIVE"] = "1"  # the package's switch to the numpy version
        try:
            t0 = time.perf_counter()
            batches = list(create_dataloader(pattern, LOADER_PP, batch_size=LOADER_BATCH, seed=0, partial=True,
                                             return_labels=True, decode_workers=workers))
            seconds = time.perf_counter() - t0
        finally:
            os.environ.pop("VITOK_DISABLE_NATIVE", None)
        n = sum(len(b["labels"]) for b in batches)
        if n != LOADER_IMAGES:
            raise AssertionError(f"loader {name}: {n} images, expected {LOADER_IMAGES}")
        runs[name] = (batches, n / seconds)
    (numpy_b, _), (native_b, _), (pool_b, _) = runs.values()
    worst = 0.0
    for a, b, c in zip(numpy_b, native_b, pool_b, strict=True):
        for key in a:
            if not np.array_equal(c[key], b[key]):
                raise AssertionError(f"loader: the decode pool's {key} differs from the serial batch")
            if key == "patches":
                worst = max(worst, float(np.abs(b[key] - a[key]).max()))
            elif not np.array_equal(a[key], b[key]):
                raise AssertionError(f"loader: the native collate's {key} differs from numpy's")
    if not worst <= 1e-5:
        raise AssertionError(f"loader: native patches differ from numpy's by {worst:.3e} > 1e-5")
    rates = {name: rate for name, (_, rate) in runs.items()}
    log(f"  loader over {SLICE_SHARDS} tar shards, {LOADER_IMAGES} JPEGs up to 256 px, {LOADER_PP}, batch "
        f"{LOADER_BATCH}: " + ", ".join(f"{k} {v:.1f} img/s" for k, v in rates.items())
        + f" (host clock, the card's host, {os.cpu_count()} cores); pool = serial bit for bit, native vs numpy "
        f"max |patches| diff {worst:.3e}; native build/load {build_s:.2f} s")
    return rates


def _muon_cpu_check(tx, model, params, grads) -> dict:
    """Copies for the CPU replay of the first Muon update: the global
    clipping factor and the chosen parameters and gradients."""
    import torch
    from vitok_torch.train_lib import global_norm

    names = [n for n, _ in model.named_parameters()]
    idx = [names.index(n) for n in MUON_CPU_PARAMS]
    g_norm = global_norm(grads)
    factor = torch.where(g_norm < tx.grad_clip, torch.ones_like(g_norm), tx.grad_clip / g_norm).cpu()
    return dict(idx=idx, factor=factor, p=[params[i].detach().cpu().clone() for i in idx],
                g=[grads[i].detach().cpu().clone() for i in idx], matrix=[tx._matrix[i] for i in idx])


def _muon_cpu_compare(tx, check, params) -> float:
    """The first update on the CPU from the same clipped gradients (Muon's
    plain host path), against the card's: the largest rel L2 of an update."""
    import torch
    from vitok_torch.muon import Muon

    cpu = Muon(tx.schedule, momentum=tx.momentum, nesterov=tx.nesterov, ns_steps=tx.ns_steps, adam_b1=tx.b1,
               adam_b2=tx.b2, adam_eps=tx.eps, grad_clip=None, moment_dtype=tx.moment_dtype)
    p = [t.clone() for t in check["p"]]
    state = cpu.init_params(p, check["matrix"])
    cpu.update(p, [g * check["factor"] for g in check["g"]], state)
    worst = 0.0
    for i, before, after in zip(check["idx"], check["p"], p):
        want, got = after - before, params[i].detach().cpu() - before
        worst = max(worst, ((got - want).norm() / want.norm().clamp_min(1e-30)).item())
    return worst


def muon_training_phase(hr_pattern: str, device, card: str, tmp: str) -> dict:
    """``vitok_torch.scripts.train_vae.main`` in this process: 350M at full
    depth on the 1024-px shards, ``MUON_ARGS`` (Muon, ``checkpoint=1`` with
    ``remat_save``). Every block takes the fold: per step 2 x depth #4 and
    3 x depth prologues (the selective replay runs the forward again), depth
    #5 and #6. The trainer's own step and optimizer are wrapped to count each
    step's launches, time each update (CUDA events around ``tx.update``),
    hold the first step's gradients against the plain backward, and replay
    the first update on the CPU."""
    import torch
    from vitok_torch import train_lib
    from vitok_torch.scripts import train_vae
    from vitok_torch.train_lib import compute_loss

    rec = dict(steps=[], step_ms=[], losses=[], updates=[], check=None, grad_rel=None, cpu_rel=None)
    orig_step, orig_opt = train_lib.make_train_step, train_lib.create_optimizer

    def create_optimizer(*a, **k):
        tx = orig_opt(*a, **k)
        update = tx.update

        def timed_update(params, grads, state, **kw):
            first = rec["check"] is None
            if first:
                rec["check"] = _muon_cpu_check(tx, rec["model"], params, grads)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            update(params, grads, state, **kw)
            end.record()
            rec["updates"].append((start, end))
            if first:
                rec["cpu_rel"] = _muon_cpu_compare(tx, rec["check"], params)

        tx.update = timed_update
        rec["tx"] = tx
        return tx

    def make_train_step(tx, loss_cfg, *a, **k):
        step = orig_step(tx, loss_cfg, *a, **k)

        def counted(state, batch, rng=None, **kw):
            model = rec["model"] = state.model
            if not rec["steps"]:  # the first step's gradients: kernels against the plain backward
                params = list(model.parameters())

                def grads_of():
                    gen = torch.Generator(device=device).manual_seed(rng * 1_000_003 + state.step)
                    loss, _ = compute_loss(model, batch, loss_cfg, gen)
                    return loss.detach(), torch.autograd.grad(loss, params)

                loss_k, g_kernel = grads_of()
                with plain_flash_backward():
                    loss_p, g_plain = grads_of()
                num = sum((x.double() - y.double()).square().sum() for x, y in zip(g_kernel, g_plain))
                rec["grad_rel"] = (num / sum(y.double().square().sum() for y in g_plain)).sqrt().item()
                if not (rec["grad_rel"] <= TRAIN_GRAD_REL_L2 and loss_k.item() == loss_p.item()):
                    raise AssertionError(f"Muon training: first-step gradients vs the plain backward rel L2 "
                                         f"{rec['grad_rel']:.3e} (limit {TRAIN_GRAD_REL_L2}), loss {loss_k.item()} "
                                         f"vs {loss_p.item()}")
                del g_kernel, g_plain
                reset_counts()  # the Muon + remat_save training path's run
            before = launch_counts()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, rng, **kw)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["steps"].append({n: v - before[n] for n, v in launch_counts().items()})
            rec["losses"].append(float(metrics["loss/total"]))
            return state, metrics

        return counted

    t0 = time.time()
    train_lib.make_train_step, train_lib.create_optimizer = make_train_step, create_optimizer
    try:
        train_vae.main([*MUON_ARGS, "--data", hr_pattern, "--output-dir", os.path.join(tmp, "vae"),
                        "--device", device.type])
    finally:
        train_lib.make_train_step, train_lib.create_optimizer = orig_step, orig_opt
    torch.cuda.synchronize()
    launches = launch_counts()
    model, tx = rec["model"], rec["tx"]
    depth = model.cfg.encoder_depth + model.cfg.decoder_depth
    per_step = _expect(flash_attention=2 * depth, fused_qk_prologue=3 * depth, flash_attention_dq=depth,
                       flash_attention_dkv=depth)
    if len(rec["steps"]) != MUON_STEPS or any(got != per_step for got in rec["steps"]):
        raise AssertionError(f"Muon training: launches per step {rec['steps']}, expected {per_step}")
    if not np.isfinite(rec["losses"]).all():
        raise AssertionError(f"Muon training: losses {rec['losses']} must be finite")
    if not rec["cpu_rel"] <= MUON_CPU_REL:
        raise AssertionError(f"Muon training: the first update vs the CPU's rel L2 {rec['cpu_rel']:.3e} > {MUON_CPU_REL}")
    muon_ms = [s.elapsed_time(e) for s, e in rec["updates"]]

    # AdamW's update on the same parameters, for comparison: three timed after one.
    adamw = orig_opt(tx.schedule)
    params = list(model.parameters())
    state = adamw.init(model)
    gen = torch.Generator(device=device).manual_seed(4)
    grads = [torch.randn(p.shape, generator=gen, device=device) * 1e-3 for p in params]
    adamw_ms = []
    for i in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        g = [x.clone() for x in grads]
        start.record()
        adamw.update(params, g, state)
        end.record()
        torch.cuda.synchronize()
        if i:
            adamw_ms.append(start.elapsed_time(end))
    n_params = sum(p.numel() for p in params)
    ms = float(np.median(rec["step_ms"][1:]))
    log(f"  train_vae.main: {VARIANT} ({n_params / 1e6:.1f}M), 1024-px shards, 4096 tokens batch 2, sw 1024, "
        f"Muon (momentum {tx.momentum}, no weight decay) + checkpoint=1 with remat_save {','.join(REMAT_SAVE)}; "
        f"{MUON_STEPS} steps: loss " + " -> ".join(f"{x:.5f}" for x in rec["losses"])
        + f"; launches a step {_nonzero(per_step)}; first-step gradients vs plain backward rel L2 {rec['grad_rel']:.3e}; "
        f"first update vs the CPU's (on {len(MUON_CPU_PARAMS)} parameters) rel L2 {rec['cpu_rel']:.3e} "
        f"(limit {MUON_CPU_REL})")
    log(f"  {ms:.3f} ms/step (host clock, median of steps 2-{MUON_STEPS}; first {rec['step_ms'][0]:.3f}); "
        f"optimizer update (CUDA events): Muon {float(np.median(muon_ms[1:])):.3f} ms (steps 2-{MUON_STEPS}; "
        f"first {muon_ms[0]:.3f}), AdamW {float(np.median(adamw_ms)):.3f} ms on the same parameters; "
        f"main() {time.time() - t0:.1f} s on {card}")
    del model, state, grads, params, adamw
    rec.pop("model")
    rec.pop("tx")
    return dict(launches=launches, losses=rec["losses"], ms_per_step=ms, grad_rel=rec["grad_rel"],
                cpu_rel=rec["cpu_rel"], muon_update_ms=float(np.median(muon_ms[1:])),
                adamw_update_ms=float(np.median(adamw_ms)))


def _policy_grads(variant: str, tokens: int, batch: int, impl: str, sw: int, device) -> dict:
    """One batch's gradients under each of ``REMAT_POLICIES``, from one
    model with ``run_train``'s initial weights, batch and loss: for each
    recomputing policy, the worst rel L2 of a parameter's gradient against
    ``checkpoint=0``'s."""
    import torch
    from vitok_torch.benchmarks import make_batch
    from vitok_torch.benchmarks.benchmark_mfu import VARIANT_ALIASES, _grid
    from vitok_torch.models.ae import AE, decode_variant
    from vitok_torch.train_lib import LossConfig, compute_loss

    kw = decode_variant(VARIANT_ALIASES[variant])
    if sw:
        kw["sw"] = sw
    model = AE(**kw, attn_impl=impl, seed=0, device=device, param_dtype=torch.float32, trainable=True)
    data = make_batch(batch, tokens, _grid(tokens), model.cfg.pixels_per_token, device=device)
    params = list(model.parameters())
    ref, rel = None, {}
    for policy, ck, save in REMAT_POLICIES:
        model.cfg = dataclasses.replace(model.cfg, checkpoint=ck, remat_save=save)
        loss, _ = compute_loss(model, data, LossConfig(), torch.Generator(device=device).manual_seed(7))
        grads = torch.autograd.grad(loss, params)
        if ref is None:
            ref = grads
        else:
            rel[policy] = max(((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()
                              for a, b in zip(grads, ref))
        del loss, grads
    del model, params, ref, data
    torch.cuda.empty_cache()
    return rel


def remat_memory_phase(device, card: str) -> dict:
    """``benchmark_mfu.run_train`` at the two ``REMAT_CELLS`` under
    ``checkpoint=0``, ``checkpoint=1`` and ``checkpoint=1`` with
    ``remat_save``: the warm-up step's loss is the same bits under all three,
    and the ``remat_save`` peak lies between the other two. Before the runs,
    one batch's gradients under each recomputing policy are held against
    ``checkpoint=0``'s (a wrong replay moves them, the loss does not)."""
    import torch
    from vitok_torch.benchmarks.benchmark_mfu import run_train

    cells = {}
    launches: dict = {}
    for label, variant, tokens, batch, impl, sw in REMAT_CELLS:
        grad_rel = _policy_grads(variant, tokens, batch, impl, sw, device)
        if not all(r <= REMAT_GRAD_REL for r in grad_rel.values()):
            raise AssertionError(f"remat {label}: a parameter's gradient vs checkpoint=0's: worst rel L2 "
                                 f"{grad_rel} (limit {REMAT_GRAD_REL})")
        runs = {}
        for policy, ck, save in REMAT_POLICIES:
            torch.cuda.empty_cache()
            before = launch_counts()
            runs[policy] = run_train(variant, tokens, batch, REMAT_ITERS, ck, remat_save=save, attn_impl=impl,
                                     sw=sw, device=device)
            for k, v in launch_counts().items():
                launches[k] = launches.get(k, 0) + v - before[k]
        losses = {p: r["first_loss"] for p, r in runs.items()}
        peaks = {p: r["peak_gb"] for p, r in runs.items()}
        if len(set(losses.values())) != 1 or not np.isfinite(list(losses.values())).all():
            raise AssertionError(f"remat {label}: first-step losses {losses} must be equal and finite")
        if not peaks["checkpoint=1"] < peaks["checkpoint=1+remat_save"] < peaks["checkpoint=0"]:
            raise AssertionError(f"remat {label}: peak memory {peaks}: remat_save must lie between the other two")
        cells[label] = {p: dict(ms_per_step=r["ms_per_step"], peak_gb=r["peak_gb"], mfu=r["mfu"],
                                grad_rel=grad_rel.get(p, 0.0)) for p, r in runs.items()}
        log(f"  {label}: " + "; ".join(f"{p} {r['ms_per_step']:.3f} ms/step, peak {r['peak_gb']:.3f} GB"
                                       for p, r in runs.items())
            + f"; first-step loss {losses['checkpoint=0']!r} under all three (CUDA events, {REMAT_ITERS} steps "
            f"after one, AdamW); one batch's gradients vs checkpoint=0's, worst parameter's rel L2 "
            + ", ".join(f"{p} {r:.3e}" for p, r in grad_rel.items()) + f" (limit {REMAT_GRAD_REL}) on {card}")
    return dict(cells=cells, launches=launches)


def dit_muon_phase(device, card: str, tmp: str) -> dict:
    """``vitok_torch.scripts.train_dit.main`` in this process: DiT-L on the
    DiT training phase's seeded latents (written as ``.npy`` files), batch
    64, ``--optimizer muon``, three steps, the model built with
    ``attn_impl="fused"`` (the CLI keeps the JAX default, whose training
    takes the unfused attention): finite losses, depth forward and depth
    backward launches of the fused kernels a step."""
    import contextlib as _ctx
    import functools
    import io
    import torch
    from vitok_torch.models import dit as dit_mod
    from vitok_torch.models.dit import decode_variant as dit_variant
    from vitok_torch.scripts import train_dit

    root = os.path.join(tmp, "latents")
    os.makedirs(root, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(12)  # the DiT training phase's latents
    z = torch.randn((DIT_TRAIN_BATCH, DIT_TOKENS, DIT_CODE_WIDTH), generator=gen, device=device).cpu().numpy()
    labels = torch.randint(0, 1000, (DIT_TRAIN_BATCH,), generator=gen, device=device).cpu().numpy()
    for i in range(DIT_TRAIN_BATCH):
        np.save(os.path.join(root, f"z_{i:04d}.npy"), {"z": z[i], "label": int(labels[i])}, allow_pickle=True)
    depth = dit_variant(DIT_VARIANT)["depth"]
    out = io.StringIO()
    reset_counts()  # the DiT Muon path's run
    t0 = time.perf_counter()
    orig = dit_mod.DiT
    dit_mod.DiT = functools.partial(orig, attn_impl="fused")  # main() imports it at call time
    try:
        with _ctx.redirect_stdout(out):
            train_dit.main(["--dit", DIT_VARIANT, "--data", root, "--bs", str(DIT_TRAIN_BATCH), "--steps",
                            str(DIT_MUON_STEPS), "--optimizer", "muon", "--log-freq", "1", "--save-freq", "0",
                            "--output-dir", os.path.join(tmp, "dit"), "--device", device.type])
    finally:
        dit_mod.DiT = orig
    seconds = time.perf_counter() - t0
    logs = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    losses = [entry["loss"] for entry in logs]
    launches = launch_counts()
    want = _expect(fused_attention=DIT_MUON_STEPS * depth, fused_attention_bwd=2 * DIT_MUON_STEPS * depth)
    if launches != want or len(losses) != DIT_MUON_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"DiT Muon: launches {launches} (expected {want}), losses {losses}")
    log(f"  train_dit.main: DiT-{DIT_VARIANT}, {DIT_TRAIN_BATCH} seeded latents of {DIT_TOKENS}x{DIT_CODE_WIDTH}, "
        f"Muon, attn_impl fused, {DIT_MUON_STEPS} steps: loss " + " -> ".join(f"{x:.5f}" for x in losses)
        + f", steps/s " + ", ".join(str(e["steps_per_s"]) for e in logs)
        + f"; launches {depth} forward and {depth} backward a step; main() {seconds:.1f} s on {card}")
    return dict(launches=launches, losses=losses)


def tokenize_phase(pattern: str, sizes, device, card: str, tmp: str) -> dict:
    """``vitok_torch.scripts.tokenize_data.main`` in this process over the
    shards: encode in bf16 and with ``--quant`` (the encoder's 4 blocks a
    batch: #1 and its prologue, and #9 and #7 in int8), then decode the
    bf16 shards (24 blocks a batch): every image comes back at its size."""
    from PIL import Image
    from vitok_torch import AEConfig
    from vitok_torch.pretrained import get_pretrained_info, list_pretrained
    from vitok_torch.scripts import tokenize_data

    named = TOKENIZE_MODEL in list_pretrained()
    cfg = AEConfig.from_variant(get_pretrained_info(TOKENIZE_MODEL)[2] if named else TOKENIZE_MODEL)
    enc, dec = cfg.encoder_depth, cfg.decoder_depth
    nb = -(-LOADER_IMAGES // LOADER_BATCH)
    runs = {}
    launches: dict = {}
    for name, argv, want in (
            ("encode bf16", ["encode", "--data", pattern, "--output", os.path.join(tmp, "lat")],
             _expect(fused_attention=enc * nb)),
            ("encode int8", ["encode", "--data", pattern, "--output", os.path.join(tmp, "lat8"), "--quant"],
             _expect(fused_attention=enc * nb, rmsnorm_quant=enc * nb, ffn_int8=enc * nb)),
            ("decode bf16", ["decode", "--data", os.path.join(tmp, "lat"), "--output", os.path.join(tmp, "png")],
             _expect(fused_attention=dec * nb))):
        reset_counts()  # the tokenizer's run
        t0 = time.perf_counter()
        stats = tokenize_data.main([*argv, "--model", TOKENIZE_MODEL, *TOKENIZE_ARGS, "--device", device.type])
        seconds = time.perf_counter() - t0
        got = launch_counts()
        if got != want or stats["n_images"] != LOADER_IMAGES:
            raise AssertionError(f"tokenize {name}: {stats['n_images']} images, launches {got} (expected {want})")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        runs[name] = dict(img_per_s=stats["img_per_s"], wall_s=stats["wall_s"], main_s=seconds)
    pngs = sorted(os.listdir(os.path.join(tmp, "png")))
    got_sizes = sorted(Image.open(os.path.join(tmp, "png", p)).size for p in pngs)
    if len(pngs) != LOADER_IMAGES or got_sizes != sorted(sizes):
        raise AssertionError(f"tokenize: {len(pngs)} PNGs; their sizes differ from the originals'")
    log(f"  tokenize_data.main over the shards ({LOADER_IMAGES} images, batch {LOADER_BATCH}, "
        f"{LOADER_WORKERS} decode workers, 350M random weights): "
        + "; ".join(f"{k} {v['img_per_s']} img/s ({v['wall_s']} s, main() {v['main_s']:.1f} s)" for k, v in runs.items())
        + f"; every PNG at its original size; launches {_nonzero(launches)} on {card}")
    return dict(runs=runs, launches=launches)


def training_data_phase(device, card: str) -> dict:
    """The training-data slice's phases a-e on seeded tar shards."""
    import tempfile
    import torch

    t0 = time.time()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        pattern, sizes = _write_shards(os.path.join(tmp, "shards"), LOADER_IMAGES, LOADER_SIZES, seed=31)
        hr_pattern, _ = _write_shards(os.path.join(tmp, "hr"), HIGHRES_SHARD_IMAGES, TRAIN[3], seed=32)
        log(f"training-data slice: wrote {SLICE_SHARDS} shards of {LOADER_IMAGES} JPEGs and {SLICE_SHARDS} of "
            f"{HIGHRES_SHARD_IMAGES} 1024-px JPEGs in {time.time() - t0:.1f} s")
        out["loader"] = loader_phase(pattern, card)
        out["muon"] = muon_training_phase(hr_pattern, device, card, tmp)
        torch.cuda.empty_cache()
        out["remat"] = remat_memory_phase(device, card)
        torch.cuda.empty_cache()
        out["dit_muon"] = dit_muon_phase(device, card, tmp)
        torch.cuda.empty_cache()
        out["tokenize"] = tokenize_phase(pattern, sizes, device, card, tmp)
        torch.cuda.empty_cache()
    launches: dict = {}
    for part in ("muon", "remat", "dit_muon", "tokenize"):
        for k, v in out[part]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    log(f"training-data slice: {time.time() - t0:.1f} s")
    return out


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


# ---------------------------------------------------------------------------
# #2 in fp32, and the instances of #7, #8 and #9 past their widths
# ---------------------------------------------------------------------------

Q8_F32_SHAPE = ("350M@256p", 16, 256, 1024, 16)  # (label, B, N, C, H): the int8 fp32 path's blocks, a tail
Q8_F32_PATH = ("256p", 256, 16, RESOLUTIONS[0][3])  # the int8 fp32-compute 350M forward, the epilogue on
WIDE_M = 2048  # token rows of the wide instances: 8 images of 256 tokens
WIDE_FP = 20480  # #7 and #8 (F' past 19,456 and 16,384)
WIDE_FFN_C = 1024
WIDE_NORM_C = 12288  # #9 (C past 8,192)
# Int8 models whose blocks take the wide instances (depth cut to one block
# each side, random int8 weights): C 12288 (96 heads of 128, F' 32,896) takes
# #9 wide and #7's scratch instance; C 6208 (97 heads of 64, F' 16,640; C is
# not a multiple of 128, so #7's gate closes) takes #8 wide after the int8
# fc1 product.
WIDE_MODELS = (("w12288_d1_h96-w12288_d1_h96/1x16x64", dict(rmsnorm_quant_wide=2, ffn_int8_wide=2,
                                                              fused_attention=2)),
               ("w6208_d1_h97-w6208_d1_h97/1x16x64", dict(rmsnorm_quant=2, silu_quant_wide=2)))
WIDE_PATH = ("256p", 256, 8, [(256, 256)])


def wide_kernel_phase(device, card: str) -> dict:
    """#2's fp32 instance (the fp32 walker, then the row quantize) against
    ``quantize_activation`` of the fp32 forward bit for bit and its plain
    version within the forward's limits; #7's scratch instance and the wide
    rows of #8 and #9 against their plain versions bit for bit; each timed
    beside its bound and its plain version. Then the paths that launch them:
    the int8 350M model on fp32 compute at 256 tokens with the epilogue on
    (#2 f32 in every block, held to the run with the opt-in off), and the
    two wide int8 models (held to themselves on the quantize kernels' plain
    versions)."""
    import torch
    from vitok_torch import AE, decode_variant
    from vitok_torch.ops import fused_attention as fa
    from vitok_torch.ops import quant

    rows = {}
    gen = torch.Generator(device=device).manual_seed(20)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=device)
    log("kernel phase: #2 fp32 (fp32 walker + row quantize), #7 scratch instance, #8 and #9 wide rows vs their "
        f"references, on {card}")

    # #2 f32 at the 350M width, 256 tokens, a tail mask.
    label, b, n, c, h = Q8_F32_SHAPE
    rng = np.random.default_rng(20)
    qkv, qs, ks, cos, sin, mask = _attention_inputs(rng, b, n, c, h, True, device)
    qkv = qkv.float()
    args = (qkv, qs, ks, cos, sin, mask)
    got = fa.fused_qkv_attention_q8(*args, num_heads=h)
    want = quant.quantize_activation(fa.fused_qkv_attention(*args, num_heads=h, impl="fused"))
    n_codes, n_scales = int((got[0] != want[0]).sum()), int((got[1] != want[1]).sum())
    plain = fa.fused_qkv_attention_q8_plain(*args, num_heads=h)
    deq = (got[0].float() * got[1] - plain[0].float() * plain[1]).abs()[mask]
    if n_codes or n_scales or not deq.max().item() <= 2e-2:
        raise AssertionError(f"#2 fp32 {label}: {n_codes} codes and {n_scales} scales differ from quantize_activation "
                             f"of the fp32 forward (expected 0); dequantized vs plain max {deq.max().item():.3e}")
    d = c // h
    nbytes = b * n * 3 * c * 4 + b * n * c + b * n * 4 + 2 * b * n * (d // 2) * 4 + 2 * d * 4 + b * n
    bound = _bound_ms(nbytes, 6 * 4.0 * h * d * _needed_pairs(b, mask, n, None), BF16_FLOPS_PER_S)
    attrs = fa.quantize_rows_attributes(c, qkv.device)
    rows["fused_attention_q8_f32"] = row = dict(
        shape=label, max_abs_err=deq.max().item(), codes_differ=0,
        ms=time_ms(lambda: fa.fused_qkv_attention_q8(*args, num_heads=h)),
        walker_ms=time_ms(lambda: fa.fused_qkv_attention(*args, num_heads=h, impl="fused")),
        plain_ms=time_ms(lambda: fa.fused_qkv_attention_q8_plain(*args, num_heads=h)),
        bound_ms=bound[0], bound_by=bound[1], library_ms=None, quantize_registers=attrs["registers"],
        quantize_spill_bytes=attrs["spill_bytes"])
    log(f"  #2 fp32 {label}: codes and scales = quantize_activation(fp32 forward) bit for bit; dequantized vs plain "
        f"max {row['max_abs_err']:.3e}; {row['ms']:.4f} ms (the walker alone {row['walker_ms']:.4f}), plain "
        f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.5f} ({row['bound_by']}); row quantize "
        f"{attrs['registers']} registers, {attrs['spill_bytes']} local bytes")
    del qkv, args, got, want, plain

    # #7's scratch instance: C 1024, F' 20,480, M 2048.
    m, c, fp = WIDE_M, WIDE_FFN_C, WIDE_FP
    hq, hs = quant.quantize_activation(randn(m, c))
    w, ws = quant.quantize_weight(0.05 * randn(2 * fp, c))
    plan = quant.ffn_int8_plan(m, c, fp)
    if not plan.scratch:
        raise AssertionError(f"ffn_int8 at F' {fp}: expected the scratch instance, plan {plan}")
    err = _exact_codes(f"ffn_int8 scratch F'={fp}", quant.fused_ffn_int8(hq, hs, w, ws),
                       quant.fused_ffn_int8_plain(hq, hs, w, ws))
    fattrs = quant.ffn_int8_attributes(plan, fp)
    nbytes = m * c + m * 4 + 2 * fp * c + 2 * fp * 4 + m * fp + m * 4
    bound = _bound_ms(nbytes, 2.0 * m * c * 2 * fp, INT8_OPS_PER_S)
    rows["ffn_int8_wide"] = row = dict(
        shape=f"M {m} C {c} F' {fp}", **err, ms=time_ms(lambda: quant.fused_ffn_int8(hq, hs, w, ws)),
        plain_ms=time_ms(lambda: quant.fused_ffn_int8_plain(hq, hs, w, ws)), bound_ms=bound[0], bound_by=bound[1],
        library_ms=None, int_mm_fc1_ms=time_ms(lambda: torch._int_mm(hq, w.t())), rows=plan.rows,
        cluster=plan.cluster, stages=plan.stages, **fattrs)
    log(f"  #7 scratch {row['shape']}: bit for bit; {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, bound "
        f"{row['bound_ms']:.5f} ({row['bound_by']}), torch._int_mm fc1 alone {row['int_mm_fc1_ms']:.4f}; plan "
        f"{plan.rows} rows, a cluster of {plan.cluster}, {plan.stages} stages, {fattrs['smem_bytes']} shared bytes, "
        f"{fattrs['registers']} registers, {fattrs['spill_bytes']} spilled")
    del hq, hs, w, ws

    # #8 and #9 wide rows, bf16 and fp32.
    for kernel, n in (("silu_quant", WIDE_FP), ("rmsnorm_quant", WIDE_NORM_C)):
        for dtype in (torch.bfloat16, torch.float32):
            isz = torch.finfo(dtype).bits // 8
            if kernel == "rmsnorm_quant":
                x = (2 * randn(m, n)).to(dtype)
                gain = 0.5 + torch.rand(n, generator=gen, device=device)
                fn, pfn = (lambda: quant.fused_rmsnorm_quant(x, gain)), (lambda: quant.fused_rmsnorm_quant_plain(x, gain))
                nbytes, elems, src = m * n * isz + n * 4 + m * n + m * 4, m * n, x
            else:
                x = randn(m, 2 * n)
                x[:, n:] *= 2
                x = x.to(dtype)
                fn, pfn = (lambda: quant.fused_silu_quant(x)), (lambda: quant.fused_silu_quant_plain(x))
                nbytes, elems, src = m * 2 * n * isz + m * n + m * 4, m * n, x
            err = _exact_codes(f"{kernel} wide {n} {dtype}", fn(), pfn())
            row = dict(shape=f"M {m} n {n}", dtype=str(dtype).replace("torch.", ""), **err,
                       **_row_kernel_row(kernel, n, dtype, m, fn, pfn, nbytes, elems, src))
            if not row["plan"]["wide"]:
                raise AssertionError(f"{kernel} at {n}: expected the wide instance, plan {row['plan']}")
            rows.setdefault(kernel + "_wide", []).append(row)
            log(f"  #{8 if kernel == 'silu_quant' else 9} wide {row['shape']} {row['dtype']}: bit for bit; "
                f"{row['ms']:.4f} ms ({row['dev_ms']:.4f} dev), plain {row['plain_ms']:.4f}, bound "
                f"{row['bound_ms']:.5f} ({row['bound_by']}); {row['registers']} registers, {row['spill_bytes']} local "
                f"bytes, {row['blocks_per_sm']} blocks an SM, grid {row['plan']['grid']}")
            del x

    # The int8 fp32-compute 350M forward with the epilogue on: #2 f32 a block.
    model = AE(**decode_variant(VARIANT), seed=0, device=device, compute_dtype=torch.float32)
    _random_gates(model, device)
    model.quantize()
    depth = model.cfg.encoder_depth + model.cfg.decoder_depth
    (case,) = main_path_cases(device, [Q8_F32_PATH], seed=20)
    name, max_tokens, batch, images, inputs = case
    with q8_epilogue(True):
        if not fa.can_fuse_q8(max_tokens, model.cfg.encoder_width, model.cfg.encoder_heads, cuda=True):
            raise AssertionError("the int8 epilogue's gate is closed at the 350M width and 256 tokens")
        expect = _expect(fused_attention_q8_f32=depth, fused_attention_f32=depth, rmsnorm_quant=depth, ffn_int8=depth,
                         fused_qk_prologue=0)
        (out,), q8_launches = _run_counted(model, [case], expect, "int8 fp32 + epilogue")
        ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=3, warmup=1)
    _check_output(name, max_tokens, batch, images, inputs, out)
    with q8_epilogue(False):
        off = model.decode(model.encode(inputs))
    if not torch.equal(out["patches"], off["patches"]):
        raise AssertionError("int8 fp32 + epilogue: output differs from the opt-in off (the fp32 walker, then "
                             "quantize_activation), which the epilogue must equal bit for bit")
    log(f"  int8 fp32-compute {VARIANT} {name} batch {batch}, epilogue on: launches {_nonzero(q8_launches)}; output "
        f"equal to the opt-in off bit for bit; {ms / batch:.4f} ms/img on {card}")
    del model, out, off

    wide_launches = {}
    for variant, counts in WIDE_MODELS:
        from vitok_torch.models.ae import AEConfig

        cfg = AEConfig.from_variant(variant)
        model = AE(**dataclasses.asdict(cfg), state_dict=quant.init_params_quantized(cfg, seed=1, device=device),
                   device=device)
        (case,) = main_path_cases(device, [WIDE_PATH], seed=21)
        name, max_tokens, batch, images, inputs = case
        expect = _expect(**counts)
        (out,), launches = _run_counted(model, [case], expect, f"int8 {variant}")
        ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=3, warmup=1)
        if not torch.isfinite(out["patches"]).all():
            raise AssertionError(f"int8 {variant}: non-finite output")
        with plain_quant_kernels():
            ref = model.decode(model.encode(inputs))
        rel = _valid_rel_l2(out, ref, inputs)
        same = bool(torch.equal(out["patches"], ref["patches"]))
        if not rel <= MODEL_REL_L2:
            raise AssertionError(f"int8 {variant}: rel L2 vs its plain quantize kernels {rel:.3e} > {MODEL_REL_L2}")
        for k, v in launches.items():
            if v:
                wide_launches[k] = wide_launches.get(k, 0) + v
        log(f"  int8 {variant} {name} batch {batch}: launches {_nonzero(launches)}; rel L2 vs the plain quantize "
            f"kernels {rel:.3e} (bit for bit: {same}); {ms / batch:.4f} ms/img on {card}")
        del model, out, ref
        torch.cuda.empty_cache()
    return dict(rows=rows, q8_f32_launches=q8_launches, wide_launches=wide_launches)


def wide_kernel_entries(wide: dict) -> list:
    """The kernels line's entries of #2 f32 and the wide instances."""
    entries = []
    q8 = wide["rows"]["fused_attention_q8_f32"]
    entries.append(dict(name="fused_attention_q8_f32", route="cuda",
                        source="vitok_torch/csrc/quantize_rows.cu",  # after csrc/fused_attention_ab_f32_sm90.cu
                        replaces="vitok_tpu/ops/fused_attention.py:340", launches=wide["q8_f32_launches"][
                            "fused_attention_q8_f32"], max_abs_err=q8["max_abs_err"], ms=q8["ms"],
                        plain_ms=q8["plain_ms"], bound_ms=q8["bound_ms"], bound_by=q8["bound_by"], library_ms=None,
                        walker_ms=q8["walker_ms"], codes_differ=0,
                        walker_launches=wide["q8_f32_launches"]["fused_attention_f32"]))
    ffn = wide["rows"]["ffn_int8_wide"]
    entries.append(dict(name="ffn_int8_wide", route="cuda", source="vitok_torch/csrc/ffn_int8.cu",
                        replaces="vitok_tpu/ops/quant.py:130", launches=wide["wide_launches"].get("ffn_int8_wide", 0),
                        max_abs_err=0, ms=ffn["ms"], plain_ms=ffn["plain_ms"], bound_ms=ffn["bound_ms"],
                        bound_by=ffn["bound_by"], library_ms=None, int_mm_fc1_ms=ffn["int_mm_fc1_ms"],
                        spill_bytes=ffn["spill_bytes"]))
    for name, replaces in (("silu_quant", "vitok_tpu/ops/quant.py:317"), ("rmsnorm_quant", "vitok_tpu/ops/quant.py:385")):
        rows = wide["rows"][name + "_wide"]
        row, f32 = rows[0], rows[1]
        entries.append(dict(name=name + "_wide", route="cuda", source=f"vitok_torch/csrc/{name}.cu", replaces=replaces,
                            launches=wide["wide_launches"].get(name + "_wide", 0), max_abs_err=0, ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                            library_ms=None, dev_ms=row["dev_ms"], fp32_ms=f32["ms"], fp32_bound_ms=f32["bound_ms"],
                            registers=row["registers"], spill_bytes=row["spill_bytes"]))
    return entries


# ---------------------------------------------------------------------------
# The distributed slice: each layout as a world of one over NCCL
# ---------------------------------------------------------------------------

DIST_TRAIN = ("256p", 256, 8, RESOLUTIONS[0][3])  # the fused kernels (#1, #3) a block
DIST_SP = ("1024p", 4096, 1, [(1024, 1024)])        # the halo route, unfused, sw 1024
DIST_SW = 1024
DIST_LR = 1e-4
DIST_REL = 1e-6  # each step's loss and updated parameters against the unwrapped step
DIST_DIT, DIST_DIT_BATCH = "Ld4/256", 8  # DiT-L's width (1024, 16 heads), four blocks, 256 tokens


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _params_rel(got: dict, want: dict) -> float:
    num = sum((got[k].double() - want[k].double()).square().sum() for k in want)
    return (num / sum(v.double().square().sum() for v in want.values())).sqrt().item()


def distributed_phase(device, card: str) -> dict:
    """350M at full width and depth laid over each mesh as a world of one
    over NCCL (``initialize_distributed`` from torchrun's variables): one
    AdamW step at 256 tokens, batch 8, ``attn_impl="fused"`` (#1 and #3 a
    block) under ``data=1`` (DDP), ``fsdp=1`` (FSDP2), ``model=1`` (the
    tensor-parallel plan) and ``fsdp=1`` under selective recomputation
    (``remat_save``); one token-sharded step under ``seq=1`` at 1024p,
    window 1024 (the halo route, unfused, fp32 compute); the int8 forward
    under ``model=1`` (the row-parallel int8 out-projection); one DiT step
    under ``model=1``; each held to the same work unwrapped, launches
    included. Then two processes on the one card over gloo with ``data=2``
    against the unwrapped step's two microbatches."""
    import tempfile

    import torch
    import torch.distributed as dist
    from vitok_torch import AE, decode_variant
    from vitok_torch.parallel import create_mesh, initialize_distributed, shard_params
    from vitok_torch.parallel.sequence import make_sp_train_step, place_batch_token_sharded
    from vitok_torch.parallel.sharding import local
    from vitok_torch.train_lib import LossConfig, create_optimizer, create_schedule, create_train_state, make_train_step

    if not dist.is_initialized():
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                          MASTER_PORT=str(_free_port()))
        initialize_distributed(device.type)
    backend = dist.get_backend()
    log(f"distributed phase: {VARIANT}, a world of {dist.get_world_size()} over {backend}; one step each under "
        f"data=1, fsdp=1, model=1, fsdp=1 with remat_save and seq=1, the int8 forward and a DiT step under "
        f"model=1, against the unwrapped runs, on {card}")
    tx_of = lambda: create_optimizer(create_schedule("constant", DIST_LR, 10, warmup_frac=0.0))
    total = {}

    def add(counts):
        for k, v in counts.items():
            if v:
                total[k] = total.get(k, 0) + v

    def fresh(**kw):
        model = AE(**{**decode_variant(VARIANT), **kw}, seed=0, device=device, param_dtype=torch.float32,
                   trainable=True)
        _random_gates(model, device)
        return model

    def full_params(model, layout):
        if layout is None:
            return {n: p.detach().clone() for n, p in model.named_parameters()}
        return {n: layout.full(i, local(p).detach()) for i, (n, p) in enumerate(model.named_parameters())}

    (case,) = main_path_cases(device, [DIST_TRAIN], seed=9)
    name, max_tokens, batch, _, inputs = case
    loss_cfg = LossConfig(ssim_weight=0.0)
    rows = {}

    def step(model, layout, microbatches=1, batch=inputs):
        tx = tx_of()
        state = create_train_state(model, tx)
        reset_counts()
        state, metrics = make_train_step(tx, loss_cfg, grad_accum=microbatches)(state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return float(metrics["loss/total"]), full_params(model, layout), launch_counts()

    def held(label, loss, params, counts, want_loss, want_params, want_counts, wrapper):
        loss_rel = abs(loss - want_loss) / abs(want_loss)
        rel = _params_rel(params, want_params)
        if counts != want_counts or not (loss_rel <= DIST_REL and rel <= DIST_REL):
            raise AssertionError(f"distributed {label}: loss rel {loss_rel:.3e}, params rel L2 {rel:.3e} (limit "
                                 f"{DIST_REL}); launches {_nonzero(counts)}, expected {_nonzero(want_counts)}")
        rows[label] = dict(loss_rel=loss_rel, params_rel_l2=rel, wrapper=wrapper, launches=_nonzero(counts))
        add(counts)
        log(f"  {label} ({wrapper}): loss rel {loss_rel:.3e}, params rel L2 {rel:.3e}"
            f"{' (exact)' if rel == 0 and loss_rel == 0 else ''}; launches {_nonzero(counts)}")

    ref_model = fresh(attn_impl="fused")
    depth = ref_model.cfg.encoder_depth + ref_model.cfg.decoder_depth
    want_launches = _expect(fused_attention=depth, fused_attention_bwd=2 * depth)
    ref_loss, ref_params, ref_counts = step(ref_model, None)
    if ref_counts != want_launches:
        raise AssertionError(f"distributed reference step: launches {ref_counts}, expected {want_launches}")
    init_state = {k: v.detach().cpu() for k, v in fresh(attn_impl="fused").state_dict().items()}
    del ref_model
    for axes in ({"data": 1}, {"fsdp": 1}, {"model": 1}):
        model = fresh(attn_impl="fused")
        layout = shard_params(model, create_mesh(axes, device=device.type))
        label = ",".join(f"{k}={v}" for k, v in axes.items())
        held(label, *step(model, layout), ref_loss, ref_params, want_launches,
             type(layout.module).__name__ + (", the tensor-parallel plan" if layout.tp else ""))
        del model, layout
        torch.cuda.empty_cache()
    del ref_params

    # fsdp=1 under selective recomputation: the replay inside the block's call.
    remat = dict(attn_impl="fused", checkpoint=1, remat_save=("qkv_out", "ffn_hid"))
    want = step(fresh(**remat), None)
    model = fresh(**remat)
    layout = shard_params(model, create_mesh({"fsdp": 1}, device=device.type))
    held("fsdp=1, remat_save", *step(model, layout), *want, "FSDP2, checkpoint 1 keeping qkv_out and ffn_hid")
    del model, layout, want
    torch.cuda.empty_cache()

    # seq=1: the halo route (unfused) at 1024p against the unwrapped unfused step, fp32 compute.
    (sp_case,) = main_path_cases(device, [DIST_SP], seed=10)
    sp_inputs = sp_case[4]
    sp_kw = dict(attn_impl="xla", sw=DIST_SW, checkpoint=1, compute_dtype=torch.float32)
    want_sp_loss, want_sp, _ = step(fresh(**sp_kw), None, batch=sp_inputs)
    mesh = create_mesh({"seq": 1}, device=device.type)
    model = fresh(**{**sp_kw, "attn_impl": "auto"})
    tx = tx_of()
    state = create_train_state(model, tx)
    reset_counts()
    state, metrics = make_sp_train_step(tx, mesh)(state, place_batch_token_sharded(sp_inputs, mesh))
    torch.cuda.synchronize()
    held(f"seq=1 ({DIST_SP[0]}, sw {DIST_SW})", float(metrics["loss/total"]), full_params(model, None),
         launch_counts(), want_sp_loss, want_sp, _expect(), "halo attention, unfused, fp32 compute, checkpoint 1")
    del model, state, want_sp
    torch.cuda.empty_cache()

    # The int8 forward under model=1: qkv and out sliced, the FFN whole, the
    # out-projection's int32 partial products all-reduced; bit for bit.
    def int8_model():
        model = AE(**decode_variant(VARIANT), seed=0, device=device)
        _random_gates(model, device)
        return model.quantize()

    int8_expect = _expect(fused_attention=depth, rmsnorm_quant=depth, ffn_int8=depth)
    (want,), want_counts = _run_counted(int8_model(), [case], int8_expect, "int8 unwrapped")
    model = int8_model()
    shard_params(model, create_mesh({"model": 1}, device=device.type))
    (got,), counts = _run_counted(model, [case], int8_expect, "int8 model=1")
    if not torch.equal(got["patches"], want["patches"]):
        raise AssertionError("int8 model=1: the tensor-parallel int8 forward differs from the unwrapped one")
    rows["int8 forward, model=1"] = dict(bit_for_bit=True, launches=_nonzero(counts))
    add(counts)
    log(f"  int8 forward, model=1 ({name}, batch {batch}): bit for bit the unwrapped forward; launches "
        f"{_nonzero(counts)}")
    del model, got, want
    torch.cuda.empty_cache()

    # One DiT step under model=1 (#1 and #3 in its blocks, its adaLN mod whole).
    from vitok_torch.models.dit import DiT, decode_variant as dit_variant
    from vitok_torch.scripts.train_dit import make_dit_train_step

    gen = torch.Generator(device=device).manual_seed(11)
    z = torch.randn((DIST_DIT_BATCH, 256, 16), generator=gen, device=device)
    labels = torch.randint(0, 1000, (DIST_DIT_BATCH,), generator=gen, device=device)
    draws = {"sigma": torch.rand(DIST_DIT_BATCH, generator=gen, device=device),
             "eps": torch.randn(z.shape, generator=gen, device=device),
             "drop": torch.rand(DIST_DIT_BATCH, generator=gen, device=device) < 0.1}

    def dit_step(layout_axes):
        model = DiT(**dit_variant(DIST_DIT), code_width=16, text_dim=1000, attn_impl="fused", seed=0,
                    device=device, param_dtype=torch.float32, trainable=True)
        with torch.no_grad():
            for blk in model.blocks:  # adaLN-zero would gate every block off
                blk.mod.weight.copy_(0.02 * torch.randn(blk.mod.weight.shape, generator=torch.Generator(
                    device=device).manual_seed(12), device=device))
        layout = shard_params(model, create_mesh(layout_axes, device=device.type)) if layout_axes else None
        tx = tx_of()
        state = create_train_state(model, tx, ema=True)
        reset_counts()
        state, loss = make_dit_train_step(tx, 1000)(state, z, labels, draws=draws)
        torch.cuda.synchronize()
        return float(loss), full_params(model, layout), launch_counts()

    dit_depth = dit_variant(DIST_DIT)["depth"]
    want = dit_step(None)
    if want[2] != _expect(fused_attention=dit_depth, fused_attention_bwd=2 * dit_depth):
        raise AssertionError(f"DiT reference step: launches {_nonzero(want[2])}, expected #1 and #3 a block")
    held(f"DiT {DIST_DIT}, model=1", *dit_step({"model": 1}), *want, "the tensor-parallel plan, mod whole")
    del want
    torch.cuda.empty_cache()

    # Two processes on the one card, gloo carrying CUDA tensors: data=2,
    # each rank four of the eight images; the unwrapped step on the same
    # two microbatches adds the same gradients.
    model = fresh(attn_impl="fused")
    model.load_state_dict({k: v.to(device) for k, v in init_state.items()})
    want_loss, want_params, _ = step(model, None, microbatches=2)
    del model
    with tempfile.TemporaryDirectory() as wd:
        torch.save({"state": init_state, "inputs": {k: v.cpu() if hasattr(v, "cpu") else v
                                                    for k, v in inputs.items()},
                    "variant": VARIANT, "lr": DIST_LR, "device": "cuda:0" if device.type == "cuda" else "cpu"},
                   os.path.join(wd, "job.pt"))
        from vitok_torch.scripts import dryrun_multiprocess as dm

        dm.spawn("ddp_job", 2, wd)
        out = torch.load(os.path.join(wd, "ddp_0.pt"), weights_only=True)
    got = {k: v.to(device) for k, v in out["params"].items()}
    loss_rel = abs(out["loss"] - want_loss) / abs(want_loss)
    rel = _params_rel(got, want_params)
    if not (loss_rel <= DIST_REL and rel <= DIST_REL):
        raise AssertionError(f"two-process data=2 on one card (gloo): loss rel {loss_rel:.3e}, params rel L2 "
                             f"{rel:.3e} (limit {DIST_REL})")
    rows["data=2 (2 processes, gloo)"] = dict(loss_rel=loss_rel, params_rel_l2=rel, launches_rank0=out["launches"])
    log(f"  data=2 over gloo, two processes on the one card: loss rel {loss_rel:.3e}, params rel L2 {rel:.3e} "
        f"against the unwrapped step's two microbatches; rank 0's launches {_nonzero(out['launches'])}")
    dist.destroy_process_group()
    return dict(rows=rows, launches=total)


PIPE_DECODE = ("256p", 256, 16, RESOLUTIONS[0][3])  # B 16 at 256 tokens: four microbatches of four
PIPE_MICRO = 4
PIPE_BIG = "Td4-T/1x16x64"  # 5B-f16x64: 40 decoder blocks, 20 a stage under pipe=2
PIPE_LOSS = dict(ssim_weight=0.1, tile_size=256, n_tiles=1, patch=16, ssim_grid=(16, 16))
PIPE_PERCEPTUAL = 0.5  # the world-of-one step's DINO term (a random-init ViT-S on the 256-px tiles)
# Where the pipeline adds the microbatches' gradients in another order than
# the reference (the encoder's over one call, not four), the parameters
# after the step are held here; the loss and the outputs at DIST_REL.
PIPE_PARAMS_REL = 1e-5


def _decode_micro(model, enc: dict, m: int):
    """The unwrapped model's decode of ``enc`` microbatch by microbatch: the
    pipeline's microbatches, each through every block."""
    import torch

    mb = enc["z"].shape[0] // m
    return torch.cat([model.decode({k: v[q * mb:(q + 1) * mb] for k, v in enc.items()})["patches"]
                      for q in range(m)])


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def pipeline_phase(device, card: str) -> dict:
    """Pipeline parallelism (``vitok_torch.parallel.pipeline``) at full
    width and depth. A world of one over NCCL, ``pipe=1``: the 350M decode
    at 256 tokens, B 16, in four microbatches, and one training step
    (``attn_impl="fused"``; Charbonnier, SSIM and a random-init DINO ViT-S
    perceptual term) against the unwrapped model on the same microbatches.
    Then two processes on the one card over gloo, ``pipe=2`` (12 of the 24
    decoder blocks a stage): the same decode, one training step
    (Charbonnier + SSIM), and the 5B decode (20 of 40 blocks a stage) in
    bf16 and after ``quantize()``, each against the unwrapped model on the
    same microbatches. Every run's launches are read: #1 and its prologue a
    block and microbatch on each stage, #3 under grad, #9 and #7 in int8."""
    import tempfile

    import torch
    import torch.distributed as dist
    from vitok_torch import AE, decode_variant
    from vitok_torch.models.vit_features import load_dino_backbone, make_dino_feature_fn
    from vitok_torch.parallel import (create_mesh, initialize_distributed, make_pipeline_train_step,
                                      pipeline_parallel_decode, shard_params)
    from vitok_torch.scripts import dryrun_multiprocess as dm
    from vitok_torch.train_lib import LossConfig, create_optimizer, create_schedule, create_train_state, make_train_step

    t_phase = time.time()
    if not dist.is_initialized():
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                          MASTER_PORT=str(_free_port()))
        initialize_distributed(device.type)
    log(f"pipeline phase: {VARIANT} and {PIPE_BIG}, pipe=1 over {dist.get_backend()} and pipe=2 as two processes "
        f"over gloo, {PIPE_MICRO} microbatches, on {card}")
    rows, total, wall = {}, {}, {}

    def add(counts):
        for k, v in counts.items():
            if v:
                total[k] = total.get(k, 0) + v

    init = AE(**decode_variant(VARIANT), seed=0, device=device, param_dtype=torch.float32)
    _random_gates(init, device)
    state = {k: v.detach() for k, v in init.state_dict().items()}
    enc_depth, depth = init.cfg.encoder_depth, init.cfg.decoder_depth
    del init
    bf16 = lambda: AE(**decode_variant(VARIANT), state_dict=state, device=device)
    fp32 = lambda: AE(**{**decode_variant(VARIANT), "attn_impl": "fused"}, state_dict=state, device=device,
                      param_dtype=torch.float32, trainable=True)
    (dec_case,) = main_path_cases(device, [PIPE_DECODE], seed=12)
    (train_case,) = main_path_cases(device, [DIST_TRAIN], seed=13)
    train_in = train_case[4]
    tiles = (torch.zeros((DIST_TRAIN[2], 1), dtype=torch.int32, device=device),) * 2  # a 256-px tile of 256 px
    ref = bf16()
    enc = ref.encode(dec_case[4])
    want_dec = _decode_micro(ref, enc, PIPE_MICRO)
    del ref

    def held(label, rel, limit, counts, want_counts, **extra):
        if counts != {k: v for k, v in want_counts.items() if v} or not rel <= limit:
            raise AssertionError(f"pipeline {label}: rel L2 {rel:.3e} (limit {limit}); launches {counts}, expected "
                                 f"{_nonzero(want_counts)}")
        rows[label] = dict(rel_l2=rel, launches=counts, **extra)
        log(f"  {label}: rel L2 {rel:.3e}{' (exact)' if rel == 0 else ''}; launches {counts}"
            + "".join(f", {k} {v:.3e}" for k, v in extra.items() if isinstance(v, float)))

    # pipe=1, a world of one over NCCL.
    t0 = time.time()
    mesh = create_mesh({"pipe": 1}, device=device.type)
    model = bf16()
    shard_params(model, mesh)
    reset_counts()
    got = pipeline_parallel_decode(model, enc, PIPE_MICRO)["patches"]
    torch.cuda.synchronize()
    counts = _nonzero(launch_counts())
    add(counts)
    held("pipe=1 decode", _rel(got, want_dec), DIST_REL, counts, _expect(fused_attention=depth * PIPE_MICRO))
    del model, got
    dino = load_dino_backbone(None, size="S", device=device)
    loss_cfg = LossConfig(**PIPE_LOSS, perceptual_weight=PIPE_PERCEPTUAL)
    feature_fn = make_dino_feature_fn(dino, target_size=PIPE_LOSS["tile_size"])
    tx = create_optimizer(create_schedule("constant", DIST_LR, 10, warmup_frac=0.0))
    ref = fp32()
    ref_state, ref_m = make_train_step(tx, loss_cfg, feature_fn=feature_fn, grad_accum=PIPE_MICRO)(
        create_train_state(ref, tx), train_in, tile_indices=tiles)
    want_params = {n: p.detach().clone() for n, p in ref.named_parameters()}
    del ref, ref_state
    model = fp32()
    layout = shard_params(model, mesh)
    tx = create_optimizer(create_schedule("constant", DIST_LR, 10, warmup_frac=0.0))
    step = make_pipeline_train_step(tx, loss_cfg, feature_fn=feature_fn, num_microbatches=PIPE_MICRO)
    reset_counts()
    st, m = step(create_train_state(model, tx), train_in, tile_indices=tiles)
    torch.cuda.synchronize()
    counts = _nonzero(launch_counts())
    add(counts)
    loss_rel = abs(float(m["loss/total"]) - float(ref_m["loss/total"])) / abs(float(ref_m["loss/total"]))
    norm_rel = abs(float(m["grad_norm"]) - float(ref_m["grad_norm"])) / float(ref_m["grad_norm"])
    if not (loss_rel <= DIST_REL and norm_rel <= DIST_REL) or sorted(m) != sorted(ref_m):
        raise AssertionError(f"pipeline pipe=1 step: loss rel {loss_rel:.3e}, grad_norm rel {norm_rel:.3e} (limit "
                             f"{DIST_REL}), metrics {sorted(m)}")
    # On each microbatch: #1 and #3 in each encoder block, #1 twice (the
    # forward, then the replay) and #3 in each decoder block.
    train_expect = _expect(fused_attention=(enc_depth + 2 * depth) * PIPE_MICRO,
                           fused_attention_bwd=2 * (enc_depth + depth) * PIPE_MICRO)
    params = layout.full_named({n: p.detach() for n, p in model.named_parameters()})
    held("pipe=1 step", _params_rel(params, want_params), PIPE_PARAMS_REL, counts, train_expect, loss_rel=loss_rel,
         grad_norm_rel=norm_rel, loss_perceptual=float(m["loss/perceptual"]))
    del model, st, params, want_params, dino, feature_fn
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    wall["pipe=1"] = time.time() - t0

    # pipe=2: two processes on the one card over gloo, against the unwrapped
    # runs here on the same microbatches.
    t0 = time.time()
    loss2 = LossConfig(**PIPE_LOSS)
    tx = create_optimizer(create_schedule("constant", DIST_LR, 10, warmup_frac=0.0))
    ref = fp32()
    _, ref_m2 = make_train_step(tx, loss2, grad_accum=PIPE_MICRO)(create_train_state(ref, tx), train_in,
                                                                   tile_indices=tiles)
    want_params2 = {n: p.detach().clone() for n, p in ref.named_parameters()}
    del ref
    big = AE(**decode_variant(PIPE_BIG), seed=0, device=device)
    _random_gates(big, device)
    big_depth = big.cfg.decoder_depth
    big_in = big.encode(dec_case[4])
    want_big = _decode_micro(big, big_in, PIPE_MICRO)
    want_big8 = _decode_micro(big.quantize(), big_in, PIPE_MICRO)
    del big
    torch.cuda.empty_cache()
    wall["pipe=2 references"] = time.time() - t0
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}
    with tempfile.TemporaryDirectory() as wd:
        torch.save({"device": "cuda:0" if device.type == "cuda" else "cpu", "variant": VARIANT, "state": cpu(state),
                    "decode": cpu(enc),
                    "microbatches": PIPE_MICRO, "lr": DIST_LR, "loss": PIPE_LOSS, "train": cpu(train_in),
                    "tiles": [t.cpu() for t in tiles], "big_variant": PIPE_BIG, "big_decode": cpu(big_in)},
                   os.path.join(wd, "pipe_job.pt"))
        t1 = time.time()
        dm.spawn("pipe_card_job", 2, wd)
        wall["pipe=2 processes"] = time.time() - t1
        outs = [torch.load(os.path.join(wd, f"pipe_card_{r}.pt"), weights_only=True) for r in range(2)]
    per = depth // 2
    expect = {
        "decode": _expect(fused_attention=per * PIPE_MICRO),
        "train": _expect(fused_attention=(enc_depth + 4 * per) * PIPE_MICRO // 2,  # two microbatches a stage
                         fused_attention_bwd=(enc_depth + 2 * per) * PIPE_MICRO),
        "big_decode": _expect(fused_attention=big_depth // 2 * PIPE_MICRO),
        "big_int8": _expect(fused_attention=big_depth // 2 * PIPE_MICRO, rmsnorm_quant=big_depth // 2 * PIPE_MICRO,
                            ffn_int8=big_depth // 2 * PIPE_MICRO),
    }
    first = outs[0]
    loss_rel = abs(first["loss"] - float(ref_m2["loss/total"])) / abs(float(ref_m2["loss/total"]))
    norm_rel = abs(first["grad_norm"] - float(ref_m2["grad_norm"])) / float(ref_m2["grad_norm"])
    if not (loss_rel <= DIST_REL and norm_rel <= DIST_REL):
        raise AssertionError(f"pipeline pipe=2 step: loss rel {loss_rel:.3e}, grad_norm rel {norm_rel:.3e} (limit "
                             f"{DIST_REL})")
    results = {
        "decode": (_rel(first["decode"].to(device), want_dec), DIST_REL, {}),
        "train": (_params_rel({k: v.to(device) for k, v in first["params"].items()}, want_params2), PIPE_PARAMS_REL,
                  {"loss_rel": loss_rel, "grad_norm_rel": norm_rel}),
        "big_decode": (_rel(first["big_decode"].to(device), want_big), DIST_REL, {}),
        "big_int8": (_rel(first["big_int8"].to(device), want_big8), DIST_REL, {}),
    }
    for run, (rel, limit, extra) in results.items():
        for r, out in enumerate(outs):
            counts = out["launches"][run]
            add(counts)
            if counts != {k: v for k, v in expect[run].items() if v}:
                raise AssertionError(f"pipeline pipe=2 {run}, rank {r}: launches {counts}, expected "
                                     f"{_nonzero(expect[run])}")
        held(f"pipe=2 {run}", rel, limit, outs[1]["launches"][run], expect[run],
             **{**extra, "launches_rank0": outs[0]["launches"][run]})
    wall["phase"] = time.time() - t_phase
    log(f"  pipeline phase wall times (s): " + ", ".join(f"{k} {v:.1f}" for k, v in wall.items()))
    return dict(rows=rows, launches=total, wall_s=wall)


def remainder_phase(device, card: str) -> dict:
    """The port's last entry points at full size: ``bench_fused_ffn`` at the
    350M and 5B shapes (M 16384 rows), #7 and the unfused chain (``_int_mm``,
    then #8) each bit for bit their plain versions and within the JAX
    script's limits of each other, both timed; ``ab_q8_epilogue`` once at
    350M (256 tokens, B 64); and ``entry()`` run once."""
    import torch
    from vitok_torch.benchmarks import ab_q8_epilogue, bench_fused_ffn
    from vitok_torch.entry import entry

    t0 = time.time()
    out = {"bench_fused_ffn": {}}
    for label, c, f in (("350M", 1024, 2736), ("5B", 3072, 8208)):
        res = bench_fused_ffn.run(16384, c, f, device=device)
        if not res["ok"]:
            raise AssertionError(f"bench_fused_ffn {label}: {res}")
        out["bench_fused_ffn"][label] = res
        log(f"  bench_fused_ffn {label} (M 16384, C {c}, F' {res['f_padded']}): fused {res['fused_ms']:.4f} ms, "
            f"unfused {res['unfused_ms']:.4f} ms, bound {res['bound_ms']:.4f}; each bit for bit its plain version; "
            f"codes apart by at most {res['code_max_diff']} (share > 1: {res['code_share_over_one']:.2e}), scales "
            f"{res['scale_max_rel']:.2e} rel")
    ab = ab_q8_epilogue.run("350M", tokens=256, batch=64, iters=3, device=device)
    out["ab_q8_epilogue"] = ab
    t = ab["timing"]
    log(f"  ab_q8_epilogue 350M @256 tokens B 64: numeric rel {ab['numeric']['rel']:.5f} (rel L2 "
        f"{ab['numeric']['rel_l2']:.3e}); A {t['A']['ms_per_img']:.4f} ms/img, B {t['B']['ms_per_img']:.4f}, A/B "
        f"{t['a_over_b']:.4f} (chain {t['chain']})")
    if not ab["numeric"]["rel_l2"] <= MODEL_REL_L2:  # the q8 path phase's limit between the same two routes
        raise AssertionError(f"ab_q8_epilogue: the arms are {ab['numeric']['rel_l2']:.3e} apart (rel L2)")
    fn, args = entry(device=device)
    patches = fn(*args)["patches"]
    torch.cuda.synchronize()
    if tuple(patches.shape) != (2, 256, 768) or not torch.isfinite(patches).all():
        raise AssertionError(f"entry(): bad output {tuple(patches.shape)}")
    out["entry"] = {"shape": list(patches.shape), "finite": True}
    del fn, args, patches
    out["wall_s"] = time.time() - t0
    log(f"  remainder phase: {out['wall_s']:.1f} s; entry() forward finite, (2, 256, 768)")
    return out


# ---------------------------------------------------------------------------
# Head dims 192 and 256: the serving kernels' wide instances at the 5B width
# ---------------------------------------------------------------------------

WIDE_HEAD_MODELS = (  # (head dim, variant): width 3072, the 5B's blocks with wider heads
    (256, "Td4h12-Th12/1x16x64"),     # 12 heads of 256, 4 + 40 blocks (the 5B's depth)
    (192, "Td4h16-Td8h16/1x16x64"),   # 16 heads of 192, the decoder cut from 40 blocks to 8
)
WIDE_HEAD_PATHS = (  # bf16, no window; the int8 runs take the first
    ("256p", 256, 16, RESOLUTIONS[0][3]),
    ("512p", 1024, 16, RESOLUTIONS[1][3]),
)
WIDE_HEAD_HIGHRES = ("1024p", 4096, 1, [(1024, 1024)])  # bf16 with sw = FLASH_SW: the fold
WIDE_HEAD_WIDTH = 3072
WIDE_HEAD_KERNELS = ((16, 256), (16, 1024))  # (B, N) of #1 and the prologue, what the paths give them; #2 the first
# The backward's instances at the 5B width: #3 at (B, N, cases), the first
# the fused training step's shape; #5, #6 and the fold at the 1024p step's.
WIDE_HEAD_BWD = ((8, 256, ("tail", "tail+sw")), (8, 1024, ("tail",)))
WIDE_HEAD_FLASH_BWD = (1, 4096, "tail+sw1024")
# Training at the 5B width: fp32 master weights, bf16
# compute, AdamW. Depth cut: a 5B's fp32 weights, moments and gradients alone
# are about 80 GB, so 2 + 4 blocks (about 0.7B parameters) of each head dim.
WIDE_HEAD_TRAIN = ((256, "Td2h12-Td4h12/1x16x64"), (192, "Td2h16-Td4h16/1x16x64"))
WIDE_HEAD_TRAIN_FUSED = ("256p", 256, 8, RESOLUTIONS[0][3])  # attn_impl="fused": #1, then #3
WIDE_HEAD_TRAIN_FOLD = ("1024p", 4096, 1, [(1024, 1024)])    # sw = FLASH_SW: the fold, then #5/#6
WIDE_HEAD_TRAIN_STEPS = 3


def _wide_kernel_rows(device, d: int) -> dict:
    """The d-wide instances at the 5B width (``WIDE_HEAD_WIDTH``) against
    their plain versions: the prologue and #1 at ``WIDE_HEAD_KERNELS`` (a
    tail mask; at the first also no mask and a window of 64), #2 there (codes
    and scales ``quantize_activation`` of #1 bit for bit; its cluster
    candidates timed), and #4 behind the prologue (the fold) and on strided
    views at B 1, N 4096, sw 1024 with a tail; each timed beside its bound,
    its plain version and a library call."""
    import torch
    import torch.nn.functional as F
    from vitok_torch.benchmarks import host_ahead_ms
    from vitok_torch.ops import flash_attention as fl
    from vitok_torch.ops import fused_attention as fa
    from vitok_torch.ops.quant import quantize_activation

    c = WIDE_HEAD_WIDTH
    h = c // d
    rng = np.random.default_rng(22 + d)
    rows = {"fused_attention": [], "fused_qk_prologue": []}
    cases = [(b, n, case, masked, sw) for i, (b, n) in enumerate(WIDE_HEAD_KERNELS)
             for case, masked, sw in KERNEL_CASES if i == 0 or case == "tail"]
    for b, n, case, masked, sw in cases:
        qkv, qs, ks, cos, sin, mask = _attention_inputs(rng, b, n, c, h, masked, device)
        kw = dict(num_heads=h, sliding_window=sw)
        kernel = lambda: fa.fused_qkv_attention(qkv, qs, ks, cos, sin, mask, impl="fused", **kw)
        plain = lambda: fa.fused_qkv_attention_plain(qkv, qs, ks, cos, sin, mask, **kw)
        prologue = lambda: fa.fused_qk_prologue(qkv, qs, ks, cos, sin, num_heads=h, with_q=True)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        err_valid = err if mask is None else err[mask]
        max_abs, mean_abs = err_valid.max().item(), err_valid.mean().item()
        rel_all = (err / want.float().abs().clamp(min=1.0)).max().item()
        if not (max_abs <= KERNEL_MAX_ABS and mean_abs <= KERNEL_MEAN_ABS and rel_all <= KERNEL_MAX_ABS):
            raise AssertionError(f"#1 d {d} B {b} N {n} {case}: valid rows max {max_abs:.3e} mean {mean_abs:.3e}, "
                                 f"all rows rel {rel_all:.3e} (limits {KERNEL_MAX_ABS}, {KERNEL_MEAN_ABS})")
        qk, _ = prologue()
        qk_want, _ = fa.fused_qk_prologue_plain(qkv, qs, ks, cos, sin, num_heads=h, with_q=True)
        perr = (qk.float() - qk_want.float()).abs()
        pro_max, pro_share = perr.max().item(), (perr > 0).float().mean().item()
        if not (pro_max <= PROLOGUE_MAX_ABS and pro_share <= PROLOGUE_DIFFER_SHARE):
            raise AssertionError(f"prologue d {d} B {b} N {n}: max {pro_max:.3e} (limit {PROLOGUE_MAX_ABS}), "
                                 f"{pro_share:.2e} of entries differ (limit {PROLOGUE_DIFFER_SHARE})")
        del got, want, qk, qk_want, err, perr
        q, k, v = _normed_qkv(qkv, qs, ks, cos, sin, b, n, h, d)
        am = _sdpa_mask(mask, n, sw, device)
        kn, _ = fa.fused_qk_prologue(qkv, qs, ks, cos, sin, num_heads=h, with_q=False)
        bound = _bound(b, n, c, h, mask, sw)
        row = dict(d=d, B=b, N=n, C=c, H=h, case=case, max_abs_err=max_abs, mean_abs_err=mean_abs,
                   ms=time_ms(kernel), dev_ms=host_ahead_ms(kernel),
                   kernel_ms=time_ms(lambda: fa._attend_sm90(qkv, kn, qs, cos, sin, mask, h, sw)),
                   plain_ms=time_ms(plain, runs=3, warmup=1),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am)),
                   bound_ms=bound[0], bound_by=bound[1])
        rows["fused_attention"].append(row)
        if case == "tail":
            pro_bound = _prologue_bound(b, n, c, d)
            rows["fused_qk_prologue"].append(dict(
                d=d, B=b, N=n, C=c, H=h, case=case, max_abs_err=pro_max, differ_share=pro_share,
                ms=time_ms(lambda: fa.fused_qk_prologue(qkv, qs, ks, cos, sin, num_heads=h, with_q=False)),
                plain_ms=time_ms(lambda: fa.fused_qk_prologue_plain(qkv, qs, ks, cos, sin, num_heads=h,
                                                                    with_q=False), runs=3, warmup=1),
                bound_ms=pro_bound[0], bound_by=pro_bound[1]))
        log(f"  #1 d {d} B {b} N {n} {case}: max {max_abs:.2e} mean {mean_abs:.2e}, prologue max {pro_max:.2e} "
            f"share {pro_share:.1e}; {row['ms']:.4f} ms (dev {row['dev_ms']:.4f}; the wgmma kernel alone "
            f"{row['kernel_ms']:.4f}), plain {row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f}, bound "
            f"{row['bound_ms']:.5f} ({row['bound_by']})")
        del q, k, v, am, kn, qkv

    # #2 at the first shape: bit for bit quantize_activation of #1; the cluster candidates
    rows["fused_attention_q8"] = []
    b, n = WIDE_HEAD_KERNELS[0]
    for case in ("none", "tail"):
        qkv, qs, ks, cos, sin, mask = _attention_inputs(rng, b, n, c, h, case == "tail", device)
        kw = dict(num_heads=h)
        kernel = lambda: fa.fused_qkv_attention_q8(qkv, qs, ks, cos, sin, mask, **kw)
        chain = lambda: quantize_activation(fa.fused_qkv_attention(qkv, qs, ks, cos, sin, mask, impl="fused", **kw))
        codes, scales = kernel()
        ref_codes, ref_scales = chain()
        p_codes, p_scales = fa.fused_qkv_attention_q8_plain(qkv, qs, ks, cos, sin, mask, **kw)
        torch.cuda.synchronize()
        n_codes, n_scales = int((codes != ref_codes).sum()), int((scales != ref_scales).sum())
        deq = (codes.float() * scales - p_codes.float() * p_scales).abs()
        srel = (scales - p_scales).abs() / p_scales
        if mask is not None:
            deq, srel = deq[mask], srel[mask]
        if not (n_codes == 0 and n_scales == 0 and deq.max().item() <= Q8_DEQUANT_MAX_ABS
                and deq.mean().item() <= Q8_DEQUANT_MEAN_ABS and srel.max().item() <= Q8_SCALE_RTOL):
            raise AssertionError(f"#2 d {d} {case}: {n_codes} codes and {n_scales} scales differ from "
                                 f"quantize_activation of #1; dequantized vs plain max {deq.max().item():.3e} mean "
                                 f"{deq.mean().item():.3e}, scales rel {srel.max().item():.3e}")
        cluster = fa._q8_cluster_size(h, d)
        sweep = {}
        saved = fa._q8_cluster_size
        try:
            for hpb in (1, 2, 4):
                if h % hpb or fa._q8_smem_bytes(hpb, d) > fa._SMEM_LIMIT:
                    continue
                fa._q8_cluster_size = lambda heads, dd, cs=h // hpb: cs
                sweep[h // hpb] = time_ms(kernel)
        finally:
            fa._q8_cluster_size = saved
        nbytes = (b * n * 3 * c * 2 + b * n * (c + 4) + 2 * b * n * (d // 2) * 4 + 2 * d * 4
                  + (0 if mask is None else b * n))
        bound = _bound_ms(nbytes, 4.0 * h * d * _needed_pairs(b, mask, n, None), BF16_FLOPS_PER_S)
        row = dict(d=d, B=b, N=n, C=c, H=h, case=case, cluster=cluster, codes_differ=0, scales_differ=0,
                   max_abs_err=deq.max().item(), mean_abs_err=deq.mean().item(), ms=time_ms(kernel),
                   dev_ms=host_ahead_ms(kernel), library_ms=time_ms(chain),
                   plain_ms=time_ms(lambda: fa.fused_qkv_attention_q8_plain(qkv, qs, ks, cos, sin, mask, **kw),
                                    runs=3, warmup=1),
                   bound_ms=bound[0], bound_by=bound[1], cluster_ms=sweep,
                   **{f"kernel_{k}": v for k, v in fa.sm90_attributes("q8", d, h // cluster).items()})
        rows["fused_attention_q8"].append(row)
        log(f"  #2 d {d} B {b} N {n} {case}: codes and scales = quantize_activation(#1) bit for bit; dequantized vs "
            f"plain max {row['max_abs_err']:.2e}; {row['ms']:.4f} ms (dev {row['dev_ms']:.4f}), #1 + eager quantize "
            f"{row['library_ms']:.4f}, plain {row['plain_ms']:.4f}, bound {row['bound_ms']:.5f} ({row['bound_by']}); "
            f"cluster {cluster} ({h // cluster} heads a block); ms by cluster {sweep}")
        del qkv, codes, scales, ref_codes, ref_scales, p_codes, p_scales, deq, srel

    # #4: behind the prologue (the fold), and on strided views, B 1, N 4096, sw 1024, a tail
    rows["flash_attention"] = []
    label, max_tokens, batch, _ = WIDE_HEAD_HIGHRES
    for case, masked, sw in (("sw1024", False, FLASH_SW), ("tail+sw1024", True, FLASH_SW)):
        qkv, qs, ks, cos, sin, mask = _attention_inputs(rng, batch, max_tokens, c, h, masked, device)
        args = (qkv, qs, ks, cos, sin, mask)
        kw = dict(num_heads=h, sliding_window=sw)
        fold = lambda: fa.flash_qkv_attention(*args, **kw)
        fmax, fmean = _check_flash_rows(f"fold d {d} {case}", fold(), fa.flash_qkv_attention_plain(*args, **kw),
                                        mask)
        qk, _ = fa.fused_qk_prologue(qkv, qs, ks, cos, sin, num_heads=h, with_q=True)
        q, k = qk.view(batch, max_tokens, 2, h, d).unbind(2)
        v = qkv.view(batch, max_tokens, 3, h, d)[:, :, 2]
        got, lse = fl.flash_attention(q, k, v, mask, sw, return_lse=True)
        want, want_lse = fl.flash_attention_plain(q, k, v, mask, sw, return_lse=True)
        max_abs, mean_abs = _check_flash_rows(f"#4 d {d} {case}", got, want, mask)
        live = want_lse < 1e29
        lse_err = (lse[live] - want_lse[live]).abs().max().item()
        if not (lse_err <= LSE_ATOL and torch.equal(lse < 1e29, live)):
            raise AssertionError(f"#4 d {d} {case}: lse {lse_err:.3e} (limit {LSE_ATOL})")
        del got, want, lse, want_lse
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        am = _sdpa_mask(mask, max_tokens, sw, device)
        valid = [max_tokens] * batch if mask is None else mask.sum(1).tolist()
        tensor = batch * max_tokens * c * 2
        pairs = _flash_pairs(valid, max_tokens, sw)
        bound = _bound_ms(4 * tensor + (0 if mask is None else batch * max_tokens), 4.0 * c * pairs,
                          BF16_FLOPS_PER_S)
        fold_bound = _bound_ms(3 * tensor + tensor + 2 * batch * max_tokens * (d // 2) * 4
                               + (0 if mask is None else batch * max_tokens), 4.0 * c * pairs, BF16_FLOPS_PER_S)
        row = dict(d=d, B=batch, N=max_tokens, H=h, case=case, max_abs_err=max_abs, mean_abs_err=mean_abs,
                   lse_max_abs_err=lse_err, ms=time_ms(lambda: fl.flash_attention(q, k, v, mask, sw)),
                   dev_ms=host_ahead_ms(lambda: fl.flash_attention(q, k, v, mask, sw)),
                   plain_ms=time_ms(lambda: fl.flash_attention_plain(q, k, v, mask, sw), runs=2, warmup=1),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am), runs=3),
                   bound_ms=bound[0], bound_by=bound[1], fold_max_abs_err=fmax, fold_mean_abs_err=fmean,
                   fold_ms=time_ms(fold), fold_dev_ms=host_ahead_ms(fold),
                   fold_plain_ms=time_ms(lambda: fa.flash_qkv_attention_plain(*args, **kw), runs=2, warmup=1),
                   fold_bound_ms=fold_bound[0], fold_bound_by=fold_bound[1],
                   **{f"kernel_{k_}": v_ for k_, v_ in fl.flash_attributes(d).items()})
        if masked:
            flex = _flex_call(q, k, v, mask, sw)
            row["flex_ms"], row["flex_dev_ms"] = time_ms(flex), host_ahead_ms(flex)
            del flex
        rows["flash_attention"].append(row)
        log(f"  #4 d {d} B {batch} N {max_tokens} {case}: max {max_abs:.2e} mean {mean_abs:.2e} (the fold {fmax:.2e}); "
            f"{row['ms']:.4f} ms (dev {row['dev_ms']:.4f}), plain {row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f}"
            + (f", FlexAttention {row['flex_ms']:.4f} (dev {row['flex_dev_ms']:.4f})" if masked else "")
            + f", bound {row['bound_ms']:.5f} ({row['bound_by']}); the fold {row['fold_ms']:.4f} (dev "
            f"{row['fold_dev_ms']:.4f}), plain {row['fold_plain_ms']:.4f}; {row['kernel_registers']} registers, "
            f"{row['kernel_local_bytes']} local bytes")
        del qkv, args, qk, q, k, v, qt, kt, vt, am
    for which in ("prologue", "attention"):
        rows[f"{which}_attributes"] = fa.sm90_attributes(which, d)
    log(f"  d {d}: registers/local bytes/blocks an SM/shared bytes: prologue {rows['prologue_attributes']}, #1 "
        f"{rows['attention_attributes']}")
    return rows


def _bwd_errors(what, got, want, mask, c) -> dict:
    """#3's (or the fold's) gradients against the plain version's: dq, dk and
    dv (planes of dqkv) and the gains' within ``FUSED_BWD_*`` of each
    gradient's largest entry on valid rows, padded rows exactly 0, finite."""
    import torch

    if mask is not None and (got[0][~mask].any() or want[0][~mask].any()):
        raise AssertionError(f"{what}: padded rows of dqkv are not exactly 0")
    errs = {}
    for i, name in enumerate(("dq", "dk", "dv")):
        a, r = got[0][..., i * c:(i + 1) * c].float(), want[0][..., i * c:(i + 1) * c].float()
        err = (a - r).abs() if mask is None else (a - r).abs()[mask]
        scale = r.abs().max().item()
        errs[name] = (err.max().item() / scale, err.mean().item() / scale, bool(torch.isfinite(a).all()))
    for i, name in ((1, "dqs"), (2, "dks")):
        errs[name] = (((got[i] - want[i]).abs().max() / want[i].abs().max()).item(), 0.0, True)
    bad = {k: e for k, e in errs.items() if not (e[2] and e[0] <= (FUSED_BWD_GAIN_REL if k in ("dqs", "dks") else
                                                                    FUSED_BWD_MAX_REL) and e[1] <= FUSED_BWD_MEAN_REL)}
    if bad:
        raise AssertionError(f"{what}: (max rel, mean rel, finite) {bad} against its plain version (limits dqkv "
                             f"{FUSED_BWD_MAX_REL} / {FUSED_BWD_MEAN_REL}, gains {FUSED_BWD_GAIN_REL})")
    return errs


def _wide_bwd_rows(device, d: int) -> dict:
    """The backward's d-wide instances at the 5B width against their plain
    versions, at the limits the d 64/128 instances meet: the q/k prologue
    with delta; #3 (the prologue, dq and dk/dv) at ``WIDE_HEAD_BWD``; #5 and
    #6 plain (``flash_bwd_kernel_phase``, SDPA's and FlexAttention's
    backward beside them) and fold at ``WIDE_HEAD_FLASH_BWD``, each fold
    instance timed alone. Registers and local bytes of every instance."""
    import torch
    import torch.nn.functional as F
    from vitok_torch.benchmarks import host_ahead_ms
    from vitok_torch.ops import flash_attention as fl
    from vitok_torch.ops import fused_attention as fa

    c = WIDE_HEAD_WIDTH
    h = c // d
    rng = np.random.default_rng(23 + d)
    gen = torch.Generator(device=device).manual_seed(23 + d)
    rows = {"fused_attention_bwd": [], "fused_qk_prologue_delta": []}
    for b, n, cases in WIDE_HEAD_BWD:
        for case in cases:
            qkv, qs, ks, cos, sin, _ = _attention_inputs(rng, b, n, c, h, False, device)
            mask, valid = _tail_mask(b, n, device, dead_last=False)
            sw = FUSED_BWD_SW if "sw" in case else None
            g = torch.randn((b, n, c), generator=gen, device=device).to(torch.bfloat16)
            args, kw = (qkv, qs, ks, cos, sin, mask), dict(num_heads=h, sliding_window=sw)
            out, lse = fa._fused_cuda(*args, h, sw, want_lse=True)
            kernel = lambda: fa.fused_qkv_attention_bwd(*args, g, out=out, lse=lse, **kw)
            plain = lambda: fa.fused_qkv_attention_bwd_plain(*args, g, out=out, **kw)
            want = plain()
            what = f"#3 d {d} B {b} N {n} {case}"
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{what}: two runs differ")
            errs = _bwd_errors(what, got, want, mask, c)
            del got, again, want
            ms, dev = time_ms(kernel), host_ahead_ms(kernel)
            plain_ms = time_ms(plain, runs=3, warmup=1)
            q, k, v = (t.requires_grad_(True) for t in _normed_qkv(qkv, qs, ks, cos, sin, b, n, h, d))
            gt, am = g.view(b, n, h, d).transpose(1, 2).contiguous(), _sdpa_mask(mask, n, sw, device)
            lib_ms = time_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(q, k, v, attn_mask=am),
                                                         (q, k, v), gt), runs=5)
            del q, k, v, gt, am
            nbytes = 7 * b * n * c * 2 + 2 * b * n * (d // 2) * 4 + b * n
            bound = _bound_ms(nbytes, 10.0 * h * d * _flash_pairs(valid, n, sw), BF16_FLOPS_PER_S)
            rows["fused_attention_bwd"].append(dict(
                d=d, B=b, N=n, C=c, H=h, case=case, ms=ms, dev_ms=dev, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound[0], bound_by=bound[1],
                **{f"{k_}_max_rel_err": e[0] for k_, e in errs.items()},
                **{f"{k_}_mean_rel_err": e[1] for k_, e in errs.items() if k_ in ("dq", "dk", "dv")}))
            log(f"  #3 d {d} B {b} N {n} {case}: dq/dk/dv max rel {errs['dq'][0]:.2e}/{errs['dk'][0]:.2e}/"
                f"{errs['dv'][0]:.2e}, gains {errs['dqs'][0]:.2e}/{errs['dks'][0]:.2e}; {ms:.4f} ms (dev {dev:.4f}), "
                f"plain {plain_ms:.4f}, SDPA forward + backward on normed q/k {lib_ms:.4f}, bound {bound[0]:.5f} "
                f"({bound[1]})")
            if not rows["fused_qk_prologue_delta"]:  # the prologue with delta, as the backward launches it
                gz = g * mask.to(g.dtype)[..., None]
                pro = lambda: fa.fused_qk_prologue(qkv, qs, ks, cos, sin, num_heads=h, out=out, dout=gz)
                pro_plain = lambda: fa.fused_qk_prologue_plain(qkv, qs, ks, cos, sin, num_heads=h, out=out, dout=gz)
                (qk, delta), (qk_want, delta_want) = pro(), pro_plain()
                torch.cuda.synchronize()
                derr = ((delta - delta_want).abs().max() / delta_want.abs().max()).item()
                perr = (qk.float() - qk_want.float()).abs()
                if not (derr <= 1e-5 and perr.max().item() <= PROLOGUE_MAX_ABS
                        and (perr > 0).float().mean().item() <= PROLOGUE_DIFFER_SHARE):
                    raise AssertionError(f"prologue with delta d {d}: delta rel {derr:.3e} (limit 1e-5), q/k max "
                                         f"{perr.max().item():.3e}")
                pbound = _bound_ms(6 * b * n * c * 2 + 2 * b * n * (d // 2) * 4 + b * h * n * 4, 0.0,
                                   BF16_FLOPS_PER_S)
                rows["fused_qk_prologue_delta"].append(dict(
                    d=d, B=b, N=n, C=c, H=h, delta_max_rel_err=derr, max_abs_err=perr.max().item(),
                    ms=time_ms(pro), dev_ms=host_ahead_ms(pro), plain_ms=time_ms(pro_plain, runs=3, warmup=1),
                    bound_ms=pbound[0], bound_by=pbound[1]))
                r_ = rows["fused_qk_prologue_delta"][-1]
                log(f"  prologue with delta d {d} B {b} N {n}: delta rel {derr:.2e}, q/k max {r_['max_abs_err']:.2e}; "
                    f"{r_['ms']:.4f} ms (dev {r_['dev_ms']:.4f}), plain {r_['plain_ms']:.4f}, bound "
                    f"{r_['bound_ms']:.5f}")
                del qk, delta, qk_want, delta_want
            del qkv, out, lse, g
    rows["fused_bwd_attributes"] = {w: fa.fused_bwd_attributes(w, d) for w in ("dq", "dkv")}
    log(f"  #3 d {d}: registers/local bytes/blocks an SM/shared bytes {rows['fused_bwd_attributes']}")

    # #5 and #6, plain (the flash kernel's backward) and fold, at the 1024p step's shape
    b, n, case = WIDE_HEAD_FLASH_BWD
    label = f"5B width d{d}"
    bk = flash_bwd_kernel_phase(device, shapes=((label, b, n, h, d, (case,)),), dims=(d,),
                                flex_rows=((label, case),), fold_rows=((label, case),))
    row = bk["rows"][0]
    qkv, qs, ks, cos, sin, mask = _attention_inputs(rng, b, n, c, h, True, device)
    dout = torch.randn((b, n, c), generator=gen, device=device).to(torch.bfloat16) * mask[..., None]
    out, lse = fa._flash_fold_cuda(qkv, qs, ks, cos, sin, mask, h, FLASH_SW, want_lse=True)
    qk, delta = fa.fused_qk_prologue(qkv, qs, ks, cos, sin, num_heads=h, out=out, dout=dout)
    counts = fl.key_counts(mask)
    dqkv = torch.empty_like(qkv)
    parts = torch.empty((2, b, h, (n + 63) // 64, d), dtype=torch.float32, device=device)
    fold = (mask, counts, dout, lse, delta, dqkv)
    dq_fold = lambda: fl.flash_dq_fold_cuda(qkv, qk, qs, cos, sin, *fold, parts[0], h, FLASH_SW)
    dkv_fold = lambda: fl.flash_dkv_fold_cuda(qkv, qk, ks, cos, sin, *fold, parts[1], h, FLASH_SW)
    row.update(dq_fold_ms=time_ms(dq_fold), dq_fold_dev_ms=host_ahead_ms(dq_fold), dkv_fold_ms=time_ms(dkv_fold),
               dkv_fold_dev_ms=host_ahead_ms(dkv_fold))
    row["attributes"] = {f"{w}{'_fold' if f_ else ''}": fl.flash_bwd_attributes(w, d, f_)
                         for w in ("dq", "dkv") for f_ in (False, True)}
    log(f"  #5/#6 fold instances d {d}: dq {row['dq_fold_ms']:.4f} ms (dev {row['dq_fold_dev_ms']:.4f}), dk/dv "
        f"{row['dkv_fold_ms']:.4f} (dev {row['dkv_fold_dev_ms']:.4f}); registers/local bytes/blocks/shared "
        f"{row['attributes']}")
    rows["flash_bwd"] = row
    del qkv, qk, delta, dqkv, parts, out, lse, dout
    return rows


@contextlib.contextmanager
def unfused_composition(model):
    """The model's attention on the unfused composition (``attn_impl="xla"``:
    no kernel, forward or backward): the fp32 trainers' reference."""
    saved = model.cfg
    model.cfg = dataclasses.replace(model.cfg, attn_impl="xla")
    try:
        yield
    finally:
        model.cfg = saved


def _wide_train(device, card: str, d: int, variant: str, compute_dtype=None) -> dict:
    """Training steps of a 3072-wide AE with heads of ``d`` (``variant``,
    ``WIDE_HEAD_TRAIN``'s cut depth): fp32 master weights, bf16 compute (or
    ``compute_dtype``), Charbonnier 1.0 + SSIM 0.1, AdamW + EMA. At 256
    tokens B 8 with ``attn_impl="fused"`` (#1 with its lse, then the prologue
    with delta and #3's dq and dk/dv in every block) and at 1024p B 1 with
    sw = FLASH_SW (the fold forward, then the prologue with delta and #5/#6's
    fold instances): the first step's gradients against the same step on the
    plain backward (within ``TRAIN_GRAD_REL_L2``; in fp32 on the unfused
    composition, within ``F32_TRAIN_GRAD_REL_L2``, the losses within
    F32_MODEL_REL_L2), then timed steps, each launching exactly those
    kernels (fp32: their fp32 instances, the losses also falling)."""
    import torch
    from vitok_torch import AE, decode_variant
    from vitok_torch.train_lib import (LossConfig, compute_loss, create_optimizer, create_schedule,
                                       create_train_state, make_train_step)

    f32 = compute_dtype == torch.float32
    model = AE(**{**decode_variant(variant), "attn_impl": "fused"}, seed=0, device=device,
               param_dtype=torch.float32, trainable=True, **({"compute_dtype": compute_dtype} if f32 else {}))
    _random_gates(model, device)
    depth = model.cfg.encoder_depth + model.cfg.decoder_depth
    params = list(model.parameters())
    n_params = sum(p.numel() for p in params)
    out = {}
    if f32:
        routes = ((WIDE_HEAD_TRAIN_FUSED, "fused", None,
                   _expect(fused_attention_f32_lse=depth, fused_qk_prologue_f32=depth,
                           fused_attention_bwd_f32=2 * depth)),
                  (WIDE_HEAD_TRAIN_FOLD, "auto", FLASH_SW,
                   _expect(flash_attention_f32=depth, fused_qk_prologue_f32=2 * depth, flash_attention_dq_f32=depth,
                           flash_attention_dkv_f32=depth)))
        routes = [(*r, lambda: unfused_composition(model)) for r in routes]
    else:
        routes = ((WIDE_HEAD_TRAIN_FUSED, "fused", None, _expect(fused_attention=depth, fused_attention_bwd=2 * depth),
                   plain_fused_backward),
                  (WIDE_HEAD_TRAIN_FOLD, "auto", FLASH_SW, _expect(flash_attention=depth, fused_qk_prologue=2 * depth,
                                                                   flash_attention_dq=depth, flash_attention_dkv=depth),
                   plain_flash_backward))
    grad_limit = F32_TRAIN_GRAD_REL_L2 if f32 else TRAIN_GRAD_REL_L2
    for step, impl, sw, expect, reference in routes:
        model.cfg = dataclasses.replace(model.cfg, attn_impl=impl, sw=sw)
        (case,) = main_path_cases(device, [step], seed=26)
        name, max_tokens, batch, _, inputs = case
        side = int(max_tokens ** 0.5)
        loss_cfg = LossConfig(ssim_weight=0.1, tile_size=256, n_tiles=2, ssim_grid=(side, side))
        what = f"d {d}{' fp32' if f32 else ''} training {name} B {batch}"
        log(f"{what}: {variant} ({n_params / 1e9:.3f}B fp32 master params, {depth} blocks), attn_impl={impl!r}, "
            f"sw {sw}, {'fp32' if f32 else 'bf16'} compute, Charbonnier 1.0 + SSIM 0.1, AdamW lr {TRAIN_LR} + EMA")

        def grads_of():
            gen = torch.Generator(device=device).manual_seed(11)
            loss, _ = compute_loss(model, inputs, loss_cfg, gen)
            return loss.detach(), torch.autograd.grad(loss, params)

        reset_counts()
        loss_k, g_kernel = grads_of()
        first = launch_counts()
        with reference():
            loss_p, g_plain = grads_of()
        torch.cuda.synchronize()
        num = sum((a.double() - r.double()).square().sum() for a, r in zip(g_kernel, g_plain))
        rel = (num / sum(r.double().square().sum() for r in g_plain)).sqrt().item()
        finite = all(bool(torch.isfinite(g_).all()) for g_ in g_kernel)
        same_loss = (abs(loss_k.item() - loss_p.item()) <= F32_MODEL_REL_L2 * abs(loss_p.item()) if f32
                     else loss_k.item() == loss_p.item())
        if not (finite and first == expect and same_loss and rel <= grad_limit):
            raise AssertionError(f"{what}: gradients vs the {'unfused composition' if f32 else 'plain backward'} rel "
                                 f"L2 {rel:.3e} (limit {grad_limit}), finite {finite}, loss {loss_k.item()} vs "
                                 f"{loss_p.item()}, launches {_nonzero(first)} (expected {_nonzero(expect)})")
        del g_kernel, g_plain
        tx = create_optimizer(create_schedule("constant", TRAIN_LR, WIDE_HEAD_TRAIN_STEPS, warmup_frac=0.0))
        state = create_train_state(model, tx)
        train_step = make_train_step(tx, loss_cfg)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()  # the path's run
        state, metrics, step_ms, per_step = _timed_steps(train_step, state, inputs, WIDE_HEAD_TRAIN_STEPS)
        launches = launch_counts()
        if any(got != expect for got in per_step):
            raise AssertionError(f"{what}: launches per step {[_nonzero(x) for x in per_step]}, expected "
                                 f"{_nonzero(expect)}")
        totals = [m["loss/total"] for m in metrics]
        if not (all(np.isfinite(list(m.values())).all() for m in metrics) and (not f32 or totals[-1] < totals[0])):
            raise AssertionError(f"{what}: losses {totals} must be finite" + (" and fall" if f32 else ""))
        ms = float(np.median(step_ms[1:]))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        out[name] = dict(variant=variant, impl=impl, sw=sw, batch=batch, tokens=max_tokens, grad_rel_l2=rel,
                         loss=loss_k.item(), reference_loss=loss_p.item(), launches=_nonzero(launches),
                         per_step=_nonzero(per_step[0]), ms_per_step=ms, first_ms=step_ms[0], peak_gb=peak_gb,
                         losses=totals)
        log(f"  {what}: first-step gradients vs the {'unfused composition' if f32 else 'plain backward'} rel L2 "
            f"{rel:.3e}; launches a step {_nonzero(per_step[0])}; loss " + " -> ".join(f"{t:.5f}" for t in totals)
            + f"; {ms:.3f} ms/step (host clock, median of steps 2-{WIDE_HEAD_TRAIN_STEPS}; first {step_ms[0]:.3f}), "
            f"{batch * max_tokens / ms * 1e3:.1f} tokens/s, peak {peak_gb:.3f} GB on {card}")
        del state, tx, train_step, inputs
        torch.cuda.empty_cache()
    del model, params
    return out


def wide_heads_phase(device, card: str) -> dict:
    """Head dims 192 and 256 at the 5B width: each new forward instance (the
    q/k prologue, #1, #2, #4) against its plain version, then both models
    through encode -> decode on the main path: bf16 at 256p and 512p (B 16,
    held to the unfused composition), bf16 at 1024p with sw = FLASH_SW (the
    fold), int8 at 256p without and with the epilogue (held to the plain
    quantize kernels, and to the opt-in off). Then each backward instance
    (the prologue's delta, #3, #5 and #6, plain and fold) against its plain
    version (``_wide_bwd_rows``), and training steps of a 3072-wide model at
    each head dim through them (``_wide_train``)."""
    import torch
    from vitok_torch import AE, decode_variant
    from vitok_torch.ops import fused_attention as fa

    t0 = time.time()
    out = {"rows": {}, "launches": {}, "paths": []}
    for d, variant in WIDE_HEAD_MODELS:
        log(f"wide heads d {d}: kernel checks at the 5B width, on {card}")
        out["rows"][d] = _wide_kernel_rows(device, d)
        torch.cuda.empty_cache()
        model = AE(**decode_variant(variant), seed=0, device=device)
        _random_gates(model, device)
        depth = model.cfg.encoder_depth + model.cfg.decoder_depth
        n_params = sum(p.numel() for p in model.parameters())
        log(f"wide heads d {d}: {variant} ({n_params / 1e9:.3f}B params, {depth} blocks), bf16")
        launches = dict.fromkeys(launch_counts(), 0)

        def add(counts):
            for k_, v_ in counts.items():
                launches[k_] += v_

        cases = main_path_cases(device, WIDE_HEAD_PATHS, seed=22)
        outs, counts = _run_counted(model, cases, _expect(fused_attention=depth), f"bf16 d {d}")
        add(counts)
        _set_attn_impl(model, "xla")
        refs = [model.decode(model.encode(inputs)) for *_, inputs in cases]
        _set_attn_impl(model, "auto")
        for (name, max_tokens, batch, images, inputs), o, ref in zip(cases, outs, refs):
            _check_output(name, max_tokens, batch, images, inputs, o)
            rel = _valid_rel_l2(o, ref, inputs)
            if not rel <= MODEL_REL_L2:
                raise AssertionError(f"bf16 d {d} {name}: rel L2 vs the unfused composition {rel:.3e} > {MODEL_REL_L2}")
            ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=2, warmup=1)
            out["paths"].append(dict(d=d, dtype="bf16", res=name, batch=batch, rel_l2=rel, ms_per_img=ms / batch))
            log(f"  bf16 d {d} {name} B {batch}: rel L2 vs the unfused composition {rel:.3e}; {ms / batch:.4f} ms/img "
                f"on {card}")
        del outs, refs

        model.cfg = dataclasses.replace(model.cfg, sw=FLASH_SW)
        (case,) = main_path_cases(device, [WIDE_HEAD_HIGHRES], seed=23)
        name, max_tokens, batch, images, inputs = case
        with torch.inference_mode():
            (o,), counts = _run_counted(model, [case], _expect(flash_attention=depth, fused_qk_prologue=depth),
                                        f"bf16 d {d} {name}")
        add(counts)
        _check_output(name, max_tokens, batch, images, inputs, o)
        _set_attn_impl(model, "xla")
        ref = model.decode(model.encode(inputs))
        _set_attn_impl(model, "auto")
        rel = _valid_rel_l2(o, ref, inputs)
        if not rel <= MODEL_REL_L2:
            raise AssertionError(f"bf16 d {d} {name}: rel L2 vs the unfused composition {rel:.3e} > {MODEL_REL_L2}")
        ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=2, warmup=1)
        out["paths"].append(dict(d=d, dtype="bf16", res=name, batch=batch, sw=FLASH_SW, rel_l2=rel, ms_per_img=ms))
        log(f"  bf16 d {d} {name} sw {FLASH_SW} B {batch}: the fold in every block; rel L2 vs the unfused "
            f"composition {rel:.3e}; {ms:.4f} ms/img on {card}")
        model.cfg = dataclasses.replace(model.cfg, sw=None)
        del o, ref

        model.quantize()
        torch.cuda.empty_cache()
        (case,) = main_path_cases(device, WIDE_HEAD_PATHS[:1], seed=24)
        name, max_tokens, batch, images, inputs = case
        expect = dict(fused_attention=depth, rmsnorm_quant=depth, ffn_int8=depth)
        (o,), counts = _run_counted(model, [case], _expect(**expect), f"int8 d {d}")
        add(counts)
        _check_output(name, max_tokens, batch, images, inputs, o)
        with plain_quant_kernels():
            rel = _valid_rel_l2(o, model.decode(model.encode(inputs)), inputs)
        if not rel <= MODEL_REL_L2:
            raise AssertionError(f"int8 d {d} {name}: rel L2 vs the plain quantize kernels {rel:.3e} > {MODEL_REL_L2}")
        ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=2, warmup=1)
        with q8_epilogue(True):
            if not fa.can_fuse_q8(max_tokens, model.cfg.encoder_width, model.cfg.encoder_heads, cuda=True):
                raise AssertionError(f"int8 d {d}: the epilogue's gate is closed at {max_tokens} tokens")
            expect = dict(fused_attention_q8=depth, fused_qk_prologue=depth, rmsnorm_quant=depth, ffn_int8=depth)
            (q8o,), counts = _run_counted(model, [case], _expect(**expect), f"int8 + epilogue d {d}")
            q8_ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=2, warmup=1)
        add(counts)
        _check_output(name, max_tokens, batch, images, inputs, q8o)
        q8_rel = _valid_rel_l2(q8o, o, inputs)
        same = bool(torch.equal(q8o["patches"], o["patches"]))
        if not q8_rel <= MODEL_REL_L2:
            raise AssertionError(f"int8 + epilogue d {d}: rel L2 vs the opt-in off {q8_rel:.3e} > {MODEL_REL_L2}")
        out["paths"].append(dict(d=d, dtype="int8", res=name, batch=batch, rel_l2_vs_plain=rel,
                                 ms_per_img=ms / batch, epilogue_rel_l2_vs_off=q8_rel, epilogue_bit_for_bit=same,
                                 epilogue_ms_per_img=q8_ms / batch))
        log(f"  int8 d {d} {name} B {batch}: rel L2 vs the plain quantize kernels {rel:.3e}; {ms / batch:.4f} ms/img; "
            f"with the epilogue {q8_ms / batch:.4f} ms/img, rel L2 vs the opt-in off {q8_rel:.3e} (bit for bit: "
            f"{same}) on {card}")
        out["launches"][d] = launches
        log(f"  d {d} launches over its path's runs: {_nonzero(launches)}")
        del model, o, q8o, cases
        torch.cuda.empty_cache()

    # The backward's instances, then training steps at the 5B width through them.
    out["forward_s"] = time.time() - t0
    for d, _ in WIDE_HEAD_MODELS:
        log(f"wide heads d {d}: the backward's instances at the 5B width, on {card}")
        t1 = time.time()
        out["rows"][d].update(_wide_bwd_rows(device, d))
        torch.cuda.empty_cache()
        log(f"  d {d} backward instances: {time.time() - t1:.1f} s")
    out["train"] = {}
    for d, variant in WIDE_HEAD_TRAIN:
        t1 = time.time()
        out["train"][d] = _wide_train(device, card, d, variant)
        torch.cuda.empty_cache()
        log(f"  d {d} training steps: {time.time() - t1:.1f} s")
    out["wall_s"] = time.time() - t0
    log(f"wide heads phase: {out['wall_s']:.1f} s (the forward's instances and models {out['forward_s']:.1f} s)")
    return out



def wide_heads_entries(wide: dict, kern: dict, fkern: dict, fbkern: dict, bkern: dict) -> list:
    """The kernels line's entries of the d 192 and 256 instances, each with
    the d 128 instance's time at the same 5B-width shape beside it."""
    flash_5b = next(r for r in bkern["rows"] if r["shape"] == "5B width" and r["case"] == "tail+sw1024")
    d128 = {
        "fused_attention": next(r for r in kern["rows"] if r["shape"] == "5B@256p main" and r["case"] == "tail"),
        "flash_attention": next(r for r in fkern["rows"] if r["shape"] == "5B width" and r["case"] == "tail+sw1024"),
        "fused_attention_bwd": next(r for r in fbkern["rows"] if r["shape"] == "5B@256t" and r["case"] == "tail"),
        "flash_attention_dq": flash_5b, "flash_attention_dkv": flash_5b,
    }
    entries = []
    for d in sorted(wide["rows"]):
        rows, launches = wide["rows"][d], wide["launches"][d]
        first, second = WIDE_HEAD_KERNELS[0][1], WIDE_HEAD_KERNELS[1][1]
        pick = lambda name, n=first, case="tail": next(r for r in rows[name] if r["N"] == n and r["case"] == case)
        head, pro, q8 = pick("fused_attention"), pick("fused_qk_prologue"), pick("fused_attention_q8")
        fl4 = pick("flash_attention", WIDE_HEAD_HIGHRES[1], "tail+sw1024")
        common = lambda name, row: dict(route="cuda", max_abs_err=max(r["max_abs_err"] for r in rows[name]),
                                        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                                        bound_by=row["bound_by"])
        entries += [
            dict(name=f"fused_attention_d{d}", source="vitok_torch/csrc/fused_attention_sm90.cu",
                 replaces="vitok_tpu/ops/fused_attention.py:317", launches=launches["fused_attention"],
                 **common("fused_attention", head), library_ms=head["library_ms"], dev_ms=head["dev_ms"],
                 kernel_ms=head["kernel_ms"], d128_ms=d128["fused_attention"]["ms"],
                 ms_1024=pick("fused_attention", second)["ms"], **{f"kernel_{k}": v for k, v in
                                                                  rows["attention_attributes"].items()}),
            dict(name=f"fused_qk_prologue_d{d}", source="vitok_torch/csrc/fused_attention_sm90.cu",
                 replaces="vitok_tpu/ops/fused_attention.py:124", launches=launches["fused_qk_prologue"],
                 **common("fused_qk_prologue", pro), library_ms=None,
                 differ_share=max(r["differ_share"] for r in rows["fused_qk_prologue"]),
                 d128_ms=d128["fused_attention"]["prologue_ms"]),
            dict(name=f"fused_attention_q8_d{d}", source="vitok_torch/csrc/fused_attention_sm90.cu",
                 replaces="vitok_tpu/ops/fused_attention.py:340", launches=launches["fused_attention_q8"],
                 **common("fused_attention_q8", q8), library_ms=q8["library_ms"], dev_ms=q8["dev_ms"],
                 codes_differ=0, cluster=q8["cluster"], cluster_ms=q8["cluster_ms"]),
            dict(name=f"flash_attention_d{d}", source="vitok_torch/csrc/flash_attention.cu",
                 replaces="vitok_tpu/ops/flash_attention.py:67", launches=launches["flash_attention"],
                 **common("flash_attention", fl4), library_ms=fl4["library_ms"], dev_ms=fl4["dev_ms"],
                 flex_ms=fl4.get("flex_ms"), flex_dev_ms=fl4.get("flex_dev_ms"), fold_ms=fl4["fold_ms"],
                 fold_dev_ms=fl4["fold_dev_ms"], fold_bound_ms=fl4["fold_bound_ms"],
                 d128_ms=d128["flash_attention"]["ms"], d128_dev_ms=d128["flash_attention"]["dev_ms"],
                 **{k: v for k, v in fl4.items() if k.startswith("kernel_")}),
        ]
        # The backward's instances: launches from the training steps (#3 at 256 tokens, #5/#6's fold
        # instances at 1024p), times at those steps' shapes.
        fused_step = wide["train"][d][WIDE_HEAD_TRAIN_FUSED[0]]["launches"]
        fold_step = wide["train"][d][WIDE_HEAD_TRAIN_FOLD[0]]["launches"]
        b3 = next(r for r in rows["fused_attention_bwd"] if r["N"] == WIDE_HEAD_BWD[0][1] and r["case"] == "tail")
        pd, fb = rows["fused_qk_prologue_delta"][0], rows["flash_bwd"]
        bwd3 = rows["fused_attention_bwd"]
        entries += [
            dict(name=f"fused_attention_bwd_d{d}", route="cuda", source="vitok_torch/csrc/fused_attention_bwd.cu",
                 replaces="vitok_tpu/ops/fused_attention.py:645", launches=fused_step["fused_attention_bwd"],
                 max_abs_err=max(r[f"{k}_max_rel_err"] for r in bwd3 for k in ("dq", "dk", "dv")),
                 ms=b3["ms"], dev_ms=b3["dev_ms"], plain_ms=b3["plain_ms"], bound_ms=b3["bound_ms"],
                 bound_by=b3["bound_by"], library_ms=b3["library_ms"],
                 ms_1024=next(r["ms"] for r in bwd3 if r["N"] == WIDE_HEAD_BWD[1][1]),
                 d128_ms=d128["fused_attention_bwd"]["ms"],
                 **{f"kernel_{k}": v for k, v in rows["fused_bwd_attributes"].items()}),
            dict(name=f"fused_qk_prologue_delta_d{d}", route="cuda", source="vitok_torch/csrc/fused_attention_sm90.cu",
                 replaces="vitok_tpu/ops/fused_attention.py:124",
                 launches=fused_step["fused_qk_prologue"] + fold_step["fused_qk_prologue"],
                 launches_with_delta=fused_step["fused_attention_bwd"] // 2 + fold_step["flash_attention_dq"],
                 max_abs_err=pd["max_abs_err"], delta_max_rel_err=pd["delta_max_rel_err"], ms=pd["ms"],
                 dev_ms=pd["dev_ms"], plain_ms=pd["plain_ms"], bound_ms=pd["bound_ms"], bound_by=pd["bound_by"],
                 library_ms=None),
        ]
        for name, key, line in (("flash_attention_dq", "dq", 427), ("flash_attention_dkv", "dkv", 556)):
            entries.append(dict(
                name=f"{name}_d{d}", route="cuda", source="vitok_torch/csrc/flash_attention_bwd.cu",
                replaces=f"vitok_tpu/ops/flash_attention.py:{line}", launches=fold_step[name],
                max_abs_err=max(fb[f"{x}_max_abs_err"] for x in (("dq",) if key == "dq" else ("dk", "dv"))),
                ms=fb[f"{key}_fold_ms"], dev_ms=fb[f"{key}_fold_dev_ms"], plain_instance_ms=fb[f"{key}_ms"],
                plain_instance_dev_ms=fb[f"{key}_dev_ms"], plain_ms=fb["plain_ms"], bound_ms=fb[f"{key}_bound_ms"],
                bound_by=fb[f"{key}_bound_by"], library_ms=fb["library_ms"], flex_ms=fb["flex_ms"],
                d128_ms=d128[name][f"{key}_ms"], fold_bwd_ms=fb["fold_bwd_ms"], fold_bwd_dev_ms=fb["fold_bwd_dev_ms"],
                **{f"kernel_{k}": v for k, v in fb["attributes"].items() if k.startswith(key)}))
    return entries


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


# ---------------------------------------------------------------------------
# fp32 at head dims 192 and 256: the fp32 forward's wide instances at the 5B width
# ---------------------------------------------------------------------------

# The fp32 models: the 3072-wide training models of the wide-heads phase (2 + 4
# blocks, 0.686B parameters, cut from the 5B's 4 + 40: fp32 products run on
# the CUDA cores with TF32 off), compute_dtype float32, random gates. Paths:
# WIDE_HEAD_PATHS (the walker, one launch a block), WIDE_HEAD_HIGHRES with sw
# = FLASH_SW (the fp32 prologue, then #4, one of each a block), and the
# quantized model at the first path with the int8 epilogue off and on.
WIDE_F32_MODELS = WIDE_HEAD_TRAIN
# (bb, hpb) splits of the fp32 walker timed at each of #1's shapes (with the tail mask).
WIDE_F32_SPLITS = ((1, 1), (1, 2), (1, 3), (1, 4), (2, 1), (2, 2), (4, 1))
# Head dims at which FlexAttention, the yardstick beside #4-#6 f32, is timed in fp32: at d 192 its kernels find no
# configuration that fits a block (torch 2.11 on an H100 asked for 344,320 bytes of shared memory), and the failed
# search takes about a minute.
WIDE_F32_FLEX_DIMS = (256,)


def _norm_rope_f64(qkv, qs, ks, cos, sin, h):
    """q and k of a flat fp32 ``qkv`` normed (eps 1e-6), scaled by their gains and rotated (rotate-half) in
    float64, as the prologue's ``[B, N, 2C]`` lays them out."""
    import torch

    b, n, c3 = qkv.shape
    x = qkv.view(b, n, 3, h, -1)[:, :, :2].double()
    gain = torch.stack([qs, ks]).double()[None, None, :, None, :]
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * gain
    half = y.shape[-1] // 2
    c64, s64 = (t.double()[:, :, None, None, :] for t in (cos, sin))
    yr, yi = y[..., :half], y[..., half:]
    return torch.cat([yr * c64 - yi * s64, yr * s64 + yi * c64], -1).reshape(b, n, 2 * c3 // 3)


def _wide_f32_rows(device, d: int) -> dict:
    """The fp32 forward's d-wide instances at the 5B width against their plain
    versions, TF32 off: #1 (the fp32 walker) at ``WIDE_HEAD_KERNELS`` within
    F32_OUT_REL of the plain version's largest entry (its splits timed); #2
    (the walker, then the row quantize) at the first, codes and scales
    ``quantize_activation`` of #1 bit for bit; the fp32 prologue and #4 on its
    views at B 1, N 4096, sw 1024 (the fold), each within F32_OUT_REL; #4,
    and #1 with the tail mask at both shapes, also against float64 within
    F32_F64_FACTOR of their plain versions' error there (the prologue's
    float64 error and its plain version's recorded). Each timed beside its
    bound, its plain version and SDPA (and FlexAttention for #4) in fp32."""
    import torch
    import torch.nn.functional as F
    from vitok_torch.benchmarks import host_ahead_ms
    from vitok_torch.ops import flash_attention as fl
    from vitok_torch.ops import fused_attention as fa
    from vitok_torch.ops.quant import quantize_activation

    c = WIDE_HEAD_WIDTH
    h = c // d
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = {"fused_attention_f32": [], "fused_attention_q8_f32": [], "fused_qk_prologue_f32": [],
            "flash_attention_f32": [], "wall_s": {}}
    t0 = time.time()
    cases = [(b, n, case, masked, sw) for i, (b, n) in enumerate(WIDE_HEAD_KERNELS)
             for case, masked, sw in KERNEL_CASES if i == 0 or case == "tail"]
    for b, n, case, masked, sw in cases:
        qkv, qs, ks, cos, sin, mask = _f32_inputs(40 + d, b, n, c, h, masked, device)
        kw = dict(num_heads=h, sliding_window=sw)
        kernel = lambda: fa.fused_qkv_attention(qkv, qs, ks, cos, sin, mask, impl="fused", **kw)
        plain = lambda: fa.fused_qkv_attention_plain(qkv, qs, ks, cos, sin, mask, **kw)
        got = _one_launch("fused_attention_f32", kernel)
        want = plain()
        err, rel = _f32_err(f"#1 f32 d {d} B {b} N {n} {case}", got, want, F32_OUT_REL)
        f64 = {}
        if case == "tail":  # both against float64 attention on the plain prologue's q and k, valid rows
            qn, kn = fa.fused_qk_prologue_plain(qkv, qs, ks, cos, sin, num_heads=h)[0].view(b, n, 2, h, d).unbind(2)
            v4 = qkv.view(b, n, 3, h, d)[:, :, 2]
            ref = _attention_f64(qn, kn, v4, mask, sw, torch.zeros_like(v4))[0].reshape(b, n, c)[mask]
            top = lambda a: ((a[mask].double() - ref).abs().max() / ref.abs().max()).item()
            f64 = dict(f64_rel_err=top(got), f64_plain_rel_err=top(want))
            del qn, kn, v4, ref
            if not f64["f64_rel_err"] <= F32_F64_FACTOR * f64["f64_plain_rel_err"]:
                raise AssertionError(f"#1 f32 d {d} B {b} N {n} {case}: {f64['f64_rel_err']:.3e} of the largest entry "
                                     f"from float64, over {F32_F64_FACTOR} x its plain version's "
                                     f"{f64['f64_plain_rel_err']:.3e}")
        del got, want
        nbytes = 4 * b * n * c * 4 + 2 * b * n * (d // 2) * 4 + 2 * d * 4 + (0 if mask is None else b * n)
        bound = _bound_ms(nbytes, 6 * 4.0 * h * d * _needed_pairs(b, mask, n, sw), BF16_FLOPS_PER_S)
        qn, kn, vn = _normed_qkv(qkv, qs, ks, cos, sin, b, n, h, d)
        am = _sdpa_mask(mask, n, sw, device)
        row = dict(d=d, B=b, N=n, C=c, H=h, case=case, max_abs_err=err, rel_err=rel,
                   split=fa.f32_walk_split(b, n, h, d, sms), ms=time_ms(kernel), dev_ms=host_ahead_ms(kernel),
                   plain_ms=time_ms(plain, runs=2, warmup=1),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(qn, kn, vn, attn_mask=am), runs=3,
                                      warmup=1), bound_ms=bound[0], bound_by=bound[1], **f64)
        if case == "tail":  # the walker alone at each split: what f32_walk_split is held to
            _, _, _, _, gq, gk, gc, gs, gm, swi = fa._check_cuda_args(qkv, qs, ks, cos, sin, mask, h, sw,
                                                                       dtypes=(torch.float32,))
            row["split_ms"] = {
                f"{bb}x{hpb}": time_ms(lambda bb=bb, hpb=hpb: fa._walk_f32_cuda(qkv, gq, gk, gc, gs, gm, h, bb=bb,
                                                                                 hpb=hpb, sw=swi, kind="fwd"))
                for bb, hpb in WIDE_F32_SPLITS if b % bb == 0 and h % hpb == 0}
        rows["fused_attention_f32"].append(row)
        log(f"  #1 f32 d {d} B {b} N {n} {case}: {err:.2e} ({rel:.2e} of the largest entry) from the plain version"
            + (f", {f64['f64_rel_err']:.2e} from float64 (plain {f64['f64_plain_rel_err']:.2e})" if f64 else "") + "; "
            f"{row['ms']:.4f} ms (dev {row['dev_ms']:.4f}), split {row['split']}, plain {row['plain_ms']:.4f}, SDPA "
            f"fp32 {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} ({row['bound_by']})"
            + (f"; walker alone by split {row['split_ms']}" if "split_ms" in row else ""))
        del qkv, qn, kn, vn, am

    rows["wall_s"]["#1"], t0 = time.time() - t0, time.time()

    # #2 f32 at the first shape: the walker, then the row quantize
    b, n = WIDE_HEAD_KERNELS[0]
    for case in ("none", "tail"):
        qkv, qs, ks, cos, sin, mask = _f32_inputs(50 + d, b, n, c, h, case == "tail", device)
        kernel = lambda: fa.fused_qkv_attention_q8(qkv, qs, ks, cos, sin, mask, num_heads=h)
        chain = lambda: quantize_activation(fa.fused_qkv_attention(qkv, qs, ks, cos, sin, mask, num_heads=h,
                                                                   impl="fused"))
        codes, scales = _one_launch("fused_attention_q8_f32", kernel)
        ref_codes, ref_scales = chain()
        p_codes, p_scales = fa.fused_qkv_attention_q8_plain(qkv, qs, ks, cos, sin, mask, num_heads=h)
        torch.cuda.synchronize()
        n_codes, n_scales = int((codes != ref_codes).sum()), int((scales != ref_scales).sum())
        deq = (codes.float() * scales - p_codes.float() * p_scales).abs()
        srel = (scales - p_scales).abs() / p_scales
        if mask is not None:
            deq, srel = deq[mask], srel[mask]
        if not (n_codes == 0 and n_scales == 0 and deq.max().item() <= Q8_DEQUANT_MAX_ABS
                and deq.mean().item() <= Q8_DEQUANT_MEAN_ABS and srel.max().item() <= Q8_SCALE_RTOL):
            raise AssertionError(f"#2 f32 d {d} {case}: {n_codes} codes and {n_scales} scales differ from "
                                 f"quantize_activation of #1; dequantized vs plain max {deq.max().item():.3e} mean "
                                 f"{deq.mean().item():.3e}, scales rel {srel.max().item():.3e}")
        nbytes = (b * n * 3 * c * 4 + b * n * (c + 4) + 2 * b * n * (d // 2) * 4 + 2 * d * 4
                  + (0 if mask is None else b * n))
        bound = _bound_ms(nbytes, 6 * 4.0 * h * d * _needed_pairs(b, mask, n, None), BF16_FLOPS_PER_S)
        row = dict(d=d, B=b, N=n, C=c, H=h, case=case, codes_differ=0, scales_differ=0,
                   max_abs_err=deq.max().item(), mean_abs_err=deq.mean().item(), ms=time_ms(kernel),
                   dev_ms=host_ahead_ms(kernel), library_ms=time_ms(chain),
                   plain_ms=time_ms(lambda: fa.fused_qkv_attention_q8_plain(qkv, qs, ks, cos, sin, mask,
                                                                            num_heads=h), runs=2, warmup=1),
                   bound_ms=bound[0], bound_by=bound[1])
        rows["fused_attention_q8_f32"].append(row)
        log(f"  #2 f32 d {d} B {b} N {n} {case}: codes and scales = quantize_activation(#1) bit for bit; dequantized "
            f"vs plain max {row['max_abs_err']:.2e}; {row['ms']:.4f} ms (dev {row['dev_ms']:.4f}), #1 + eager "
            f"quantize {row['library_ms']:.4f}, plain {row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
            f"({row['bound_by']})")
        del qkv, codes, scales, ref_codes, ref_scales, p_codes, p_scales, deq, srel

    rows["wall_s"]["#2"], t0 = time.time() - t0, time.time()

    # The fold's kernels: the fp32 prologue, then #4 on its views; B 1, N 4096, sw 1024
    _, n, b, _ = WIDE_HEAD_HIGHRES
    sw = FLASH_SW
    for case, masked in (("sw1024", False), ("tail+sw1024", True)):
        qkv, qs, ks, cos, sin, mask = _f32_inputs(60 + d, b, n, c, h, masked, device)
        args, kw = (qkv, qs, ks, cos, sin, mask), dict(num_heads=h, sliding_window=sw)
        valid = [n] * b if mask is None else mask.sum(1).tolist()
        tensor, tables, mbytes = b * n * c * 4, 2 * b * n * (d // 2) * 4, (0 if mask is None else b * n)
        pair_flops = 2.0 * h * d * _flash_pairs(valid, n, sw)

        prologue = lambda: fa.fused_qk_prologue(qkv, qs, ks, cos, sin, num_heads=h)
        pro_plain = lambda: fa.fused_qk_prologue_plain(qkv, qs, ks, cos, sin, num_heads=h)
        qk, _ = _one_launch("fused_qk_prologue_f32", prologue)
        qk_plain = pro_plain()[0]
        perr, prel = _f32_err(f"fp32 prologue d {d} {case}", qk, qk_plain, F32_OUT_REL)
        qk64 = _norm_rope_f64(qkv, qs, ks, cos, sin, h)
        ptop = lambda a: ((a.double() - qk64).abs().max() / qk64.abs().max()).item()
        pf64, pf64_plain = ptop(qk), ptop(qk_plain)
        del qk_plain, qk64
        pbound = _bound_ms(4 * tensor + tables + 2 * d * 4, 0.0, BF16_FLOPS_PER_S)
        rows["fused_qk_prologue_f32"].append(dict(
            d=d, B=b, N=n, C=c, H=h, case=case, max_abs_err=perr, rel_err=prel, f64_rel_err=pf64,
            f64_plain_rel_err=pf64_plain, ms=time_ms(prologue),
            dev_ms=host_ahead_ms(prologue), plain_ms=time_ms(pro_plain, runs=2, warmup=1), bound_ms=pbound[0],
            bound_by=pbound[1]))

        q, k = qk.view(b, n, 2, h, d).unbind(2)
        v = qkv.view(b, n, 3, h, d)[:, :, 2]
        fwd = lambda: fl.flash_attention(q, k, v, mask, sw)
        plain = lambda: fl.flash_attention_plain(q, k, v, mask, sw)
        out = _one_launch("flash_attention_f32", fwd)
        want = plain()
        err, rel = _f32_err(f"#4 f32 d {d} {case}", out, want, F32_OUT_REL)
        if mask is not None and out[~mask].any():
            raise AssertionError(f"#4 f32 d {d} {case}: padded rows are not exactly 0")
        got_lse = fl.flash_attention(q, k, v, mask, sw, return_lse=True)[1]
        want_lse = fl.flash_attention_plain(q, k, v, mask, sw, return_lse=True)[1]
        live = want_lse < 1e29
        lse_err = (got_lse[live] - want_lse[live]).abs().max().item()
        if not (lse_err <= LSE_ATOL and torch.equal(got_lse >= 1e29, ~live)):
            raise AssertionError(f"#4 f32 d {d} {case}: lse max |err| {lse_err:.3e} (limit {LSE_ATOL}) or dead rows")
        ref = _attention_f64(q, k, v, mask, sw, torch.zeros_like(v))[0]
        keep = slice(None) if mask is None else mask
        top = lambda a: ((a[keep].double() - ref[keep]).abs().max() / ref[keep].abs().max()).item()
        f64, f64_plain = top(out), top(want)
        if not f64 <= F32_F64_FACTOR * f64_plain:
            raise AssertionError(f"#4 f32 d {d} {case}: {f64:.3e} of the largest entry from float64, over "
                                 f"{F32_F64_FACTOR} x its plain version's {f64_plain:.3e}")
        fold = lambda: fa.flash_qkv_attention(*args, **kw)
        fold_plain = lambda: fa.flash_qkv_attention_plain(*args, **kw)
        ferr, frel = _f32_err(f"fold f32 d {d} {case}", fold(), fold_plain(), F32_OUT_REL)
        del out, want, got_lse, want_lse, live, ref
        bound = _bound_ms(4 * tensor + mbytes, 6 * 2 * pair_flops, BF16_FLOPS_PER_S)
        fbound = _bound_ms(4 * tensor + tables + mbytes + 2 * d * 4, 6 * 2 * pair_flops, BF16_FLOPS_PER_S)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        am = _sdpa_mask(mask, n, sw, device)
        row = dict(d=d, B=b, N=n, H=h, case=case, max_abs_err=err, rel_err=rel, lse_max_abs_err=lse_err,
                   f64_rel_err=f64, f64_plain_rel_err=f64_plain, fold_max_abs_err=ferr, fold_rel_err=frel,
                   ms=time_ms(fwd), dev_ms=host_ahead_ms(fwd), plain_ms=time_ms(plain, runs=2, warmup=1),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am), runs=3,
                                      warmup=1),
                   bound_ms=bound[0], bound_by=bound[1], fold_ms=time_ms(fold), fold_dev_ms=host_ahead_ms(fold),
                   fold_plain_ms=time_ms(fold_plain, runs=2, warmup=1), fold_bound_ms=fbound[0],
                   fold_bound_by=fbound[1])
        row["flex_ms"] = None
        if masked and d in WIDE_F32_FLEX_DIMS:  # the yardstick, compiled once a head dim
            t1 = time.time()
            flex = _flex_call(q, k, v, mask, sw)
            row["flex_ms"] = time_ms(flex)
            del flex
            rows["wall_s"]["flex"] = time.time() - t1
        rows["flash_attention_f32"].append(row)
        log(f"  fp32 prologue d {d} B {b} N {n}: {perr:.2e} ({prel:.2e}; from float64 {pf64:.2e}, plain {pf64_plain:.2e}); "
            f"{rows['fused_qk_prologue_f32'][-1]['ms']:.4f}"
            f" ms, plain {rows['fused_qk_prologue_f32'][-1]['plain_ms']:.4f}, bound {pbound[0]:.4f}; #4 f32 {case}: "
            f"{err:.2e} ({rel:.2e}), lse {lse_err:.2e}, against float64 {f64:.2e} (plain {f64_plain:.2e}); "
            f"{row['ms']:.4f} ms (dev {row['dev_ms']:.4f}), plain {row['plain_ms']:.4f}, SDPA fp32 "
            f"{row['library_ms']:.4f}, FlexAttention fp32 {row['flex_ms'] or 'not timed'}, bound "
            f"{row['bound_ms']:.4f} "
            f"({row['bound_by']}); the fold {row['fold_ms']:.4f} (dev {row['fold_dev_ms']:.4f}), {ferr:.2e} from "
            f"its plain version ({row['fold_plain_ms']:.4f})")
        del qkv, args, qk, q, k, v, qt, kt, vt, am
    rows["wall_s"]["#4"] = time.time() - t0
    split = fa.f32_walk_split(*WIDE_HEAD_KERNELS[0], h, d, sms)
    rows["attributes"] = dict(walker=fa.f32_walk_attributes(d, "fwd", split[0]),
                              prologue=fa.sm90_attributes("prologue_f32", d), flash=fl.flash_f32_attributes("fwd", d))
    log(f"  d {d} fp32 (registers, local bytes, blocks an SM, shared bytes): {rows['attributes']}; seconds "
        f"{ {k: round(v, 1) for k, v in rows['wall_s'].items()} } (#4's with FlexAttention's compile)")
    return rows


def wide_f32_phase(device, card: str) -> dict:
    """fp32 at head dims 192 and 256: each of the fp32 forward's wide
    instances against its plain version (``_wide_f32_rows``), then both
    3072-wide models (``WIDE_F32_MODELS``) with compute_dtype float32 on the
    main path: encode -> decode at 256p and 512p (the walker in every block)
    and at 1024p with sw = FLASH_SW (the fp32 prologue and #4 in every block),
    each within F32_MODEL_REL_L2 of the same weights on the unfused
    composition; ``AE.quantize()``d at 256p with the int8 epilogue off (the
    walker) and on (#2 f32), within MODEL_REL_L2 of the quantize kernels'
    plain versions, the two bit for bit."""
    import torch
    from vitok_torch import AE, decode_variant
    from vitok_torch.ops import fused_attention as fa

    t0 = time.time()
    out = {"rows": {}, "launches": {}, "paths": []}
    for d, variant in WIDE_F32_MODELS:
        log(f"fp32 wide heads d {d}: kernel checks at the 5B width, TF32 off, on {card}")
        t1 = time.time()
        out["rows"][d] = _wide_f32_rows(device, d)
        torch.cuda.empty_cache()
        log(f"  d {d} fp32 kernel rows: {time.time() - t1:.1f} s")
        t1 = time.time()
        model = AE(**decode_variant(variant), seed=0, device=device, compute_dtype=torch.float32)
        _random_gates(model, device)
        depth = model.cfg.encoder_depth + model.cfg.decoder_depth
        log(f"fp32 wide heads d {d}: {variant} ({sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params, "
            f"{depth} blocks), compute_dtype float32")
        launches = dict.fromkeys(launch_counts(), 0)

        def add(counts):
            for k_, v_ in counts.items():
                launches[k_] += v_

        def unfused_ms(inputs):
            _set_attn_impl(model, "xla")
            ref = model.decode(model.encode(inputs))
            ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=2, warmup=1)
            _set_attn_impl(model, "auto")
            return ref, ms

        cases = main_path_cases(device, WIDE_HEAD_PATHS, seed=25)
        outs, counts = _run_counted(model, cases, _expect(fused_attention_f32=depth), f"fp32 d {d}")
        add(counts)
        for (name, max_tokens, batch, images, inputs), o in zip(cases, outs):
            _check_output(name, max_tokens, batch, images, inputs, o)
            ref, ref_ms = unfused_ms(inputs)
            rel = _valid_rel_l2(o, ref, inputs)
            if not rel <= F32_MODEL_REL_L2:
                raise AssertionError(f"fp32 d {d} {name}: rel L2 vs the unfused composition {rel:.3e} > "
                                     f"{F32_MODEL_REL_L2}")
            ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=2, warmup=1)
            out["paths"].append(dict(d=d, dtype="fp32", res=name, batch=batch, rel_l2=rel, ms_per_img=ms / batch,
                                     unfused_ms_per_img=ref_ms / batch))
            log(f"  fp32 d {d} {name} B {batch}: the walker in every block; rel L2 vs the unfused composition "
                f"{rel:.3e}; {ms / batch:.4f} ms/img (unfused {ref_ms / batch:.4f}) on {card}")
            del ref
        del outs, cases

        model.cfg = dataclasses.replace(model.cfg, sw=FLASH_SW)
        (case,) = main_path_cases(device, [WIDE_HEAD_HIGHRES], seed=26)
        name, max_tokens, batch, images, inputs = case
        with torch.inference_mode():
            (o,), counts = _run_counted(model, [case], _expect(flash_attention_f32=depth,
                                                               fused_qk_prologue_f32=depth, fused_qk_prologue=0),
                                        f"fp32 d {d} {name}")
            add(counts)
            _check_output(name, max_tokens, batch, images, inputs, o)
            ref, ref_ms = unfused_ms(inputs)
            rel = _valid_rel_l2(o, ref, inputs)
            if not rel <= F32_MODEL_REL_L2:
                raise AssertionError(f"fp32 d {d} {name}: rel L2 vs the unfused composition {rel:.3e} > "
                                     f"{F32_MODEL_REL_L2}")
            ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=2, warmup=1)
        out["paths"].append(dict(d=d, dtype="fp32", res=name, batch=batch, sw=FLASH_SW, rel_l2=rel, ms_per_img=ms,
                                 unfused_ms_per_img=ref_ms))
        log(f"  fp32 d {d} {name} sw {FLASH_SW} B {batch}: the fp32 prologue and #4 in every block; rel L2 vs the "
            f"unfused composition {rel:.3e}; {ms:.4f} ms/img (unfused {ref_ms:.4f}) on {card}")
        model.cfg = dataclasses.replace(model.cfg, sw=None)
        del o, ref

        model.quantize()
        torch.cuda.empty_cache()
        (case,) = main_path_cases(device, WIDE_HEAD_PATHS[:1], seed=27)
        name, max_tokens, batch, images, inputs = case
        expect = dict(fused_attention_f32=depth, rmsnorm_quant=depth, ffn_int8=depth, fused_qk_prologue=0)
        (o,), counts = _run_counted(model, [case], _expect(**expect), f"int8 fp32 d {d}")
        add(counts)
        _check_output(name, max_tokens, batch, images, inputs, o)
        with plain_quant_kernels():
            rel = _valid_rel_l2(o, model.decode(model.encode(inputs)), inputs)
        if not rel <= MODEL_REL_L2:
            raise AssertionError(f"int8 fp32 d {d} {name}: rel L2 vs the plain quantize kernels {rel:.3e} > "
                                 f"{MODEL_REL_L2}")
        ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=2, warmup=1)
        with q8_epilogue(True):
            if not fa.can_fuse_q8(max_tokens, model.cfg.encoder_width, model.cfg.encoder_heads, cuda=True,
                                  dtype=torch.float32):
                raise AssertionError(f"int8 fp32 d {d}: the epilogue's gate is closed at {max_tokens} tokens")
            expect = dict(fused_attention_q8_f32=depth, fused_attention_f32=depth, rmsnorm_quant=depth,
                          ffn_int8=depth, fused_qk_prologue=0)
            (q8o,), counts = _run_counted(model, [case], _expect(**expect), f"int8 fp32 + epilogue d {d}")
            q8_ms = time_ms(lambda: model.decode(model.encode(inputs)), runs=2, warmup=1)
        add(counts)
        _check_output(name, max_tokens, batch, images, inputs, q8o)
        with plain_quant_kernels():
            q8_rel = _valid_rel_l2(q8o, model.decode(model.encode(inputs)), inputs)
        if not (q8_rel <= MODEL_REL_L2 and torch.equal(q8o["patches"], o["patches"])):
            raise AssertionError(f"int8 fp32 + epilogue d {d}: rel L2 vs the plain quantize kernels {q8_rel:.3e} "
                                 f"(limit {MODEL_REL_L2}), or not bit for bit the opt-in off")
        out["paths"].append(dict(d=d, dtype="int8 fp32", res=name, batch=batch, rel_l2_vs_plain=rel,
                                 ms_per_img=ms / batch, epilogue_rel_l2_vs_plain=q8_rel, epilogue_bit_for_bit=True,
                                 epilogue_ms_per_img=q8_ms / batch))
        log(f"  int8 fp32 d {d} {name} B {batch}: rel L2 vs the plain quantize kernels {rel:.3e}; "
            f"{ms / batch:.4f} ms/img; with the epilogue (#2 f32) {q8_ms / batch:.4f} ms/img, rel L2 {q8_rel:.3e}, "
            f"bit for bit the opt-in off, on {card}")
        out["launches"][d] = launches
        log(f"  fp32 d {d} launches over its path's runs: {_nonzero(launches)}; the models {time.time() - t1:.1f} s")
        del model, o, q8o
        torch.cuda.empty_cache()
    out["wall_s"] = time.time() - t0
    log(f"fp32 wide heads phase: {out['wall_s']:.1f} s")
    return out


def wide_f32_entries(wide32: dict) -> list:
    """The kernels line's entries of the fp32 forward's d 192 and 256
    instances (#1, #2, the prologue and #4, at the first shape each row
    set has), launches from the models' runs."""
    entries = []
    for d in sorted(wide32["rows"]):
        rows, launches = wide32["rows"][d], wide32["launches"][d]
        attrs = rows["attributes"]
        pick = lambda name, case, n=None: next(r for r in rows[name] if r["case"] == case and (n is None or r["N"] == n))
        first, second = WIDE_HEAD_KERNELS[0][1], WIDE_HEAD_KERNELS[1][1]
        w, q8 = pick("fused_attention_f32", "tail", first), pick("fused_attention_q8_f32", "tail")
        pro, f4 = pick("fused_qk_prologue_f32", "tail+sw1024"), pick("flash_attention_f32", "tail+sw1024")
        common = lambda name, row: dict(route="cuda", max_abs_err=max(r["max_abs_err"] for r in rows[name]),
                                        ms=row["ms"], dev_ms=row["dev_ms"], plain_ms=row["plain_ms"],
                                        bound_ms=row["bound_ms"], bound_by=row["bound_by"])
        kernel = lambda key: {f"kernel_{k}": v for k, v in attrs[key].items()}
        entries += [
            dict(name=f"fused_attention_f32_d{d}", source="vitok_torch/csrc/fused_attention_ab_f32_sm90.cu",
                 replaces="vitok_tpu/ops/fused_attention.py:317", launches=launches["fused_attention_f32"],
                 **common("fused_attention_f32", w), library_ms=w["library_ms"], f64_rel_err=w["f64_rel_err"],
                 f64_plain_rel_err=w["f64_plain_rel_err"], split=w["split"],
                 split_ms=w["split_ms"], ms_1024=pick("fused_attention_f32", "tail", second)["ms"], **kernel("walker")),
            dict(name=f"fused_attention_q8_f32_d{d}", source="vitok_torch/csrc/quantize_rows.cu",
                 replaces="vitok_tpu/ops/fused_attention.py:340", launches=launches["fused_attention_q8_f32"],
                 walker_launches=launches["fused_attention_f32"], **common("fused_attention_q8_f32", q8),
                 library_ms=q8["library_ms"], codes_differ=0),
            dict(name=f"fused_qk_prologue_f32_d{d}", source="vitok_torch/csrc/fused_attention_sm90.cu",
                 replaces="vitok_tpu/ops/fused_attention.py:124", launches=launches["fused_qk_prologue_f32"],
                 **common("fused_qk_prologue_f32", pro), library_ms=None, f64_rel_err=pro["f64_rel_err"],
                 f64_plain_rel_err=pro["f64_plain_rel_err"], **kernel("prologue")),
            dict(name=f"flash_attention_f32_d{d}", source="vitok_torch/csrc/flash_attention_f32.cu",
                 replaces="vitok_tpu/ops/flash_attention.py:67", launches=launches["flash_attention_f32"],
                 **common("flash_attention_f32", f4), library_ms=f4["library_ms"], flex_ms=f4["flex_ms"],
                 f64_rel_err=f4["f64_rel_err"], f64_plain_rel_err=f4["f64_plain_rel_err"], fold_ms=f4["fold_ms"],
                 fold_dev_ms=f4["fold_dev_ms"], fold_plain_ms=f4["fold_plain_ms"], fold_bound_ms=f4["fold_bound_ms"],
                 **kernel("flash")),
        ]
    return entries


WIDE_F32_BWD_FUSED = ((8, 256), (8, 1024))  # (B, N) of the lse instance and #3: the 256-token route's B; the gate's most N


def _wide_f32_bwd_rows(device, d: int) -> dict:
    """The fp32 backward's d-wide instances at the 5B width against their
    plain versions, TF32 off: the walker's lse instance and #3 (the prologue
    with delta, then #5's and #6's fold instances at the walker's log2 lse)
    at ``WIDE_F32_BWD_FUSED`` with the tail mask (``_f32_fused_row``; the
    lse instance also against float64 within F32_F64_FACTOR of its plain
    version's error); the fp32 prologue with delta alone at the first shape
    (q/k and delta within F32_OUT_REL, delta's float64 error recorded); the
    fold's kernels at the 1024p route's shape, B 1, N 4096, sw 1024, tail
    (``_f32_flash_row``: the prologue, #4, #5 and #6 plain, each against
    float64, and the fold's backward, each fold instance timed alone).
    Registers, local bytes and shared bytes of every new instance."""
    import torch
    from vitok_torch.benchmarks import host_ahead_ms
    from vitok_torch.ops import flash_attention as fl
    from vitok_torch.ops import fused_attention as fa

    c = WIDE_HEAD_WIDTH
    h = c // d
    label = f"5B width d{d}"
    rows = {"fused": [_f32_fused_row(label, b, n, c, h, True, device, f64=True) for b, n in WIDE_F32_BWD_FUSED]}

    b, n = WIDE_F32_BWD_FUSED[0]  # the prologue with delta, as #3 launches it
    qkv, qs, ks, cos, sin, mask = _f32_inputs(70 + d, b, n, c, h, True, device)
    out = fa.fused_qkv_attention_plain(qkv, qs, ks, cos, sin, mask, num_heads=h)
    gen = torch.Generator(device=device).manual_seed(71)
    dout = torch.randn((b, n, c), generator=gen, device=device) * mask[..., None]
    pro = lambda: fa.fused_qk_prologue(qkv, qs, ks, cos, sin, num_heads=h, out=out, dout=dout)
    pro_plain = lambda: fa.fused_qk_prologue_plain(qkv, qs, ks, cos, sin, num_heads=h, out=out, dout=dout)
    qk, delta = _one_launch("fused_qk_prologue_f32", pro)
    qk_want, delta_want = pro_plain()
    qerr, qrel = _f32_err(f"fp32 prologue with delta d {d}: q/k", qk, qk_want, F32_OUT_REL)
    derr, drel = _f32_err(f"fp32 prologue with delta d {d}: delta", delta, delta_want, F32_OUT_REL)
    delta64 = (out.double() * dout.double()).view(b, n, h, d).sum(-1).transpose(1, 2)
    dtop = lambda a: ((a.double() - delta64).abs().max() / delta64.abs().max()).item()
    bound = _bound_ms(6 * b * n * c * 4 + 2 * b * n * (d // 2) * 4 + 2 * d * 4 + b * h * n * 4, 0.0,
                      BF16_FLOPS_PER_S)
    rows["prologue_delta"] = row = dict(
        d=d, B=b, N=n, C=c, H=h, max_abs_err=max(qerr, derr), rel_err=max(qrel, drel), delta_rel_err=drel,
        f64_rel_err=dtop(delta), f64_plain_rel_err=dtop(delta_want), ms=time_ms(pro), dev_ms=host_ahead_ms(pro),
        plain_ms=time_ms(pro_plain, runs=2, warmup=1), bound_ms=bound[0], bound_by=bound[1])
    log(f"  fp32 prologue with delta d {d} B {b} N {n}: q/k {qrel:.2e}, delta {drel:.2e} of the largest entry from "
        f"the plain version, delta from float64 {row['f64_rel_err']:.2e} (plain {row['f64_plain_rel_err']:.2e}); "
        f"{row['ms']:.4f} ms (dev {row['dev_ms']:.4f}), plain {row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
        f"({row['bound_by']})")
    del qkv, out, dout, qk, delta, qk_want, delta_want, delta64

    _, n, b, _ = WIDE_HEAD_HIGHRES  # the fold at the 1024p route's shape
    rows["flash"] = _f32_flash_row(label, b, n, h, d, True, FLASH_SW, device, flex=False,
                                   flex_bwd=d in WIDE_F32_FLEX_DIMS)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    bb = fa.f32_walk_split(*WIDE_F32_BWD_FUSED[0], h, d, sms)[0]
    rows["attributes"] = dict(walker_lse=fa.f32_walk_attributes(d, "fwd", bb, lse=True),
                              prologue=fa.sm90_attributes("prologue_f32", d),
                              **{w: fl.flash_f32_attributes(w, d) for w in fl.F32_KERNELS[1:]})
    log(f"  d {d} fp32 backward (registers, local bytes, blocks an SM, shared bytes): {rows['attributes']}")
    return rows


def wide_f32_bwd_phase(device, card: str) -> dict:
    """The fp32 backward at head dims 192 and 256, TF32 off: each new
    instance against its plain version (``_wide_f32_bwd_rows``), then both
    3072-wide models (``WIDE_F32_MODELS``) trained in fp32 (compute and
    master weights) on both routes (``_wide_train``): at 256 tokens with
    ``attn_impl="fused"`` the walker's lse instance forward, the fp32
    prologue with delta and #3's fp32 instance backward; at 1024p with sw =
    FLASH_SW the fp32 prologue and #4 forward, the prologue with delta and
    #5's and #6's fold instances backward; every block's kernels counted."""
    import torch

    t0 = time.time()
    out = {"rows": {}, "train": {}}
    saved_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for d, variant in WIDE_F32_MODELS:
            log(f"fp32 backward d {d}: kernel checks at the 5B width, TF32 off, on {card}")
            t1 = time.time()
            out["rows"][d] = _wide_f32_bwd_rows(device, d)
            torch.cuda.empty_cache()
            log(f"  d {d} fp32 backward rows: {time.time() - t1:.1f} s")
            t1 = time.time()
            out["train"][d] = _wide_train(device, card, d, variant, compute_dtype=torch.float32)
            torch.cuda.empty_cache()
            log(f"  d {d} fp32 training: {time.time() - t1:.1f} s")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved_tf32
    out["wall_s"] = time.time() - t0
    log(f"fp32 backward phase: {out['wall_s']:.1f} s")
    return out


def wide_f32_bwd_entries(wide: dict) -> list:
    """The kernels line's entries of the fp32 backward's d 192 and 256
    instances (the walker's lse instance, the prologue with delta, #3, #5
    and #6), launches from the fp32 training runs (the 256-token route's and
    the 1024p route's three steps); times at the first row of each set."""
    entries = []
    src_fl, src_sm90 = "vitok_torch/csrc/flash_attention_f32.cu", "vitok_torch/csrc/fused_attention_sm90.cu"
    for d in sorted(wide["rows"]):
        rows, train = wide["rows"][d], wide["train"][d]
        fused_run = collections.Counter(train[WIDE_HEAD_TRAIN_FUSED[0]]["launches"])  # nonzero counts
        fold_run = collections.Counter(train[WIDE_HEAD_TRAIN_FOLD[0]]["launches"])
        top, fl_row, pro, attrs = rows["fused"][0], rows["flash"], rows["prologue_delta"], rows["attributes"]
        kernel = lambda *keys: {f"kernel_{k}": attrs[k] for k in keys}
        fused_rows = lambda *keys: [{"N": r["N"], **{k: r[k] for k in keys}} for r in rows["fused"]]

        def entry(name, source, replaces, launches, row, key, err, library, plain=None, **more):
            return {"name": f"{name}_d{d}", "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches, "max_abs_err": row[err], "ms": row[f"{key}ms"],
                    "plain_ms": row[plain or f"{key}plain_ms"], "bound_ms": row[f"{key}bound_ms"],
                    "bound_by": row[f"{key}bound_by"], "library_ms": None if library is None else row[library],
                    "dev_ms": row[f"{key}dev_ms"], **more}

        entries += [
            entry("fused_attention_f32_lse", "vitok_torch/csrc/fused_attention_ab_f32_sm90.cu",
                  "vitok_tpu/ops/fused_attention.py:317", fused_run["fused_attention_f32_lse"], top, "", "max_abs_err",
                  "library_ms", lse_max_abs_err=max(r["lse_max_abs_err"] for r in rows["fused"]),
                  rows=fused_rows("ms", "dev_ms", "plain_ms", "bound_ms", "library_ms", "f64_rel_err",
                                  "f64_plain_rel_err"), **kernel("walker_lse")),
            entry("fused_qk_prologue_f32_delta", src_sm90, "vitok_tpu/ops/fused_attention.py:124",
                  fused_run["fused_qk_prologue_f32"] + fold_run["fused_qk_prologue_f32"]
                  - fold_run["flash_attention_f32"], pro, "", "max_abs_err", None, delta_rel_err=pro["delta_rel_err"],
                  f64_rel_err=pro["f64_rel_err"], f64_plain_rel_err=pro["f64_plain_rel_err"], **kernel("prologue")),
            entry("fused_attention_bwd_f32", src_fl, "vitok_tpu/ops/fused_attention.py:645",
                  fused_run["fused_attention_bwd_f32"], top, "bwd_", "bwd_max_abs_err", "bwd_library_ms",
                  rows=fused_rows("bwd_ms", "bwd_dev_ms", "bwd_plain_ms", "bwd_bound_ms", "bwd_library_ms"),
                  **kernel("dq_fold", "dkv_fold")),
            entry("flash_attention_dq_f32", src_fl, "vitok_tpu/ops/flash_attention.py:427",
                  fold_run["flash_attention_dq_f32"], fl_row, "dq_", "dq_max_abs_err", "bwd_library_ms",
                  plain="bwd_plain_ms", fold_ms=fl_row["fold_dq_ms"], fold_dev_ms=fl_row["fold_dq_dev_ms"],
                  f64_rel_err=fl_row["dq_f64_rel_err"], f64_plain_rel_err=fl_row["dq_f64_plain_rel_err"],
                  flex_ms=fl_row["bwd_flex_ms"], **kernel("dq", "dq_fold")),
            entry("flash_attention_dkv_f32", src_fl, "vitok_tpu/ops/flash_attention.py:556",
                  fold_run["flash_attention_dkv_f32"], fl_row, "dkv_", "dkv_max_abs_err", "bwd_library_ms",
                  plain="bwd_plain_ms", fold_ms=fl_row["fold_dkv_ms"], fold_dev_ms=fl_row["fold_dkv_dev_ms"],
                  fold_bwd_ms=fl_row["fold_bwd_ms"], fold_bwd_plain_ms=fl_row["fold_bwd_plain_ms"],
                  fold_bwd_bound_ms=fl_row["fold_bwd_bound_ms"], fold_bwd_max_abs_err=fl_row["fold_bwd_max_abs_err"],
                  f64_rel_err=fl_row["dkv_f64_rel_err"], f64_plain_rel_err=fl_row["dkv_f64_plain_rel_err"],
                  flex_ms=fl_row["bwd_flex_ms"], **kernel("dkv", "dkv_fold")),
        ]
    return entries


# ---------------------------------------------------------------------------
# The A/B kernels #10-#13 at head dims 192 and 256
# ---------------------------------------------------------------------------

WIDE_AB_WIDTH = 3072
WIDE_AB_HEADS = ((192, 16), (256, 12))  # (head dim, heads) at C WIDE_AB_WIDTH
WIDE_AB_SHAPES = (  # (dtype, N, B, masks): the recorded A/B shapes of each dtype
    ("bfloat16", 256, 64, ("ones", "tail+dead")),
    ("float32", 64, 256, ("tail+dead",)),
)
WIDE_AB_SKIPS = {192: {"C512", "C256", "C128"}, 256: {"C384", "C128"}}  # the JAX entry's "FAILED to build" arms


def _wide_ab_rows(device, d: int, h: int) -> dict:
    """Each new instance at head dim ``d`` (C WIDE_AB_WIDTH, ``h`` heads) on
    WIDE_AB_SHAPES, bit for bit against the reference of its own body: in
    bf16 #10 (every arm this width takes), #11 (on images with a valid key)
    and #13 against #1 at that width (X), #12 against X on the assembled
    tensor and the int8 prologue against the bf16 prologue on bf16(code); in
    fp32 #10, #11 and #13 against the fp32 walker with one cell a block (W).
    Each within its limits of its plain version (the pack's, with its dead
    image averaged over the pack, ``_pack_plain``). Timed on the first mask
    of each dtype: ms, dev (host ahead), plain, bound, SDPA on the normed
    q/k."""
    import torch
    import torch.nn.functional as F
    from vitok_torch.benchmarks import ab_batch_block as abb
    from vitok_torch.benchmarks import ab_q8_input as ab8
    from vitok_torch.benchmarks import host_ahead_ms, sm90_attributes
    from vitok_torch.ops import fused_attention as fa

    c = WIDE_AB_WIDTH
    gen = torch.Generator(device=device).manual_seed(26 + d)
    out = {"rows": [], "errs": {}, "attributes": {}}
    errs = out["errs"]

    def held(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    for dtype, n, b, masks in WIDE_AB_SHAPES:
        f32 = dtype == "float32"
        sfx = "_f32" if f32 else ""
        for mask_kind in masks:
            qkv, qs, ks, cos, sin, mask = _ab_inputs(gen, b, n, c, h, dtype, mask_kind, device)
            args = (qkv, qs, ks, cos, sin, mask)
            isz = qkv.element_size()
            live = mask.any(1)
            valid = mask | ~live[:, None]  # rows held to the limits: valid rows, and a dead image's
            plain = fa.fused_qkv_attention_plain(*args, num_heads=h)
            if f32:  # W: the bits of every fp32 walker kernel
                ref_name = "W (the fp32 walker, one cell a block)"
                ref = _one_launch("fused_attention_bb_f32", lambda: abb.fused_attention_bb(*args, num_heads=h, bb=1,
                                                                                           cg=d))
            else:  # X: #1 at this width
                ref_name = "X (#1 at this width)"
                ref = _one_launch("fused_attention", lambda: fa.fused_qkv_attention(*args, num_heads=h, impl="fused"))
            timed = mask_kind == masks[0]
            row = dict(dtype=dtype, N=n, B=b, C=c, H=h, d=d, mask=mask_kind, reference=ref_name, kernels={})

            def kernel(name, call, want, rows_eq=slice(None), pairs=None):
                got = _one_launch(name, call)
                if not torch.equal(got[rows_eq], ref[rows_eq]):
                    raise AssertionError(f"{name} d {d} {dtype} {mask_kind}: not bit-identical to {ref_name}")
                held(name, _check_ab(f"{name} d {d} {mask_kind}", got, want, valid, f32))
                if timed:
                    bound = _ab_bound(b, n, c, h, mask, isz, pairs=pairs, split=f32)
                    row["kernels"][name] = dict(ms=time_ms(call), dev_ms=host_ahead_ms(call), bound_ms=bound[0],
                                                bound_by=bound[1])
                return got

            # #10 at every arm this width takes; D2 (bb 2, cg 1536) timed
            for arm, bb, cg, _ in abb.arm_defs(c, d, n, b, h):
                if cg is None or arm.startswith("P") or cg % d:
                    continue
                call = lambda bb=bb, cg=cg: abb.fused_attention_bb(*args, num_heads=h, bb=bb, cg=cg)
                if arm == "D2":
                    kernel("fused_attention_bb" + sfx, call, plain)
                else:
                    got = _one_launch("fused_attention_bb" + sfx, call)
                    if not torch.equal(got, ref):
                        raise AssertionError(f"#10 arm {arm} d {d} {dtype}: not bit-identical to {ref_name}")
            # #11, P2: X's (W's) bits on images with a valid key; a dead image the mean of v over its pack
            pack = lambda: abb.fused_attention_bb(*args, num_heads=h, bb=2, cg=1536, pack=True)
            pack_plain = abb.fused_attention_bb_plain(*args, num_heads=h, bb=2, cg=1536, pack=True)
            kernel("fused_attention_pack" + sfx, pack, pack_plain, rows_eq=live, pairs=_pack_pairs(mask, n, 2))
            # #13
            kernel("fused_attention_contig" + sfx, lambda: ab8.fused_attention_contig(*args, num_heads=h), plain)
            if timed:
                row["plain_ms"] = time_ms(lambda: fa.fused_qkv_attention_plain(*args, num_heads=h), runs=3, warmup=1)
                row["pack_plain_ms"] = time_ms(lambda: abb.fused_attention_bb_plain(*args, num_heads=h, bb=2, cg=1536,
                                                                                   pack=True), runs=3, warmup=1)
                q, k, v = _normed_qkv(qkv, qs, ks, cos, sin, b, n, h, d)
                am = mask[:, None, None, :]
                row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am))
                del q, k, v
                row["reference_ms"] = time_ms(lambda: fa.fused_qkv_attention(*args, num_heads=h, impl="fused"))
            if not f32:  # #12: the int8 prologue, then the walk over int8 q and v tiles
                codes, scale = ab8.quantize_qkv(qkv)
                assembled = ab8.assemble_q8in(codes, scale)
                kn8 = _one_launch("fused_attention_q8in_prologue",
                                  lambda: ab8.q8in_k_prologue(codes, ks, cos, sin, num_heads=h))
                kn, _ = fa.fused_qk_prologue(assembled, qs, ks, cos, sin, num_heads=h, with_q=False)
                if not torch.equal(kn8, kn):
                    raise AssertionError(f"int8 prologue d {d} {mask_kind}: not the bf16 prologue's bits on bf16(code)")
                prologue8 = lambda: ab8.q8in_k_prologue(codes, ks, cos, sin, num_heads=h)
                prologue8_plain = lambda: ab8.q8in_k_prologue_plain(codes, ks, cos, sin, num_heads=h)
                perr = (kn8.float() - prologue8_plain().float()).abs()
                pro_max, pro_share = perr.max().item(), (perr > 0).float().mean().item()
                if not (pro_max <= PROLOGUE_MAX_ABS and pro_share <= PROLOGUE_DIFFER_SHARE):
                    raise AssertionError(f"int8 prologue d {d} {mask_kind}: max {pro_max:.3e} (limit "
                                         f"{PROLOGUE_MAX_ABS}), {pro_share:.2e} of entries differ (limit "
                                         f"{PROLOGUE_DIFFER_SHARE}) against its plain version")
                held("fused_attention_q8in_prologue", pro_max)
                if timed:  # k's codes read, its normed copy written, the tables and the gain read once
                    bound = _bound_ms(b * n * c * 3 + 2 * b * n * (d // 2) * 4 + d * 4, 0.0, BF16_FLOPS_PER_S)
                    row["kernels"]["fused_attention_q8in_prologue"] = dict(
                        ms=time_ms(prologue8), dev_ms=host_ahead_ms(prologue8), bound_ms=bound[0], bound_by=bound[1],
                        plain_ms=time_ms(prologue8_plain, runs=3, warmup=1), library_ms=None)
                del kn8, kn, perr
                x_assembled = fa.fused_qkv_attention(assembled, qs, ks, cos, sin, mask, num_heads=h, impl="fused")
                q8args = (codes, scale, qs, ks, cos, sin, mask)
                call = lambda: ab8.fused_attention_q8in(*q8args, num_heads=h)
                got = _one_launch("fused_attention_q8in_prologue", lambda: _one_launch("fused_attention_q8in", call))
                if not torch.equal(got, x_assembled):
                    raise AssertionError(f"fused_attention_q8in d {d} {mask_kind}: not bit-identical to X on the "
                                         "assembled tensor")
                q8plain = lambda: ab8.fused_attention_q8in_plain(*q8args, num_heads=h)
                held("fused_attention_q8in", _check_ab(f"q8in d {d} {mask_kind}", got, q8plain(), valid, False))
                if timed:
                    bound = _ab_bound(b, n, c, h, mask, 2, in_bytes=3 * c + 4)
                    chain = lambda: fa.fused_qkv_attention(ab8.assemble_q8in(codes, scale), qs, ks, cos, sin, mask,
                                                           num_heads=h, impl="fused")
                    row["kernels"]["fused_attention_q8in"] = dict(
                        ms=time_ms(call), dev_ms=host_ahead_ms(call), bound_ms=bound[0], bound_by=bound[1],
                        plain_ms=time_ms(q8plain, runs=3, warmup=1), library_ms=time_ms(chain),
                        split=ab8.q8in_plan(b, n, c, h, fa._sm_count(device.index) if device.type == "cuda" else 132))
                del codes, scale, assembled, x_assembled, got
            out["rows"].append(row)
            if timed:
                log(f"  d {d} {dtype} B={b} N={n} C={c} H={h} mask {mask_kind} (ms, dev, bound): "
                    + "; ".join(f"{k} {r['ms']:.4f}, {r['dev_ms']:.4f}, {r['bound_ms']:.5f} ({r['bound_by']})"
                                + (f", plain {r['plain_ms']:.4f}" if "plain_ms" in r else "")
                                + (f", assemble + X {r['library_ms']:.4f}, split bb, hpb {r['split']}" if "split" in r
                                   else "")
                                for k, r in row["kernels"].items())
                    + f"; {ref_name.split(' ')[0]} {row['reference_ms']:.4f}, plain {row['plain_ms']:.4f} "
                    f"(pack's {row['pack_plain_ms']:.4f}), SDPA {row['library_ms']:.4f}")
            del qkv, plain, pack_plain, ref
            torch.cuda.empty_cache()
    if device.type == "cuda":  # what the compiler and the card make of each new instance
        for kind, bb in (("bb", 2), ("pack", 2), ("contig", 1), ("q8in", 1), ("bb_f32", 2), ("pack_f32", 2),
                         ("contig_f32", 1)):
            out["attributes"][kind] = sm90_attributes(d, kind, bb=bb)
        log(f"  d {d} walkers (registers, local bytes a thread, blocks an SM, shared bytes a block): "
            + "; ".join(f"{k} {a['registers']}, {a['local_bytes']}, {a['blocks_per_sm']}, {a['smem_bytes']}"
                        for k, a in out["attributes"].items()))
    log(f"  d {d} max |err| vs plain: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return out


def _wide_ab_entries_run(device, d: int, h: int) -> dict:
    """Both A/B entry points at ``--c WIDE_AB_WIDTH --heads h`` (head dim
    ``d``) with ``AB_ENTRY_ARGS``: ab_batch_block in bf16 at N 256 B 64 and
    in fp32 at N 64 B 256, ab_q8_input at N 256 B 64; then #13 in fp32
    through its wrapper ``--layers`` times. Every arm but the JAX entry's
    skipped ones (WIDE_AB_SKIPS, each with its reason) builds, every numeric
    leg reads 0 (arm B is X here, so B's too), and each kernel is launched as
    often as the runs call it: the counts set to 0 before, read after."""
    import torch
    from vitok_torch.benchmarks import ab_batch_block as abb
    from vitok_torch.benchmarks import ab_q8_input as ab8
    from vitok_torch.benchmarks import rope_inputs

    iters, layers = int(AB_ENTRY_ARGS[1]), int(AB_ENTRY_ARGS[3])
    per_arm = 1 + layers * (1 + iters)  # the numeric call, the warm-up run, the timed runs
    c = WIDE_AB_WIDTH
    shapes = {dtype: (n, b) for dtype, n, b, _ in WIDE_AB_SHAPES}
    reset_counts()
    runs, bb_arms = {}, {}
    for dtype, (n, b) in shapes.items():
        flags = ["--c", str(c), "--heads", str(h), "--tokens", str(n), "--batch", str(b), "--dtype", dtype,
                 *AB_ENTRY_ARGS]
        log(f"entry point: python -m vitok_torch.benchmarks.ab_batch_block {' '.join(flags)}")
        res = abb.main([*flags, "--device", device.type])
        ref = "X" if dtype == "bfloat16" else "W"
        arms = set(res["arms"])
        if (set(res["skipped"]) != WIDE_AB_SKIPS[d] or arms != {a for a, *_ in abb.arm_defs(c, d, n, b, h)} -
                WIDE_AB_SKIPS[d] or any(v != 0.0 for v in res["numeric"].values())
                or set(res["references"]) != arms - {"B"}
                or any(not r.startswith(ref) for r in res["references"].values())
                or not res["arm_B"].startswith("the shipped forward")):
            raise AssertionError(f"ab_batch_block d {d} {dtype}: skipped {res['skipped']}, arms {sorted(arms)}, "
                                 f"numeric {res['numeric']}, references {res['references']}, B {res['arm_B']}")
        reference_row = res["redesigned"] if dtype == "bfloat16" else res["walker_f32"]
        if reference_row["max_abs_vs_B"] != 0.0:
            raise AssertionError(f"ab_batch_block d {d} {dtype}: B is not its reference's bits: {reference_row}")
        runs[f"ab_batch_block {dtype}"] = res
        bb_arms[dtype] = len(arms - {"B", "P2"})
    n, b = shapes["bfloat16"]
    flags = ["--c", str(c), "--heads", str(h), "--tokens", str(n), "--batch", str(b), *AB_ENTRY_ARGS]
    log(f"entry point: python -m vitok_torch.benchmarks.ab_q8_input {' '.join(flags)}")
    res = ab8.main([*flags, "--device", device.type])
    if (res["numeric"]["A_assembled"] != 0.0 or res["numeric"]["C"] != 0.0 or res["redesigned"]["max_abs_vs_B"] != 0.0
            or not res["references"]["C"].startswith("X") or not res["references"]["A_assembled"].startswith("X")):
        raise AssertionError(f"ab_q8_input d {d}: numeric legs {res['numeric']}, references {res['references']}, "
                             f"max |X-B| {res['redesigned']['max_abs_vs_B']}")
    runs["ab_q8_input"] = res
    n, b = shapes["float32"]
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(b, n, 3 * c, generator=gen).to(device)
    q_scale, k_scale, cos, sin = rope_inputs(b, n, d, device, gen)
    mask = torch.ones(b, n, dtype=torch.bool, device=device)
    log(f"#13 in fp32 through its wrapper, {layers} calls at C {c}, H {h}, N {n}, B {b}")
    for _ in range(layers):
        ab8.fused_attention_contig(qkv, q_scale, k_scale, cos, sin, mask, num_heads=h)
    torch.cuda.synchronize()
    del qkv
    launches = launch_counts()
    # ab_batch_block bf16: B and the redesigned row on #1 (each after the prologue), the arms on #10 and P2
    # on #11 (each after the prologue); fp32: B on #1 f32 (the fp32 walker's forward), the arms on #10 f32
    # and P2 on #11 f32, W once; ab_q8_input: A (after its int8 prologue), B, C and the redesigned row, X
    # once more on the assembled tensor; then #13 in fp32
    walkers = (bb_arms["bfloat16"] + 1) * per_arm + per_arm  # bf16 #10, #11, #13, each after a prologue
    expect = _expect(fused_attention=4 * per_arm + 1, fused_qk_prologue=4 * per_arm + 1 + walkers,
                     fused_attention_bb=bb_arms["bfloat16"] * per_arm, fused_attention_pack=per_arm,
                     fused_attention_f32=per_arm, fused_attention_bb_f32=bb_arms["float32"] * per_arm + 1,
                     fused_attention_pack_f32=per_arm, fused_attention_q8in=per_arm,
                     fused_attention_q8in_prologue=per_arm, fused_attention_contig=per_arm,
                     fused_attention_contig_f32=layers)
    if launches != expect:
        raise AssertionError(f"A/B entry points d {d}: launches {launches}, expected {expect}")
    log(f"  d {d} launches: {dict((k, v) for k, v in launches.items() if v)}")
    return dict(runs=runs, launches=launches)


def wide_ab_phase(device, card: str) -> dict:
    """The A/B kernels #10-#13 at head dims 192 and 256 on {card}: each new
    instance against the reference of its own body (``_wide_ab_rows``), then
    both entry points at each width (``_wide_ab_entries_run``)."""
    import torch

    t0 = time.time()
    out = {}
    for d, h in WIDE_AB_HEADS:
        log(f"A/B kernels d {d} (C {WIDE_AB_WIDTH}, {h} heads) on {card}")
        out[d] = dict(kernels=_wide_ab_rows(device, d, h), entries=_wide_ab_entries_run(device, d, h))
        torch.cuda.empty_cache()
    out["wall_s"] = time.time() - t0
    log(f"A/B kernels at d 192 and 256: {out['wall_s']:.1f} s")
    return out


def wide_ab_entries(wide_ab: dict) -> list:
    """The kernels line's entries of #10-#13's d 192 and 256 instances and
    #12's int8 q/k prologue: launches from the entry points' runs at that
    width, times from the first mask of each dtype (bf16 N 256 B 64, fp32 N
    64 B 256), the library column SDPA on the same normed q/k (#12's:
    assemble + X, the chain it replaces, as at d 128; the prologue's none)."""
    entries = []
    src_sm90 = "vitok_torch/csrc/fused_attention_ab_sm90.cu"
    src_f32 = "vitok_torch/csrc/fused_attention_ab_f32_sm90.cu"
    src_q8 = "vitok_torch/csrc/fused_attention_q8in_sm90.cu"
    src_prologue = "vitok_torch/csrc/fused_attention_sm90.cu"  # fused_qk_prologue_kernel<D, int8_t>
    for d, h in WIDE_AB_HEADS:
        rows, launches = wide_ab[d]["kernels"], wide_ab[d]["entries"]["launches"]
        timed = {r["dtype"]: r for r in rows["rows"] if "plain_ms" in r}
        for name, source, replaces, kind in (
                ("fused_attention_bb", src_sm90, "benchmarks/ab_batch_block.py:78", "bb"),
                ("fused_attention_pack", src_sm90, "benchmarks/ab_batch_block.py:105", "pack"),
                ("fused_attention_contig", src_sm90, "benchmarks/ab_q8_input.py:164", "contig"),
                ("fused_attention_q8in", src_q8, "benchmarks/ab_q8_input.py:64", "q8in"),
                ("fused_attention_q8in_prologue", src_prologue, "benchmarks/ab_q8_input.py:64", None),
                ("fused_attention_bb_f32", src_f32, "benchmarks/ab_batch_block.py:78", "bb_f32"),
                ("fused_attention_pack_f32", src_f32, "benchmarks/ab_batch_block.py:105", "pack_f32"),
                ("fused_attention_contig_f32", src_f32, "benchmarks/ab_q8_input.py:164", "contig_f32")):
            row = timed["float32" if name.endswith("_f32") else "bfloat16"]
            k = row["kernels"][name]
            plain = k.get("plain_ms", row["pack_plain_ms"] if "pack" in name else row["plain_ms"])
            entry = {"name": f"{name}_d{d}", "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": rows["errs"][name], "ms": k["ms"],
                     "plain_ms": plain, "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                     "library_ms": k.get("library_ms", row["library_ms"]), "dev_ms": k["dev_ms"],
                     "shape": f"B {row['B']} N {row['N']} C {row['C']} H {h} {row['dtype']} mask {row['mask']}",
                     "reference_ms": row["reference_ms"], "attributes": rows["attributes"].get(kind)}
            if name == "fused_attention_q8in":  # its library column: assemble + X, the chain it replaces
                entry.update(split=k["split"], sdpa_ms=row["library_ms"])
            if name == "fused_attention_bb" or name == "fused_attention_bb_f32":
                entry["arm"] = "D2 (bb=2, cg=1536)"
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
                  "fused_attention_ab_sm90", "fused_attention_ab_f32_sm90",  # the fp32 walker
                  "flash_attention_f32",  # the fp32 instances of #4-#6 (and #3's)
                  "quantize_rows"])  # #2 f32's row quantize
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
    f32_train = f32_training_phase(device, card)
    torch.cuda.empty_cache()
    t0 = time.time()
    ab_runs = ab_entry_phase(device)
    log(f"A/B entry points: {time.time() - t0:.1f} s")
    t0 = time.time()
    evals = eval_phase(device, card)
    torch.cuda.empty_cache()
    perceptual = perceptual_phase(device, card)
    torch.cuda.empty_cache()
    log(f"eval and perceptual phases: {time.time() - t0:.1f} s")
    data_slice = training_data_phase(device, card)
    torch.cuda.empty_cache()
    t0 = time.time()
    wide = wide_kernel_phase(device, card)
    torch.cuda.empty_cache()
    log(f"#2 fp32 and the wide instances: {time.time() - t0:.1f} s")
    t0 = time.time()
    distributed = distributed_phase(device, card)
    torch.cuda.empty_cache()
    log(f"distributed phase: {time.time() - t0:.1f} s")
    pipeline = pipeline_phase(device, card)
    torch.cuda.empty_cache()
    remainder_phase(device, card)
    torch.cuda.empty_cache()
    wide_heads = wide_heads_phase(device, card)
    torch.cuda.empty_cache()
    wide32 = wide_f32_phase(device, card)
    torch.cuda.empty_cache()
    wide32_bwd = wide_f32_bwd_phase(device, card)
    torch.cuda.empty_cache()
    wide_ab = wide_ab_phase(device, card)
    torch.cuda.empty_cache()
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
    entries += f32_training_entries(f32_train)
    entries += wide_kernel_entries(wide)
    entries += wide_heads_entries(wide_heads, kern, fkern, fbkern, bkern)
    entries += wide_f32_entries(wide32)
    entries += wide_f32_bwd_entries(wide32_bwd)
    entries += wide_ab_entries(wide_ab)
    for e in entries:  # the 5B run's, the eval runs' and the perceptual steps' launches beside each path's own
        if bench_5b["launches"].get(e["name"]):
            e["launches_5b_bench"] = bench_5b["launches"][e["name"]]
        eval_launches = sum(evals[run]["launches"].get(e["name"], 0) for run in ("bf16", "int8", "buckets"))
        if eval_launches:
            e["launches_eval"] = eval_launches
        if perceptual["launches"].get(e["name"]):
            e["launches_perceptual"] = perceptual["launches"][e["name"]]
        if data_slice["launches"].get(e["name"]):
            e["launches_training_data"] = data_slice["launches"][e["name"]]
        if distributed["launches"].get(e["name"]):
            e["launches_distributed"] = distributed["launches"][e["name"]]
        if pipeline["launches"].get(e["name"]):
            e["launches_pipeline"] = pipeline["launches"][e["name"]]
    log(f"chip_smoke.py ran for {time.time() - started:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
