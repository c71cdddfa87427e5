"""Interleaved A/B: int8 QKV input to the fused attention, and a block per
(sample, query tile) over all heads; the port's counterpart of
``benchmarks/ab_q8_input.py``.

Arm A, :func:`fused_attention_q8in` (``csrc/fused_attention_ab.cu``,
replacing ``_kernel_q8in``): the input is the QKV projection's int8 codes
``[B, N, 3C]`` and a per-token fp32 scale ``[B, N, 1]``, half the bytes of
bf16. q and k are normed as raw codes (the per-token RMSNorm cancels the
scale, up to its 1e-6 eps against code variances of about 1e3), v is
``bf16(code * scale)``. Its function is the fused forward's on the assembled
bf16 tensor (:func:`assemble_q8in`), and on the card it equals the mma.sync
forward there bit for bit. Arm B: the mma.sync forward
(:func:`fused_qkv_attention_mma`) on the bf16 qkv. Arm C,
:func:`fused_attention_contig` (replacing ``_kernel_contig``): the forward's
function with one block per (sample, 64-query tile) walking all heads; in
bf16 on the wgmma body (``csrc/fused_attention_ab_sm90.cu``; in fp32 on the
fp32 walker, ``csrc/fused_attention_ab_f32_sm90.cu``), so it is held
to the redesigned forward (:func:`fused_qkv_attention`: the q/k prologue and
the wgmma kernel; X in the printed lines), which one more row times with its
delta and its distance from B. Each numeric leg names its reference.

    python -m vitok_torch.benchmarks.ab_q8_input --c 3072 --heads 24 --tokens 256 --batch 64

``--device cpu`` runs the plain versions (host clock: no device time).
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from vitok_torch.benchmarks import (card_line, chained_ms, check_device, kernel_lib, max_abs_diff,
                                    resolve_device, rope_inputs, walk_f32, walk_sm90)
from vitok_torch.ops import _build
from vitok_torch.ops import fused_attention as fa

# Launches of each kernel since its count was last set to 0: #12, #13 in
# bf16 (the wgmma walker; its q/k prologue counts in
# ``fused_attention.PROLOGUE_LAUNCHES``) and in fp32 (the fp32 walker).
LAUNCHES = {"fused_attention_q8in": 0, "fused_attention_contig": 0, "fused_attention_contig_f32": 0}


def assemble_q8in(qkv8: torch.Tensor, tok_scale: torch.Tensor) -> torch.Tensor:
    """``[q codes | k codes | bf16(v codes * scale)]`` in bf16: the input on
    which the int8-input kernel computes the fused forward's function (codes
    are exact in bf16)."""
    c = qkv8.shape[-1] // 3
    codes = qkv8.to(torch.bfloat16)
    v = (qkv8[..., 2 * c:].float() * tok_scale).to(torch.bfloat16)
    return torch.cat([codes[..., :2 * c], v], dim=-1)


def fused_attention_q8in_plain(
    qkv8: torch.Tensor,
    tok_scale: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """``_kernel_q8in`` in plain PyTorch: the fused forward's plain version
    on :func:`assemble_q8in`'s tensor. bf16 ``[B, N, C]``."""
    return fa.fused_qkv_attention_plain(assemble_q8in(qkv8, tok_scale), q_scale, k_scale, cos, sin,
                                        patch_mask, num_heads=num_heads, sliding_window=sliding_window)


def fused_attention_q8in(
    qkv8: torch.Tensor,
    tok_scale: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """The fused forward from int8 QKV codes ``[B, N, 3C]`` and their
    per-token fp32 scales ``[B, N, 1]``: bf16 ``[B, N, C]``. On a CUDA tensor
    it launches ``fused_attention_q8in_kernel`` or raises; on a CPU tensor it
    runs :func:`fused_attention_q8in_plain`."""
    check_device(qkv8)
    b, n = qkv8.shape[:2]
    if tuple(tok_scale.shape) != (b, n, 1) or tok_scale.device != qkv8.device:
        raise ValueError(f"tok_scale must be {(b, n, 1)} on {qkv8.device}, got {tuple(tok_scale.shape)}")
    if not qkv8.is_cuda:
        return fused_attention_q8in_plain(qkv8, tok_scale, q_scale, k_scale, cos, sin, patch_mask,
                                          num_heads=num_heads, sliding_window=sliding_window)
    b, n, c, d, q_scale, k_scale, cos, sin, mask, sw = fa._check_cuda_args(
        qkv8, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window, dtypes=(torch.int8,))
    tok = tok_scale.detach().float().contiguous()
    out = torch.empty((b, n, c), dtype=torch.bfloat16, device=qkv8.device)
    lib = kernel_lib()
    with torch.cuda.device(qkv8.device):
        err = lib.vitok_fused_attention_q8in(
            qkv8.data_ptr(), tok.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), fa._ptr(mask), out.data_ptr(), b, n, num_heads, d, sw,
            torch.cuda.current_stream(qkv8.device).cuda_stream)
    _build.check(lib, err, "fused_attention_q8in launch")
    LAUNCHES["fused_attention_q8in"] += 1
    return out


def fused_attention_contig_plain(qkv, q_scale, k_scale, cos, sin, patch_mask=None, *, num_heads,
                                 sliding_window=None) -> torch.Tensor:
    """The contiguous arm's function: the fused forward's plain version."""
    return fa.fused_qkv_attention_plain(qkv, q_scale, k_scale, cos, sin, patch_mask,
                                        num_heads=num_heads, sliding_window=sliding_window)


def fused_attention_contig(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """The fused forward with one block per (sample, 64-query tile) walking
    all heads (bf16 or fp32 qkv). On a CUDA tensor it launches, in bf16, the
    q/k prologue and then ``fused_attention_contig_sm90_kernel`` (the wgmma
    body; N a multiple of 8), in fp32 ``fused_attention_contig_f32_sm90_kernel``
    (the fp32 walker, ``csrc/fused_attention_ab_f32_sm90.cu``); or raises. On
    a CPU tensor it runs :func:`fused_attention_contig_plain`."""
    check_device(qkv)
    if not qkv.is_cuda:
        return fused_attention_contig_plain(qkv, q_scale, k_scale, cos, sin, patch_mask,
                                            num_heads=num_heads, sliding_window=sliding_window)
    b, n, c, d, q_scale, k_scale, cos, sin, mask, sw = fa._check_cuda_args(
        qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window,
        dtypes=(torch.bfloat16, torch.float32))
    if qkv.dtype == torch.bfloat16:  # the wgmma walker, after the q/k prologue
        fa._check_rows(n)
        kn, _ = fa._prologue_cuda(qkv, q_scale, k_scale, cos, sin, num_heads, with_q=False)
        out = walk_sm90(qkv, kn, q_scale, cos, sin, mask, num_heads, sw=sw)
        LAUNCHES["fused_attention_contig"] += 1
        return out
    out = walk_f32(qkv, q_scale, k_scale, cos, sin, mask, num_heads, bb=1, hpb=num_heads, sw=sw, kind="contig")
    LAUNCHES["fused_attention_contig_f32"] += 1
    return out


def quantize_qkv(qkv: torch.Tensor):
    """Per-token symmetric int8 codes of ``qkv`` and their fp32 scales, as
    the JAX script makes them (what a requantizing qkv GEMM would emit)."""
    x32 = qkv.float()
    tok_scale = torch.clamp(x32.abs().amax(-1, keepdim=True) / 127.0, min=1e-12)
    return torch.clamp(torch.round(x32 / tok_scale), -127, 127).to(torch.int8), tok_scale


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--c", type=int, default=3072)
    ap.add_argument("--heads", type=int, default=24)
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--layers", type=int, default=8, help="kernel calls chained per timed run")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    print(f"device: {card_line(device)}", flush=True)
    c, h, n, b = args.c, args.heads, args.tokens, args.batch
    d = c // h
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(b, n, 3 * c, generator=gen).to(torch.bfloat16).to(device)
    qkv8, tok_scale = quantize_qkv(qkv)
    q_scale, k_scale, cos, sin = rope_inputs(b, n, d, device, gen)
    mask = torch.ones(b, n, dtype=torch.bool, device=device)
    layers = args.layers

    arms = (
        ("A", lambda cos_: fused_attention_q8in(qkv8, tok_scale, q_scale, k_scale, cos_, sin, mask,
                                                num_heads=h)),
        ("B", lambda cos_: fa.fused_qkv_attention_mma(qkv, q_scale, k_scale, cos_, sin, mask, num_heads=h)),
        ("C", lambda cos_: fused_attention_contig(qkv, q_scale, k_scale, cos_, sin, mask, num_heads=h)),
        ("redesigned", lambda cos_: fa.fused_qkv_attention(qkv, q_scale, k_scale, cos_, sin, mask, num_heads=h,
                                                           impl="fused")),
    )
    # numeric legs: A's difference is the input quantization; against the
    # forward on the assembled tensor it is the same function.
    oa, ob, oc, onew = (fn(cos) for _, fn in arms)
    da, mb = max_abs_diff(oa, ob), float(ob.float().abs().max())
    print(f"numeric A: max|A-B|={da:.5f} max|B|={mb:.3f} rel={da / mb:.5f}")
    assembled = fa.fused_qkv_attention_mma(assemble_q8in(qkv8, tok_scale), q_scale, k_scale, cos, sin, mask,
                                           num_heads=h)
    dq = max_abs_diff(oa, assembled)
    print(f"numeric A: max|A-B(assembled)|={dq:.6f} (same function, expect 0.0)")
    dc = max_abs_diff(oc, onew)
    print(f"numeric C: max|C-X|={dc:.6f} (the redesigned forward's body, expect 0.0)")
    dn = max_abs_diff(onew, ob)
    print(f"numeric redesigned: max|X-B|={dn:.6f} (another kernel: within #1's limits, not 0)")
    del oa, ob, oc, onew, assembled

    for _, fn in arms:  # warm the chained runs
        chained_ms(fn, cos, layers, 0.0)
    times = {name: [] for name, _ in arms}
    t = 1.0
    for _ in range(args.iters):
        for name, fn in arms:
            times[name].append(chained_ms(fn, cos, layers, t))
            t += 1.0

    bytes_a = b * n * (3 * c * 1 + c * 2)  # int8 in, bf16 out
    bytes_b = b * n * (3 * c * 2 + c * 2)
    labels = {"A": "int8-in strided", "B": "bf16-in strided", "C": "bf16-in contiguous",
              "redesigned": "bf16-in, q/k prologue + wgmma kernel"}
    result = {"device": card_line(device), "arms": {},
              "numeric": {"A": da, "A_assembled": dq, "C": dc},
              "references": {"A": "B: the mma.sync forward (fused_qkv_attention_mma; A's input is quantized)",
                             "A_assembled": "B on the assembled tensor (assemble_q8in)",
                             "C": "X: the redesigned forward (fused_qkv_attention: q/k prologue + wgmma kernel)"}}
    for name, byts in (("A", bytes_a), ("B", bytes_b), ("C", bytes_b), ("redesigned", bytes_b)):
        ms = np.array(times[name])
        row = {"ms": float(ms.mean()), "min_ms": float(ms.min()), "n": len(ms)}
        if name == "redesigned":
            result["redesigned"] = {**row, "max_abs_vs_B": dn}
        else:
            result["arms"][name] = row
        print(f"{name} ({labels[name]}): {ms.mean():.3f} ms/call (min {ms.min():.3f}, n={len(ms)}) "
              f"eff-BW {byts / ms.mean() / 1e6:.0f} GB/s")
    bmean = np.mean(times["B"])
    for name in ("A", "C", "redesigned"):
        r = np.mean(times[name]) / bmean
        (result["arms"].get(name) or result["redesigned"])["delta"] = float(r)
        print(f"delta {name}/B = {r:.4f} ({(r - 1) * 100:+.2f}%)")
    return result


if __name__ == "__main__":
    main()
