"""Interleaved A/B: int8 QKV input to the fused attention, and a block per
(sample, query tile) over all heads; the port's counterpart of
``benchmarks/ab_q8_input.py``.

Arm A, :func:`fused_attention_q8in` (replacing ``_kernel_q8in``): the input
is the QKV projection's int8 codes ``[B, N, 3C]`` and a per-token fp32
scale ``[B, N, 1]``, half the bytes of bf16. q and k are normed as raw codes
(the per-token RMSNorm cancels the scale, up to its 1e-6 eps against code
variances of about 1e3), v is ``bf16(code * scale)``. Its function is the
fused forward's on the assembled bf16 tensor (:func:`assemble_q8in`). On the
card it runs the int8 instance of the forward's q/k prologue (k) and then a
walk of the wgmma body over int8 q and v tiles
(``csrc/fused_attention_q8in_sm90.cu``, at :func:`q8in_plan`'s split), and
equals the redesigned forward there bit for bit: the same body, int8 against
bf16 input. Arm B: the mma.sync forward (:func:`fused_qkv_attention_mma`) on
the bf16 qkv at head dims 64 and 128; at 192 and 256, where it has no
instance, the JAX script's B, the shipped forward (X;
``ab_batch_block.arm_b``). Arm C, :func:`fused_attention_contig` (replacing
``_kernel_contig``): the forward's function with one block per (sample,
64-query tile) walking all heads; in bf16 on the wgmma body
(``csrc/fused_attention_ab_sm90.cu``; in fp32 on the fp32 walker,
``csrc/fused_attention_ab_f32_sm90.cu``), so it is held to the redesigned
forward (:func:`fused_qkv_attention`: the q/k prologue and the wgmma kernel;
X in the printed lines), which one more row times with its delta and its
distance from B. Each numeric leg names its reference.

    python -m vitok_torch.benchmarks.ab_q8_input --c 3072 --heads 24 --tokens 256 --batch 64
    python -m vitok_torch.benchmarks.ab_q8_input --c 3072 --heads 16 --tokens 256 --batch 64 --iters 2 --layers 16
    python -m vitok_torch.benchmarks.ab_q8_input --c 3072 --heads 12 --tokens 256 --batch 64 --iters 2 --layers 16

``--device cpu`` runs the plain versions (host clock: no device time).
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

import numpy as np
import torch

from vitok_torch.benchmarks import (card_line, chained_ms, check_device, max_abs_diff, q8in_lib, resolve_device,
                                    rope_inputs, walk_f32, walk_sm90)
from vitok_torch.benchmarks.ab_batch_block import arm_b, arm_b_forward
from vitok_torch.ops import _build
from vitok_torch.ops import fused_attention as fa
from vitok_torch.ops.rope import apply_rotary_emb

# Launches of each kernel since its count was last set to 0: #12 and the
# int8 instance of the q/k prologue it runs first, #13 in bf16 (the wgmma
# walker; its q/k prologue counts in ``fused_attention.PROLOGUE_LAUNCHES``)
# and in fp32 (the fp32 walker).
LAUNCHES = {"fused_attention_q8in": 0, "fused_attention_q8in_prologue": 0, "fused_attention_contig": 0,
            "fused_attention_contig_f32": 0}

_STAGES = 2  # key tiles in the ring (kStages of csrc/fused_attend_sm90.cuh)
_SMEM_PER_SM = 233472  # shared memory of one H100 SM; the runtime keeps 1 KB of it a block
_MAX_BLOCKS = 3  # what the launch bounds ask for at d = 64: up to 168 registers a thread


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


def q8in_smem_bytes(d: int, bb: int) -> int:
    """Dynamic shared memory a block of the int8-input kernel asks for at
    head dim ``d`` with ``bb`` images a block (``Q8inSmem<D>::bytes``): the
    cell's bf16 Q tile and the tile's bf16 V tile, ``_STAGES`` bf16 K tiles,
    ``_STAGES`` int8 Q and V code tiles, the keys' scales and states, q's
    gain, an int4 per image and 1 KB of alignment slack."""
    tile, codes = 64 * d * 2, 64 * d
    return (2 + _STAGES) * tile + 2 * _STAGES * codes + _STAGES * 64 * (4 + 1) + 4 * d + 16 * bb + 1024


def q8in_blocks_per_sm(d: int) -> int:
    """Blocks of the int8-input kernel an H100 SM holds at head dim ``d``,
    one image a block: as many as its shared memory fits
    (:func:`q8in_smem_bytes` and the 1 KB the runtime keeps a block), at
    most the three its launch bounds' registers allow."""
    return min(_MAX_BLOCKS, _SMEM_PER_SM // (q8in_smem_bytes(d, 1) + 1024))


def q8in_plan(b: int, n: int, c: int, h: int, sms: int) -> Tuple[int, int]:
    """``(bb, hpb)``: the images and heads of a 64-query tile that one block
    of the int8-input kernel walks, for ``b`` images of ``n`` tokens and
    ``h`` heads of ``c / h`` channels on a card of ``sms`` SMs. ``bb``
    divides ``b``, ``hpb`` divides ``h``.

    One image a block, and the heads that give the fewest cells to the SM
    that runs the most: waves of the blocks the card holds at once
    (:func:`q8in_blocks_per_sm`: three an SM at d = 64, two at 128, one at
    192 and 256) times the cells of a block; on a tie the
    most heads, since a longer walk spends less on each block's setup and
    ring fill. On an H100 (PERF.md), at the 5B A/B shape (C 3072, H 24,
    N 256, B 64) every split of at least a wave ties and 1 x 24 read within
    1.2% of the fastest (2 x 12), one cell a block 13% slower; at the 350M
    shape (C 1024, H 16, N 256, B 16) one cell a block (three waves of one
    cell, against one wave of four) was the fastest, 16 heads a block (64
    blocks) 3.1x slower. More images a block gained no more than that 1.2%."""
    slots = sms * q8in_blocks_per_sm(c // h)
    blocks = -(-n // 64) * b

    def cells_on_the_busiest_sm(hpb: int) -> int:
        return -(-blocks * (h // hpb) // slots) * hpb

    return 1, min((k for k in range(1, h + 1) if h % k == 0), key=lambda k: (cells_on_the_busiest_sm(k), -k))


def q8in_k_prologue_plain(qkv8: torch.Tensor, k_scale: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
                          num_heads: int) -> torch.Tensor:
    """The int8 prologue's function: the k codes normed (fp32 statistics in
    the kernels' order, times the fp32 gain, cast to bf16) and rotated in
    bf16, ``[B, N, C]``; read from the codes, not from a bf16 copy."""
    b, n, c3 = qkv8.shape
    c = c3 // 3
    k32 = qkv8[..., c:2 * c].float().view(b, n, num_heads, c // num_heads)
    kn = ((k32 * fa._rms_inv(k32)) * k_scale.float()).to(torch.bfloat16)
    _, k = apply_rotary_emb(kn, kn, cos, sin, convention="half")
    return k.reshape(b, n, c)


def _k_prologue_q8_cuda(qkv8, k_scale, cos, sin, num_heads: int) -> torch.Tensor:
    """One launch of the q/k prologue's int8 instance (arguments as
    ``fused_attention._check_cuda_args`` returns them): k normed and rotated,
    ``[B, N, C]`` bf16."""
    b, n, c3 = qkv8.shape
    c = c3 // 3
    kn = torch.empty((b, n, c), dtype=torch.bfloat16, device=qkv8.device)
    lib = fa._sm90_lib()
    with torch.cuda.device(qkv8.device):
        err = lib.vitok_fused_k_prologue_q8(qkv8.data_ptr(), k_scale.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                                            kn.data_ptr(), b, n, num_heads, c // num_heads,
                                            torch.cuda.current_stream(qkv8.device).cuda_stream)
    _build.check(lib, err, "fused_k_prologue_q8 launch")
    LAUNCHES["fused_attention_q8in_prologue"] += 1
    return kn


def q8in_k_prologue(qkv8: torch.Tensor, k_scale: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
                    num_heads: int) -> torch.Tensor:
    """k normed and rotated from the int8 codes, ``[B, N, C]`` bf16: what
    :func:`fused_attention_q8in` runs first. On a CUDA tensor it launches the
    q/k prologue's int8 instance (``fused_qk_prologue_kernel<D, int8_t>``,
    ``csrc/fused_attention_sm90.cu``) or raises; on a CPU tensor it runs
    :func:`q8in_k_prologue_plain`."""
    check_device(qkv8)
    if not qkv8.is_cuda:
        return q8in_k_prologue_plain(qkv8, k_scale, cos, sin, num_heads=num_heads)
    _, n, _, _, _, k_scale, cos, sin, _, _ = fa._check_cuda_args(qkv8, k_scale, k_scale, cos, sin, None, num_heads,
                                                                 None, dtypes=(torch.int8,), head_dims=fa.AB_HEAD_DIMS)
    fa._check_rows(n)
    return _k_prologue_q8_cuda(qkv8, k_scale, cos, sin, num_heads)


def walk_q8in(qkv8: torch.Tensor, tok: torch.Tensor, kn: torch.Tensor, q_scale: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, mask: Optional[torch.Tensor], num_heads: int, *, bb: int, hpb: int,
              sw: int = -1) -> torch.Tensor:
    """One launch of the int8-input kernel on ``kn`` (the int8 prologue's
    normed k) and the q and v codes of ``qkv8``, with ``tok`` the tokens'
    fp32 scales (``[B, N]`` or ``[B, N, 1]``, contiguous): ``bb`` images x
    ``hpb`` heads a block, window ``sw`` (-1 for none). The other arguments
    as ``fused_attention._check_cuda_args`` returns them. Counts nothing: its
    callers count."""
    b, n, c3 = qkv8.shape
    c = c3 // 3
    if kn.shape != (b, n, c) or kn.dtype != torch.bfloat16 or kn.device != qkv8.device or not kn.is_contiguous():
        raise ValueError(f"kn must be a contiguous {(b, n, c)} bfloat16 tensor on {qkv8.device}")
    if tok.dtype != torch.float32 or tok.numel() != b * n or not tok.is_contiguous() or tok.data_ptr() % 16:
        raise ValueError(f"tok must be {b * n} contiguous, 16-byte aligned fp32 scales")
    out = torch.empty((b, n, c), dtype=torch.bfloat16, device=qkv8.device)
    lib = q8in_lib()
    with torch.cuda.device(qkv8.device):
        err = lib.vitok_fused_attention_q8in_sm90(
            qkv8.data_ptr(), tok.data_ptr(), kn.data_ptr(), q_scale.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), b, n, num_heads, c // num_heads, bb, hpb, sw,
            torch.cuda.current_stream(qkv8.device).cuda_stream)
    _build.check(lib, err, "fused_attention_q8in_sm90 launch")
    return out


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
    (N a multiple of 8) it launches the q/k prologue's int8 instance and then
    ``fused_attention_q8in_sm90_kernel`` at :func:`q8in_plan`'s split, or
    raises; on a CPU tensor it runs :func:`fused_attention_q8in_plain`."""
    check_device(qkv8)
    b, n = qkv8.shape[:2]
    if tuple(tok_scale.shape) != (b, n, 1) or tok_scale.device != qkv8.device:
        raise ValueError(f"tok_scale must be {(b, n, 1)} on {qkv8.device}, got {tuple(tok_scale.shape)}")
    if not qkv8.is_cuda:
        return fused_attention_q8in_plain(qkv8, tok_scale, q_scale, k_scale, cos, sin, patch_mask,
                                          num_heads=num_heads, sliding_window=sliding_window)
    b, n, c, d, q_scale, k_scale, cos, sin, mask, sw = fa._check_cuda_args(
        qkv8, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window, dtypes=(torch.int8,),
        head_dims=fa.AB_HEAD_DIMS)
    fa._check_rows(n)
    bb, hpb = q8in_plan(b, n, c, num_heads, fa._sm_count(qkv8.device.index))
    tok = tok_scale.detach().float().contiguous()
    kn = _k_prologue_q8_cuda(qkv8, k_scale, cos, sin, num_heads)
    out = walk_q8in(qkv8, tok, kn, q_scale, cos, sin, mask, num_heads, bb=bb, hpb=hpb, sw=sw)
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
        dtypes=(torch.bfloat16, torch.float32), head_dims=fa.AB_HEAD_DIMS)
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
    print(f"arm B: {arm_b_forward(d)}", flush=True)
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(b, n, 3 * c, generator=gen).to(torch.bfloat16).to(device)
    qkv8, tok_scale = quantize_qkv(qkv)
    q_scale, k_scale, cos, sin = rope_inputs(b, n, d, device, gen)
    mask = torch.ones(b, n, dtype=torch.bool, device=device)
    layers = args.layers

    arms = (
        ("A", lambda cos_: fused_attention_q8in(qkv8, tok_scale, q_scale, k_scale, cos_, sin, mask,
                                                num_heads=h)),
        ("B", lambda cos_: arm_b(qkv, q_scale, k_scale, cos_, sin, mask, h)),
        ("C", lambda cos_: fused_attention_contig(qkv, q_scale, k_scale, cos_, sin, mask, num_heads=h)),
        ("redesigned", lambda cos_: fa.fused_qkv_attention(qkv, q_scale, k_scale, cos_, sin, mask, num_heads=h,
                                                           impl="fused")),
    )
    # numeric legs: A's difference is the input quantization; against the
    # redesigned forward on the assembled tensor it is the same function on
    # the same body.
    oa, ob, oc, onew = (fn(cos) for _, fn in arms)
    da, mb = max_abs_diff(oa, ob), float(ob.float().abs().max())
    print(f"numeric A: max|A-B|={da:.5f} max|B|={mb:.3f} rel={da / mb:.5f}")
    assembled = fa.fused_qkv_attention(assemble_q8in(qkv8, tok_scale), q_scale, k_scale, cos, sin, mask,
                                       num_heads=h, impl="fused")
    dq = max_abs_diff(oa, assembled)
    print(f"numeric A: max|A-X(assembled)|={dq:.6f} (the redesigned forward's body on the same function, "
          "expect 0.0)")
    dc = max_abs_diff(oc, onew)
    print(f"numeric C: max|C-X|={dc:.6f} (the redesigned forward's body, expect 0.0)")
    dn = max_abs_diff(onew, ob)
    expect = "another kernel: within #1's limits, not 0" if d in fa.MMA_HEAD_DIMS else "B is X: expect 0.0"
    print(f"numeric redesigned: max|X-B|={dn:.6f} ({expect})")
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
    labels = {"A": "int8-in strided", "B": f"bf16-in strided, {arm_b_forward(d)}", "C": "bf16-in contiguous",
              "redesigned": "bf16-in, q/k prologue + wgmma kernel"}
    result = {"device": card_line(device), "arm_B": arm_b_forward(d), "arms": {},
              "numeric": {"A": da, "A_assembled": dq, "C": dc},
              "references": {"A": f"B: {arm_b_forward(d)} (A's input is quantized)",
                             "A_assembled": "X on the assembled tensor (assemble_q8in): the redesigned forward",
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
    # the A/B answer: the same body, int8 against bf16 input
    r = np.mean(times["A"]) / np.mean(times["redesigned"])
    result["arms"]["A"]["delta_vs_redesigned"] = float(r)
    print(f"delta A/redesigned = {r:.4f} ({(r - 1) * 100:+.2f}%) (int8 against bf16 input on the same body)")
    return result


if __name__ == "__main__":
    main()
