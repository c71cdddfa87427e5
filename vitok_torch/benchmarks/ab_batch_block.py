"""Interleaved A/B: the fused attention's work per block (batch blocks, head
groups, packed images), the port's counterpart of
``benchmarks/ab_batch_block.py``.

On the TPU the question was whether a fixed per-grid-cell cost dominates the
fused kernel, asked by giving a cell ``bb`` batch items of ``cg`` channels.
On the card a block of :func:`fused_attention_bb` walks ``bb`` samples x
``cg / d`` heads of one 64-query tile (replacing ``_kernel_bb``), and with
``pack=True`` the ``bb`` samples are images packed along the token axis of
one score tile (``_kernel_pack``): the same question of a block's fixed cost
against its serial work. Both run on a walker, a block that takes its cells
on one tile ring: in bf16 the wgmma body of ``csrc/fused_attend_sm90.cuh``
after the q/k prologue (``csrc/fused_attention_ab_sm90.cu``), in fp32 the
fp32 walker of ``csrc/fused_attend_f32_sm90.cuh``, whose products run on the
tensor cores at fp32 accuracy (``csrc/fused_attention_ab_f32_sm90.cu``). A
cell's result does not depend on the split, so each numeric leg reads 0
against the reference it names: in bf16 the redesigned forward
(:func:`fused_qkv_attention`: the q/k prologue and the wgmma kernel; X in
the printed lines), on images with a valid key for the pack; in fp32 the
fp32 walker with one cell a block (W). Arm B is the mma.sync forward
(:func:`fused_qkv_attention_mma`; its FMA instance in fp32) at head dims 64
and 128; at 192 and 256, where it has no instance, the JAX script's B, the
shipped forward (:func:`fused_qkv_attention`: #1 at that width, in fp32 on
the fp32 walker), so B is X there (W's bits in fp32). One more line gives
the reference's largest distance from B, and in bf16 one more row times the
redesigned forward beside the arms.

Arms: B, G (the largest 128-aligned group below C), S2, D2, D4, C768 ...
C128 and P2, as in JAX; an arm whose group is not whole heads is skipped
with its reason, as the JAX script's fails to build (at d 192 C512, C256 and
C128; at d 256 C384 and C128). Recorded invocations:

    python -m vitok_torch.benchmarks.ab_batch_block --c 3072 --heads 24 --tokens 256 --batch 64 --layers 256 --iters 6
    python -m vitok_torch.benchmarks.ab_batch_block --c 3072 --heads 24 --tokens 64 --batch 256 --dtype float32 --layers 256 --iters 6

and at head dims 192 and 256 (``--heads 16``, ``--heads 12``), both dtypes:

    python -m vitok_torch.benchmarks.ab_batch_block --c 3072 --heads 16 --tokens 256 --batch 64 --iters 2 --layers 16
    python -m vitok_torch.benchmarks.ab_batch_block --c 3072 --heads 12 --tokens 64 --batch 256 --dtype float32 --iters 2 --layers 16

``--device cpu`` runs the plain versions (host clock: no device time).
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from vitok_torch.benchmarks import (card_line, chained_ms, check_device, max_abs_diff, pick_group_channels,
                                    resolve_device, rope_inputs, walk_f32, walk_sm90)
from vitok_torch.ops import fused_attention as fa

# Launches of each kernel since its count was last set to 0: #10 and #11 in
# bf16 (the wgmma walker; their q/k prologue counts in
# ``fused_attention.PROLOGUE_LAUNCHES``) and in fp32 (the fp32 walker).
LAUNCHES = {"fused_attention_bb": 0, "fused_attention_pack": 0, "fused_attention_bb_f32": 0,
            "fused_attention_pack_f32": 0}


# The references a numeric leg is held to, by the symbol its line prints.
REFERENCES = {"B": "B: the mma.sync forward (fused_qkv_attention_mma; its FMA instance in fp32) at head dims 64 "
                   "and 128; at 192 and 256 the shipped forward (fused_qkv_attention: #1 at that width, the fp32 "
                   "walker in fp32), so X there (W's bits in fp32)",
              "X": "X: the redesigned forward (fused_qkv_attention: q/k prologue + wgmma kernel)",
              "W": "W: the fp32 walker with one cell a block (fused_attention_bb, bb=1, one head)"}


def check_arm(shape, num_heads: int, bb: int, cg: int, sliding_window=None, pack: bool = False):
    """``(b, n, c, d)``, or ValueError for a work split the kernels do not
    take: heads of ``fa.AB_HEAD_DIMS`` channels (64-256), ``bb`` dividing B,
    ``cg`` dividing C and whole heads (the JAX script's assert); a pack
    takes no window."""
    if len(shape) != 3 or shape[-1] % 3:
        raise ValueError(f"qkv must be [B, N, 3C], got {tuple(shape)}")
    b, n, c3 = shape
    c = c3 // 3
    if c % num_heads:
        raise ValueError(f"C={c} is not a multiple of num_heads={num_heads}")
    d = c // num_heads
    if d not in fa.AB_HEAD_DIMS:
        raise ValueError(f"the kernels take head_dim in {fa.AB_HEAD_DIMS}, got {d}")
    if bb < 1 or b % bb:
        raise ValueError(f"bb={bb} does not divide B={b}")
    if cg < d or c % cg or cg % d:
        raise ValueError(f"cg={cg} is not a whole number of {d}-channel heads dividing C={c}")
    if pack and sliding_window is not None:
        raise ValueError("a pack takes no sliding window (as _kernel_pack)")
    return b, n, c, d


def _pack_plain(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, bb):
    """``_kernel_pack`` in plain PyTorch: each pack of ``bb`` images is one
    ``[bb*N, bb*N]`` score block per head, with cross-image and masked keys
    filled with -1e30 and a full-row softmax, so a row whose image has no
    valid key averages v over the whole pack."""
    b, n, c3 = qkv.shape
    q, k, v = fa._split_qkv(qkv, num_heads)
    d = q.shape[-1]
    q, k = fa._qk_norm_rope(q, k, q_scale, k_scale, cos, sin)  # the forward's plain q/k
    packs, nn = b // bb, bb * n
    q, k, v = (t.reshape(packs, nn, num_heads, d) for t in (q, k, v))
    s = torch.einsum("gqhd,gkhd->ghqk", q.float(), k.float()) * (1.0 / d ** 0.5 * fa._LOG2E)
    image = torch.arange(nn, device=qkv.device) // n
    keep = (image[:, None] == image[None, :])[None]
    if patch_mask is not None:
        keep = keep & patch_mask.bool().reshape(packs, 1, nn)
    s = s.masked_fill(~keep[:, None], fa._NEG_FILL)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    o = torch.einsum("ghqk,gkhd->gqhd", p.to(v.dtype).float(), v.float())
    o = o / p.sum(-1).transpose(1, 2)[..., None]
    return o.to(qkv.dtype).reshape(b, n, c3 // 3)


def fused_attention_bb_plain(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    bb: int,
    cg: int,
    sliding_window: Optional[int] = None,
    pack: bool = False,
) -> torch.Tensor:
    """The kernels' function in plain PyTorch: the fused forward's
    (:func:`~vitok_torch.ops.fused_attention.fused_qkv_attention_plain`; the
    work split does not change it), or with ``pack`` the packed function."""
    check_arm(qkv.shape, num_heads, bb, cg, sliding_window, pack)
    if pack:
        return _pack_plain(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, bb)
    return fa.fused_qkv_attention_plain(qkv, q_scale, k_scale, cos, sin, patch_mask,
                                        num_heads=num_heads, sliding_window=sliding_window)


# The six products of the fp32 walker's split, small terms first: the pieces
# (0 hi, 1 mid, 2 lo) of the two operands.
SPLIT_PRODUCTS = ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0))


def split_bf16(x: torch.Tensor):
    """An fp32 tensor as three bf16 pieces whose sum is ``x`` exactly:
    ``hi = bf16(x)``, ``mid = bf16(x - hi)``, ``lo = bf16(x - hi - mid)``."""
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


def split_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` of two fp32 tensors as the fp32 walker forms it:
    the six products of their pieces (:data:`SPLIT_PRODUCTS`), each exact
    products summed in fp32, added in that order."""
    pa, pb = split_bf16(a), split_bf16(b)
    out = None
    for i, j in SPLIT_PRODUCTS:
        term = torch.einsum(eq, pa[i].float(), pb[j].float())
        out = term if out is None else out + term
    return out


def fused_attention_bb_split_plain(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    bb: int,
    cg: int,
    sliding_window: Optional[int] = None,
    pack: bool = False,
) -> torch.Tensor:
    """The fp32 walker's arithmetic in plain PyTorch, on an fp32 ``qkv``:
    the fp32 function of :func:`fused_attention_bb_plain` (packed with
    ``pack``) with both products (S = Q K^T and P V) formed by
    :func:`split_einsum` and P not rounded. The kernel is held to
    :func:`fused_attention_bb_plain`; this twin shows that the split itself
    computes that function. At head dims past 128 P V follows the wide
    layout's order (``walk_cells_f32_wide``): each 64-key tile's six products
    summed apart, then the tiles added."""
    check_arm(qkv.shape, num_heads, bb, cg, sliding_window, pack)
    if qkv.dtype != torch.float32:
        raise TypeError(f"the fp32 walker takes float32 qkv, got {qkv.dtype}")
    b, n, c3 = qkv.shape
    q, k, v = fa._split_qkv(qkv, num_heads)
    d = q.shape[-1]
    q, k = fa._qk_norm_rope(q, k, q_scale, k_scale, cos, sin)
    g = bb if pack else 1  # images in one score tile
    nn = g * n
    q, k, v = (t.reshape(b // g, nn, num_heads, d) for t in (q, k, v))
    image = torch.arange(nn, device=qkv.device) // n
    keep = (image[:, None] == image[None, :])[None]
    if patch_mask is not None:
        keep = keep & patch_mask.bool().reshape(b // g, 1, nn)
    if sliding_window is not None:
        idx = torch.arange(n, device=qkv.device)
        keep = keep & ((idx[:, None] - idx[None, :]).abs() <= sliding_window)[None]
    s = split_einsum("gqhd,gkhd->ghqk", q, k) * (1.0 / d ** 0.5 * fa._LOG2E)
    s = s.masked_fill(~keep[:, None], fa._NEG_FILL)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    if d <= 128:
        o = split_einsum("ghqk,gkhd->gqhd", p, v)
    else:  # a fresh sum a key tile (each image's keys in tiles of 64), then the tiles added
        o = None
        for k0, k1 in ((i * n + t, i * n + min(t + 64, n)) for i in range(g) for t in range(0, n, 64)):
            part = split_einsum("ghqk,gkhd->gqhd", p[..., k0:k1], v[:, k0:k1])
            o = part if o is None else o + part
    o = o / p.sum(-1).transpose(1, 2)[..., None]
    return o.reshape(b, n, c3 // 3)


def fused_attention_bb(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    bb: int,
    cg: int,
    sliding_window: Optional[int] = None,
    pack: bool = False,
) -> torch.Tensor:
    """The fused forward with ``bb`` samples x ``cg / d`` heads of a 64-query
    tile per block (``pack``: the ``bb`` samples packed into one score tile).

    ``qkv`` is ``[B, N, 3C]`` bf16 or fp32; the other arguments are those of
    :func:`~vitok_torch.ops.fused_attention.fused_qkv_attention`. A split the
    kernels do not take raises ValueError before anything runs, as does in
    bf16 an N that is not a multiple of 8. On a CUDA tensor it launches, in
    bf16, the q/k prologue and then ``fused_attention_bb_sm90_kernel`` or
    with ``pack`` ``fused_attention_pack_sm90_kernel`` (the wgmma walker,
    ``csrc/fused_attention_ab_sm90.cu``); in fp32
    ``fused_attention_bb_f32_sm90_kernel`` or
    ``fused_attention_pack_f32_sm90_kernel`` (the fp32 walker,
    ``csrc/fused_attention_ab_f32_sm90.cu``); or raises. On a CPU tensor it
    runs :func:`fused_attention_bb_plain`.
    """
    check_arm(qkv.shape, num_heads, bb, cg, sliding_window, pack)
    check_device(qkv)
    if not qkv.is_cuda:
        return fused_attention_bb_plain(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads=num_heads,
                                        bb=bb, cg=cg, sliding_window=sliding_window, pack=pack)
    b, n, c, d, q_scale, k_scale, cos, sin, mask, sw = fa._check_cuda_args(
        qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window,
        dtypes=(torch.bfloat16, torch.float32), head_dims=fa.AB_HEAD_DIMS)
    split = dict(bb=bb, hpb=cg // d, sw=sw, pack=pack)
    if qkv.dtype == torch.bfloat16:  # the wgmma walker, after the q/k prologue
        fa._check_rows(n)
        kn, _ = fa._prologue_cuda(qkv, q_scale, k_scale, cos, sin, num_heads, with_q=False)
        out = walk_sm90(qkv, kn, q_scale, cos, sin, mask, num_heads, **split)
        LAUNCHES["fused_attention_pack" if pack else "fused_attention_bb"] += 1
        return out
    out = walk_f32(qkv, q_scale, k_scale, cos, sin, mask, num_heads, **split)
    LAUNCHES["fused_attention_pack_f32" if pack else "fused_attention_bb_f32"] += 1
    return out


def arm_b_forward(d: int) -> str:
    """What arm B runs at head dim ``d``: the mma.sync forward where it has
    an instance (``fa.MMA_HEAD_DIMS``), else the shipped forward (#1)."""
    return "the mma.sync forward" if d in fa.MMA_HEAD_DIMS else f"the shipped forward (#1 at d {d})"


def arm_b(qkv, q_scale, k_scale, cos, sin, mask, num_heads: int):
    """Arm B's call (:func:`arm_b_forward`)."""
    d = qkv.shape[-1] // 3 // num_heads
    if d in fa.MMA_HEAD_DIMS:
        return fa.fused_qkv_attention_mma(qkv, q_scale, k_scale, cos, sin, mask, num_heads=num_heads)
    return fa.fused_qkv_attention(qkv, q_scale, k_scale, cos, sin, mask, num_heads=num_heads, impl="fused")


def arm_defs(c: int, d: int, n: int, b: int, h: int):
    """``(name, bb, cg, description)`` of every arm, as in JAX; B's cg is
    None (the fused forward), G's None where no 128-aligned group below C
    divides C."""
    auto_cg = pick_group_channels(c, d, n)
    tiles = -(-n // 64)
    return [
        ("B", 1, None, f"{arm_b_forward(d)}: one block per (tile, head, sample), {tiles * h * b} blocks "
                       f"(TPU: bb=1 cg=auto({auto_cg}), {b * (c // max(auto_cg, 1))} cells)"),
        ("G", 1, max((cg for cg in range(d, c, d) if c % cg == 0 and cg % 128 == 0), default=None),
         "pinned large-group baseline"),
        ("S2", 2, 768, "bb=2 cg=768: same 128 cells, control"),
        ("D2", 2, 1536, "bb=2 cg=1536: 64 cells, 2x bytes/cell"),
        ("D4", 4, 768, "bb=4 cg=768: 64 cells, 2x bytes/cell"),
        ("C768", 1, 768, "bb=1 cg=768: 2x cells, half bytes/cell"),
        ("C512", 1, 512, "bb=1 cg=512"),
        ("C384", 1, 384, "bb=1 cg=384: 4x cells"),
        ("C256", 1, 256, "bb=1 cg=256"),
        ("C128", 1, 128, "bb=1 cg=128: one head per cell"),
        ("P2", 2, 1536, "2 images packed per score tile (block-diag mask)"),
    ]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--c", type=int, default=3072)
    ap.add_argument("--heads", type=int, default=24)
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--layers", type=int, default=8, help="kernel calls chained per timed run")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="qkv dtype (float32 reproduces the small-N f32-family sweep)")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    print(f"device: {card_line(device)}", flush=True)
    c, h, n, b = args.c, args.heads, args.tokens, args.batch
    d = c // h
    dtype = getattr(torch, args.dtype)
    print(f"arm B: {arm_b_forward(d)}", flush=True)
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(b, n, 3 * c, generator=gen).to(dtype).to(device)
    q_scale, k_scale, cos, sin = rope_inputs(b, n, d, device, gen)
    mask = torch.ones(b, n, dtype=torch.bool, device=device)
    layers = args.layers

    def make_call(bb, cg, pack):
        if cg is None:
            return lambda cos_: arm_b(qkv, q_scale, k_scale, cos_, sin, mask, h)
        return lambda cos_: fused_attention_bb(qkv, q_scale, k_scale, cos_, sin, mask, num_heads=h,
                                               bb=bb, cg=cg, pack=pack)

    # The numeric legs' reference: in bf16 the redesigned forward (X), whose
    # body every arm but B runs; in fp32 the fp32 walker with one cell a
    # block (W), timed as arm C128 where d = 128.
    f32 = dtype == torch.float32
    if f32:
        new_call = lambda cos_: fused_attention_bb(qkv, q_scale, k_scale, cos_, sin, mask, num_heads=h, bb=1, cg=d)
    else:
        new_call = lambda cos_: fa.fused_qkv_attention(qkv, q_scale, k_scale, cos_, sin, mask, num_heads=h,
                                                       impl="fused")
    new_out = new_call(cos)
    ref = "W" if f32 else "X"
    arms, numeric, references, skipped = [], {}, {}, {}
    ref_out = None
    for name, bb, cg, desc in arm_defs(c, d, n, b, h):
        if name != "B" and cg is None:
            print(f"arm {name} skipped: no lane-aligned group for c={c} d={d}")
            skipped[name] = "no lane-aligned group"
            continue
        pack = name.startswith("P")
        if cg is not None:
            try:
                check_arm(qkv.shape, h, bb, cg, pack=pack)
            except ValueError as e:  # refused up front: nothing ran
                print(f"arm {name} skipped: {e}")
                skipped[name] = str(e)
                continue
        call = make_call(bb, cg, pack)
        out = call(cos)
        if ref_out is None:
            ref_out = out
        else:
            numeric[name] = max_abs_diff(out, new_out)
            references[name] = ref
            print(f"numeric {name}: max|{name}-{ref}| = {numeric[name]:.6f} (expect 0.0)")
        chained_ms(call, cos, layers, 0.0)  # warm the chained run
        arms.append((name, call, desc))
    new_diff = max_abs_diff(new_out, ref_out)
    if f32:
        top = float(ref_out.abs().max())
        expect = ("another kernel: within 1e-5 of B's largest entry, not 0" if d in fa.MMA_HEAD_DIMS
                  else "B is the fp32 walker's forward: expect 0.0")
        print(f"numeric fp32 walker: max|W-B| = {new_diff:.3e} ({expect}; max|B| {top:.3f})")
    else:
        expect = ("another kernel: within #1's limits, not 0" if d in fa.MMA_HEAD_DIMS
                  else "B is X: expect 0.0")
        print(f"numeric redesigned: max|X-B| = {new_diff:.6f} ({expect})")
        chained_ms(new_call, cos, layers, 0.0)
        redesigned = ("redesigned", new_call, "the redesigned forward: q/k prologue + wgmma kernel")
    del out, new_out, ref_out

    timed = arms + ([] if f32 else [redesigned])
    times = {name: [] for name, _, _ in timed}
    t = 1.0
    for _ in range(args.iters):
        for name, call, _ in timed:
            times[name].append(chained_ms(call, cos, layers, t))
            t += 1.0

    isz = qkv.element_size()
    byts = b * n * (3 * c * isz + c * isz)  # qkv in + attn out
    result = {"device": card_line(device), "arm_B": arm_b_forward(d), "arms": {}, "numeric": numeric,
              "references": {k: REFERENCES[v] for k, v in references.items()}, "skipped": skipped}
    for name, _, desc in timed:
        ms = np.array(times[name])
        row = {"ms": float(ms.mean()), "min_ms": float(ms.min()), "n": len(ms), "desc": desc}
        if name == "redesigned":
            result["redesigned"] = {**row, "max_abs_vs_B": new_diff}
        else:
            result["arms"][name] = row
        print(f"{name} ({desc}): {ms.mean():.3f} ms/call (min {ms.min():.3f}, n={len(ms)}) "
              f"eff-BW {byts / ms.mean() / 1e6:.0f} GB/s")
    if f32:
        result["walker_f32"] = {"max_abs_vs_B": new_diff, "max_abs_B": top}
    if times.get("B"):
        bmean = np.mean(times["B"])
        for name, _, _ in timed:
            if name != "B":
                r = np.mean(times[name]) / bmean
                (result["arms"].get(name) or result["redesigned"])["delta"] = float(r)
                print(f"delta {name}/B = {r:.4f} ({(r - 1) * 100:+.2f}%)")
    return result


if __name__ == "__main__":
    main()
