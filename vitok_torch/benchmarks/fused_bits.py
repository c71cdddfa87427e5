"""Hold the fused attention kernels of two checkouts against each other.

Runs the fused forward (#1), its int8 epilogue (#2) and its backward (#3)
of the ``vitok_torch`` under ``--root`` on seeded inputs at the 350M and 5B
widths (with and without a tail mask and a window); at the 350M width and
the recorded A/B shape (B 64, N 256) the A/B kernels #10 (arm D2's split:
two images and half the heads a block, with the window), #11 (the pack,
P2's split; no window) and #13 (all heads of a tile), bf16; and at the
recorded fp32 A/B shape (B 256, N 64, C 3072) the fp32 instances of #1 and
#13 and #10 (D2) and #11 (P2) in fp32; and at the high-resolution flash
shapes (350M at 1024p and 2048p, the 5B width; no mask, or a tail and
window 1024) the flash forward #4 (output and log-sum-exp), its backward #5
and #6 (``flash_attention_bwd`` given that output), and the unfused
branch's attention from the flat QKV (``unfused_qkv_attention`` with
``attn_impl="flash"``), under no grad and, for its gradients, under grad: in
a tree without the fold the eager q/k norm and rotation, then #4 (under
grad the flash kernel's autograd Function, whose backward is #5 and #6); in
one with it the q/k prologue, then #4 (under grad the fold's Function, whose
backward is the prologue and #5 and #6 in their fold instances). It times
each (CUDA events, 20 calls after 3; #3 given the forward's output and
log-sum-exp where its checkout takes them, so that the time is the
backward's alone), saves the outputs, and with ``--against`` compares them
with a file an earlier run saved: #2 bit for bit; the rest, which a
checkout may compute on another kernel with the same rounding points, by
their largest distance (valid rows) and rel L2 against the limits
``chip_smoke.py`` holds them to against their plain versions (bf16 #1,
#10, #11, #13: 2e-2 absolute; #3 and the unfused branch's gradients: 4e-2
of each gradient's largest entry, 3e-2 for the gains; fp32: 1e-5 of the
largest entry; #4 and the fold: the flash limits, 8e-3 max and 2e-4 mean
absolute on valid rows, the log-sum-exp within 1e-3 on live rows and +1e30
on the same dead rows; #5 and #6: 1e-2 max and 6e-6 mean of each
gradient's largest entry, valid rows); and says which are bit for bit the
earlier run's. Run by path, once per checkout, in turns (parent, change,
change, parent):

    python vitok_torch/benchmarks/fused_bits.py --root PARENT --save /tmp/p.pt
    python vitok_torch/benchmarks/fused_bits.py --root . --save /tmp/c.pt --against /tmp/p.pt

Exits 1 if #2 differs or any other output is past its limit. Needs a card.
"""

from __future__ import annotations

import argparse
import inspect
import sys

SHAPES = ((64, 256, 1024, 16), (16, 1024, 1024, 16), (64, 256, 3072, 24))  # B, N, C, H
AB_SHAPES = (SHAPES[0], SHAPES[2])  # #10, #11 and #13: the 350M width and the recorded A/B shape
F32_SHAPE = (256, 64, 3072, 24)     # the recorded fp32 A/B shape
FLASH_SHAPES = ((2, 4096, 16, 64), (1, 16384, 16, 64), (1, 4096, 24, 128))  # B, N, H, D
FLASH_SW = 1024
FLASH_MAX_ABS = 8e-3   # chip_smoke.py's FLASH_MAX_ABS
FLASH_MEAN_ABS = 2e-4  # chip_smoke.py's FLASH_MEAN_ABS
LSE_ATOL = 1e-3        # chip_smoke.py's LSE_ATOL
FLASH_BWD_MAX_REL = 1e-2   # chip_smoke.py's FLASH_BWD_MAX_REL
FLASH_BWD_MEAN_REL = 6e-6  # chip_smoke.py's FLASH_BWD_MEAN_REL
FWD_MAX_ABS = 2e-2   # chip_smoke.py's KERNEL_MAX_ABS
F32_MAX_REL = 1e-5   # chip_smoke.py's AB_F32_MAX_REL
BWD_MAX_REL = 4e-2   # chip_smoke.py's FUSED_BWD_MAX_REL
GAIN_MAX_REL = 3e-2  # chip_smoke.py's FUSED_BWD_GAIN_REL


def _time_ms(fn) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 20


def _distances(key, new, old, mask):
    """(max |new - old| over valid rows, relative to the old tensor's largest
    entry for the backward and fp32; rel L2; limit) per output tensor."""
    import torch

    out = []
    for i, (a, b) in enumerate(zip(new, old)):
        f32 = a.dtype == torch.float32
        a, b = a.float(), b.float()
        err = (a - b).abs()
        if mask is not None and a.dim() == 3:
            err = err[mask]
        rel_l2 = ((a - b).norm() / b.norm().clamp(min=1e-30)).item()
        top = b.abs().max().clamp(min=1e-30).item()
        if key.endswith("bwd"):
            out.append((err.max().item() / top, rel_l2, BWD_MAX_REL if i == 0 else GAIN_MAX_REL))
        elif f32:
            out.append((err.max().item() / top, rel_l2, F32_MAX_REL))
        else:  # #1, #10, #11, #13 in bf16
            out.append((err.max().item(), rel_l2, FWD_MAX_ABS))
    return out


def _inputs(b, n, c, h, case, dtype):
    """Seeded qkv (N(0, 1)), gains U(0.5, 1.5), tables U(0, 1); with a case
    other than "none" a tail mask (another valid count per sample) and
    window 64."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(b * n + c)
    d = c // h
    qkv = torch.randn(b, n, 3 * c, generator=gen, device="cuda").to(dtype)
    qs = 0.5 + torch.rand(d, generator=gen, device="cuda")
    ks = 0.5 + torch.rand(d, generator=gen, device="cuda")
    cos = torch.rand(b, n, d // 2, generator=gen, device="cuda")
    sin = torch.rand(b, n, d // 2, generator=gen, device="cuda")
    mask, sw = None, None
    if case != "none":
        valid = torch.tensor([n - (i * n) // (b + 2) for i in range(b)], device="cuda")
        mask, sw = torch.arange(n, device="cuda")[None] < valid[:, None], 64
    return (qkv, qs, ks, cos, sin, mask), sw, gen


def _flash_inputs(b, n, h, d, case):
    """Seeded q, k, v (N(0, 1), views of one [B, N, 3, H, D] tensor), the
    flat QKV with gains U(0.5, 1.5) and tables U(0, 1) for the unfused
    branch, and with "tail+sw" a tail mask (a quarter of each sample's
    tokens padding, more in later samples) and window ``FLASH_SW``."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(b * n + h * d)
    qkv5 = torch.randn(b, n, 3, h, d, generator=gen, device="cuda").bfloat16()
    qs = 0.5 + torch.rand(d, generator=gen, device="cuda")
    ks = 0.5 + torch.rand(d, generator=gen, device="cuda")
    cos = torch.rand(b, n, d // 2, generator=gen, device="cuda")
    sin = torch.rand(b, n, d // 2, generator=gen, device="cuda")
    mask, sw = None, None
    if case != "none":
        valid = torch.tensor([n - n // 4 - (i * n) // (b + 2) for i in range(b)], device="cuda")
        mask, sw = torch.arange(n, device="cuda")[None] < valid[:, None], FLASH_SW
    return qkv5, (qkv5.view(b, n, 3 * h * d), qs, ks, cos, sin, mask), sw


def _flash_distances(new, old, mask):
    """(max |new - old|, mean |new - old|) on valid rows of the output, the
    log-sum-exp's largest distance on live rows (0 without one), and whether
    the two agree on which rows are dead; the output is [B, N, H, D] or
    [B, N, C]."""
    import torch

    err = (new[0].float() - old[0].float()).abs()
    if mask is not None:
        err = err[mask]
    lse_err, dead_same = 0.0, True
    if len(new) > 1:
        live = old[1] < 1e29
        dead_same = torch.equal(new[1] < 1e29, live)
        lse_err = (new[1][live] - old[1][live]).abs().max().item() if live.any() else 0.0
    return err.max().item(), err.mean().item(), lse_err, dead_same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the checkout whose vitok_torch runs")
    ap.add_argument("--save", required=True, help="file for this run's outputs")
    ap.add_argument("--against", help="an earlier run's outputs, compared bit for bit")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    import torch
    from vitok_torch.benchmarks import ab_batch_block as abb
    from vitok_torch.benchmarks import ab_q8_input as ab8
    from vitok_torch.ops import fused_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    outputs, times, masks = {}, {}, {}
    for b, n, c, h in SHAPES:
        for case in ("none", "tail+sw"):
            fwd_args, sw, gen = _inputs(b, n, c, h, case, torch.bfloat16)
            key = f"{b}x{n}x{c} {case}"
            masks[key] = fwd_args[-1]
            fwd = lambda: fa.fused_qkv_attention(*fwd_args, num_heads=h, sliding_window=sw, impl="fused")
            q8 = lambda: fa.fused_qkv_attention_q8(*fwd_args, num_heads=h, sliding_window=sw)
            outputs[key + " fwd"] = fwd()
            outputs[key + " q8"] = q8()
            dout = torch.randn(b, n, c, generator=gen, device="cuda").bfloat16()
            saved = {}
            if "lse" in inspect.signature(fa.fused_qkv_attention_bwd).parameters:
                out, lse = fa._fused_cuda(*fwd_args, h, sw, want_lse=True)
                saved = dict(out=out, lse=lse)
            bwd = lambda: fa.fused_qkv_attention_bwd(*fwd_args, dout, num_heads=h, sliding_window=sw, **saved)
            outputs[key + " bwd"] = bwd()
            times[key + " #1"] = _time_ms(fwd)
            times[key + " #2"] = _time_ms(q8)
            times[key + " #3"] = _time_ms(bwd)
            if (b, n, c, h) in AB_SHAPES:
                legs = {
                    "bb": ("#10", lambda: abb.fused_attention_bb(*fwd_args, num_heads=h, bb=2, cg=c // 2,
                                                                 sliding_window=sw)),
                    "pack": ("#11", lambda: abb.fused_attention_bb(*fwd_args, num_heads=h, bb=2, cg=c // 2,
                                                                   pack=True)),
                    "contig": ("#13", lambda: ab8.fused_attention_contig(*fwd_args, num_heads=h, sliding_window=sw)),
                }
                for leg, (num, call) in legs.items():
                    outputs[f"{key} {leg}"] = call()
                    times[f"{key} {num}"] = _time_ms(call)
    b, n, c, h = F32_SHAPE
    for case in ("none", "tail+sw"):
        fwd_args, sw, _ = _inputs(b, n, c, h, case, torch.float32)
        key = f"{b}x{n}x{c} {case} f32"
        masks[key] = fwd_args[-1]
        legs = {
            "fwd": ("#1", lambda: fa.fused_qkv_attention(*fwd_args, num_heads=h, sliding_window=sw, impl="fused")),
            "contig": ("#13", lambda: ab8.fused_attention_contig(*fwd_args, num_heads=h, sliding_window=sw)),
            "bb": ("#10", lambda: abb.fused_attention_bb(*fwd_args, num_heads=h, bb=2, cg=c // 2, sliding_window=sw)),
            "pack": ("#11", lambda: abb.fused_attention_bb(*fwd_args, num_heads=h, bb=2, cg=c // 2, pack=True)),
        }
        for leg, (num, call) in legs.items():
            outputs[f"{key} {leg}"] = call()
            times[f"{key} {num}"] = _time_ms(call)
    from vitok_torch.ops import flash_attention as fl

    for b, n, h, d in FLASH_SHAPES:
        for case in ("none", "tail+sw"):
            qkv5, flat, sw = _flash_inputs(b, n, h, d, case)
            q, k, v = qkv5.unbind(2)
            key = f"{b}x{n}x{h * d} {case}"
            masks[key] = flat[-1]
            flash = lambda: fl.flash_attention(q, k, v, flat[-1], sw, return_lse=True)
            outputs[key + " flash"] = flash()
            times[key + " #4"] = _time_ms(flash)
            with torch.no_grad():
                fold = lambda: fa.unfused_qkv_attention(*flat, h, sw, attn_impl="flash")
                outputs[key + " fold"] = fold()
                times[key + " fold"] = _time_ms(fold)
            gen = torch.Generator(device="cuda").manual_seed(b * n + h * d + 1)
            dout = torch.randn(b, n, h * d, generator=gen, device="cuda").bfloat16()
            out, lse = outputs[key + " flash"]
            fbwd = lambda: fl.flash_attention_bwd(q, k, v, out, lse, dout.view(b, n, h, d), flat[-1], sw)
            outputs[key + " fbwd"] = fbwd()
            times[key + " #5+#6"] = _time_ms(fbwd)

            def branch_grads():
                x, a, kk = (t.detach().requires_grad_(True) for t in flat[:3])
                o = fa.unfused_qkv_attention(x, a, kk, *flat[3:], h, sw, attn_impl="flash")
                return torch.autograd.grad(o, (x, a, kk), dout)

            outputs[key + " foldbwd"] = branch_grads()
            times[key + " fold fwd+bwd"] = _time_ms(branch_grads)
            del qkv5, q, k, v, flat, dout, out, lse
    torch.save(outputs, args.save)
    print(f"{args.root}: ms " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    if args.against:
        old = torch.load(args.against)
        as_tuple = lambda x: x if isinstance(x, (tuple, list)) else (x,)
        bad, same = [], {}
        for k in outputs:
            new_t, old_t = as_tuple(outputs[k]), as_tuple(old[k])
            same[k] = all(torch.equal(a, b) for a, b in zip(new_t, old_t))
            if k.endswith("q8"):
                print(f"  {k}: bit-identical {same[k]}", flush=True)
                bad += [] if same[k] else [k]
                continue
            if k.endswith(" fbwd"):
                mask = masks[k.rsplit(" ", 1)[0]]
                dist = []
                for a, b in zip(new_t, old_t):
                    err = (a.float() - b.float()).abs()
                    err = err if mask is None else err[mask]
                    top = b.float().abs().max().clamp(min=1e-30).item()
                    dist.append((err.max().item() / top, err.mean().item() / top))
                print(f"  {k}: " + "; ".join(f"max {m:.3e} mean {mean:.3e}" for m, mean in dist)
                      + f" (limits {FLASH_BWD_MAX_REL}, {FLASH_BWD_MEAN_REL} of the largest entry); "
                      f"bit-identical {same[k]}", flush=True)
                bad += [] if all(m <= FLASH_BWD_MAX_REL and mean <= FLASH_BWD_MEAN_REL for m, mean in dist) else [k]
                continue
            if k.endswith((" flash", " fold")):
                mx, mean, lse_err, dead_same = _flash_distances(new_t, old_t, masks[k.rsplit(" ", 1)[0]])
                print(f"  {k}: max {mx:.3e} mean {mean:.3e} (limits {FLASH_MAX_ABS}, {FLASH_MEAN_ABS}); lse "
                      f"{lse_err:.3e} (limit {LSE_ATOL}), the same dead rows {dead_same}; bit-identical {same[k]}",
                      flush=True)
                bad += [] if (mx <= FLASH_MAX_ABS and mean <= FLASH_MEAN_ABS and lse_err <= LSE_ATOL
                              and dead_same) else [k]
                continue
            dist = _distances(k, new_t, old_t, masks[k.rsplit(" ", 1)[0]])
            print(f"  {k}: " + "; ".join(f"max {m:.3e} (limit {lim}) rel L2 {r:.3e}" for m, r, lim in dist)
                  + f"; bit-identical {same[k]}", flush=True)
            bad += [k] if any(m > lim for m, _, lim in dist) else []
        groups = {"#1": " fwd", "#3": " bwd", "#2": " q8", "#10": " bb", "#11": " pack", "#13": " contig",
                  "#4": " flash", "fold": " fold", "#5+#6": " fbwd", "fold bwd": " foldbwd"}
        summary = []
        for kind, f32 in (("bf16", False), ("fp32", True)):
            for num, suffix in groups.items():
                keys = [k for k in outputs if k.endswith(suffix) and k.endswith(" f32" + suffix) == f32]
                if keys:
                    summary.append(f"{num} {kind}: bit-identical at {sum(same[k] for k in keys)} of {len(keys)}, "
                                   f"within its limit at {sum(k not in bad for k in keys)}")
        print(f"against {args.against}: " + "; ".join(summary) + f"; past a limit: {bad}", flush=True)
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
