"""Hold the fp32 attention kernels at head dims 64 and 128 of two checkouts
against each other, bit for bit.

Runs, on seeded fp32 inputs (four shapes a head dim: tail masks, a window,
a 1024-token sample, a 256-sample batch of 64 tokens), every fp32 kernel of
the ``vitok_torch`` under ``--root`` that has a d 64/128 instance: the fp32
walker's forward (#1) and its log-sum-exp instance, the mma.sync fp32
forward, the fp32 batch-block walker (#10), the fp32 q/k prologue with and
without delta, the fold's forward (the prologue, then #4's fp32 instance),
#3's fp32 instance given the walker's output and lse, the fold's gradient
(the prologue, then #5 and #6 in their fold instances), #4-#6 in their
plain instances, and #2 on fp32 (codes and scales). Saves the outputs; with
``--against`` says which are bit for bit an earlier run's. Run by path,
once a checkout, in turns (parent, change, change, parent):

    python vitok_torch/benchmarks/f32_bits.py --root PARENT --save /tmp/p.pt
    python vitok_torch/benchmarks/f32_bits.py --root . --save /tmp/c.pt --against /tmp/p.pt

Exits 1 if any output differs from the earlier run's. Needs a card.
"""

from __future__ import annotations

import argparse
import os
import sys

SHAPES = ((4, 200, 4, True, None), (4, 200, 4, True, 24), (2, 1024, 8, False, None), (16, 64, 24, True, None))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the checkout whose vitok_torch runs")
    ap.add_argument("--save", required=True, help="where to save the outputs")
    ap.add_argument("--against", help="an earlier run's saved outputs")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    from vitok_torch.benchmarks import ab_batch_block as abb
    from vitok_torch.ops import flash_attention as fl
    from vitok_torch.ops import fused_attention as fa
    from vitok_torch.ops.rope import compute_2d_freqs_cis

    if not fa.__file__.startswith(os.path.abspath(args.root) + os.sep):
        raise SystemExit(f"vitok_torch came from {fa.__file__}, not from {args.root}")
    if not torch.cuda.is_available():
        raise SystemExit("f32_bits.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}
    for d in (64, 128):
        for b, n, h, masked, sw in SHAPES:
            rng = np.random.default_rng(d + n)
            c = h * d
            qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * c), dtype=np.float32)).to(dev)
            qs, ks = (torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32)).to(dev) for _ in range(2))
            idx = np.arange(n)
            cos, sin = (t.to(dev) for t in compute_2d_freqs_cis(torch.from_numpy(np.tile(idx // 16, (b, 1))),
                                                                torch.from_numpy(np.tile(idx % 16, (b, 1))), d))
            valid = np.array([n, 23] + [n // 2] * (b - 2))
            mask = torch.from_numpy(idx[None] < valid[:, None]).to(dev) if masked else None
            key = f"d{d} b{b} n{n} sw{sw} mask{masked}"
            fwd = (qkv, qs, ks, cos, sin, mask)
            kw = dict(num_heads=h, sliding_window=sw)
            g = torch.randn((b, n, c), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
            out[key + " walker"] = fa.fused_qkv_attention(*fwd, impl="fused", **kw)
            o, lse = fa._fused_cuda(*fwd, h, sw, want_lse=True)
            out[key + " walker_lse"], out[key + " lse"] = o, lse
            out[key + " mma"] = fa.fused_qkv_attention_mma(*fwd, **kw)
            out[key + " bb"] = abb.fused_attention_bb(*fwd, num_heads=h, bb=2 if b % 2 == 0 else 1,
                                                      cg=2 * d if h % 2 == 0 else d, sliding_window=sw)
            out[key + " prologue"] = fa.fused_qk_prologue(qkv, qs, ks, cos, sin, num_heads=h)[0]
            out[key + " delta"] = fa.fused_qk_prologue(qkv, qs, ks, cos, sin, num_heads=h, out=o, dout=g)[1]
            out[key + " fold"] = fa.flash_qkv_attention(*fwd, **kw)
            for i, t in enumerate(fa.fused_qkv_attention_bwd(*fwd, g, out=o, lse=lse, **kw)):
                out[key + f" bwd{i}"] = t
            x = qkv.clone().requires_grad_()
            y = fa.flash_qkv_attention(x, qs, ks, cos, sin, mask, **kw)
            out[key + " fold_grad"] = torch.autograd.grad((y * g).sum(), x)[0]
            q, k, v = qkv.view(b, n, 3, h, d).unbind(2)
            fo, flse = fl.flash_attention(q, k, v, mask, sw, return_lse=True)
            out[key + " flash"], out[key + " flash_lse"] = fo, flse
            for name, t in zip(("dq", "dk", "dv"), fl.flash_attention_bwd(q, k, v, fo, flse, g.view(b, n, h, d),
                                                                          mask, sw)):
                out[key + f" flash_{name}"] = t
            out[key + " q8_codes"], out[key + " q8_scales"] = fa.fused_qkv_attention_q8(*fwd, **kw)
    torch.cuda.synchronize()
    out = {k: v.detach().cpu() for k, v in out.items()}
    torch.save(out, args.save)
    print(f"{args.root}: {len(out)} outputs saved to {args.save} ({torch.cuda.get_device_name(0)})")
    if not args.against:
        return 0
    prev = torch.load(args.against)
    differ = [k for k in out if k not in prev or not torch.equal(out[k], prev[k])]
    print(f"bit for bit: {len(out) - len(differ)} of {len(out)}; differ: {differ}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
