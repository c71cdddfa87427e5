"""Hold the fused attention kernels of two checkouts against each other.

Runs the fused forward (#1), its int8 epilogue (#2) and its backward (#3)
of the ``vitok_torch`` under ``--root`` on seeded inputs at the 350M and 5B
widths (with and without a tail mask and a window), times #1 there (CUDA
events, 20 calls after 3), saves the outputs, and with ``--against`` checks
them bit for bit against a file an earlier run saved. Run by path, once per
checkout, in turns (parent, change, change, parent):

    python vitok_torch/benchmarks/fused_bits.py --root PARENT --save /tmp/p.pt
    python vitok_torch/benchmarks/fused_bits.py --root . --save /tmp/c.pt --against /tmp/p.pt

Exits 1 if any output differs. Needs a card.
"""

from __future__ import annotations

import argparse
import sys

SHAPES = ((64, 256, 1024, 16), (16, 1024, 1024, 16), (64, 256, 3072, 24))  # B, N, C, H


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the checkout whose vitok_torch runs")
    ap.add_argument("--save", required=True, help="file for this run's outputs")
    ap.add_argument("--against", help="an earlier run's outputs, compared bit for bit")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    import torch
    from vitok_torch.ops import fused_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernels run only on the card")
    outputs, times = {}, {}
    for b, n, c, h in SHAPES:
        for case in ("none", "tail+sw"):
            gen = torch.Generator(device="cuda").manual_seed(b * n + c)
            d = c // h
            qkv = torch.randn(b, n, 3 * c, generator=gen, device="cuda").bfloat16()
            qs = 0.5 + torch.rand(d, generator=gen, device="cuda")
            ks = 0.5 + torch.rand(d, generator=gen, device="cuda")
            cos = torch.rand(b, n, d // 2, generator=gen, device="cuda")
            sin = torch.rand(b, n, d // 2, generator=gen, device="cuda")
            mask, sw = None, None
            if case != "none":
                valid = torch.tensor([n - (i * n) // (b + 2) for i in range(b)], device="cuda")
                mask, sw = torch.arange(n, device="cuda")[None] < valid[:, None], 64
            key = f"{b}x{n}x{c} {case}"
            fwd_args = (qkv, qs, ks, cos, sin, mask)
            fwd = lambda: fa.fused_qkv_attention(*fwd_args, num_heads=h, sliding_window=sw, impl="fused")
            outputs[key + " fwd"] = fwd()
            outputs[key + " q8"] = fa.fused_qkv_attention_q8(*fwd_args, num_heads=h, sliding_window=sw)
            dout = torch.randn(b, n, c, generator=gen, device="cuda").bfloat16()
            outputs[key + " bwd"] = fa.fused_qkv_attention_bwd(*fwd_args, dout, num_heads=h, sliding_window=sw)
            for _ in range(3):
                fwd()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fwd()
            end.record()
            torch.cuda.synchronize()
            times[key] = start.elapsed_time(end) / 20
    torch.save(outputs, args.save)
    print(f"{args.root}: #1 ms " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    if args.against:
        old = torch.load(args.against)
        as_tuple = lambda x: x if isinstance(x, (tuple, list)) else (x,)
        differ = [k for k in outputs if not all(torch.equal(a, b) for a, b in zip(as_tuple(outputs[k]), as_tuple(old[k])))]
        print(f"bit-identical to {args.against}: {len(outputs) - len(differ)} of {len(outputs)}; differ: {differ}",
              flush=True)
        return 1 if differ else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
