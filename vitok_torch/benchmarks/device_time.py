"""Three device times of one call, side by side, session after session.

For the fp32 forward (#1) and all heads of a tile (#13) on the fp32 walker
at the recorded fp32 A/B shape (C 3072, 24 heads, N 64, B 256), and the
bf16 forward (#1: the q/k prologue and the wgmma kernel) at the recorded
bf16 shape (N 256, B 64), with an all-ones mask: CUDA events around chained
calls (what ``chip_smoke.py``'s ``time_ms`` reads), CUDA events with the
host ahead (:func:`~vitok_torch.benchmarks.host_ahead_ms`), and the kernel
records ``torch.profiler`` keeps over five calls, with how many of the
launches each profiler session kept. ``--big-session N`` first profiles one
session of N launches of a small elementwise kernel (as a profiled training
step holds thousands), and says how many records it kept. Needs a card:

    python -m vitok_torch.benchmarks.device_time --sessions 8
    python -m vitok_torch.benchmarks.device_time --sessions 8 --big-session 50000
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from vitok_torch.benchmarks import ab_q8_input as ab8
from vitok_torch.benchmarks import card_line, chained_ms, host_ahead_ms, profiler_records, rope_inputs
from vitok_torch.ops import fused_attention as fa


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--big-session", type=int, default=0, help="launches of one profiled session run first")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the times are the card's")
    device = torch.device("cuda")
    print(f"device: {card_line(device)}", flush=True)
    result = {}
    if args.big_session:
        x = torch.zeros(1024, device=device)
        kept = len(profiler_records(lambda: x.add_(1.0), runs=args.big_session))
        result["big_session"] = dict(launches=args.big_session, records_kept=kept)
        print(f"big session: {kept} records kept of {args.big_session} launches", flush=True)
    c, h = 3072, 24
    calls = {}
    for dtype, n, b in ((torch.float32, 64, 256), (torch.bfloat16, 256, 64)):
        gen = torch.Generator().manual_seed(0)
        qkv = torch.randn(b, n, 3 * c, generator=gen).to(dtype).to(device)
        qs, ks, cos, sin = rope_inputs(b, n, c // h, device, gen)
        mask = torch.ones(b, n, dtype=torch.bool, device=device)
        name = "fp32" if dtype == torch.float32 else "bf16"
        fwd = lambda cos_, a=(qkv, qs, ks), s=sin, m=mask: fa.fused_qkv_attention(
            *a, cos_, s, m, num_heads=h, impl="fused")
        calls[f"#1 {name}"] = (fwd, cos, 1 if dtype == torch.float32 else 2)
        if dtype == torch.float32:
            calls["#13 fp32"] = (lambda cos_, a=(qkv, qs, ks), s=sin, m=mask: ab8.fused_attention_contig(
                *a, cos_, s, m, num_heads=h), cos, 1)
    for label, (call, cos, kernels) in calls.items():
        one = lambda call=call, cos=cos: call(cos)
        rows = []
        for _ in range(args.sessions):
            records = profiler_records(one)
            rows.append((chained_ms(call, cos, 16, 1.0), host_ahead_ms(one), sum(records) / 5, len(records)))
        chained, ahead, prof, kept = (np.array(col) for col in zip(*rows))
        result[label] = dict(chained_ms=chained.tolist(), host_ahead_ms=ahead.tolist(), profiler_ms=prof.tolist(),
                             records_kept=kept.tolist(), records_expected=5 * kernels)
        print(f"{label}: chained {np.median(chained):.4f} ms, host ahead {np.median(ahead):.4f} "
              f"(ratio {np.median(ahead / chained):.3f}), profiler {np.median(prof):.4f}; records kept per session "
              f"{kept.astype(int).tolist()} of {5 * kernels}", flush=True)
    return result


if __name__ == "__main__":
    main()
