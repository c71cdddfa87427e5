"""Microbench: the fused int8 FFN kernel against the unfused int8 chain.

The port's counterpart of ``benchmarks/bench_fused_ffn.py``. On ``M`` token
rows of int8 activations (``[M, C]`` codes and per-token scales) and a
padded int8 fc1 ``[2F', C]``:

* fused: ``quant.fused_ffn_int8`` (``csrc/ffn_int8.cu``, #7): the fc1
  product, SwiGLU and the per-token requantization in one launch;
* unfused: ``torch._int_mm`` for fc1 with the fp32 rescale to bf16, then
  ``quant.fused_silu_quant`` (``csrc/silu_quant.cu``, #8).

The check holds each against its plain version bit for bit (codes and
scales), and the two against each other within the JAX script's limits:
the chain rounds the hidden to bf16 before SwiGLU, the fused kernel does
not, so codes may differ by up to 2 (fewer than 1% by more than 1) and
scales by 2e-2 relative. Times are CUDA events around chained calls
(``utils/profiling.time_ms``), beside the operations' bound at the int8
peak (1979 TOP/s).

    python -m vitok_torch.benchmarks.bench_fused_ffn                       # 5B decoder shape
    python -m vitok_torch.benchmarks.bench_fused_ffn --c 1024 --f 2736     # 350M shape
    python -m vitok_torch.benchmarks.bench_fused_ffn --check-only          # numerics only

``--device cpu`` runs the plain versions (no time).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Tuple

import numpy as np
import torch

from vitok_torch.benchmarks import card_line, resolve_device
from vitok_torch.ops import quant as q8

INT8_PEAK_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
CODE_MAX_DIFF = 2         # the JAX script's limits between the fused kernel and the chain
CODE_SHARE_OVER_ONE = 0.01
SCALE_MAX_REL = 2e-2


def make_inputs(m: int, c: int, f: int, device, seed: int = 0) -> Tuple[torch.Tensor, ...]:
    """The JAX script's draws (numpy, ``seed``): activations ``0.5 N(0, 1)``
    in bf16, quantized per token; fc1 ``0.02 N(0, 1)`` in bf16, padded to
    128-aligned SwiGLU halves and quantized per output channel. Returns
    ``(hq [M, C], h_scale [M, 1], w_int8 [2F', C], w_scale [2F'])``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((m, c)) * 0.5).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((2 * f, c)) * 0.02).astype(np.float32)).to(torch.bfloat16)
    hq, hs = q8.quantize_activation(x.to(device))
    w_int8, w_scale = q8.quantize_block_linear("fc1", w.to(device))
    return hq, hs, w_int8, w_scale


def fused(hq, hs, w_int8, w_scale):
    return q8.fused_ffn_int8(hq, hs, w_int8, w_scale)


def unfused(hq, hs, w_int8, w_scale, silu_quant=None):
    hid = q8.int8_matmul_prequant(hq, hs, w_int8, w_scale, torch.bfloat16)
    return (silu_quant or q8.fused_silu_quant)(hid)


def check(hq, hs, w_int8, w_scale) -> Dict[str, object]:
    """Each path against its plain version (bit for bit) and the two paths
    against each other (the JAX script's limits)."""
    qa, sa = unfused(hq, hs, w_int8, w_scale)
    qb, sb = fused(hq, hs, w_int8, w_scale)
    pa, psa = unfused(hq, hs, w_int8, w_scale, q8.fused_silu_quant_plain)
    pb, psb = q8.fused_ffn_int8_plain(hq, hs, w_int8, w_scale)
    diff = (qa.int() - qb.int()).abs()
    srel = ((sa - sb).abs() / sa.abs().clamp(min=1e-12)).max().item()
    out = {
        "fused_bit_for_bit": bool(torch.equal(qb, pb) and torch.equal(sb, psb)),
        "unfused_bit_for_bit": bool(torch.equal(qa, pa) and torch.equal(sa, psa)),
        "code_max_diff": int(diff.max()),
        "code_share_over_one": float((diff > 1).float().mean()),
        "scale_max_rel": srel,
    }
    out["ok"] = (out["fused_bit_for_bit"] and out["unfused_bit_for_bit"] and out["code_max_diff"] <= CODE_MAX_DIFF
                 and out["code_share_over_one"] < CODE_SHARE_OVER_ONE and srel < SCALE_MAX_REL)
    return out


def run(m: int = 64 * 256, c: int = 3072, f: int = 8208, device="cuda", check_only: bool = False,
        runs: int = 10) -> Dict[str, object]:
    """Check, and on the card time, both paths at ``M x C`` with fc1's
    hidden ``f`` (padded to ``F'``)."""
    device = torch.device(device)
    hq, hs, w_int8, w_scale = make_inputs(m, c, f, device)
    fp = w_int8.shape[0] // 2
    res = {"m": m, "c": c, "f": f, "f_padded": fp, **check(hq, hs, w_int8, w_scale)}
    if check_only or device.type != "cuda":
        return res
    from vitok_torch.utils.profiling import time_ms

    ops = 2.0 * m * c * 2 * fp
    for name, fn in (("unfused", unfused), ("fused", fused)):
        ms = time_ms(lambda: fn(hq, hs, w_int8, w_scale), runs=runs)
        res[f"{name}_ms"] = ms
        res[f"{name}_tops"] = ops / (ms * 1e-3) / 1e12
    res["bound_ms"] = ops / INT8_PEAK_OPS * 1e3
    res["card"] = card_line(device)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=64 * 256)
    ap.add_argument("--c", type=int, default=3072)
    ap.add_argument("--f", type=int, default=8208)
    ap.add_argument("--runs", type=int, default=10, help="chained calls a timing")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.m, args.c, args.f, resolve_device(args.device), args.check_only, args.runs)
    print(f"# int8 diff: max {res['code_max_diff']}  frac>1 {res['code_share_over_one']:.2e}")
    print(f"# scale rel: max {res['scale_max_rel']:.3e}")
    print(f"# each path against its plain version: fused {res['fused_bit_for_bit']}, "
          f"unfused {res['unfused_bit_for_bit']} (bit for bit)")
    if not res["ok"]:
        print(json.dumps(res))
        raise SystemExit("numerics mismatch")
    if "fused_ms" not in res:
        print("# numerics OK")
        return 0
    for name in ("unfused", "fused"):
        print(f"{name:8s} {res[name + '_ms']:8.3f} ms  {res[name + '_tops']:6.1f} TOP/s (int8 peak 1979; bound "
              f"{res['bound_ms']:.3f} ms)")
    print(f"# {res['card']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
