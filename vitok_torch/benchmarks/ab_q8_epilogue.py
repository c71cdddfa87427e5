"""Interleaved A/B: the fused attention's int8 epilogue against #1 plus the
quantize chain, on a ``quantize()``d AE.

The port's counterpart of ``benchmarks/ab_q8_epilogue.py``. Arm A routes
each int8 block's attention through ``fused_qkv_attention_q8`` (#2: the
kernel quantizes its own output per token, and the out-projection reads the
codes); arm B is the default route: #1's bf16 output, then the eager
``quantize_activation`` before the int8 out-projection. The switch is the
package's opt-in (``fused_attention._ENABLE_Q8``, set from
``VITOK_Q8_EPILOGUE``), flipped for each arm in one process, and the arms
are timed in turns.

The numeric leg: ``max|A - B| / max|B|`` over the decoded patches of one
forward each.

    python -m vitok_torch.benchmarks.ab_q8_epilogue --variant 5B --tokens 256 --batch 64

``--device cpu`` runs the plain versions (host clock: no device time).
"""

from __future__ import annotations

import argparse
import contextlib
from typing import Dict

import numpy as np
import torch

from vitok_torch.benchmarks import card_line, make_batch, resolve_device
from vitok_torch.ops import fused_attention as fa
from vitok_torch.utils.profiling import DeviceTimer

VARIANT_ALIASES = {
    "350M": "Ld4-Ld24/1x16x64",
    "5B": "Td4-T/1x16x64",
    "tiny": "w256_d2_h4-w256_d4_h4/1x16x16",
    "tiny128": "w512_d2_h4-w512_d4_h4/1x16x16",  # d=128 heads
}


@contextlib.contextmanager
def q8_epilogue(on: bool):
    """The int8 epilogue's opt-in set to ``on`` for the calls inside."""
    saved, fa._ENABLE_Q8 = fa._ENABLE_Q8, on
    try:
        yield
    finally:
        fa._ENABLE_Q8 = saved


def build(variant: str, tokens: int, batch: int, device):
    """The ``quantize()``d AE from seed 0 and a dense batch of ``batch``
    square images of ``tokens`` tokens; also the parameter count before
    quantizing."""
    from vitok_torch import AE, decode_variant

    model = AE(**decode_variant(VARIANT_ALIASES.get(variant, variant)), seed=0, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    side = int(np.sqrt(tokens))
    data = make_batch(batch, tokens, (side, side), model.cfg.pixels_per_token, device=device)
    return model.quantize(), data, n_params


def numeric(model, data) -> Dict[str, float]:
    """``max|A - B|``, ``max|B|`` and their ratio over one forward's
    patches, and their relative L2 distance."""
    with q8_epilogue(True):
        a = model(data)["patches"].float()
    with q8_epilogue(False):
        b = model(data)["patches"].float()
    dmax, bmax = float((a - b).abs().max()), float(b.abs().max())
    return {"max_abs": dmax, "max_b": bmax, "rel": dmax / max(bmax, 1e-9),
            "rel_l2": float((a - b).norm() / b.norm().clamp(min=1e-30))}


def timing(model, data, iters: int, device) -> Dict[str, object]:
    """Each arm's ms per image over ``iters`` turns (A, B, A, B, ...) of a
    chain of forwards, each fed the previous one's patches; the chain is
    about 1.5 s of work (2 to 32 forwards)."""
    fwd = lambda pt: model(dict(data, patches=pt))["patches"]
    with q8_epilogue(True):
        fwd(data["patches"])
        single = DeviceTimer(device)
        with single:
            fwd(data["patches"])
    with q8_epilogue(False):
        fwd(data["patches"])
    chain = int(min(max(round(1.5 / max(single.times[0], 1e-3)), 2), 32))
    timers = {"A": DeviceTimer(device), "B": DeviceTimer(device)}
    for _ in range(iters):
        for arm, on in (("A", True), ("B", False)):
            with q8_epilogue(on), timers[arm]:
                pt = data["patches"]
                for _ in range(chain):
                    pt = fwd(pt)
    b = data["patches"].shape[0]
    out = {"chain": chain}
    for arm, t in timers.items():
        per_img = np.asarray(t.times) / (chain * b) * 1e3
        out[arm] = {"ms_per_img": float(per_img.mean()), "min_ms_per_img": float(per_img.min()), "n": len(per_img)}
    out["a_over_b"] = out["A"]["ms_per_img"] / out["B"]["ms_per_img"]
    return out


def run(variant: str = "tiny", tokens: int = 256, batch: int = 64, iters: int = 4, device="cuda",
        numeric_only: bool = False) -> Dict[str, object]:
    device = torch.device(device)
    model, data, n_params = build(variant, tokens, batch, device)
    res = {"variant": VARIANT_ALIASES.get(variant, variant), "tokens": tokens, "batch": batch,
           "numeric": numeric(model, data)}
    if not numeric_only:
        res["timing"] = timing(model, data, iters, device)
        for arm in ("A", "B"):
            res["timing"][arm]["tflops"] = 2.0 * n_params * tokens / (res["timing"][arm]["ms_per_img"] * 1e-3) / 1e12
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", default="tiny")
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    res = run(args.variant, args.tokens, args.batch, args.iters, device)
    n = res["numeric"]
    print(f"numeric: max|A-B|={n['max_abs']:.5f} max|B|={n['max_b']:.3f} rel={n['rel']:.5f}")
    t = res["timing"]
    for arm, label in (("A", "q8-epilogue"), ("B", "quantize chain")):
        print(f"{arm} ({label}): {t[arm]['ms_per_img']:.3f} ms/img (min {t[arm]['min_ms_per_img']:.3f}, "
              f"n={t[arm]['n']}, chain={t['chain']}) eff {t[arm]['tflops']:.1f} TFLOP/s")
    print(f"delta: A/B = {t['a_over_b']:.4f} ({(t['a_over_b'] - 1) * 100:+.2f}%)")
    print(f"# {card_line(device)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
