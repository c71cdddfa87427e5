"""Checkpoint debug utilities: key dump, per-component summary, shape diff.

The port's counterpart of the JAX package's ``scripts/inspect_checkpoint.py``.
It reads the port's own artifacts: a training checkpoint (a directory
holding ``state.pt``, or the file itself; its parameters), safetensors in the
released flat layout (``export_safetensors`` / ``save_safetensors_params``)
and ``.npz`` files. The names are the flat module names of both layouts.

    # flat key dump (names, shapes, dtypes)
    python -m vitok_torch.scripts.inspect_checkpoint keys encoder.safetensors

    # per-component parameter/byte summary
    python -m vitok_torch.scripts.inspect_checkpoint summary output/last

    # shape diff against what a model variant expects
    python -m vitok_torch.scripts.inspect_checkpoint diff encoder.safetensors \\
        --variant Ld4-Ld24/1x16x64 --component encoder
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch

_HALF_PREFIXES = {
    "encoder": ("patch_embed", "to_code", "encoder_blocks"),
    "decoder": ("decoder_embed", "to_pixels", "decoder_blocks"),
}


def load_flat(path: str) -> Dict[str, object]:
    """Any supported artifact as a flat ``{name: tensor or array}`` dict."""
    if os.path.isdir(path):
        path = os.path.join(path, "state.pt")
    if path.endswith(".pt"):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        return dict(payload.get("params", payload))
    if path.endswith(".npz"):
        return dict(np.load(path))
    from safetensors.torch import load_file

    return load_file(path)


def expected_shapes(variant: str) -> Dict[str, tuple]:
    """The flat names and shapes a model variant holds (built on the meta
    device: nothing is allocated)."""
    from vitok_torch.models.ae import AE, AEConfig

    cfg = AEConfig.from_variant(variant)
    model = AE(**cfg.__dict__, device="meta", param_dtype=torch.float32)
    return {n: tuple(p.shape) for n, p in model.state_dict().items()}


def _nbytes(v) -> int:
    return v.numel() * v.element_size() if isinstance(v, torch.Tensor) else int(v.nbytes)


def cmd_keys(args) -> int:
    flat = load_flat(args.path)
    for name in sorted(flat):
        v = flat[name]
        print(f"{name:60s} {str(tuple(v.shape)):20s} {v.dtype}")
    print(f"-- {len(flat)} tensors")
    return 0


def cmd_summary(args) -> int:
    flat = load_flat(args.path)
    groups: Dict[str, tuple] = {}
    for name, v in flat.items():
        top = name.split(".")[0]
        n, b = groups.get(top, (0, 0))
        groups[top] = (n + int(np.prod(v.shape)), b + _nbytes(v))
    rows = {top: {"params": n, "mbytes": round(b / 1e6, 2)} for top, (n, b) in sorted(groups.items())}
    print(json.dumps({"total_params": sum(n for n, _ in groups.values()), "components": rows}, indent=2))
    return 0


def cmd_diff(args) -> int:
    flat = load_flat(args.path)
    want = expected_shapes(args.variant)
    if args.component in _HALF_PREFIXES:
        want = {k: v for k, v in want.items() if k.startswith(_HALF_PREFIXES[args.component])}
    ck, wk = set(flat), set(want)
    issues = 0
    for name in sorted(wk - ck):
        print(f"MISSING  {name:55s} want {want[name]}")
        issues += 1
    for name in sorted(ck - wk):
        print(f"EXTRA    {name:55s} have {tuple(flat[name].shape)}")
        issues += 1
    for name in sorted(ck & wk):
        have = tuple(flat[name].shape)
        if have != want[name]:
            print(f"SHAPE    {name:55s} have {have} want {want[name]}")
            issues += 1
    print(f"-- {issues} mismatches" if issues else "-- OK: shapes match")
    return 1 if issues else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    for mode, fn in (("keys", cmd_keys), ("summary", cmd_summary), ("diff", cmd_diff)):
        p = sub.add_parser(mode)
        p.add_argument("path", help="safetensors file, .npz, state.pt or a checkpoint directory")
        p.set_defaults(fn=fn)
        if mode == "diff":
            p.add_argument("--variant", required=True, help="model variant string, e.g. Ld4-Ld24/1x16x64")
            p.add_argument("--component", default="full", choices=("full", "encoder", "decoder"),
                           help="limit MISSING checks to one released half")
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
