"""InceptionV3, pytorch_fid's FID variant, for rFID features (port of
``vitok_tpu/models/inception.py``).

The network is built from the same declarative table (``INCEPTION_LAYOUT``)
as the JAX package's, in NCHW:

* each unit is one convolution with BatchNorm (eps 1e-3) folded into its
  weight and bias, then a ReLU, in fp32;
* max pools pad with -inf;
* every in-block average pool has ``count_include_pad=False`` (pytorch_fid's
  FIDInceptionA/C/E_1 patch);
* the last InceptionE block (Mixed_7c) pools its pool branch with a max
  pool where torchvision has an average pool (the FIDInceptionE_2 patch);
* the output is the global mean, ``[B, 2048]``.

Weights load from a pytorch_fid/torchvision-named ``state_dict`` (the
published FID weights are the ``pt_inception-2015-12-05`` checkpoint),
folded by :func:`fold_inception_state`. Without weights the network is
random from a seeded ``torch.Generator``, with a warning: such features are
NOT comparable to published rFID.

Input contract: images resized to 299² bicubic-antialias, clamped to
[-1, 1], then mapped to [0, 1], and fed with no further normalisation.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vitok_torch.utils.device import resolve_device

BN_EPS = 1e-3

# ---------------------------------------------------------------------------
# Declarative topology (the JAX package's table)
# ---------------------------------------------------------------------------
# Each unit: ("conv", name, out_ch, (kh, kw), (sh, sw), (ph, pw)).
# Branch = tuple of units applied sequentially.
# Block = ("block", name, (branch, ...)) — branch outputs concat on channels.
# Pool entries: ("maxpool", (k, s, p)) / ("avgpool_nip", (k, s, p)) where
# _nip = count_include_pad=False (the pytorch_fid patch).

Conv = Tuple[str, str, int, Tuple[int, int], Tuple[int, int], Tuple[int, int]]


def _c(name: str, out: int, k, s=1, p=0) -> Conv:
    k = (k, k) if isinstance(k, int) else k
    s = (s, s) if isinstance(s, int) else s
    p = (p, p) if isinstance(p, int) else p
    return ("conv", name, out, k, s, p)


def _inception_a(pool_features: int):
    return (
        (_c("branch1x1", 64, 1),),
        (_c("branch5x5_1", 48, 1), _c("branch5x5_2", 64, 5, 1, 2)),
        (
            _c("branch3x3dbl_1", 64, 1),
            _c("branch3x3dbl_2", 96, 3, 1, 1),
            _c("branch3x3dbl_3", 96, 3, 1, 1),
        ),
        (("avgpool_nip", (3, 1, 1)), _c("branch_pool", pool_features, 1)),
    )


def _inception_b():
    return (
        (_c("branch3x3", 384, 3, 2, 0),),
        (
            _c("branch3x3dbl_1", 64, 1),
            _c("branch3x3dbl_2", 96, 3, 1, 1),
            _c("branch3x3dbl_3", 96, 3, 2, 0),
        ),
        (("maxpool", (3, 2, 0)),),
    )


def _inception_c(c7: int):
    return (
        (_c("branch1x1", 192, 1),),
        (
            _c("branch7x7_1", c7, 1),
            _c("branch7x7_2", c7, (1, 7), 1, (0, 3)),
            _c("branch7x7_3", 192, (7, 1), 1, (3, 0)),
        ),
        (
            _c("branch7x7dbl_1", c7, 1),
            _c("branch7x7dbl_2", c7, (7, 1), 1, (3, 0)),
            _c("branch7x7dbl_3", c7, (1, 7), 1, (0, 3)),
            _c("branch7x7dbl_4", c7, (7, 1), 1, (3, 0)),
            _c("branch7x7dbl_5", 192, (1, 7), 1, (0, 3)),
        ),
        (("avgpool_nip", (3, 1, 1)), _c("branch_pool", 192, 1)),
    )


def _inception_d():
    return (
        (_c("branch3x3_1", 192, 1), _c("branch3x3_2", 320, 3, 2, 0)),
        (
            _c("branch7x7x3_1", 192, 1),
            _c("branch7x7x3_2", 192, (1, 7), 1, (0, 3)),
            _c("branch7x7x3_3", 192, (7, 1), 1, (3, 0)),
            _c("branch7x7x3_4", 192, 3, 2, 0),
        ),
        (("maxpool", (3, 2, 0)),),
    )


def _inception_e(last: bool):
    # torchvision's InceptionE has a forking 3x3 branch: a stem, then two
    # parallel tails concatenated.
    pool = ("maxpool", (3, 1, 1)) if last else ("avgpool_nip", (3, 1, 1))
    return (
        (_c("branch1x1", 320, 1),),
        (
            _c("branch3x3_1", 384, 1),
            (
                "fork",
                (_c("branch3x3_2a", 384, (1, 3), 1, (0, 1)),),
                (_c("branch3x3_2b", 384, (3, 1), 1, (1, 0)),),
            ),
        ),
        (
            _c("branch3x3dbl_1", 448, 1),
            _c("branch3x3dbl_2", 384, 3, 1, 1),
            (
                "fork",
                (_c("branch3x3dbl_3a", 384, (1, 3), 1, (0, 1)),),
                (_c("branch3x3dbl_3b", 384, (3, 1), 1, (1, 0)),),
            ),
        ),
        (pool, _c("branch_pool", 192, 1)),
    )


# (kind, name, payload); kinds: "conv" (stem BasicConv2d), "maxpool",
# "block" (inception module).
INCEPTION_LAYOUT: List[Tuple] = [
    ("conv", "Conv2d_1a_3x3", _c("", 32, 3, 2, 0)),
    ("conv", "Conv2d_2a_3x3", _c("", 32, 3, 1, 0)),
    ("conv", "Conv2d_2b_3x3", _c("", 64, 3, 1, 1)),
    ("maxpool", "", (3, 2, 0)),
    ("conv", "Conv2d_3b_1x1", _c("", 80, 1, 1, 0)),
    ("conv", "Conv2d_4a_3x3", _c("", 192, 3, 1, 0)),
    ("maxpool", "", (3, 2, 0)),
    ("block", "Mixed_5b", _inception_a(32)),
    ("block", "Mixed_5c", _inception_a(64)),
    ("block", "Mixed_5d", _inception_a(64)),
    ("block", "Mixed_6a", _inception_b()),
    ("block", "Mixed_6b", _inception_c(128)),
    ("block", "Mixed_6c", _inception_c(160)),
    ("block", "Mixed_6d", _inception_c(160)),
    ("block", "Mixed_6e", _inception_c(192)),
    ("block", "Mixed_7a", _inception_d()),
    ("block", "Mixed_7b", _inception_e(last=False)),
    ("block", "Mixed_7c", _inception_e(last=True)),
]

POOL_DIM = 2048


def _iter_convs() -> List[Tuple[str, Conv]]:
    """Flat (param_name, conv_spec) traversal in layout order."""
    out = []
    for kind, name, payload in INCEPTION_LAYOUT:
        if kind == "conv":
            out.append((name, payload))
        elif kind == "block":
            for branch in payload:
                for unit in branch:
                    if unit[0] == "conv":
                        out.append((f"{name}.{unit[1]}", unit))
                    elif unit[0] == "fork":
                        for tail in unit[1:]:
                            for u in tail:
                                out.append((f"{name}.{u[1]}", u))
    return out


def _infer_in_channels() -> Dict[str, int]:
    """Input channel count of every conv, derived from the layout table."""
    chans: Dict[str, int] = {}
    c = 3
    for kind, name, payload in INCEPTION_LAYOUT:
        if kind == "conv":
            chans[name] = c
            c = payload[2]
        elif kind == "maxpool":
            continue
        elif kind == "block":
            out_total = 0
            for branch in payload:
                bc = c
                for unit in branch:
                    if unit[0] == "conv":
                        chans[f"{name}.{unit[1]}"] = bc
                        bc = unit[2]
                    elif unit[0] == "fork":
                        fork_out = 0
                        for tail in unit[1:]:
                            tc = bc
                            for u in tail:
                                chans[f"{name}.{u[1]}"] = tc
                                tc = u[2]
                            fork_out += tc
                        bc = fork_out
                    # pools keep channel count
                out_total += bc
            c = out_total
    return chans


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------


class InceptionV3(nn.Module):
    """FID InceptionV3 with BN folded: ``[B, 3, H, W]`` in [0, 1] -> ``[B, 2048]``.

    Each conv of the table is an ``nn.Conv2d`` with a bias, reached as
    ``getattr(self, block).<conv>`` (state-dict names such as
    ``Mixed_5b.branch1x1.weight``). Weights are random from ``seed`` (a CPU
    ``torch.Generator``, so the same on every device) unless a folded
    ``state_dict`` is given. Parameters require no grad.
    """

    def __init__(self, state_dict: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        chans = _infer_in_channels()
        for pname, spec in _iter_convs():
            _, _, out_ch, k, s, p = spec
            conv = nn.Conv2d(chans[pname], out_ch, k, stride=s, padding=p, bias=True, device="meta")
            parent = self
            *path, leaf = pname.split(".")
            for part in path:
                if not hasattr(parent, part):
                    parent.add_module(part, nn.Module())
                parent = getattr(parent, part)
            parent.add_module(leaf, conv)
        self.to_empty(device=device)  # built on the meta device: no init is drawn and thrown away
        self.requires_grad_(False)
        if state_dict is None:
            self._init_weights(seed)
        else:
            self.load_state_dict(state_dict)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        """Weights ~ N(0, 1 / fan_in), biases 0: the JAX package's random
        init's distribution, drawn from a torch generator."""
        gen = torch.Generator().manual_seed(seed)
        for pname, _ in _iter_convs():
            conv = self.conv(pname)
            o, i, kh, kw = conv.weight.shape
            w = torch.randn((o, i, kh, kw), generator=gen) / np.sqrt(kh * kw * i)
            conv.weight.copy_(w)
            conv.bias.zero_()

    def conv(self, pname: str) -> nn.Conv2d:
        return self.get_submodule(pname)

    def _unit(self, x: torch.Tensor, prefix: str, unit) -> torch.Tensor:
        if unit[0] == "conv":
            return F.relu(self.conv(f"{prefix}.{unit[1]}" if prefix else unit[1])(x))
        if unit[0] == "maxpool":
            k, s, p = unit[1]
            return F.max_pool2d(x, k, s, p)  # pads with -inf
        if unit[0] == "avgpool_nip":
            k, s, p = unit[1]
            return F.avg_pool2d(x, k, s, p, count_include_pad=False)
        if unit[0] == "fork":
            outs = []
            for tail in unit[1:]:
                y = x
                for u in tail:
                    y = self._unit(y, prefix, u)
                outs.append(y)
            return torch.cat(outs, dim=1)
        raise ValueError(unit[0])

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """``[B, 3, H, W]`` in [0, 1] -> pool features ``[B, 2048]`` (fp32)."""
        x = images.float()
        for kind, name, payload in INCEPTION_LAYOUT:
            if kind == "conv":
                x = F.relu(self.conv(name)(x))
            elif kind == "maxpool":
                x = F.max_pool2d(x, *payload)
            else:
                outs = []
                for branch in payload:
                    y = x
                    for unit in branch:
                        y = self._unit(y, name, unit)
                    outs.append(y)
                x = torch.cat(outs, dim=1)
        return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# pytorch_fid state dicts (BN folded)
# ---------------------------------------------------------------------------


def fold_inception_state(state: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """pytorch_fid/torchvision ``state_dict`` -> :class:`InceptionV3`'s.

    Reads ``{conv}.conv.weight`` and ``{conv}.bn.{weight,bias,running_mean,
    running_var}`` (torch tensors or numpy arrays) and folds BN (eps 1e-3)
    into each conv's weight and bias, in fp64, stored as fp32.
    """

    def get(name):
        t = state[name]
        return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t, np.float64)

    out: Dict[str, torch.Tensor] = {}
    for pname, _ in _iter_convs():
        w = get(f"{pname}.conv.weight")  # [O, I, kh, kw]
        scale = get(f"{pname}.bn.weight") / np.sqrt(get(f"{pname}.bn.running_var") + BN_EPS)
        out[f"{pname}.weight"] = torch.from_numpy((w * scale[:, None, None, None]).astype(np.float32))
        out[f"{pname}.bias"] = torch.from_numpy(
            (get(f"{pname}.bn.bias") - get(f"{pname}.bn.running_mean") * scale).astype(np.float32))
    return out


def load_inception(weights: Optional[str] = None, device="cuda") -> InceptionV3:
    """The FID InceptionV3 on ``device``, in eval mode.

    ``weights``: a local ``pt_inception-2015-12-05``-style state dict
    (``.pth``) or ``.safetensors`` with pytorch_fid names; ``None`` draws
    random weights from seed 0 (architecture smoke only: NOT comparable
    to published rFID numbers).
    """
    if weights is None:
        import warnings

        warnings.warn(
            "FID-Inception weights not provided; using random init. "
            "rFID values will NOT be comparable to published numbers.",
            stacklevel=2,
        )
        return InceptionV3(device=device)
    if weights.endswith(".safetensors"):
        from safetensors.torch import load_file

        state = load_file(weights)
    else:
        state = torch.load(weights, map_location="cpu", weights_only=True)
        if isinstance(state, dict) and "state_dict" in state:
            state = state["state_dict"]
    return InceptionV3(state_dict=fold_inception_state(state), device=device)


__all__ = [
    "INCEPTION_LAYOUT",
    "POOL_DIM",
    "BN_EPS",
    "InceptionV3",
    "fold_inception_state",
    "load_inception",
]
