"""FID/FDD feature extractors (port of ``vitok_tpu/eval_features.py``).

The reference contracts, on the port's own backbones:

* ``inception_feature_fn``: ``vitok_torch.models.inception`` (the FID
  variant of InceptionV3, pool 2048) at 299², bicubic-resized, clamped,
  mapped to [0, 1];
* ``dino_feature_fn``: the CLS token of a DINO ViT-B/16
  (``vitok_torch.models.vit_features``) at 512², bicubic-resized, clamped,
  ImageNet-normalised inside the ViT;
* ``random_projection_feature_fn``: a seeded random projection, weight-free,
  for pipeline tests and relative comparisons.

Every resize is one separable product per shape group on the weight matrices
of ``jax.image.resize`` (Keys cubic a = -0.5 or the triangle, antialiased when
downsampling, each output column normalised), computed here in numpy, in
fp32, then clamped to [-1, 1]. ``F.interpolate`` computes another function
(a = -0.75 bicubic, other edge weights), so it is not used. ``bucketed_resize``
groups images by a padded bucket shape instead of their exact shape, with
zero weight rows over the padding: the same numbers, fewer groups.

Weights load from local files (``VITOK_INCEPTION_WEIGHTS`` /
``VITOK_DINO_WEIGHTS`` or explicit paths); without them the backbones are
random from a seed, with a loud warning: such rFID/rFDD are relative numbers
only, not comparable to published ones.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from vitok_torch.utils.device import resolve_device

FeatureFn = Callable[[Sequence[torch.Tensor]], np.ndarray]

_BUCKET_QUANTUM = 256  # bucketed grouping pads H and W up to the next multiple


def _np_keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _np_triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


_NP_KERNELS = {
    "bicubic": _np_keys_cubic,
    "cubic": _np_keys_cubic,
    "bilinear": _np_triangle,
    "linear": _np_triangle,
    "triangle": _np_triangle,
}


@functools.lru_cache(maxsize=512)
def _resize_weights_np(in_size: int, out_size: int, method: str, pad_to: int):
    """[pad_to, out_size] f32 separable-resize weights, rows >= in_size zero.

    Mirrors ``jax.image.resize``'s ``compute_weight_mat`` (scale = out/in,
    translation 0, antialias=True) in float32 numpy: kernel stretched by
    1/scale when downsampling, per-output-column weight normalisation,
    out-of-range sample columns zeroed. The cached array is shared: callers
    copy it, never write to it.
    """
    kernel = _NP_KERNELS[method]
    scale = np.float32(out_size) / np.float32(in_size)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = kernel(x).astype(np.float32)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
        weights / np.where(total != 0, total, 1),
        0.0,
    )
    weights = np.where(
        ((sample_f >= -0.5) & (sample_f <= in_size - 0.5))[None, :],
        weights,
        0.0,
    ).astype(np.float32)
    out = np.zeros((pad_to, out_size), np.float32)
    out[:in_size] = weights
    return out


def _bucket_up(n: int) -> int:
    return max(_BUCKET_QUANTUM, -(-n // _BUCKET_QUANTUM) * _BUCKET_QUANTUM)


def separable_resize(x: torch.Tensor, wh: torch.Tensor, ww: torch.Tensor) -> torch.Tensor:
    """``[G, C, H, W]`` -> ``[G, C, Ho, Wo]``: ``wh [G|1, H, Ho]`` over rows,
    ``ww [G|1, W, Wo]`` over columns, in fp32. Differentiable in ``x``."""
    y = torch.matmul(x.float(), ww.unsqueeze(1))  # [G, C, H, Wo]
    return torch.matmul(wh.transpose(1, 2).unsqueeze(1), y)  # [G, C, Ho, Wo]


def resize_weights(in_size: int, out_size: int, method: str, device) -> torch.Tensor:
    """``[in_size, out_size]`` resize weights as an fp32 tensor on ``device``."""
    return torch.from_numpy(_resize_weights_np(in_size, out_size, method, in_size).copy()).to(device)


def resize_batch(
    images: Sequence[torch.Tensor], size: int, method: str = "bicubic", bucketed: bool = False
) -> torch.Tensor:
    """Resize + stack to ``[B, C, size, size]`` fp32, clamped to [-1, 1] (the
    reference resizes bicubic-antialias, then clamps).

    Images are grouped by shape (``bucketed``: by the bucket shape their H
    and W pad up to) and each group is one separable product, so a batch
    costs one call per group, not one per image. The output is on the first
    image's device.
    """
    if method not in _NP_KERNELS:
        raise ValueError(f"unknown resize method {method!r}; use one of {sorted(_NP_KERNELS)}")
    device = images[0].device
    groups: Dict[tuple, list] = {}
    for i, img in enumerate(images):
        c, h, w = img.shape
        key = (c, _bucket_up(h), _bucket_up(w)) if bucketed else (c, h, w)
        groups.setdefault(key, []).append(i)
    out = torch.empty((len(images), images[0].shape[0], size, size), dtype=torch.float32, device=device)
    for (c, hp, wp), idx in groups.items():
        x = torch.zeros((len(idx), c, hp, wp), dtype=torch.float32, device=device)
        for k, i in enumerate(idx):
            _, h, w = images[i].shape
            x[k, :, :h, :w] = images[i].to(device)
        wh = np.stack([_resize_weights_np(images[i].shape[1], size, method, hp) for i in idx])
        ww = np.stack([_resize_weights_np(images[i].shape[2], size, method, wp) for i in idx])
        y = separable_resize(x, torch.from_numpy(wh).to(device), torch.from_numpy(ww).to(device))
        out[torch.as_tensor(idx, device=device)] = y.clamp(-1.0, 1.0)
    return out


def random_projection_feature_fn(
    dim: int = 192, size: int = 64, seed: int = 0, bucketed_resize: bool = False
) -> FeatureFn:
    """Deterministic random-projection features (weight-free test backbone):
    the JAX package's ``np.random.default_rng(seed)`` projection, applied on
    the images' device. As there, the projection is fp64 (fp32 draws
    divided by an fp64 scale) and so is the product."""
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((3 * size * size, dim)).astype(np.float32) / np.sqrt(3 * size * size)
    on_device: Dict[torch.device, torch.Tensor] = {}

    def fn(images: Sequence[torch.Tensor]) -> np.ndarray:
        batch = resize_batch(images, size, method="bilinear", bucketed=bucketed_resize)
        p = on_device.get(batch.device)
        if p is None:
            p = on_device[batch.device] = torch.from_numpy(proj).to(batch.device)
        return (batch.reshape(batch.shape[0], -1).double() @ p).cpu().numpy()

    return fn


def inception_feature_fn(
    weights: Optional[str] = None,
    size: int = 299,
    bucketed_resize: bool = False,
    device="cuda",
) -> FeatureFn:
    """pytorch_fid-contract InceptionV3 pool-2048 features.

    ``weights``: a pytorch_fid ``pt_inception-2015-12-05`` state-dict path
    (else ``$VITOK_INCEPTION_WEIGHTS``, else a random init with a warning).
    Feed: 299² bicubic, clamp, [0, 1], no normalisation. The network runs
    on ``device`` in fp32.
    """
    from vitok_torch.models.inception import load_inception

    device = resolve_device(device)
    model = load_inception(weights or os.environ.get("VITOK_INCEPTION_WEIGHTS"), device=device)

    @torch.no_grad()
    def fn(images: Sequence[torch.Tensor]) -> np.ndarray:
        batch = resize_batch([img.to(device) for img in images], size, bucketed=bucketed_resize)
        return model((batch + 1.0) / 2.0).cpu().numpy()

    return fn


def dino_feature_fn(
    weights: Optional[str] = None,
    size: int = 512,
    model_size: str = "B",
    bucketed_resize: bool = False,
    device="cuda",
) -> FeatureFn:
    """Reference-contract FDD features: the CLS token of DINO ViT-B/16 at
    512², after a bicubic resize and clamp (``DINOModel(model_size='B',
    target_size=512)``). ``weights``: a timm-named state dict (else
    ``$VITOK_DINO_WEIGHTS``, else a random init with a warning). fp32 on
    ``device``."""
    from vitok_torch.models.vit_features import load_dino_backbone, make_dino_feature_fn

    device = resolve_device(device)
    model = load_dino_backbone(weights or os.environ.get("VITOK_DINO_WEIGHTS"), size=model_size, device=device)
    feat = make_dino_feature_fn(model)

    @torch.no_grad()
    def fn(images: Sequence[torch.Tensor]) -> np.ndarray:
        batch = resize_batch([img.to(device) for img in images], size, bucketed=bucketed_resize)
        return feat(batch)[:, 0].cpu().numpy()  # CLS

    return fn


__all__ = [
    "resize_batch",
    "separable_resize",
    "resize_weights",
    "random_projection_feature_fn",
    "inception_feature_fn",
    "dino_feature_fn",
]
