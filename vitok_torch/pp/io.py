"""High-level preprocess/postprocess (port of ``vitok_tpu/pp/io.py``).

PIL images -> batched NaFlex patch dict of tensors on the device (host
transform and collate, then one copy per array); model output -> images
(unpatchify, format conversion, crop back to the original sizes).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from vitok_torch.pp.ops import unpack, unpatchify
from vitok_torch.pp.registry import build_transform
from vitok_torch.utils.device import resolve_device

DEFAULT_PP = "to_tensor|normalize(minus_one_to_one)|patchify(16, 256)"


def patch_collate_fn(batch: List[dict]) -> Dict[str, object]:
    """Stack a list of per-sample patch dicts into numpy arrays; scalars
    become 1-D arrays and other values pass through as lists."""
    out: Dict[str, object] = {}
    for k in batch[0]:
        vals = [b[k] for b in batch]
        v0 = vals[0]
        if isinstance(v0, np.ndarray) or np.isscalar(v0) or isinstance(
            v0, (int, float, np.integer, np.floating, np.bool_)
        ):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals
    return out


def preprocess(images, pp: str = DEFAULT_PP, device="cuda") -> Dict[str, object]:
    """Preprocess PIL image(s) into a batched patch dict of tensors on ``device``."""
    if not isinstance(images, (list, tuple)):
        images = [images]
    device = resolve_device(device)
    batched = patch_collate_fn([build_transform(pp)(img) for img in images])
    return {
        k: (torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v)
        for k, v in batched.items()
    }


def postprocess(
    output,
    output_format: str = "minus_one_to_one",
    current_format: str = "minus_one_to_one",
    do_unpack: bool = True,
    patch: int = 16,
    max_grid_size: Optional[int] = None,
):
    """Model output (patch dict or image tensor) -> images.

    Returns ``[B, C, H, W]``, or with ``do_unpack=True`` and a patch dict a
    list of per-image host tensors cropped to their original sizes.
    """
    if not isinstance(output, dict):
        return _convert_format(torch.as_tensor(output), current_format, output_format)
    images = _convert_format(
        unpatchify(output, patch=patch, max_grid_size=max_grid_size), current_format, output_format
    )
    if do_unpack:
        orig_h, orig_w = output.get("orig_height"), output.get("orig_width")
        if orig_h is None or orig_w is None:
            raise ValueError("do_unpack=True requires 'orig_height' and 'orig_width' in output")
        return unpack(images, orig_h, orig_w)
    return images


def _convert_format(images: torch.Tensor, from_format: str, to_format: str) -> torch.Tensor:
    """Convert between image value ranges, clamping interpolation overshoot."""
    if from_format == to_format:
        return images
    if to_format == "minus_one_to_one":
        if from_format == "0_255":
            result = images.float() / 127.5 - 1.0
        elif from_format == "zero_to_one":
            result = images * 2.0 - 1.0
        else:
            return images
        return result.clamp(-1.0, 1.0)
    if to_format == "zero_to_one":
        if from_format == "0_255":
            result = images.float() / 255.0
        elif from_format == "minus_one_to_one":
            result = (images + 1.0) / 2.0
        else:
            return images
        return result.clamp(0.0, 1.0)
    if to_format == "0_255":
        if from_format == "minus_one_to_one":
            return torch.round((images.clamp(-1.0, 1.0) + 1.0) / 2.0 * 255).to(torch.uint8)
        if from_format == "zero_to_one":
            return torch.round(images.clamp(0.0, 1.0) * 255).to(torch.uint8)
    return images


# The JAX package's (and the reference module's) aliases.
preprocess_images = preprocess
postprocess_images = postprocess

__all__ = ["preprocess", "postprocess", "patch_collate_fn", "DEFAULT_PP", "preprocess_images", "postprocess_images"]
