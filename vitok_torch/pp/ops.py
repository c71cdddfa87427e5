"""NaFlex preprocessing ops: host (PIL/numpy) transforms and tensor (un)patchify.

Port of ``vitok_tpu/pp/ops.py``. Host ops run in the input pipeline and
produce numpy patch dicts with static ``max_tokens`` padding; ``unpatchify``
and ``sample_tiles`` run on tensors wherever the model output lives. Every
factory ``op(args) -> callable`` composes in the pp-string DSL
(``pp/registry.py``). The random host ops (``random_resized_crop``, ``flip``,
``random_choice``) draw from Python's ``random`` module in the same order as
the JAX package's, so one ``random.seed`` gives both the same augmentations.
"""

from __future__ import annotations

import math
import random as _random
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image


def resize_longest_side(max_size: int):
    """Lanczos downscale so the longest side is at most ``max_size``."""

    def _resize(img):
        w, h = img.size
        if max(h, w) <= max_size:
            return img
        scale = max_size / max(h, w)
        return img.resize((int(round(w * scale)), int(round(h * scale))), resample=Image.LANCZOS)

    return _resize


def center_crop(size: int):
    """ADM-style center crop: iterated 2x BOX downsample, BICUBIC, crop."""

    def _center_crop(img):
        while min(*img.size) >= 2 * size:
            img = img.resize(tuple(x // 2 for x in img.size), resample=Image.BOX)
        scale = size / min(*img.size)
        img = img.resize(tuple(round(x * scale) for x in img.size), resample=Image.BICUBIC)
        arr = np.array(img)
        cy = (arr.shape[0] - size) // 2
        cx = (arr.shape[1] - size) // 2
        return Image.fromarray(arr[cy : cy + size, cx : cx + size])

    return _center_crop


def random_resized_crop(
    size: int,
    scale: Tuple[float, float] = (0.8, 1.0),
    ratio: Tuple[float, float] = (0.75, 1.333),
):
    """Random resized crop (ImageNet-style augmentation), Lanczos resample."""

    def _rrc(img):
        w, h = img.size
        area = w * h
        for _ in range(10):
            target_area = area * _random.uniform(*scale)
            log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
            aspect = math.exp(_random.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                x0 = _random.randint(0, w - cw)
                y0 = _random.randint(0, h - ch)
                img = img.crop((x0, y0, x0 + cw, y0 + ch))
                return img.resize((size, size), resample=Image.LANCZOS)
        # Fallback: center crop to the limiting aspect, then resize.
        in_ratio = w / h
        if in_ratio < ratio[0]:
            cw, ch = w, int(round(w / ratio[0]))
        elif in_ratio > ratio[1]:
            cw, ch = int(round(h * ratio[1])), h
        else:
            cw, ch = w, h
        x0, y0 = (w - cw) // 2, (h - ch) // 2
        img = img.crop((x0, y0, x0 + cw, y0 + ch))
        return img.resize((size, size), resample=Image.LANCZOS)

    return _rrc


def flip(p: float = 0.5):
    """Random horizontal flip with probability p."""

    def _flip(img):
        if _random.random() < p:
            return img.transpose(Image.FLIP_LEFT_RIGHT)
        return img

    return _flip


def identity() -> Callable:
    return lambda x: x


def random_choice(ops: Sequence[str], probs: Sequence[float]) -> Callable:
    """Randomly apply one of several op-spec strings (recursively parsed)."""
    if not ops:
        raise ValueError("ops cannot be empty")
    if len(ops) != len(probs):
        raise ValueError(f"ops and probs must have same length: {len(ops)} != {len(probs)}")
    from vitok_torch.pp.registry import parse_op_spec

    resolved = [parse_op_spec(op).build() for op in ops]

    def _random_choice(x):
        idx = _random.choices(range(len(resolved)), weights=probs, k=1)[0]
        return resolved[idx](x)

    return _random_choice


def to_tensor():
    """PIL image -> float32 numpy array, CHW, range [0, 1]."""

    def _to_tensor(img):
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return np.ascontiguousarray(arr.transpose(2, 0, 1))

    return _to_tensor


_NORM_STATS = {
    "minus_one_to_one": ([0.5, 0.5, 0.5], [0.5, 0.5, 0.5]),
    "imagenet": ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
}


def normalize(mode: str = "minus_one_to_one"):
    """Normalize a [0,1] CHW array: ``minus_one_to_one``, ``imagenet`` or ``zero_to_one``."""
    if mode == "zero_to_one":
        return lambda x: x
    if mode not in _NORM_STATS:
        raise ValueError(
            f"Unknown normalize mode: '{mode}'. Use 'minus_one_to_one', 'imagenet', or 'zero_to_one'"
        )
    mean, std = _NORM_STATS[mode]
    mean = np.asarray(mean, np.float32)[:, None, None]
    std = np.asarray(std, np.float32)[:, None, None]
    return lambda x: (x - mean) / std


def fit_to_token_budget(
    h: int, w: int, patch: int, max_tokens: int, eps: float = 1e-5
) -> Tuple[int, int]:
    """Largest ``(h', w') <= (h, w)`` with ``ceil(h'/P) * ceil(w'/P) <= max_tokens``."""
    h_p = math.ceil(h / patch)
    w_p = math.ceil(w / patch)
    if h_p * w_p <= max_tokens:
        return h, w
    scale = math.sqrt(max_tokens / (h_p * w_p))
    new_h_p = max(1, math.floor(h_p * scale + eps))
    new_w_p = max(1, math.floor(w_p * scale + eps))
    return min(new_h_p * patch, h), min(new_w_p * patch, w)


def _resize_chw_bicubic(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Bicubic resize of a float CHW array via PIL (per channel, fp32)."""
    out = np.empty((img.shape[0], th, tw), np.float32)
    for i in range(img.shape[0]):
        ch = Image.fromarray(img[i].astype(np.float32), mode="F")
        out[i] = np.asarray(ch.resize((tw, th), resample=Image.BICUBIC))
    return out


def resize_to_token_budget(patch: int, max_tokens: int):
    """Resize a CHW array so its patch grid fits the token budget."""

    def _resize(img: np.ndarray) -> np.ndarray:
        _, h, w = img.shape
        th, tw = fit_to_token_budget(h, w, patch, max_tokens)
        if (th, tw) != (h, w):
            img = _resize_chw_bicubic(img, th, tw)
        return img

    return _resize


def patchify_array(img: np.ndarray, patch: int, max_tokens: int) -> dict:
    """Patchify one CHW image into a NaFlex patch dict (numpy, host-side).

    Row-major patch order; pixel ``(c, py, px)`` of a patch at index
    ``c*P*P + py*P + px``. Padding tokens form a tail suffix.
    """
    c, h, w = img.shape
    orig_h, orig_w = h, w
    pad_h = (patch - h % patch) % patch
    pad_w = (patch - w % patch) % patch
    if pad_h or pad_w:
        img = np.pad(img, ((0, 0), (0, pad_h), (0, pad_w)))
    gr, gc = img.shape[1] // patch, img.shape[2] // patch
    n = gr * gc
    if n > max_tokens:
        raise ValueError(
            f"Image produces {n} patches > max_tokens={max_tokens}; "
            "compose with resize_to_token_budget first"
        )
    patches = img.reshape(c, gr, patch, gc, patch).transpose(1, 3, 0, 2, 4).reshape(n, -1)
    patches_full = np.zeros((max_tokens, c * patch * patch), np.float32)
    patches_full[:n] = patches
    patch_mask = np.zeros((max_tokens,), bool)
    patch_mask[:n] = True
    yy, xx = np.meshgrid(np.arange(gr), np.arange(gc), indexing="ij")
    row_idx = np.zeros((max_tokens,), np.int32)
    col_idx = np.zeros((max_tokens,), np.int32)
    row_idx[:n] = yy.ravel()
    col_idx[:n] = xx.ravel()
    return {
        "patches": patches_full,
        "patch_mask": patch_mask,
        "row_idx": row_idx,
        "col_idx": col_idx,
        "time_idx": np.zeros((max_tokens,), np.int32),
        "orig_height": np.int32(orig_h),
        "orig_width": np.int32(orig_w),
        "grid_rows": np.int32(gr),
        "grid_cols": np.int32(gc),
    }


def patchify(patch: int = 16, max_tokens: int = 256):
    """Factory: CHW array -> patch dict (no resize; compose with the budget op)."""

    def _patchify(img: np.ndarray) -> dict:
        return patchify_array(np.asarray(img, np.float32), patch, max_tokens)

    return _patchify


def patchify_image(images: torch.Tensor, patch: int = 16) -> dict:
    """Batched patchify of fixed-size images ``[B, C, H, W]`` (H, W multiples
    of ``patch``) on their own device: every token valid, no padding."""
    b, c, h, w = images.shape
    gr, gc = h // patch, w // patch
    n = gr * gc
    dev = images.device
    patches = (
        images.reshape(b, c, gr, patch, gc, patch).permute(0, 2, 4, 1, 3, 5).reshape(b, n, -1)
    )
    yy, xx = torch.meshgrid(torch.arange(gr, device=dev), torch.arange(gc, device=dev), indexing="ij")
    tile = lambda a: a.reshape(1, n).expand(b, n).to(torch.int32).contiguous()
    full = lambda v: torch.full((b,), v, dtype=torch.int32, device=dev)
    return {
        "patches": patches,
        "patch_mask": torch.ones((b, n), dtype=torch.bool, device=dev),
        "row_idx": tile(yy),
        "col_idx": tile(xx),
        "time_idx": torch.zeros((b, n), dtype=torch.int32, device=dev),
        "orig_height": full(h),
        "orig_width": full(w),
        "grid_rows": full(gr),
        "grid_cols": full(gc),
    }


def _unpatchify_dense(patches, grid_rows, grid_cols, patch):
    """Reshape-only inverse when valid patches are a dense row-major grid."""
    b = patches.shape[0]
    n = grid_rows * grid_cols
    c = patches.shape[-1] // (patch * patch)
    x = patches[:, :n].reshape(b, grid_rows, grid_cols, c, patch, patch)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(b, c, grid_rows * patch, grid_cols * patch)


def _host_ints(v) -> np.ndarray:
    return torch.as_tensor(v).cpu().numpy().reshape(-1)


def unpatchify(patch_dict: dict, patch: int = 16, max_grid_size: Optional[int] = None) -> torch.Tensor:
    """Patch dict -> images ``[B, C, maxY*P, maxX*P]`` on the patches' device.

    One grid shape across the batch is a pure reshape; mixed grids scatter
    each valid token to ``row * max_x + col`` (``scatter_add_`` in place of
    the JAX ``.at[].add``; masked tokens land in a trash cell that is
    dropped). The grid size comes from the metadata or ``max_grid_size``.
    """
    patches = torch.as_tensor(patch_dict["patches"])
    dev = patches.device
    mask = torch.as_tensor(patch_dict["patch_mask"], device=dev).bool()
    row = torch.as_tensor(patch_dict["row_idx"], device=dev).long()
    col = torch.as_tensor(patch_dict["col_idx"], device=dev).long()
    b, n, dim = patches.shape
    c = dim // (patch * patch)
    masked = torch.where(mask[..., None], patches, torch.zeros((), dtype=patches.dtype, device=dev))

    if max_grid_size is not None:
        max_y = max_x = int(max_grid_size)
    elif patch_dict.get("grid_rows") is not None and patch_dict.get("grid_cols") is not None:
        gr, gc = _host_ints(patch_dict["grid_rows"]), _host_ints(patch_dict["grid_cols"])
        max_y, max_x = int(gr.max()), int(gc.max())
        if (gr == gr[0]).all() and (gc == gc[0]).all():
            return _unpatchify_dense(masked, int(gr[0]), int(gc[0]), patch)
    else:
        valid = mask.cpu().numpy()
        max_y = int(row.cpu().numpy()[valid].max()) + 1
        max_x = int(col.cpu().numpy()[valid].max()) + 1

    cells = max_y * max_x
    flat_idx = torch.where(mask, row * max_x + col, torch.full_like(row, cells))
    grid = torch.zeros((b, cells + 1, dim), dtype=patches.dtype, device=dev)
    grid.scatter_add_(1, flat_idx[..., None].expand(b, n, dim), masked)
    x = grid[:, :cells].reshape(b, max_y, max_x, c, patch, patch)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(b, c, max_y * patch, max_x * patch)


def unpack(images, orig_h, orig_w) -> List[torch.Tensor]:
    """Crop each image of the batch back to its original size, on the host."""
    images = torch.as_tensor(images).cpu()
    if images.ndim == 3:
        images = images[None]
    hs, ws = _host_ints(orig_h), _host_ints(orig_w)
    return [img[:, : int(h), : int(w)] for img, h, w in zip(images, hs, ws)]


def sample_tile_indices(
    orig_h: torch.Tensor,
    orig_w: torch.Tensor,
    n_tiles: int = 2,
    tile_size: Tuple[int, int] = (256, 256),
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image tile origins ``(start_y, start_x)``, each ``[B, n_tiles]``
    int32, uniform over the origins that keep a tile inside the image:
    ``floor(U * (max(size - tile, 0) + 1))``. The uniforms come from
    ``generator`` (a generator seeded with 0 when None), drawn on the
    generator's device."""
    orig_h, orig_w = torch.as_tensor(orig_h), torch.as_tensor(orig_w)
    b, dev = orig_h.shape[0], orig_h.device
    th, tw = tile_size
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    max_sy = (orig_h.float() - th).clamp(min=0)
    max_sx = (orig_w.float() - tw).clamp(min=0)
    r_y = torch.rand((b, n_tiles), generator=generator, device=generator.device).to(dev)
    r_x = torch.rand((b, n_tiles), generator=generator, device=generator.device).to(dev)
    start_y = torch.floor(r_y * (max_sy[:, None] + 1)).to(torch.int32)
    start_x = torch.floor(r_x * (max_sx[:, None] + 1)).to(torch.int32)
    return start_y, start_x


def sample_tiles(
    images: torch.Tensor,
    orig_h: torch.Tensor,
    orig_w: torch.Tensor,
    n_tiles: int = 2,
    tile_size: Tuple[int, int] = (256, 256),
    indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Random tiles of each image for the perceptual-style losses.

    Images smaller than a tile are padded with -1.0 on the bottom and right;
    origins are clipped so every tile lies inside. Passing the returned
    ``indices`` crops a second tensor at the same places. Each tile is a
    slice (the origins are read back to the host once per call), so
    gradients flow back into ``images`` without a scatter.

    Returns tiles ``[B, n_tiles, C, th, tw]`` and ``(start_y, start_x)``.
    """
    b, c, h, w = images.shape
    th, tw = tile_size
    pad_h, pad_w = max(th - h, 0), max(tw - w, 0)
    if pad_h or pad_w:
        images = torch.nn.functional.pad(images, (0, pad_w, 0, pad_h), value=-1.0)
    ph, pw = images.shape[2], images.shape[3]
    if indices is None:
        start_y, start_x = sample_tile_indices(
            orig_h, orig_w, n_tiles=n_tiles, tile_size=tile_size, generator=generator)
    else:
        start_y, start_x = indices
    start_y = torch.as_tensor(start_y).to(torch.int32).clamp(0, ph - th)
    start_x = torch.as_tensor(start_x).to(torch.int32).clamp(0, pw - tw)
    origins = torch.stack([start_y, start_x], -1).tolist()
    tiles = torch.stack([
        torch.stack([images[i, :, sy:sy + th, sx:sx + tw] for sy, sx in per_image])
        for i, per_image in enumerate(origins)
    ])
    return tiles, (start_y, start_x)


OPS = {
    "center_crop": center_crop,
    "random_resized_crop": random_resized_crop,
    "resize_longest_side": resize_longest_side,
    "resize_to_token_budget": resize_to_token_budget,
    "flip": flip,
    "identity": identity,
    "random_choice": random_choice,
    "to_tensor": to_tensor,
    "normalize": normalize,
    "patchify": patchify,
}


__all__ = [
    "center_crop",
    "random_resized_crop",
    "flip",
    "random_choice",
    "sample_tile_indices",
    "sample_tiles",
    "resize_longest_side",
    "resize_to_token_budget",
    "fit_to_token_budget",
    "identity",
    "to_tensor",
    "normalize",
    "patchify",
    "patchify_array",
    "patchify_image",
    "unpatchify",
    "unpack",
    "OPS",
]
