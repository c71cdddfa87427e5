"""2D rotary position embeddings as plain tensor functions.

Same conventions as ``vitok_tpu/ops/rope.py``: frequencies in float32, the
rotation itself in the activation dtype with the tables cast to it. 2D RoPE
splits the head dimension in half: the first half rotates by the patch-grid
row, the second by the column.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def compute_inv_freq(dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """Inverse frequencies ``1 / theta^(2i/dim)`` for one rotary axis, float32 ``[dim // 2]``."""
    if dim % 2 != 0:
        raise ValueError(f"RoPE axis dimension must be even, got dim={dim}")
    exponents = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exponents)


def _axis_freqs(positions, dim, theta, inv_freq):
    if inv_freq is None:
        inv_freq = compute_inv_freq(dim, theta, device=positions.device)
    freqs = positions.float()[..., None] * inv_freq
    return torch.cos(freqs), torch.sin(freqs)


def compute_2d_freqs_cis(
    y_positions: torch.Tensor,
    x_positions: torch.Tensor,
    dim: int,
    theta: float = 10000.0,
    inv_freq: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """2D rotary cos/sin for (row, col) patch coordinates.

    Returns ``(cos, sin)`` of shape ``y_positions.shape + (dim // 2,)``,
    float32: the first ``dim // 4`` lanes encode the row, the rest the column.
    """
    if y_positions.shape != x_positions.shape:
        raise ValueError("x_positions and y_positions must have matching shapes")
    if dim % 4 != 0:
        raise ValueError("2D RoPE requires head dimension divisible by 4")
    axis_dim = dim // 2
    cos_y, sin_y = _axis_freqs(y_positions, axis_dim, theta, inv_freq)
    cos_x, sin_x = _axis_freqs(x_positions, axis_dim, theta, inv_freq)
    return torch.cat([cos_y, cos_x], -1), torch.cat([sin_y, sin_x], -1)


def rope_half_permutation(head_dim: int) -> np.ndarray:
    """Channel permutation from interleaved RoPE layout to rotate-half.

    ``perm[i]`` is the interleaved channel that lands at rotate-half position
    ``i``: reals ``(0, 2, 4, ...)`` first, imaginaries ``(1, 3, 5, ...)``
    second. Attention is invariant to it because q and k permute alike.
    """
    return np.concatenate([np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)])


def _broadcast_tables(cos, sin, xr):
    """Reshape ``[N, D2]`` or ``[B, N, D2]`` tables against ``xr [B, N, H, D2]``
    or ``[B, H, N, D2]``."""
    if cos.ndim == 2 and cos.shape == (xr.shape[-2], xr.shape[-1]):
        return cos, sin
    if cos.ndim == 3 and cos.shape == (xr.shape[0], xr.shape[-2], xr.shape[-1]):
        shape = (xr.shape[0],) + (1,) * (xr.ndim - 3) + (xr.shape[-2], xr.shape[-1])
        return cos.reshape(shape), sin.reshape(shape)
    if cos.ndim == 3 and cos.shape == (xr.shape[0], xr.shape[1], xr.shape[-1]):
        shape = (xr.shape[0], xr.shape[1], 1, xr.shape[-1])
        return cos.reshape(shape), sin.reshape(shape)
    raise ValueError(
        f"freqs shape {tuple(cos.shape)} incompatible with rotated input shape {tuple(xr.shape)}"
    )


def apply_rotary_emb(
    xq: torch.Tensor,
    xk: torch.Tensor,
    freqs_cos: torch.Tensor,
    freqs_sin: torch.Tensor,
    convention: str = "interleaved",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate query/key tensors by precomputed cos/sin tables.

    ``"interleaved"``: lanes ``(2i, 2i+1)`` form pair ``i``. ``"half"``:
    channel ``i`` pairs with ``i + D/2`` (the model's layout; checkpoints are
    permuted at load time with :func:`rope_half_permutation`).

    Args:
        xq, xk: ``[B, N, H, D]`` (or ``[B, H, N, D]``).
        freqs_cos, freqs_sin: ``[B, N, D//2]`` or ``[N, D//2]``, float32.
    """
    dtype = xq.dtype
    cos_t, sin_t = freqs_cos.to(dtype), freqs_sin.to(dtype)

    def rotate_interleaved(x):
        pairs = x.reshape(*x.shape[:-1], -1, 2)
        xr, xi = pairs[..., 0], pairs[..., 1]
        cos, sin = _broadcast_tables(cos_t, sin_t, xr)
        return torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], -1).reshape(x.shape)

    def rotate_half(x):
        d2 = x.shape[-1] // 2
        xr, xi = x[..., :d2], x[..., d2:]
        cos, sin = _broadcast_tables(cos_t, sin_t, xr)
        return torch.cat([xr * cos - xi * sin, xr * sin + xi * cos], -1)

    if convention == "half":
        return rotate_half(xq), rotate_half(xk)
    if convention != "interleaved":
        raise ValueError(f"Unknown RoPE convention: {convention!r}")
    return rotate_interleaved(xq), rotate_interleaved(xk)


__all__ = [
    "compute_inv_freq",
    "compute_2d_freqs_cis",
    "apply_rotary_emb",
    "rope_half_permutation",
]
