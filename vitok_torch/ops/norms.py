"""Normalization and scaling primitives as plain tensor functions.

Same recipe as ``vitok_tpu/ops/norms.py``: statistics in float32, the
result cast back to the input dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, fp32 compute, cast back to ``x.dtype``.

    Args:
        x: ``[..., D]`` activations.
        scale: ``[D]`` gain, applied in float32.
        eps: stability epsilon.
    """
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    y = y * scale.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm over the last axis, fp32 compute (latent head)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return y.to(x.dtype)


def layer_scale(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Per-channel residual scaling, in the activation dtype."""
    return x * gamma.to(x.dtype)


__all__ = ["rms_norm", "layer_norm", "layer_scale"]
