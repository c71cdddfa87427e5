"""Training losses: masked Charbonnier, SSIM, PSNR and the perceptual hook.

Port of ``vitok_tpu/losses.py``: masked Charbonnier on patches, SSIM on
sampled tiles and a pluggable feature-space term. Plain tensor functions,
differentiable, fp32 accumulation. The gaussian filter is a separable
depthwise ``F.conv2d`` (the counterpart of the JAX package's XLA
convolution, outside any kernel).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def charbonnier_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    eps: float = 1e-3,
) -> torch.Tensor:
    """Masked Charbonnier (smooth-L1) loss over NaFlex patches.

    ``sqrt(diff^2 + eps^2)`` averaged over patch pixels, then the
    mask-weighted mean over tokens per image, then the batch mean.
    """
    diff = pred.float() - target.float()
    per_token = torch.sqrt(diff * diff + eps * eps).mean(-1)  # [B, N]
    if patch_mask is None:
        return per_token.mean()
    m = patch_mask.float()
    per_image = (per_token * m).sum(-1) / m.sum(-1).clamp(min=1.0)
    return per_image.mean()


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / g.sum()


def ssim(
    x: torch.Tensor,
    y: torch.Tensor,
    data_range: float = 2.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    reduce: bool = True,
) -> torch.Tensor:
    """Structural similarity over ``[B, C, H, W]`` images (gaussian window).

    Gaussian 11x11, sigma 1.5, 'valid' padding, with the kernel clamped to
    the image size (odd) for small inputs; fp32 throughout.
    """
    b, c, h, w = x.shape
    k = min(kernel_size, h, w)
    if k % 2 == 0:
        k -= 1
    kern = _gaussian_kernel(k, sigma, x.device)
    k_col = kern.reshape(1, 1, k, 1).expand(c, 1, k, 1).contiguous()
    k_row = kern.reshape(1, 1, 1, k).expand(c, 1, 1, k).contiguous()

    def filt(img):  # separable depthwise gaussian, columns then rows
        return F.conv2d(F.conv2d(img, k_col, groups=c), k_row, groups=c)

    xn, yn = x.float(), y.float()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_x = filt(xn)
    mu_y = filt(yn)
    mu_xx = filt(xn * xn) - mu_x * mu_x
    mu_yy = filt(yn * yn) - mu_y * mu_y
    mu_xy = filt(xn * yn) - mu_x * mu_y
    ssim_map = ((2 * mu_x * mu_y + c1) * (2 * mu_xy + c2)) / (
        (mu_x * mu_x + mu_y * mu_y + c1) * (mu_xx + mu_yy + c2)
    )
    per_image = ssim_map.mean((1, 2, 3))
    return per_image.mean() if reduce else per_image


def ssim_loss(x: torch.Tensor, y: torch.Tensor, **kw) -> torch.Tensor:
    """``1 - SSIM``, the form the trainer minimises."""
    return 1.0 - ssim(x, y, **kw)


def psnr(x: torch.Tensor, y: torch.Tensor, data_range: float = 2.0, reduce: bool = True) -> torch.Tensor:
    """Peak signal-to-noise ratio over ``[B, C, H, W]`` (or any) images."""
    axes = tuple(range(1, x.ndim))
    mse = ((x.float() - y.float()) ** 2).mean(axes)
    val = 10.0 * torch.log10((data_range ** 2) / mse.clamp(min=1e-12))
    return val.mean() if reduce else val


def perceptual_loss(
    feature_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    y: torch.Tensor,
) -> torch.Tensor:
    """Feature-space L2 between tiles: ``feature_fn`` maps ``[B, C, H, W]``
    to features (the hook a perceptual backbone plugs into)."""
    fx = feature_fn(x)
    fy = feature_fn(y)
    return ((fx.float() - fy.float()) ** 2).mean()


__all__ = ["charbonnier_loss", "ssim", "ssim_loss", "psnr", "perceptual_loss"]
