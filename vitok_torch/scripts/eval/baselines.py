"""Baseline VAE wrappers for eval comparisons, on torch tensors.

The port's counterpart of the JAX package's ``scripts/eval/baselines.py``
(the reference's ``scripts/eval/baselines.py``, lines 23-327): one
``BaselineVAE`` over third-party convolutional VAEs (FLUX.2, SDXL fp16-fix,
SD ft-mse, Qwen-Image, DC-AE f32/f64) with the surface an eval needs:
``spatial_stride``, reflect padding to a stride multiple before encode and
the crop back after decode, and the latent scaling, so that rFID tables can
hold the reference's baseline rows.

The backends follow the reference's per-model loading:

* ``kl``   -> ``diffusers.AutoencoderKL`` (flux / sdxl / sd);
* ``qwen`` -> ``diffusers.AutoencoderKLQwenImage``, whose images gain a
  frame dimension before encode and whose latents lose it after;
* ``dc``   -> ``diffusers.AutoencoderDC``, whose encode returns ``.latent``
  instead of a ``latent_dist``.

``diffusers`` is not a dependency and nothing is downloaded: building a real
baseline without it raises ``ImportError``. The wrapper logic runs against
any object with ``encode(x)`` / ``decode(z)`` passed as ``autoencoder=``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class BaselineSpec:
    repo: str
    spatial_stride: int
    latent_channels: int
    model_class: str  # "kl" | "qwen" | "dc"
    scaling_factor: Optional[float] = None
    shift_factor: float = 0.0
    subfolder: Optional[str] = None
    dtype: str = "bfloat16"


# The reference's baseline set (baselines.py:23-67).
BASELINES: Dict[str, BaselineSpec] = {
    "flux": BaselineSpec("black-forest-labs/FLUX.2-dev", 8, 16, "kl", subfolder="vae"),
    "sdxl": BaselineSpec("madebyollin/sdxl-vae-fp16-fix", 8, 4, "kl", 0.13025),
    "sd": BaselineSpec("stabilityai/sd-vae-ft-mse", 8, 4, "kl", 0.18215),
    "qwen": BaselineSpec("REPA-E/e2e-qwenimage-vae", 8, 16, "qwen"),
    "dc-ae-f32": BaselineSpec("mit-han-lab/dc-ae-f32c32-sana-1.0-diffusers", 32, 32, "dc"),
    "dc-ae-f64": BaselineSpec("mit-han-lab/dc-ae-f64c128-in-1.0-diffusers", 64, 128, "dc"),
}


def pad_to_stride(images: torch.Tensor, stride: int) -> Tuple[torch.Tensor, int, int]:
    """Reflect-pad ``[B, C, H, W]`` up to multiples of ``stride`` (the
    reference pads, then crops back); also the original ``H, W``."""
    _, _, h, w = images.shape
    ph, pw = (stride - h % stride) % stride, (stride - w % stride) % stride
    if ph or pw:
        images = F.pad(images, (0, pw, 0, ph), mode="reflect")
    return images, h, w


class _TorchBackend:
    """A diffusers autoencoder module, fed in its own dtype and device."""

    def __init__(self, vae, deterministic: bool = True):
        self._vae = vae.eval()
        self._deterministic = deterministic

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        p = next(self._vae.parameters())
        return x.to(device=p.device, dtype=p.dtype)

    def _latent(self, dist):
        return dist.mode() if self._deterministic else dist.sample()


class TorchKLBackend(_TorchBackend):
    """diffusers ``AutoencoderKL`` (flux / sdxl / sd)."""

    @torch.no_grad()
    def encode(self, x):
        return self._latent(self._vae.encode(self._in(x)).latent_dist)

    @torch.no_grad()
    def decode(self, z):
        return self._vae.decode(self._in(z)).sample


class TorchQwenBackend(_TorchBackend):
    """diffusers ``AutoencoderKLQwenImage``: video-shaped, so images gain a
    frame dimension before encode and latents lose it after (reference
    baselines.py:178-193)."""

    @torch.no_grad()
    def encode(self, x):
        return self._latent(self._vae.encode(self._in(x).unsqueeze(2)).latent_dist).squeeze(2)

    @torch.no_grad()
    def decode(self, z):
        return self._vae.decode(self._in(z).unsqueeze(2)).sample.squeeze(2)


class TorchDCBackend(_TorchBackend):
    """diffusers ``AutoencoderDC``: encode returns ``.latent`` directly
    (reference baselines.py:183-186)."""

    @torch.no_grad()
    def encode(self, x):
        return self._vae.encode(self._in(x)).latent

    @torch.no_grad()
    def decode(self, z):
        return self._vae.decode(self._in(z)).sample


_BACKEND_CLASSES = {
    "kl": ("AutoencoderKL", TorchKLBackend),
    "qwen": ("AutoencoderKLQwenImage", TorchQwenBackend),
    "dc": ("AutoencoderDC", TorchDCBackend),
}


def load_backend(spec: BaselineSpec, deterministic: bool = True):
    """The reference's diffusers backend for ``spec``, from weights that
    ``diffusers`` finds locally. Raises ``ImportError`` without
    ``diffusers``."""
    import os

    cls_name, adapter = _BACKEND_CLASSES[spec.model_class]
    try:
        import diffusers
    except ImportError as e:
        raise ImportError(f"baseline '{spec.repo}' needs the diffusers package (class {cls_name}) and its weights "
                          "cached locally; or pass autoencoder= to BaselineVAE") from e
    kwargs = {"torch_dtype": getattr(torch, spec.dtype)}
    if spec.subfolder:
        kwargs["subfolder"] = spec.subfolder
    if os.environ.get("HF_TOKEN"):  # gated repositories such as FLUX
        kwargs["token"] = os.environ["HF_TOKEN"]
    vae = getattr(diffusers, cls_name).from_pretrained(spec.repo, **kwargs)
    return adapter(vae, deterministic=deterministic)


class BaselineVAE:
    """One baseline: ``__call__(images [B, C, H, W] in [-1, 1])`` -> the
    reconstruction at the same size, in ``dtype``.

    ``autoencoder`` injects a backend (an object with ``encode(x) ->
    latents`` and ``decode(latents) -> x``); by default the reference's
    diffusers backend is built on first use (:func:`load_backend`).
    """

    def __init__(self, name: str, autoencoder: Optional[object] = None, dtype: torch.dtype = torch.bfloat16,
                 deterministic: bool = True):
        if name not in BASELINES:
            raise KeyError(f"Unknown baseline: {name}. Available: {list(BASELINES)}")
        self.name = name
        self.spec = BASELINES[name]
        self.dtype = dtype
        self.deterministic = deterministic
        self._ae = autoencoder

    @property
    def spatial_stride(self) -> int:
        return self.spec.spatial_stride

    @property
    def latent_channels(self) -> int:
        return self.spec.latent_channels

    def _backend(self):
        if self._ae is None:
            self._ae = load_backend(self.spec, self.deterministic)
        return self._ae

    def encode(self, images: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """[-1, 1] images -> scaled latents, and the original size for the
        crop back."""
        images, h, w = pad_to_stride(torch.as_tensor(images).to(self.dtype), self.spatial_stride)
        latents = torch.as_tensor(self._backend().encode(images)).to(self.dtype)
        if self.spec.scaling_factor is not None:
            latents = (latents - self.spec.shift_factor) * self.spec.scaling_factor
        return latents, h, w

    def decode(self, latents: torch.Tensor, orig_h: int, orig_w: int) -> torch.Tensor:
        if self.spec.scaling_factor is not None:
            latents = latents / self.spec.scaling_factor + self.spec.shift_factor
        images = torch.as_tensor(self._backend().decode(latents)).to(self.dtype)
        return images[:, :, :orig_h, :orig_w]

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        latents, h, w = self.encode(images)
        return self.decode(latents, h, w)


__all__ = [
    "BaselineVAE",
    "BASELINES",
    "BaselineSpec",
    "pad_to_stride",
    "load_backend",
    "TorchKLBackend",
    "TorchQwenBackend",
    "TorchDCBackend",
]
