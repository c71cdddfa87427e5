"""DINO-style ViT feature backbone for the perceptual loss and FDD (port of
``vitok_tpu/models/vit_features.py``).

A plain pre-LN ViT with learned position embeddings, under timm's names
(``patch_embed.proj``, ``blocks.{i}.attn.qkv``, ``blocks.{i}.mlp.fc1``, ...),
so a DINO/timm state dict loads with ``load_state_dict``:

* LayerNorm with eps 1e-6 and exact (erf) GELU, in fp32;
* the patch embed is an unfold + product in torch-conv ``(c, ph, pw)`` order;
* attention through the port's ``dot_product_attention`` with no mask (the
  unfused composition up to 2047 tokens, as in the JAX package);
* position embeddings interpolate bilinearly to any grid through the
  ``jax.image.resize`` weights of ``vitok_torch.eval_features`` (antialiased
  when the grid shrinks), so the same weights serve 224² pretraining, 256²
  perceptual tiles and 512² FDD.

The parameters are frozen; gradients flow to the images, which the
perceptual term needs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vitok_torch.eval_features import resize_weights, separable_resize
from vitok_torch.ops.attention import dot_product_attention
from vitok_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ViTCfg:
    """Standard ViT geometry (timm ``vit_<size>_patch16_224`` layouts)."""

    width: int = 384
    depth: int = 12
    heads: int = 6
    patch: int = 16
    img_size: int = 224  # grid the stored pos_embed was trained at
    mlp_ratio: float = 4.0
    attn_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def hidden(self) -> int:
        return int(self.width * self.mlp_ratio)

    @property
    def grid(self) -> int:
        return self.img_size // self.patch


def dino_vit_s16(**kw) -> ViTCfg:
    """DINO ViT-S/16 (the reference perceptual backbone size)."""
    return ViTCfg(width=384, depth=12, heads=6, patch=16, **kw)


def dino_vit_b16(**kw) -> ViTCfg:
    """DINO ViT-B/16 (the reference FDD backbone size)."""
    return ViTCfg(width=768, depth=12, heads=12, patch=16, **kw)


def interpolate_pos_embed(pos_embed: torch.Tensor, src_grid: int, dst: Tuple[int, int]) -> torch.Tensor:
    """Bilinear pos-embed interpolation (the cls slot passes through)."""
    gh, gw = dst
    if (gh, gw) == (src_grid, src_grid):
        return pos_embed
    cls_pe, patch_pe = pos_embed[:, :1], pos_embed[:, 1:]
    pe = patch_pe.reshape(src_grid, src_grid, -1).permute(2, 0, 1)[None].float()  # [1, D, g, g]
    wh = resize_weights(src_grid, gh, "bilinear", pos_embed.device)[None]
    ww = resize_weights(src_grid, gw, "bilinear", pos_embed.device)[None]
    pe = separable_resize(pe, wh, ww)[0].permute(1, 2, 0).reshape(1, gh * gw, -1).to(pos_embed.dtype)
    return torch.cat([cls_pe, pe], dim=1)


class _Attention(nn.Module):
    def __init__(self, d: int, heads: int, impl: str, device):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d, device=device)
        self.proj = nn.Linear(d, d, device=device)
        self.heads, self.impl = heads, impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, d // self.heads).unbind(2)
        return self.proj(dot_product_attention(q, k, v, impl=self.impl).reshape(b, n, d))


class _Mlp(nn.Module):
    def __init__(self, d: int, hidden: int, device):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden, device=device)
        self.fc2 = nn.Linear(hidden, d, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class _Block(nn.Module):
    def __init__(self, cfg: ViTCfg, device):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.width, eps=1e-6, device=device)
        self.attn = _Attention(cfg.width, cfg.heads, cfg.attn_impl, device)
        self.norm2 = nn.LayerNorm(cfg.width, eps=1e-6, device=device)
        self.mlp = _Mlp(cfg.width, cfg.hidden, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class DinoViT(nn.Module):
    """ViT forward in fp32: ``[B, 3, H, W]`` (already normalised) -> tokens
    ``[B, 1 + N, D]`` after the final LayerNorm. H and W are multiples of
    ``cfg.patch``; the position embeddings follow the grid.

    Random weights (trunc-normal 0.02 for the patch, cls, position and
    block linear weights; zero biases; unit LayerNorm gains) come from a CPU
    ``torch.Generator`` seeded with ``seed``, so they are the same on every
    device; a ``state_dict`` with timm names replaces them (keys the
    backbone does not have, such as a head, are ignored).
    """

    def __init__(self, cfg: ViTCfg, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 seed: int = 42, device="cuda"):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        meta = torch.device("meta")
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, cfg.width, cfg.patch, stride=cfg.patch, device=meta)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.width, device=meta))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + cfg.grid ** 2, cfg.width, device=meta))
        self.blocks = nn.ModuleList(_Block(cfg, meta) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(cfg.width, eps=1e-6, device=meta)
        self.to_empty(device=device)  # built on the meta device: no init is drawn and thrown away
        self.requires_grad_(False)
        if state_dict is None:
            self._init_weights(seed)
        else:  # a DINO checkpoint may hold a head and other extras the backbone has no use for
            self.load_state_dict({k: state_dict[k] for k in self.state_dict()})
        self.eval()

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)

        def tn(p: torch.Tensor) -> None:
            t = torch.empty(p.shape)
            nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=gen)
            p.copy_(t)

        tn(self.patch_embed.proj.weight)
        tn(self.cls_token)
        tn(self.pos_embed)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                tn(mod.weight)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, c, hh, ww = images.shape
        gh, gw = hh // cfg.patch, ww // cfg.patch
        # unfold in torch-conv (c, ph, pw) order, then one product
        x = images.float().reshape(b, c, gh, cfg.patch, gw, cfg.patch).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(b, gh * gw, c * cfg.patch * cfg.patch)
        proj = self.patch_embed.proj
        x = F.linear(x, proj.weight.reshape(cfg.width, -1), proj.bias)
        x = torch.cat([self.cls_token.expand(b, 1, cfg.width), x], dim=1)
        x = x + interpolate_pos_embed(self.pos_embed, cfg.grid, (gh, gw))
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32).reshape(1, 3, 1, 1)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32).reshape(1, 3, 1, 1)


def make_dino_feature_fn(model: DinoViT, target_size: Optional[int] = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """``[B, 3, H, W]`` in [-1, 1] -> ``[B, 1 + N, D]`` features, differentiable
    in the images.

    ImageNet-normalises inside (the DINO input contract), after an
    antialiased bilinear resize to ``target_size`` when given and the images
    differ from it: ``DINOPerceptual(model_size='S', target_size=tile_size)``
    of the reference trainer.
    """
    dev = next(model.parameters()).device
    mean = torch.from_numpy(_IMAGENET_MEAN * 2.0 - 1.0).to(dev)  # in [-1, 1] space
    std = torch.from_numpy(_IMAGENET_STD * 2.0).to(dev)

    def fn(images: torch.Tensor) -> torch.Tensor:
        x = images.float()
        if target_size is not None and tuple(x.shape[-2:]) != (target_size, target_size):
            wh = resize_weights(x.shape[-2], target_size, "bilinear", x.device)[None]
            ww = resize_weights(x.shape[-1], target_size, "bilinear", x.device)[None]
            x = separable_resize(x, wh, ww)
        return model((x - mean) / std)

    return fn


def load_dino_backbone(
    weights: Optional[str],
    size: str = "S",
    attn_impl: str = "auto",
    device="cuda",
) -> DinoViT:
    """A frozen DINO ViT backbone for the perceptual loss and FDD features.

    ``weights`` may be a local ``.pth``/``.safetensors`` path with a
    timm-named state dict (``module.``/``backbone.`` prefixes and
    ``state_dict``/``model``/``teacher``/``student`` wrappers are stripped;
    the grid of ``pos_embed`` sets ``img_size``). ``None`` draws random
    weights with a loud warning: features that are a smoothness prior, NOT
    comparable to DINO-trained runs.
    """
    cfg = (dino_vit_s16 if size.upper() == "S" else dino_vit_b16)(attn_impl=attn_impl)
    if weights is None:
        import warnings

        warnings.warn(
            "DINO weights not provided; using a random-init ViT backbone. "
            "Set --dino-weights / VITOK_DINO_WEIGHTS for DINO-parity "
            "perceptual training.",
            stacklevel=2,
        )
        return DinoViT(cfg, device=device)

    if weights.endswith(".safetensors"):
        from safetensors.torch import load_file

        state = load_file(weights)
    else:
        state = torch.load(weights, map_location="cpu", weights_only=True)
        if isinstance(state, dict):
            for key in ("state_dict", "model", "teacher", "student"):
                if key in state and isinstance(state[key], dict):
                    state = state[key]
                    break
        state = {k.removeprefix("module.").removeprefix("backbone."): v for k, v in state.items()}
    n_tokens = state["pos_embed"].shape[1] - 1
    grid = math.isqrt(n_tokens)
    if grid * grid == n_tokens and grid != cfg.grid:
        cfg = dataclasses.replace(cfg, img_size=grid * cfg.patch)
    return DinoViT(cfg, state_dict=state, device=device)


__all__ = [
    "ViTCfg",
    "dino_vit_s16",
    "dino_vit_b16",
    "DinoViT",
    "interpolate_pos_embed",
    "make_dino_feature_fn",
    "load_dino_backbone",
]
