"""Vision Transformer autoencoder (NaFlex), bf16 inference in PyTorch.

Port of ``vitok_tpu/models/ae.py``: asymmetric encoder/decoder ViT over
NaFlex patch dicts, parallel blocks (one RMSNorm feeding both attention and
SwiGLU, summed, LayerScale, residual), per-head-dim QK RMSNorm, rotate-half
2D RoPE, affine-free LayerNorm latent head, and the ``decode_variant`` DSL.

Parameters live in ``nn.Module``s named as the released flat checkpoints
(``encoder_blocks.N.attn.qkv_proj.weight`` ...), with q/k channels in
rotate-half order (``utils/params_io.py`` permutes released weights on load).
The JAX package keeps fp32 params and casts each matmul kernel to the compute
dtype on every use; this port casts the Linear weights, biases and LayerScale
gains to the compute dtype once, when they are made or loaded, which gives
the same numbers. RMSNorm gains stay fp32, as the norms multiply in fp32.

Attention in a block at ``N <= 1024`` tokens goes to the fused Hopper kernel
(``ops/fused_attention.py``), as the JAX package routes it to its Pallas
kernel; ``attn_impl="xla"`` asks for the unfused composition instead.
Training paths (drop path, remat) and int8 (``AE.quantize``) are not ported.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vitok_torch.ops.fused_attention import fused_qkv_attention
from vitok_torch.ops.mlp import round_hidden_dim, swiglu
from vitok_torch.ops.norms import layer_norm, layer_scale, rms_norm
from vitok_torch.ops.rope import compute_2d_freqs_cis
from vitok_torch.utils.device import resolve_device

ATTN_IMPLS = ("auto", "fused", "xla")


@dataclasses.dataclass(frozen=True)
class AEConfig:
    """Static architecture configuration (the inference fields of the JAX
    package's ``AEConfig``)."""

    pixels_per_token: int = 768
    channels_per_token: int = 32
    encoder_width: int = 1024
    decoder_width: int = 1024
    encoder_depth: int = 4
    decoder_depth: int = 24
    encoder_heads: int = 12
    decoder_heads: int = 12
    mlp_factor: float = 2.67
    spatial_stride: int = 16
    temporal_stride: int = 1
    use_layer_scale: bool = True
    layer_scale_init: float = 1e-4
    encoder: bool = True
    decoder: bool = True
    sw: Optional[int] = None
    attn_impl: str = "auto"
    rope_theta: float = 10000.0

    def __post_init__(self):
        if not self.encoder and not self.decoder:
            raise ValueError("At least one of encoder or decoder must be True")
        if self.sw is not None and self.sw <= 0:  # sw <= 0 disables the window
            object.__setattr__(self, "sw", None)
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")

    @property
    def encoder_head_dim(self) -> int:
        return self.encoder_width // self.encoder_heads

    @property
    def decoder_head_dim(self) -> int:
        return self.decoder_width // self.decoder_heads

    @property
    def encoder_ffn_dim(self) -> int:
        return round_hidden_dim(int(self.encoder_width * self.mlp_factor))

    @property
    def decoder_ffn_dim(self) -> int:
        return round_hidden_dim(int(self.decoder_width * self.mlp_factor))

    @classmethod
    def from_variant(cls, variant: str, **overrides) -> "AEConfig":
        cfg = decode_variant(variant)
        cfg.update(overrides)
        return cls(**_filter_known(cfg))


def _filter_known(kw: Dict[str, Any]) -> Dict[str, Any]:
    """Drop kwargs that are not config fields, as the reference AE does."""
    names = {f.name for f in dataclasses.fields(AEConfig)}
    return {k: v for k, v in kw.items() if k in names}


_BASE_WIDTHS = {"B": 768, "L": 1024, "G": 1728, "T": 3072, "E": 4096}
_BASE_DEPTHS = {"B": 12, "L": 24, "G": 32, "T": 40, "E": 48}
_BASE_HEADS = {"B": 12, "L": 16, "G": 24, "T": 24, "E": 32}
_BASE_MLP = 2.67


def _parse_variant_name(variant_name: str) -> Dict[str, Any]:
    """Parse one side of a variant string (``Ld4`` or ``w512_d8_h8``)."""
    if variant_name.startswith("w") and "_d" in variant_name and "_h" in variant_name:
        parts = variant_name.split("_")
        mlp = float(parts[3][1:]) if len(parts) > 3 and parts[3].startswith("m") else _BASE_MLP
        return {
            "width": int(parts[0][1:]),
            "depth": int(parts[1][1:]),
            "heads": int(parts[2][1:]),
            "mlp_factor": mlp,
        }
    width_m = re.search(r"w(\d+)", variant_name)
    depth_m = re.search(r"d(\d+)", variant_name)
    heads_m = re.search(r"h(\d+)", variant_name)
    mlp_m = re.search(r"m(\d+(?:\.\d+)?)", variant_name)
    base = re.sub(r"w\d+|d\d+|h\d+|m\d+(?:\.\d+)?", "", variant_name)
    if base and base not in _BASE_WIDTHS:
        raise ValueError(f"Unknown base variant: {base}. Available: {list(_BASE_WIDTHS.keys())}")
    return {
        "width": int(width_m.group(1)) if width_m else _BASE_WIDTHS.get(base, 768),
        "depth": int(depth_m.group(1)) if depth_m else _BASE_DEPTHS.get(base, 12),
        "heads": int(heads_m.group(1)) if heads_m else _BASE_HEADS.get(base, 12),
        "mlp_factor": float(mlp_m.group(1)) if mlp_m else _BASE_MLP,
    }


def decode_variant(variant: str) -> Dict[str, Any]:
    """Parse ``"B/1x16x64"`` or ``"Ld4-Ld24/1x16x64"`` into config kwargs.

    Geometry ``{t}x{s}x{c}``: temporal stride, patch size, latent channels
    (``{s}x{c}`` implies t=1); ``pixels_per_token = s*s*t*3``; ``mlp_factor``
    is the larger of the two sides.
    """
    v, rest = variant.split("/")
    enc_v, dec_v = v.split("-") if "-" in v else (v, v)
    parts = list(map(int, rest.split("x")))
    if len(parts) == 3:
        temporal_stride, spatial_stride, channel_size = parts
    elif len(parts) == 2:
        temporal_stride, spatial_stride, channel_size = 1, parts[0], parts[1]
    else:
        raise ValueError(f"Invalid variant format: {variant}")
    enc = _parse_variant_name(enc_v)
    dec = _parse_variant_name(dec_v)
    return {
        "encoder_width": enc["width"],
        "decoder_width": dec["width"],
        "encoder_depth": enc["depth"],
        "decoder_depth": dec["depth"],
        "encoder_heads": enc["heads"],
        "decoder_heads": dec["heads"],
        "mlp_factor": max(enc["mlp_factor"], dec["mlp_factor"]),
        "temporal_stride": temporal_stride,
        "spatial_stride": spatial_stride,
        "channels_per_token": channel_size,
        "pixels_per_token": spatial_stride * spatial_stride * temporal_stride * 3,
    }


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``x @ W^T`` rounded to x's dtype, then the bias added in that dtype
    (the JAX ``_linear``'s two rounding points)."""
    y = F.linear(x, lin.weight)
    return y if lin.bias is None else y + lin.bias


class _Gain(nn.Module):
    """An fp32 per-channel norm gain, stored as ``weight``."""

    def __init__(self, dim: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))


class _LayerScale(nn.Module):
    def __init__(self, dim: int, init: float, device, dtype):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init, dtype=dtype, device=device))


class _Attention(nn.Module):
    def __init__(self, width: int, head_dim: int, device, dtype):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.qkv_proj = nn.Linear(width, 3 * width, **kw)
        self.out_proj = nn.Linear(width, width, **kw)
        self.norm_q = _Gain(head_dim, device)
        self.norm_k = _Gain(head_dim, device)


class _FFN(nn.Module):
    def __init__(self, width: int, ffn_dim: int, device, dtype):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.fc1 = nn.Linear(width, 2 * ffn_dim, **kw)
        self.fc2 = nn.Linear(ffn_dim, width, **kw)


class Block(nn.Module):
    """Parallel block: ``x + ls(attn(norm(x)) + mlp(norm(x)))``."""

    def __init__(self, width, heads, ffn_dim, use_layer_scale, layer_scale_init, device, dtype):
        super().__init__()
        self.heads = heads
        self.norm1 = _Gain(width, device)
        self.attn = _Attention(width, width // heads, device, dtype)
        self.ffn = _FFN(width, ffn_dim, device, dtype)
        self.layer_scale = (
            _LayerScale(width, layer_scale_init, device, dtype) if use_layer_scale else None
        )

    def forward(
        self,
        x: torch.Tensor,
        rope: Tuple[torch.Tensor, torch.Tensor],
        patch_mask: Optional[torch.Tensor],
        sliding_window: Optional[int],
        attn_impl: str,
    ) -> torch.Tensor:
        h = rms_norm(x, self.norm1.weight)
        qkv = F.linear(h, self.attn.qkv_proj.weight)
        # At inference "fused" asks for the kernel where its gate opens and
        # degrades to auto routing elsewhere, as in the JAX package.
        attn = fused_qkv_attention(
            qkv, self.attn.norm_q.weight, self.attn.norm_k.weight, rope[0], rope[1], patch_mask,
            num_heads=self.heads, sliding_window=sliding_window,
            impl="auto" if attn_impl == "fused" else attn_impl,
        )
        out = F.linear(attn, self.attn.out_proj.weight) + swiglu(
            h, self.ffn.fc1.weight, self.ffn.fc2.weight
        )
        if self.layer_scale is not None:
            out = layer_scale(out, self.layer_scale.gamma)
        return x + out


# Metadata carried through encode/decode outputs, as in the JAX package.
_META_KEYS = (
    "patch_mask",
    "row_idx",
    "col_idx",
    "time_idx",
    "orig_height",
    "orig_width",
    "grid_rows",
    "grid_cols",
)


def _meta(d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: d[k] for k in _META_KEYS if k in d}


def _rope_tables(patch_dict, head_dim: int, theta: float, device):
    """Per-sample 2D RoPE cos/sin ``[B, N, D/2]`` in fp32."""
    row = torch.as_tensor(patch_dict["row_idx"], device=device).float()
    col = torch.as_tensor(patch_dict["col_idx"], device=device).float()
    return compute_2d_freqs_cis(row, col, head_dim, theta)


class AE(nn.Module):
    """NaFlex autoencoder: dict in, dict out.

    ``AE(**decode_variant("Ld4-Ld24/1x16x64"))`` as in the JAX package
    (unknown kwargs are dropped). Weights are random from ``seed`` unless a
    ``state_dict`` (this module's layout, e.g. from
    ``utils.params_io.from_jax_params``) is given. Runs on the card unless
    ``device="cpu"``.
    """

    def __init__(
        self,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
        compute_dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        **kwargs,
    ):
        super().__init__()
        self.cfg = cfg = AEConfig(**_filter_known(kwargs))
        self.device = device = resolve_device(device)
        self.compute_dtype = compute_dtype
        dt = compute_dtype
        blocks = lambda width, depth, heads, ffn: nn.ModuleList(
            Block(width, heads, ffn, cfg.use_layer_scale, cfg.layer_scale_init, device, dt)
            for _ in range(depth)
        )
        if cfg.encoder:
            self.patch_embed = nn.Linear(cfg.pixels_per_token, cfg.encoder_width, device=device, dtype=dt)
            self.encoder_blocks = blocks(
                cfg.encoder_width, cfg.encoder_depth, cfg.encoder_heads, cfg.encoder_ffn_dim
            )
            self.to_code = nn.Linear(cfg.encoder_width, cfg.channels_per_token, device=device, dtype=dt)
        if cfg.decoder:
            self.decoder_embed = nn.Linear(cfg.channels_per_token, cfg.decoder_width, device=device, dtype=dt)
            self.decoder_blocks = blocks(
                cfg.decoder_width, cfg.decoder_depth, cfg.decoder_heads, cfg.decoder_ffn_dim
            )
            self.to_pixels = nn.Linear(cfg.decoder_width, cfg.pixels_per_token, device=device, dtype=dt)
        self.requires_grad_(False)
        if state_dict is None:
            self._init_weights(seed)
        else:
            self.load_state_dict(state_dict)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        """Linear weights and biases ~ U(+-1/sqrt(fan_in)) (torch's nn.Linear
        bound) from a generator seeded with ``seed``; gains stay as built."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                bound = mod.in_features ** -0.5
                for p in (mod.weight, mod.bias):
                    if p is not None:
                        u = torch.rand(p.shape, generator=gen, device=self.device)
                        p.copy_((u * 2 - 1) * bound)

    def _blocks(self, x, blocks, patch_dict, head_dim):
        cfg = self.cfg
        rope = _rope_tables(patch_dict, head_dim, cfg.rope_theta, self.device)
        mask = patch_dict.get("patch_mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device).bool()
        for blk in blocks:
            x = blk(x, rope, mask, cfg.sw, cfg.attn_impl)
        return x

    @torch.no_grad()
    def encode(self, patch_dict: Dict[str, Any]) -> Dict[str, Any]:
        """NaFlex patch dict -> ``{"z": [B, N, c], **metadata}``."""
        x = torch.as_tensor(patch_dict["patches"], device=self.device).to(self.compute_dtype)
        x = _linear(x, self.patch_embed)
        x = self._blocks(x, self.encoder_blocks, patch_dict, self.cfg.encoder_head_dim)
        out = _meta(patch_dict)
        out["z"] = layer_norm(_linear(x, self.to_code))
        return out

    @torch.no_grad()
    def decode(self, encode_dict: Dict[str, Any]) -> Dict[str, Any]:
        """Latents -> ``{"patches": [B, N, pixels_per_token], **metadata}``."""
        x = torch.as_tensor(encode_dict["z"], device=self.device).to(self.compute_dtype)
        x = _linear(x, self.decoder_embed)
        x = self._blocks(x, self.decoder_blocks, encode_dict, self.cfg.decoder_head_dim)
        out = _meta(encode_dict)
        out["patches"] = _linear(x, self.to_pixels)
        return out

    def forward(self, patch_dict: Dict[str, Any]) -> Dict[str, Any]:
        """Encode then decode (whichever halves the config has)."""
        out = patch_dict
        if self.cfg.encoder:
            out = self.encode(out)
        if self.cfg.decoder:
            out = self.decode(out)
        return out


__all__ = ["AE", "AEConfig", "Block", "decode_variant"]
