"""DiT: diffusion transformer over ViTok latents (flow matching), in PyTorch.

Port of ``vitok_tpu/models/dit.py``: the adaLN-zero DiT conditioned on
timestep and class, built from the AE's primitives (fp32 RMSNorm, rotate-half
2D RoPE, QK-norm, SwiGLU) as a parallel block whose one modulated norm feeds
attention and MLP.

* dict forward ``{z, t, context, row_idx?, col_idx?} -> prediction`` of
  ``z``'s shape; positions default to an implicit square grid;
* classifier-free guidance by batch doubling, null class index ``text_dim``;
* optional class token and register tokens prepended at position 0 and
  stripped from the output;
* ``decode_variant("Bd4/256")`` -> width/depth/heads/mlp + max_tokens.

Attention in a block goes to the fused Hopper kernel
(``ops/fused_attention.py``) when deterministic or with
``attn_impl="fused"`` (then training runs the kernel and its backward
kernel), else to the unfused composition, as the JAX package routes it.
``DiT.quantize()`` gives int8 block linears; a quantized block quantizes the
modulated input once for the QKV and fc1 products and takes the fused int8
fc1 + SwiGLU + requantize kernel where its gate opens (``ops/quant.py``).
The adaLN ``mod`` linears, norms, embeds and the final head stay in full
precision.

Parameters are named like the AE's (``blocks.N.attn.qkv_proj.weight`` ...,
``blocks.N.mod``, ``t_embed.fc1``, ``ctx_embed``, ``final.mod``,
``final.proj``), q/k channels in rotate-half order on both sides, so
``utils/params_io.py`` moves weights to and from the JAX pytree without a
permutation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

from vitok_torch.models.ae import (
    _BASE_MLP,
    Block,
    Int8Linear,
    _linear,
    _parse_variant_name,
    _prequant,
)
from vitok_torch.ops import quant as q8
from vitok_torch.ops.fused_attention import can_fuse, fused_qkv_attention, unfused_qkv_attention
from vitok_torch.ops.mlp import round_hidden_dim, swiglu
from vitok_torch.ops.norms import layer_scale, rms_norm
from vitok_torch.ops.rope import compute_2d_freqs_cis
from vitok_torch.utils.device import resolve_device

_T_EMBED_DIM = 256


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding ``[B] -> [B, dim]`` (values in [-1, 1])."""
    t = torch.as_tensor(t).float()
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def decode_variant(variant: str) -> Dict[str, Any]:
    """Parse a DiT variant like ``"Bd4/256"`` -> arch dict + max_tokens."""
    if "/" in variant:
        name, _, rest = variant.partition("/")
        max_tokens = int(rest)
    else:
        name, max_tokens = variant, 256
    arch = _parse_variant_name(name)
    return {
        "width": arch["width"],
        "depth": arch["depth"],
        "heads": arch["heads"],
        "mlp_factor": arch["mlp_factor"],
        "max_tokens": max_tokens,
    }


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    width: int = 768
    depth: int = 12
    heads: int = 12
    mlp_factor: float = _BASE_MLP
    max_tokens: int = 256
    code_width: int = 32
    text_dim: int = 1000  # number of classes; index text_dim = null class
    use_layer_scale: bool = False
    layer_scale_init: float = 1e-5
    class_token: bool = False
    reg_tokens: int = 0
    rope_theta: float = 10000.0
    checkpoint: int = 0
    attn_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def ffn_dim(self) -> int:
        return round_hidden_dim(int(self.width * self.mlp_factor))

    @property
    def num_special_tokens(self) -> int:
        return int(self.class_token) + self.reg_tokens


def _filter_known(kw: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(DiTConfig)}
    return {k: v for k, v in kw.items() if k in names}


class DiTBlock(Block):
    """Parallel DiT block with adaLN-zero conditioning:
    ``x + gate * ls(attn(h) + mlp(h))``, ``h = norm(x) * (1 + scale) + shift``,
    with shift, scale and gate from ``mod(cond)``."""

    def __init__(self, width, heads, ffn_dim, use_layer_scale, layer_scale_init, device, dtype):
        super().__init__(width, heads, ffn_dim, use_layer_scale, layer_scale_init, device, dtype)
        self.mod = nn.Linear(width, 3 * width, device=device, dtype=dtype)

    def forward(self, x, cond, rope, attn_impl: str, deterministic: bool = True):
        b, n, c = x.shape
        mod = _linear(cond, self.mod).reshape(b, 1, 3, c)
        shift, scale, gate = mod[:, :, 0], mod[:, :, 1], mod[:, :, 2]
        h = rms_norm(x, self.norm1.weight)
        h = h * (1.0 + scale) + shift

        int8 = isinstance(self.attn.qkv_proj, Int8Linear)
        if int8:
            # The shift and scale sit between the norm and the products, so
            # the RMSNorm + quantize kernel does not apply: the modulated
            # input is quantized once and shared by the QKV and fc1 products.
            hq, h_scale = q8.quantize_activation(h)
            qkv = _prequant(hq, h_scale, self.attn.qkv_proj, h.dtype)
            fc1 = self.ffn.fc1
            if q8.can_fuse_ffn(b * n, c, fc1.out_features):
                hid = q8.fused_ffn_int8(hq.reshape(b * n, c), h_scale.reshape(b * n, 1),
                                        fc1.weight_int8, fc1.scale)
            else:
                hid = _prequant(hq, h_scale, fc1, h.dtype)
        else:
            qkv = F.linear(h, self.attn.qkv_proj.weight.to(h.dtype))

        # No padding in a DiT sequence: no mask (the JAX package hands its
        # kernel an all-ones mask, which is the same function).
        args = (qkv, self.attn.norm_q.weight, self.attn.norm_k.weight, rope[0], rope[1], None)
        if (
            attn_impl in ("auto", "fused")
            and (deterministic or attn_impl == "fused")
            and can_fuse(n, c, self.heads, cuda=qkv.is_cuda)
        ):
            attn = fused_qkv_attention(*args, num_heads=self.heads, impl="fused")
        else:
            attn = unfused_qkv_attention(*args, self.heads, None,
                                         attn_impl="auto" if attn_impl == "fused" else attn_impl)
        if int8:
            out = self.attn.out_proj(attn) + self._int8_mlp(hid, x)
        else:
            out = F.linear(attn, self.attn.out_proj.weight.to(attn.dtype)) + swiglu(
                h, self.ffn.fc1.weight, self.ffn.fc2.weight
            )
        if self.layer_scale is not None:
            out = layer_scale(out, self.layer_scale.gamma)
        return x + gate * out


class _TimeEmbed(nn.Module):
    def __init__(self, width: int, device, dtype):
        super().__init__()
        self.fc1 = nn.Linear(_T_EMBED_DIM, width, device=device, dtype=dtype)
        self.fc2 = nn.Linear(width, width, device=device, dtype=dtype)


class _FinalHead(nn.Module):
    def __init__(self, width: int, code_width: int, device, dtype):
        super().__init__()
        self.mod = nn.Linear(width, 2 * width, device=device, dtype=dtype)
        self.proj = nn.Linear(width, code_width, device=device, dtype=dtype)


class DiT(nn.Module):
    """``DiT(**decode_variant("Bd4/256"), code_width=32, text_dim=1000)``.

    Weights are random from ``seed`` (the block ``mod`` linears zero, as
    adaLN-zero starts) unless a ``state_dict`` in this module's layout is
    given (e.g. from ``utils.params_io.dit_from_jax_params``; int8 block
    weights make an int8 model). Runs on the card unless ``device="cpu"``.
    ``param_dtype`` and ``trainable`` as in :class:`vitok_torch.models.ae.AE`.
    """

    def __init__(
        self,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
        compute_dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        param_dtype: Optional[torch.dtype] = None,
        trainable: bool = False,
        **kwargs,
    ):
        super().__init__()
        self.cfg = cfg = DiTConfig(**_filter_known(kwargs))
        self.device = device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.param_dtype = dt = compute_dtype if param_dtype is None else param_dtype
        w = cfg.width
        self.input_proj = nn.Linear(cfg.code_width, w, device=device, dtype=dt)
        self.t_embed = _TimeEmbed(w, device, dt)
        # Class embedding table, the null class (CFG) last.
        self.ctx_embed = nn.Parameter(torch.zeros((cfg.text_dim + 1, w), device=device, dtype=dt))
        self.blocks = nn.ModuleList(
            DiTBlock(w, cfg.heads, cfg.ffn_dim, cfg.use_layer_scale, cfg.layer_scale_init, device, dt)
            for _ in range(cfg.depth)
        )
        self.final = _FinalHead(w, cfg.code_width, device, dt)
        if cfg.class_token:
            self.cls_token = nn.Parameter(torch.zeros((1, 1, w), device=device, dtype=dt))
        if cfg.reg_tokens:
            self.reg_token = nn.Parameter(torch.zeros((1, cfg.reg_tokens, w), device=device, dtype=dt))
        self.requires_grad_(False)
        if state_dict is None:
            self._init_weights(seed)
        else:
            if q8.is_quantized(state_dict):
                self.quantize()  # the int8 layout; the state dict overwrites it
            self.load_state_dict(state_dict)
        if trainable:
            if self.is_quantized:
                raise ValueError("an int8 model cannot be trained: build it from full-precision weights")
            self.requires_grad_(True)

    # The reference's test surface.
    @property
    def code_width(self) -> int:
        return self.cfg.code_width

    @property
    def text_dim(self) -> int:
        return self.cfg.text_dim

    @property
    def num_special_tokens(self) -> int:
        return self.cfg.num_special_tokens

    @property
    def is_quantized(self) -> bool:
        return any(isinstance(m, Int8Linear) for m in self.modules())

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters()) + sum(b.numel() for b in self.buffers())

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        """Linear weights and biases ~ U(+-1/sqrt(fan_in)); the class table,
        the special tokens and the final ``mod`` weight ~ N(0, 0.02^2), its
        bias 0; every block's ``mod`` zero (adaLN-zero: the residual gates
        start closed). All from a generator seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                bound = mod.in_features ** -0.5
                for p in (mod.weight, mod.bias):
                    if p is not None:
                        u = torch.rand(p.shape, generator=gen, device=self.device)
                        p.copy_((u * 2 - 1) * bound)
        small = [self.ctx_embed, self.final.mod.weight]
        small += [getattr(self, n) for n in ("cls_token", "reg_token") if hasattr(self, n)]
        for p in small:
            p.copy_(torch.randn(p.shape, generator=gen, device=self.device) * 0.02)
        self.final.mod.bias.zero_()
        for blk in self.blocks:
            blk.mod.weight.zero_()
            blk.mod.bias.zero_()

    @torch.no_grad()
    def quantize(self) -> "DiT":
        """Int8 block linears (``qkv_proj``, ``out_proj``, ``fc1``, ``fc2``;
        fc1/fc2 padded for the fused FFN kernel), as ``AE.quantize``. The
        adaLN ``mod``, norms, embeds and the final head stay as they are.
        Idempotent; returns ``self``."""
        for blk in self.blocks:
            for path in q8.QUANT_LINEARS:
                parent_name, name = path.split(".")
                parent = getattr(blk, parent_name)
                lin = getattr(parent, name)
                if not isinstance(lin, Int8Linear):
                    setattr(parent, name, Int8Linear(*q8.quantize_block_linear(name, lin.weight)))
                del lin
        return self

    def _predict(self, dit_input: Dict[str, Any], deterministic: bool) -> torch.Tensor:
        cfg, dev, cd = self.cfg, self.device, self.compute_dtype
        z = torch.as_tensor(dit_input["z"], device=dev).to(cd)
        b, n, _ = z.shape

        if dit_input.get("row_idx") is not None:
            row = torch.as_tensor(dit_input["row_idx"], device=dev).float()
            col = torch.as_tensor(dit_input["col_idx"], device=dev).float()
        else:
            # Implicit grid: the row-major prefix of a side x side grid, the
            # side rounded up so any token count is covered.
            side = int(math.ceil(math.sqrt(n)))
            yy, xx = torch.meshgrid(torch.arange(side, device=dev), torch.arange(side, device=dev),
                                    indexing="ij")
            row = yy.reshape(1, -1).expand(b, -1).float()[:, :n]
            col = xx.reshape(1, -1).expand(b, -1).float()[:, :n]

        x = _linear(z, self.input_proj)

        # Conditioning: timestep + class (null class = index text_dim).
        t_emb = timestep_embedding(torch.as_tensor(dit_input["t"], device=dev), _T_EMBED_DIM).to(cd)
        cond = _linear(t_emb, self.t_embed.fc1)
        cond = _linear(F.silu(cond), self.t_embed.fc2)
        context = dit_input.get("context")
        if context is not None:
            idx = torch.as_tensor(context, device=dev).long().clamp(0, cfg.text_dim)
            cond = cond + self.ctx_embed.to(cd)[idx]
        cond = F.silu(cond)[:, None, :]  # [B, 1, W]

        # Special tokens prepended (no rotation: positions 0).
        n_special = cfg.num_special_tokens
        if n_special:
            specials = []
            if cfg.class_token:
                specials.append(self.cls_token.to(cd).expand(b, -1, -1))
            if cfg.reg_tokens:
                specials.append(self.reg_token.to(cd).expand(b, -1, -1))
            x = torch.cat(specials + [x], dim=1)
            zeros = torch.zeros((b, n_special), dtype=torch.float32, device=dev)
            row = torch.cat([zeros, row], dim=1)
            col = torch.cat([zeros, col], dim=1)

        rope = compute_2d_freqs_cis(row, col, cfg.head_dim, cfg.rope_theta)
        remat = cfg.checkpoint > 0 and torch.is_grad_enabled()
        for blk in self.blocks:
            args = (x, cond, rope, cfg.attn_impl, deterministic)
            if remat:
                x = _checkpoint(blk, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                x = blk(*args)

        if n_special:
            x = x[:, n_special:]

        # adaLN-zero final head over a gain-free RMSNorm.
        mod = _linear(cond[:, 0], self.final.mod).reshape(b, 1, 2, cfg.width)
        shift, scale = mod[:, :, 0], mod[:, :, 1]
        h = rms_norm(x, torch.ones(cfg.width, dtype=torch.float32, device=dev))
        h = h * (1.0 + scale) + shift
        return _linear(h, self.final.proj)

    def forward(self, dit_input: Dict[str, Any], deterministic: bool = True) -> torch.Tensor:
        """``{z, t, context, row_idx?, col_idx?}`` -> prediction ``[B, N, c]``.

        ``deterministic=True`` is inference, under ``torch.no_grad()``;
        ``deterministic=False`` is the training forward (grad follows the
        caller's mode; ``cfg.checkpoint > 0`` recomputes every block in the
        backward; ``attn_impl="auto"`` takes the unfused attention)."""
        if deterministic:
            with torch.no_grad():
                return self._predict(dit_input, True)
        if self.is_quantized:
            raise ValueError("an int8 model cannot be trained: its block linears hold int8 codes")
        return self._predict(dit_input, False)


__all__ = ["DiT", "DiTConfig", "DiTBlock", "decode_variant", "timestep_embedding"]
