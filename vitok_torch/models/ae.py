"""Vision Transformer autoencoder (NaFlex) in PyTorch: bf16 and int8
inference, and training with fp32 master weights.

Port of ``vitok_tpu/models/ae.py``: asymmetric encoder/decoder ViT over
NaFlex patch dicts, parallel blocks (one RMSNorm feeding both attention and
SwiGLU, summed, LayerScale, residual), per-head-dim QK RMSNorm, rotate-half
2D RoPE, affine-free LayerNorm latent head, and the ``decode_variant`` DSL.

Parameters live in ``nn.Module``s named as the released flat checkpoints
(``encoder_blocks.N.attn.qkv_proj.weight`` ...), with q/k channels in
rotate-half order (``utils/params_io.py`` permutes released weights on load).
The JAX package keeps fp32 params and casts each matmul kernel to the compute
dtype on every use. For inference this port casts the Linear weights, biases
and LayerScale gains to the compute dtype once, when they are made or loaded,
which gives the same numbers; with ``param_dtype=torch.float32`` they stay
fp32 master weights and are cast where they are used, as in the JAX package
(what training needs). RMSNorm gains stay fp32, as the norms multiply in fp32.

Attention in a block at ``N <= 1024`` tokens goes to the fused Hopper kernel
(``ops/fused_attention.py``), as the JAX package routes it to its Pallas
kernel; at ``N >= 2048`` (head dim a multiple of 64) the block normalises
and rotates q and k and hands them, with v as a strided view into the QKV
output, to the flash kernel (``ops/flash_attention.py``); in between, and
at other head dims, the unfused composition runs. ``attn_impl="xla"`` asks
for the unfused composition everywhere, ``attn_impl="flash"`` for the flash
kernel everywhere (the JAX package's ``"pallas"``).

``AE.quantize()`` gives int8 block linears (``Int8Linear``); a quantized
block then runs the JAX package's int8 block as it is routed on the TPU:
RMSNorm + quantize in one kernel, the int8 QKV product, the fused attention,
the int8 out-projection, and the fused int8 fc1 + SwiGLU + requantize kernel
(or the fc1 product and the SwiGLU + quantize kernel) before the int8 fc2
product (``ops/quant.py``). With the opt-in ``VITOK_Q8_EPILOGUE`` the fused
attention quantizes its own output (``fused_qkv_attention_q8``) and the
out-projection reads the codes directly.

Training: ``AE(..., param_dtype=torch.float32, trainable=True)`` and
``model(batch, deterministic=False)`` is the JAX package's
``forward_apply(deterministic=False)``: grad enabled, per-sample drop path
on the decoder blocks, activation checkpointing per ``cfg.checkpoint``.
Under training the fused kernel is not taken with ``attn_impl="auto"`` (the
JAX package's gate): blocks at ``N >= 2048`` run the flash kernel forward
and its two backward kernels, below that the unfused composition under
autograd. ``attn_impl="fused"`` trains on the fused kernel and its backward
kernel where the gate opens. ``encode``/``decode`` and ``model(batch)`` stay
inference calls under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

from vitok_torch.ops import quant as q8
from vitok_torch.ops import fused_attention as fa
from vitok_torch.ops.fused_attention import can_fuse, fused_qkv_attention, unfused_qkv_attention
from vitok_torch.ops.mlp import round_hidden_dim, swiglu
from vitok_torch.ops.norms import layer_norm, layer_scale, rms_norm
from vitok_torch.ops.rope import compute_2d_freqs_cis
from vitok_torch.parallel.comm import copy_to_group, reduce_from_group, row_parallel_int8
from vitok_torch.utils.device import resolve_device

ATTN_IMPLS = ("auto", "fused", "flash", "xla")
# The block intermediates the JAX package tags with ``checkpoint_name``
# (``q_rot``/``k_rot`` exist only on the eager unfused attention route).
REMAT_NAMES = ("h_norm", "qkv_out", "ffn_hid", "q_rot", "k_rot", "attn_out")
# Those a recomputed block keeps here: the two linear outputs whose replay
# skips their products. The rest keep nothing: the replay runs the norm and
# the attention again whatever is kept, since the attention's backward needs
# the forward's row log-sum-exp, which no name holds.
HELD_NAMES = ("qkv_out", "ffn_hid")


@dataclasses.dataclass(frozen=True)
class AEConfig:
    """Static architecture configuration (the JAX package's ``AEConfig``).

    ``checkpoint``: 0 stores every activation, 1 recomputes every block in
    the backward, k > 1 every k-th block (those with ``i % k == 0``); -1
    and -2, the JAX package's unrolled forms of 1 and 0, mean 1 and 0 here,
    where the block loop is always unrolled. ``remat_save`` (names from
    ``REMAT_NAMES``) is what a block recomputed under ``checkpoint`` 1 or -1
    keeps across the backward besides its input (the JAX package's
    ``save_only_these_names`` policy); of its names only ``HELD_NAMES`` keep
    a tensor here. ``checkpoint`` 0, -2 and k > 1 ignore it, as in the JAX
    package.
    """

    pixels_per_token: int = 768
    channels_per_token: int = 32
    encoder_width: int = 1024
    decoder_width: int = 1024
    encoder_depth: int = 4
    decoder_depth: int = 24
    encoder_heads: int = 12
    decoder_heads: int = 12
    mlp_factor: float = 2.67
    checkpoint: int = 0
    remat_save: Tuple[str, ...] = ()
    spatial_stride: int = 16
    temporal_stride: int = 1
    use_layer_scale: bool = True
    layer_scale_init: float = 1e-4
    drop_path_rate: float = 0.0
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
        if not isinstance(self.remat_save, tuple):
            object.__setattr__(self, "remat_save", tuple(self.remat_save))
        unknown = set(self.remat_save) - set(REMAT_NAMES)
        if unknown:
            raise ValueError(f"remat_save: unknown names {sorted(unknown)}; the tagged ones are {REMAT_NAMES}")
        if self.attn_impl not in ATTN_IMPLS and not self.attn_impl.startswith("halo:"):
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS} or 'halo:<axis>', got {self.attn_impl!r}")

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
    y = F.linear(x, lin.weight.to(x.dtype))
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


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


class Int8Linear(nn.Module):
    """A quantized block linear: buffers ``weight_int8 [out, in]`` int8 and
    ``scale [out]`` fp32 (per output channel); no bias, as block linears."""

    def __init__(self, weight_int8: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("weight_int8", weight_int8)
        self.register_buffer("scale", scale)

    @property
    def out_features(self) -> int:
        return self.weight_int8.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return q8.int8_linear(x, self.weight_int8, self.scale)


class _KnownLinear(torch.autograd.Function):
    """``F.linear(h, w)`` whose output ``y`` is already known: the forward
    returns ``y`` without the product, the backward is the linear's
    (``g @ w`` and ``g^T @ h``, autograd's own ``mm`` backward on the
    flattened rows, so the gradients are the same bits)."""

    @staticmethod
    def forward(ctx, h, w, y):
        ctx.save_for_backward(h, w)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, gy):
        h, w = ctx.saved_tensors
        g2 = gy.reshape(-1, gy.shape[-1])
        gh = g2.mm(w).view(h.shape) if ctx.needs_input_grad[0] else None
        gw = g2.t().mm(h.reshape(-1, h.shape[-1])) if ctx.needs_input_grad[1] else None
        return gh, gw, None


class _Taps:
    """A block's named linear products (``HELD_NAMES``). The default,
    ``_Taps()``, is the plain forward. Recording (``kept=None``): each
    product named in ``save`` is kept, detached. Replaying (``kept``
    given): a kept product stands in for its ``F.linear``."""

    def __init__(self, save: Tuple[str, ...] = (), kept: Optional[Dict[str, torch.Tensor]] = None):
        self.save = save
        self.replay = kept is not None
        self.kept: Dict[str, torch.Tensor] = {} if kept is None else kept

    def linear(self, name: str, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.replay and name in self.kept:
            return _KnownLinear.apply(h, w, self.kept[name])
        y = F.linear(h, w)
        if not self.replay and name in self.save:
            self.kept[name] = y.detach()
        return y


_PLAIN = _Taps()


def _drop(_):
    return None


class _SelectiveRemat(torch.autograd.Function):
    """One block under ``checkpoint`` with ``remat_save``: the forward runs
    the block (grad enabled, so every route is the one the plain forward
    takes, and nothing it would save is held) and keeps the block input
    and the named products; the backward runs the block again from them,
    the kept products standing in for theirs, and differentiates it.
    It is applied inside the block's forward, so ``params`` are the ones
    the forward sees (FSDP2's gathered parameters, which its pre-backward
    hook gathers again before this backward runs)."""

    @staticmethod
    def forward(ctx, run, save, x, *params):  # the block's parameters are inputs for autograd to see
        taps = _Taps(save)
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(_drop, _drop):
            y = run(x.detach(), taps)
        ctx.run, ctx.params, ctx.names = run, params, tuple(taps.kept)
        ctx.save_for_backward(x, *taps.kept.values())
        return y.detach()

    @staticmethod
    def backward(ctx, gy):
        x, *kept = ctx.saved_tensors
        x = x.detach().requires_grad_(ctx.needs_input_grad[2])
        with torch.enable_grad():
            y = ctx.run(x, _Taps((), dict(zip(ctx.names, kept))))
        wrt = ([x] if x.requires_grad else []) + [p for p in ctx.params if p.requires_grad]
        got = iter(torch.autograd.grad(y, wrt, gy, allow_unused=True))
        gx = next(got) if x.requires_grad else None
        return (None, None, gx, *(next(got) if p.requires_grad else None for p in ctx.params))


def _prequant(xq, a_scale, lin: Int8Linear, dtype) -> torch.Tensor:
    return q8.int8_matmul_prequant(xq, a_scale, lin.weight_int8, lin.scale, dtype)


class Block(nn.Module):
    """Parallel block: ``x + ls(attn(norm(x)) + mlp(norm(x)))``.

    Under tensor parallelism (``tp_group`` set by
    ``vitok_torch.parallel.sharding.apply_tensor_parallel``) the block holds
    ``heads`` of the model's heads and the matching slices of its linears:
    the normed input's gradient and the q/k gains' are summed over the group
    in the backward, and the attention and FFN partial sums are all-reduced
    once before the residual. An int8 block slices qkv and out only and
    keeps its FFN whole (:func:`row_parallel_int8` for out)."""

    tp_group = None
    tp_size = 1

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
        deterministic: bool = True,
        drop_gate: Optional[torch.Tensor] = None,
        taps: _Taps = _PLAIN,
        remat_save: Tuple[str, ...] = (),
    ) -> torch.Tensor:
        """``drop_gate``: per-sample stochastic-depth factor ``[B, 1, 1]``
        (``floor(keep + U) / keep``), or None for no drop path. ``taps``:
        the named products of a selectively recomputed block.
        ``remat_save``: run the block under selective recomputation
        (:meth:`remat_forward`)."""
        if remat_save:
            run = lambda x_, taps_: self.forward(x_, rope, patch_mask, sliding_window, attn_impl, deterministic,
                                                 drop_gate, taps_)
            return _SelectiveRemat.apply(run, remat_save, x, *self.parameters())
        int8 = isinstance(self.attn.qkv_proj, Int8Linear)
        tp = self.tp_group
        q_gain, k_gain = self.attn.norm_q.weight, self.attn.norm_k.weight
        if int8:
            qkv, hid = self._int8_qkv_fc1(x)
        else:
            h = rms_norm(x, self.norm1.weight)
            if tp is not None:
                h = copy_to_group(h, tp)
                q_gain, k_gain = copy_to_group(q_gain, tp), copy_to_group(k_gain, tp)
            qkv = taps.linear("qkv_out", h, self.attn.qkv_proj.weight.to(h.dtype))
        # The fused kernel is an inference path (the JAX package's gate):
        # "auto" takes it only when deterministic, "fused" asks for it where
        # its gate opens and degrades to auto routing elsewhere. A
        # tensor-parallel block holds heads / tp of the local qkv's width c;
        # the gate reads the model's, so every layout routes as one device
        # does (the kernels take any number of heads). A call that asks for
        # a gradient reads the backward's gate (its head dims on the card).
        n, c = x.shape[1], qkv.shape[-1] // 3
        fuse_gate = fa.can_fuse_bwd if fa.asks_grad(qkv, q_gain, k_gain) else can_fuse
        fused = (
            attn_impl in ("auto", "fused")
            and (deterministic or attn_impl == "fused")
            and fuse_gate(n, c * self.tp_size, self.heads * self.tp_size, cuda=qkv.is_cuda, dtype=qkv.dtype)
        )
        args = (qkv, q_gain, k_gain, rope[0], rope[1], patch_mask)
        if (fused and int8 and deterministic and tp is None
                and fa.can_fuse_q8(n, c, self.heads, cuda=qkv.is_cuda, dtype=qkv.dtype)):
            # The kernel's epilogue quantizes per token, so the out-projection
            # reads int8 codes and the bf16 attention output is never written.
            aq, a_scale = fa.fused_qkv_attention_q8(*args, num_heads=self.heads,
                                                    sliding_window=sliding_window)
            return self._residual(x, _prequant(aq, a_scale, self.attn.out_proj, x.dtype)
                                  + self._int8_mlp(hid, x), drop_gate)
        if fused:
            attn = fused_qkv_attention(*args, num_heads=self.heads, sliding_window=sliding_window,
                                       impl="fused")
        else:
            attn = unfused_qkv_attention(*args, self.heads, sliding_window,
                                         attn_impl="auto" if attn_impl == "fused" else attn_impl)
        if int8:
            out = self._int8_out(attn) + self._int8_mlp(hid, x)
        else:
            out = F.linear(attn, self.attn.out_proj.weight.to(attn.dtype)) + swiglu(
                h, self.ffn.fc1.weight, self.ffn.fc2.weight, fc1=functools.partial(taps.linear, "ffn_hid")
            )
            if tp is not None:
                out = reduce_from_group(out, tp)
        return self._residual(x, out, drop_gate)

    def remat_forward(self, save: Tuple[str, ...], x: torch.Tensor, *args) -> torch.Tensor:
        """The training forward under selective recomputation: the backward
        keeps the block input and the products named in ``save`` (of
        ``HELD_NAMES``), which the replay does not compute again, and
        recomputes the rest. ``args`` are :meth:`forward`'s after ``x``.
        Gradients are the plain backward's, bit for bit on the CPU. It goes
        through the module's call, so FSDP2's hooks gather the parameters."""
        return self(x, *args, remat_save=save)

    def _residual(self, x, out, drop_gate):
        if self.layer_scale is not None:
            out = layer_scale(out, self.layer_scale.gamma)
        if drop_gate is not None:
            out = out * drop_gate.to(out.dtype)
        return x + out

    def _int8_qkv_fc1(self, x: torch.Tensor):
        """qkv and fc1 read one int8 copy of the normed input (``_block_body``'s
        shared-int8 branch). Returns the QKV output and either the fused FFN's
        ``(tq, t_scale)`` or the compute-dtype fc1 output."""
        b, n, c = x.shape
        if q8.can_fuse_silu_quant(n):
            hq, h_scale = q8.fused_rmsnorm_quant(x, self.norm1.weight)
        else:
            hq, h_scale = q8.quantize_activation(rms_norm(x, self.norm1.weight))
        qkv = _prequant(hq, h_scale, self.attn.qkv_proj, x.dtype)
        fc1 = self.ffn.fc1
        if q8.can_fuse_ffn(b * n, c, fc1.out_features):
            hid = q8.fused_ffn_int8(hq.reshape(b * n, c), h_scale.reshape(b * n, 1),
                                    fc1.weight_int8, fc1.scale)
        else:
            hid = _prequant(hq, h_scale, fc1, x.dtype)
        return qkv, hid

    def _int8_out(self, attn: torch.Tensor) -> torch.Tensor:
        """The int8 out-projection; under tensor parallelism on the rank's
        heads, summed over the group (:func:`row_parallel_int8`)."""
        lin = self.attn.out_proj
        if self.tp_group is None:
            return lin(attn)
        return row_parallel_int8(attn, lin.weight_int8, lin.scale, self.tp_group)

    def _int8_mlp(self, hid, x: torch.Tensor) -> torch.Tensor:
        """SwiGLU and the int8 fc2 product on what :meth:`_int8_qkv_fc1` gave."""
        fc2 = self.ffn.fc2
        if isinstance(hid, tuple):  # already gated and quantized
            return _prequant(*hid, fc2, x.dtype).reshape(x.shape)
        if q8.can_fuse_silu_quant(x.shape[1]):
            return _prequant(*q8.fused_silu_quant(hid), fc2, x.dtype)
        v, g = hid.chunk(2, -1)
        return fc2(F.silu(g) * v)


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
    ``utils.params_io.from_jax_params``; int8 block weights make an int8
    model) is given. Runs on the card unless ``device="cpu"``.

    ``param_dtype`` is the dtype the Linear weights, biases and LayerScale
    gains are held in: the compute dtype by default (inference), or
    ``torch.float32`` for master weights that are cast where they are used.
    Parameters require no grad unless ``trainable=True``.
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
        self.cfg = cfg = AEConfig(**_filter_known(kwargs))
        self.device = device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.param_dtype = dt = compute_dtype if param_dtype is None else param_dtype
        # An int8 state dict is loaded int8-native: the modules are made on
        # the meta device, so no full-precision weight is ever allocated.
        int8 = state_dict is not None and q8.is_quantized(state_dict)
        build = torch.device("meta") if int8 else device
        blocks = lambda width, depth, heads, ffn: nn.ModuleList(
            Block(width, heads, ffn, cfg.use_layer_scale, cfg.layer_scale_init, build, dt)
            for _ in range(depth)
        )
        if cfg.encoder:
            self.patch_embed = nn.Linear(cfg.pixels_per_token, cfg.encoder_width, device=build, dtype=dt)
            self.encoder_blocks = blocks(
                cfg.encoder_width, cfg.encoder_depth, cfg.encoder_heads, cfg.encoder_ffn_dim
            )
            self.to_code = nn.Linear(cfg.encoder_width, cfg.channels_per_token, device=build, dtype=dt)
        if cfg.decoder:
            self.decoder_embed = nn.Linear(cfg.channels_per_token, cfg.decoder_width, device=build, dtype=dt)
            self.decoder_blocks = blocks(
                cfg.decoder_width, cfg.decoder_depth, cfg.decoder_heads, cfg.decoder_ffn_dim
            )
            self.to_pixels = nn.Linear(cfg.decoder_width, cfg.pixels_per_token, device=build, dtype=dt)
        self.requires_grad_(False)
        if state_dict is None:
            self._init_weights(seed)
        elif int8:
            self.quantize()  # the int8 layout, on the meta device
            own = self.state_dict()
            self.load_state_dict({k: v.to(device=device, dtype=own.get(k, v).dtype, copy=True)
                                  for k, v in state_dict.items()}, assign=True)
        else:
            self.load_state_dict(state_dict)
        if trainable:
            if self.is_quantized:
                raise ValueError("an int8 model cannot be trained: build it from full-precision weights")
            self.requires_grad_(True)

    @property
    def is_quantized(self) -> bool:
        return any(isinstance(m, Int8Linear) for m in self.modules())

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        """Linear weights and biases ~ U(+-1/sqrt(fan_in)) (torch's nn.Linear
        bound) from a generator seeded with ``seed``; gains stay as built. On
        the meta device (shapes only) nothing is drawn."""
        if self.device.type == "meta":
            return
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                bound = mod.in_features ** -0.5
                for p in (mod.weight, mod.bias):
                    if p is not None:
                        u = torch.rand(p.shape, generator=gen, device=self.device)
                        p.copy_((u * 2 - 1) * bound)

    @torch.no_grad()
    def quantize(self) -> "AE":
        """Int8 block linears (``qkv_proj``, ``out_proj``, ``fc1``, ``fc2``),
        per-output-channel scales, fc1/fc2 padded to 128-aligned SwiGLU halves
        first, as ``quantize_block_params`` does; embeds and heads keep the
        compute dtype. Converts layer by layer on the model's device and drops
        each full-precision weight as it goes (a pipe stage its own blocks).
        Idempotent; returns ``self``.

        It quantizes the weights the model holds: a bf16 model's are rounded
        to bf16 first, so codes may differ by one step from those of the fp32
        weights. For int8 serving of fp32 checkpoints (the released ones),
        quantize the fp32 state dict (``ops/quant.py::quantize_state_dict``)
        before building the bf16 model instead.
        """
        for blk in [*getattr(self, "encoder_blocks", ()), *getattr(self, "decoder_blocks", ())]:
            if not isinstance(blk, Block):  # a block another pipe stage holds
                continue
            if blk.tp_group is not None:
                raise ValueError("quantize before tensor parallelism: the scales span whole rows")
            for path in q8.QUANT_LINEARS:
                parent_name, name = path.split(".")
                parent = getattr(blk, parent_name)
                lin = getattr(parent, name)
                if not isinstance(lin, Int8Linear):
                    setattr(parent, name, Int8Linear(*q8.quantize_block_linear(name, lin.weight)))
                del lin  # the full-precision weight goes with its module
        return self

    def _blocks(self, x, blocks, patch_dict, head_dim, deterministic=True, drop_gates=None):
        """The block stack. ``drop_gates``: None, or one ``[B, 1, 1]`` factor
        per block. When grad is enabled, blocks picked by ``cfg.checkpoint``
        store only their input (and, under 1 or -1, the ``cfg.remat_save``
        products of ``HELD_NAMES``) and are recomputed in the backward."""
        cfg = self.cfg
        rope = _rope_tables(patch_dict, head_dim, cfg.rope_theta, self.device)
        mask = patch_dict.get("patch_mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device).bool()
        every = {-1: 1, -2: 0}.get(cfg.checkpoint, max(cfg.checkpoint, 0))
        remat = every > 0 and torch.is_grad_enabled()
        save = tuple(n for n in cfg.remat_save if n in HELD_NAMES) if remat and every == 1 else ()
        for i, blk in enumerate(blocks):
            gate = None if drop_gates is None else drop_gates[i]
            args = (x, rope, mask, cfg.sw, cfg.attn_impl, deterministic, gate)
            if save:
                x = blk.remat_forward(save, *args)
            elif remat and i % every == 0:
                x = _checkpoint(blk, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                x = blk(*args)
        return x

    def _encode(self, patch_dict, deterministic=True):
        x = torch.as_tensor(patch_dict["patches"], device=self.device).to(self.compute_dtype)
        x = _linear(x, self.patch_embed)
        # The encoder never drops a path (the JAX package ramps the decoder only).
        x = self._blocks(x, self.encoder_blocks, patch_dict, self.cfg.encoder_head_dim, deterministic)
        out = _meta(patch_dict)
        out["z"] = layer_norm(_linear(x, self.to_code))
        return out

    def _decode(self, encode_dict, deterministic=True, drop_gates=None):
        x = torch.as_tensor(encode_dict["z"], device=self.device).to(self.compute_dtype)
        x = _linear(x, self.decoder_embed)
        x = self._blocks(x, self.decoder_blocks, encode_dict, self.cfg.decoder_head_dim,
                         deterministic, drop_gates)
        out = _meta(encode_dict)
        out["patches"] = _linear(x, self.to_pixels)
        return out

    @torch.no_grad()
    def encode(self, patch_dict: Dict[str, Any]) -> Dict[str, Any]:
        """NaFlex patch dict -> ``{"z": [B, N, c], **metadata}`` (inference)."""
        return self._encode(patch_dict)

    @torch.no_grad()
    def decode(self, encode_dict: Dict[str, Any]) -> Dict[str, Any]:
        """Latents -> ``{"patches": [B, N, pixels_per_token], **metadata}`` (inference)."""
        return self._decode(encode_dict)

    def drop_path_gates(self, batch: int, generator: Optional[torch.Generator] = None,
                        uniforms: Optional[torch.Tensor] = None) -> Optional[list]:
        """Per-sample stochastic-depth factors of the decoder blocks, or None
        when ``cfg.drop_path_rate`` is 0: block ``i`` keeps a sample with
        probability ``keep_i = 1 - rate * i / (depth - 1)`` and scales it by
        ``1 / keep_i``, i.e. ``floor(keep_i + U) / keep_i``. ``U`` is drawn
        from ``generator``, or given as ``uniforms`` ``[depth, B]``."""
        cfg = self.cfg
        if cfg.drop_path_rate <= 0.0:
            return None
        d = cfg.decoder_depth
        if uniforms is None:
            uniforms = torch.rand((d, batch), generator=generator,
                                  device=None if generator is None else generator.device)
        u = torch.as_tensor(uniforms, dtype=torch.float32).to(self.device).reshape(d, batch, 1, 1)
        gates = []
        for i in range(d):
            keep = 1.0 - cfg.drop_path_rate * i / max(d - 1, 1)
            scale = 1.0 / max(keep, 1e-8) if keep > 0.0 else 0.0
            gates.append(torch.floor(keep + u[i]) * scale)
        return gates

    def forward(
        self,
        patch_dict: Dict[str, Any],
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        drop_uniforms: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """Encode then decode (whichever halves the config has).

        ``deterministic=True`` is inference, under ``torch.no_grad()``.
        ``deterministic=False`` is the training forward: grad follows the
        caller's mode, the fused attention kernel is not taken, the decoder
        blocks drop paths per sample (uniforms from ``generator``, or given
        as ``drop_uniforms`` ``[decoder_depth, B]``), and ``cfg.checkpoint``
        picks the blocks to recompute in the backward.
        """
        if deterministic:
            with torch.no_grad():
                out = patch_dict
                if self.cfg.encoder:
                    out = self._encode(out)
                if self.cfg.decoder:
                    out = self._decode(out)
                return out
        if self.is_quantized:
            raise ValueError("an int8 model cannot be trained: its block linears hold int8 codes")
        out = patch_dict
        if self.cfg.encoder:
            out = self._encode(out, deterministic=False)
        if self.cfg.decoder:
            batch = (out["z"] if "z" in out else out["patches"]).shape[0]
            gates = self.drop_path_gates(batch, generator, drop_uniforms)
            out = self._decode(out, deterministic=False, drop_gates=gates)
        return out


def Model(**kw) -> AE:
    """``AE(**kw)``: the JAX package's (and the reference's) factory name."""
    return AE(**kw)


def num_params(model: nn.Module) -> int:
    """The parameter count of a module (its int8 codes and scales too)."""
    return sum(t.numel() for t in [*model.parameters(), *model.buffers()])


__all__ = ["AE", "AEConfig", "Block", "HELD_NAMES", "Int8Linear", "Model", "REMAT_NAMES", "decode_variant",
           "num_params"]
