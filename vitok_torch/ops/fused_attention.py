"""Fused QK-norm + rotate-half RoPE + masked attention from the flat QKV.

Port of ``vitok_tpu/ops/fused_attention.py``: the input is the raw
``[B, N, 3C]`` QKV projection output (q | k | v planes along channels), the
output the flat ``[B, N, C]`` attention result. On a CUDA tensor
:func:`fused_qkv_attention` launches the hand-written Hopper kernel in
``vitok_torch/csrc/fused_attention.cu`` (it replaces the TPU kernel
``_fused_kernel``); on a CPU tensor it runs :func:`fused_qkv_attention_plain`,
the same function in plain PyTorch. The CUDA path never falls back.

Masking is key-side only, as in the TPU kernel: padded query rows attend to
the valid keys. The unfused composition (:func:`unfused_qkv_attention`)
masks two-sided, so the two agree on valid rows.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from vitok_torch.ops import _build
from vitok_torch.ops.attention import dot_product_attention
from vitok_torch.ops.norms import rms_norm
from vitok_torch.ops.rope import apply_rotary_emb

MAX_FUSED_TOKENS = 1024
KERNEL_HEAD_DIMS = (64, 128)
_NEG_FILL = -1e30
_LOG2E = 1.4426950408889634

# Launches of the CUDA kernel since the count was last set to 0.
LAUNCHES = 0


def can_fuse(n: int, c: int, num_heads: int) -> bool:
    """Whether a block at this shape routes to the fused kernel.

    The JAX package's gate (``fused_attention.py:979-989``): at most
    ``MAX_FUSED_TOKENS`` tokens, ``n % 8 == 0``, head dim a multiple of 64
    and a 128-lane head group dividing C.
    """
    if c % num_heads:
        return False
    d = c // num_heads
    group = d * 128 // math.gcd(d, 128)
    return n <= MAX_FUSED_TOKENS and n % 8 == 0 and d % 64 == 0 and c % group == 0


def _split_qkv(qkv, num_heads):
    b, n, c3 = qkv.shape
    c = c3 // 3
    return qkv.view(b, n, 3, num_heads, c // num_heads).unbind(2)


def fused_qkv_attention_plain(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``_attend_cell``).

    fp32 norm statistics, rotation in ``qkv.dtype``, fp32 logits scaled by
    ``log2(e)/sqrt(d)``, key-side mask and window filled with -1e30, ``exp2``
    against the full-row max, P cast to v's dtype before PV, fp32
    accumulation, then division by the fp32 row sum.
    """
    b, n, c3 = qkv.shape
    q, k, v = _split_qkv(qkv, num_heads)
    d = q.shape[-1]
    q, k = apply_rotary_emb(rms_norm(q, q_scale), rms_norm(k, k_scale), cos, sin, convention="half")
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / d ** 0.5 * _LOG2E)
    if patch_mask is not None:
        s = s.masked_fill(~patch_mask.bool()[:, None, None, :], _NEG_FILL)
    if sliding_window is not None:
        idx = torch.arange(n, device=qkv.device)
        outside = (idx[:, None] - idx[None, :]).abs() > sliding_window
        s = s.masked_fill(outside, _NEG_FILL)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / p.sum(-1).transpose(1, 2)[..., None]
    return o.to(qkv.dtype).reshape(b, n, c3 // 3)


def _fused_cuda(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window):
    global LAUNCHES
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, N, 3C], got {tuple(qkv.shape)}")
    b, n, c3 = qkv.shape
    c = c3 // 3
    if c % num_heads:
        raise ValueError(f"C={c} is not a multiple of num_heads={num_heads}")
    d = c // num_heads
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the fused CUDA kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(
            f"the fused CUDA kernel takes bfloat16 qkv, got {qkv.dtype} "
            "(fp32 has no kernel instance yet: ROADMAP.md Queue 3)"
        )
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    dev = qkv.device
    for name, t, shape in (
        ("q_scale", q_scale, (d,)),
        ("k_scale", k_scale, (d,)),
        ("cos", cos, (b, n, d // 2)),
        ("sin", sin, (b, n, d // 2)),
    ):
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} on {dev}, got {tuple(t.shape)} on {t.device}")
    if patch_mask is not None and (patch_mask.device != dev or tuple(patch_mask.shape) != (b, n)):
        raise ValueError(f"patch_mask must be {(b, n)} on {dev}")
    q_scale = q_scale.float().contiguous()
    k_scale = k_scale.float().contiguous()
    cos = cos.float().contiguous()
    sin = sin.float().contiguous()
    mask = patch_mask.bool().contiguous() if patch_mask is not None else None
    sw = -1 if sliding_window is None else int(sliding_window)
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=dev)

    lib = _kernel_lib()
    with torch.cuda.device(dev):  # the C entry launches on the current device
        err = lib.vitok_fused_attention_bf16(
            qkv.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), mask.data_ptr() if mask is not None else None, out.data_ptr(),
            b, n, num_heads, d, sw, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, "fused_attention launch")
    LAUNCHES += 1
    return out


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("fused_attention")
    fn = lib.vitok_fused_attention_bf16
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 7 + [i] * 5 + [ptr]
        fn.restype = ctypes.c_int
    return lib


def unfused_qkv_attention(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    patch_mask: Optional[torch.Tensor],
    num_heads: int,
    sliding_window: Optional[int],
    attn_impl: str = "auto",
) -> torch.Tensor:
    """The unfused composition the kernel replaces (two-sided mask)."""
    b, n, c3 = qkv.shape
    q, k, v = _split_qkv(qkv, num_heads)
    q, k = apply_rotary_emb(rms_norm(q, q_scale), rms_norm(k, k_scale), cos, sin, convention="half")
    out = dot_product_attention(
        q, k, v, patch_mask=patch_mask, sliding_window=sliding_window, impl=attn_impl
    )
    return out.reshape(b, n, c3 // 3)


def fused_qkv_attention(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    sliding_window: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """QK-norm + rotate-half RoPE + masked attention from flat QKV.

    Args:
        qkv: ``[B, N, 3C]`` fused QKV projection output.
        q_scale, k_scale: ``[D]`` QK-RMSNorm gains.
        cos, sin: ``[B, N, D//2]`` fp32 RoPE tables (rotate-half pairing).
        patch_mask: optional ``[B, N]`` bool validity mask.
        num_heads: head count H (``D = C // H``).
        sliding_window: optional half-width ``|i-j| <= sw``.
        impl: ``"auto"`` (the fused kernel where :func:`can_fuse`, else the
            unfused composition), ``"fused"`` (force the kernel), or an
            attention impl name for the unfused path (``"flash"``, ``"xla"``).

    Returns:
        ``[B, N, C]`` in qkv's dtype.
    """
    n, c = qkv.shape[1], qkv.shape[-1] // 3
    if impl == "fused" or (impl == "auto" and can_fuse(n, c, num_heads)):
        args = (qkv, q_scale, k_scale, cos, sin, patch_mask)
        if qkv.is_cuda:
            return _fused_cuda(*args, num_heads, sliding_window)
        if qkv.device.type != "cpu":
            raise RuntimeError(f"no fused attention kernel for device {qkv.device}")
        return fused_qkv_attention_plain(*args, num_heads=num_heads, sliding_window=sliding_window)
    return unfused_qkv_attention(
        qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window, attn_impl=impl
    )


__all__ = [
    "fused_qkv_attention",
    "fused_qkv_attention_plain",
    "unfused_qkv_attention",
    "can_fuse",
    "MAX_FUSED_TOKENS",
]
