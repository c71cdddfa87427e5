"""Fused QK-norm + rotate-half RoPE + masked attention from the flat QKV.

Port of ``vitok_tpu/ops/fused_attention.py``: the input is the raw
``[B, N, 3C]`` QKV projection output (q | k | v planes along channels), the
output the flat ``[B, N, C]`` attention result. On a CUDA tensor
:func:`fused_qkv_attention` launches the hand-written Hopper kernel in
``vitok_torch/csrc/fused_attention.cu`` (it replaces the TPU kernel
``_fused_kernel``; bf16, or its fp32 instance on fp32 qkv); on a CPU tensor it
runs :func:`fused_qkv_attention_plain`, the same function in plain PyTorch.
The CUDA path never falls back.

Under autograd the kernel's backward is a kernel too
(:func:`fused_qkv_attention_bwd`, ``csrc/fused_attention_bwd.cu``, replacing
``_fused_bwd_kernel``), and :func:`fused_qkv_attention_q8`
(``fused_attention_q8_kernel`` in ``csrc/fused_attention.cu``, replacing
``_fused_kernel_q8``) is the forward with a per-token int8 quantize as its
epilogue, for the int8 block's out-projection. Each has its plain version
beside it and its own launch count.

Masking is key-side only, as in the TPU kernel: padded query rows attend to
the valid keys. The unfused composition (:func:`unfused_qkv_attention`)
masks two-sided, so the two agree on valid rows.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional, Tuple

import torch

from vitok_torch.ops import _build
from vitok_torch.ops.attention import dot_product_attention
from vitok_torch.ops.norms import rms_norm
from vitok_torch.ops.quant import quantize_activation
from vitok_torch.ops.rope import apply_rotary_emb

MAX_FUSED_TOKENS = 1024
KERNEL_HEAD_DIMS = (64, 128)
_NEG_FILL = -1e30
_LOG2E = 1.4426950408889634

_RMS_EPS = 1e-6

# Launches of each CUDA kernel since its count was last set to 0: the
# forward, its backward, and the forward with the int8 epilogue.
LAUNCHES = 0
BWD_LAUNCHES = 0
Q8_LAUNCHES = 0

# The int8 epilogue is opt-in, as in the JAX package (``VITOK_Q8_EPILOGUE``).
_ENABLE_Q8 = os.environ.get("VITOK_Q8_EPILOGUE", "0") not in ("", "0")
# The JAX package's per-cell budget (bytes) behind its int8-epilogue shape
# gate; kept so that both packages route the same shapes.
_Q8_BUDGET = 13 * 1024 * 1024
_SMEM_LIMIT = 232448  # dynamic shared memory a block may use on sm_90


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


def _check_cuda_args(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window,
                     dtypes=(torch.bfloat16,)):
    """Validates a CUDA call and returns ``(b, n, c, d, q_scale, k_scale, cos,
    sin, mask, sw)`` in the types and layouts the kernels read. ``dtypes``:
    the qkv types the kernel has instances for."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, N, 3C], got {tuple(qkv.shape)}")
    b, n, c3 = qkv.shape
    c = c3 // 3
    if c % num_heads:
        raise ValueError(f"C={c} is not a multiple of num_heads={num_heads}")
    d = c // num_heads
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the fused CUDA kernels take head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    if qkv.dtype not in dtypes:
        names = " or ".join(str(t).replace("torch.", "") for t in dtypes)
        why = "" if torch.float32 in dtypes or torch.int8 in dtypes else (
            " (fp32 has an instance of the forward kernel only: ROADMAP.md Queue 3)")
        raise TypeError(f"this fused CUDA kernel takes {names} qkv, got {qkv.dtype}{why}")
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
    mask = patch_mask.bool().contiguous() if patch_mask is not None else None
    sw = -1 if sliding_window is None else int(sliding_window)
    return (b, n, c, d, q_scale.detach().float().contiguous(), k_scale.detach().float().contiguous(),
            cos.detach().float().contiguous(), sin.detach().float().contiguous(), mask, sw)


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _fused_cuda(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window):
    global LAUNCHES
    b, n, c, d, q_scale, k_scale, cos, sin, mask, sw = _check_cuda_args(
        qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window,
        dtypes=(torch.bfloat16, torch.float32),
    )
    dev = qkv.device
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=dev)
    lib = _kernel_lib()
    entry = lib.vitok_fused_attention_f32 if qkv.dtype == torch.float32 else lib.vitok_fused_attention_bf16
    with torch.cuda.device(dev):  # the C entry launches on the current device
        err = entry(
            qkv.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), _ptr(mask), out.data_ptr(),
            b, n, num_heads, d, sw, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, "fused_attention launch")
    LAUNCHES += 1
    return out


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("fused_attention")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for fn, argtypes in (
        (lib.vitok_fused_attention_bf16, [ptr] * 7 + [i] * 5 + [ptr]),
        (lib.vitok_fused_attention_f32, [ptr] * 7 + [i] * 5 + [ptr]),
        (lib.vitok_fused_attention_q8_bf16, [ptr] * 8 + [i] * 6 + [ptr]),
    ):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _bwd_kernel_lib() -> ctypes.CDLL:
    lib = _build.load("fused_attention_bwd")
    fn = lib.vitok_fused_attention_bwd_bf16
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 12 + [i] * 5 + [ptr]
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# Backward (kernel #3)
# ---------------------------------------------------------------------------


def can_fuse_bwd(n: int, c: int, num_heads: int) -> bool:
    """Whether the backward kernel takes this shape: wherever the forward
    kernel does. (The JAX package's gate is tighter, on the TPU's VMEM; it
    falls back to the unfused VJP at 1024 tokens. ROADMAP.md Queue 3.)"""
    return can_fuse(n, c, num_heads)


def _rotate_half_bwd(dz: torch.Tensor, cos32: torch.Tensor, sin32: torch.Tensor) -> torch.Tensor:
    """Transpose of the rotate-half rotation in fp32: ``dz [..., D]``."""
    d2 = dz.shape[-1] // 2
    dzr, dzi = dz[..., :d2], dz[..., d2:]
    return torch.cat([dzr * cos32 + dzi * sin32, dzi * cos32 - dzr * sin32], dim=-1)


def fused_qkv_attention_bwd_plain(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    patch_mask: Optional[torch.Tensor],
    dout: torch.Tensor,
    *,
    num_heads: int,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain PyTorch (``_fused_bwd_kernel``
    behind ``_fused_op_bwd``), product by product with its rounding points.

    The cotangent is zeroed on padded query rows first. Norm statistics in
    fp32, normed q/k cast to ``qkv.dtype`` and rotated there with cos/sin in
    that dtype; fp32 logits times ``1/sqrt(d)``, key-side mask and window
    filled with -1e30; ``p`` from the full row; ``dv = p^T dO`` with ``p`` in
    ``qkv.dtype``; ``delta = sum_k dp * p`` in fp32; ``ds`` cast to
    ``qkv.dtype`` for ``dqrot`` and ``dkrot``; the rotation's transpose and
    the RMSNorm backward in fp32 on the raw q/k. cos/sin get no gradient.

    Returns ``(dqkv [B, N, 3C] in qkv.dtype, dq_scale [D], dk_scale [D])``
    with the gain gradients in fp32.
    """
    b, n, c3 = qkv.shape
    dt = qkv.dtype
    q, k, v = _split_qkv(qkv, num_heads)
    d = q.shape[-1]
    d2 = d // 2
    inv_sqrt_d = 1.0 / d ** 0.5
    g = dout
    if patch_mask is not None:
        g = g * patch_mask.to(g.dtype)[..., None]
    do = g.to(dt).reshape(b, n, num_heads, d)
    cos_b = cos.to(dt)[:, :, None, :]
    sin_b = sin.to(dt)[:, :, None, :]

    def norm_rope(x, scale):
        x32 = x.float()
        r = torch.rsqrt(x32.square().mean(-1, keepdim=True) + _RMS_EPS)
        yb = (x32 * r * scale.float()).to(dt)
        xr, xi = yb[..., :d2], yb[..., d2:]
        rot = torch.cat([xr * cos_b - xi * sin_b, xr * sin_b + xi * cos_b], dim=-1)
        return x32, r, rot.float()

    q32, rq, qrot = norm_rope(q, q_scale)
    k32, rk, krot = norm_rope(k, k_scale)
    v32, do32 = v.float(), do.float()

    s = torch.einsum("bqhd,bkhd->bhqk", qrot, krot) * inv_sqrt_d
    if patch_mask is not None:
        s = s.masked_fill(~patch_mask.bool()[:, None, None, :], _NEG_FILL)
    if sliding_window is not None:
        idx = torch.arange(n, device=qkv.device)
        s = s.masked_fill((idx[:, None] - idx[None, :]).abs() > sliding_window, _NEG_FILL)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)

    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    delta = (dp * p).sum(-1, keepdim=True)
    dsb = (p * (dp - delta) * inv_sqrt_d).to(dt).float()
    dqrot = torch.einsum("bhqk,bkhd->bqhd", dsb, krot)
    dkrot = torch.einsum("bhqk,bqhd->bkhd", dsb, qrot)

    cos32, sin32 = cos_b.float(), sin_b.float()

    def norm_bwd(dz, x32, r, scale):
        dy = _rotate_half_bwd(dz, cos32, sin32)
        dscale = (dy * x32 * r).sum((0, 1, 2))
        gy = dy * scale.float()
        dx = gy * r - x32 * (r * r * r / d) * (gy * x32).sum(-1, keepdim=True)
        return dx, dscale

    dq, dqs = norm_bwd(dqrot, q32, rq, q_scale)
    dk, dks = norm_bwd(dkrot, k32, rk, k_scale)
    dqkv = torch.stack([dq.to(dt), dk.to(dt), dv.to(dt)], dim=2).reshape(b, n, c3)
    return dqkv, dqs, dks


def _fused_bwd_cuda(qkv, q_scale, k_scale, cos, sin, patch_mask, dout, num_heads, sliding_window):
    global BWD_LAUNCHES
    b, n, c, d, q_scale, k_scale, cos, sin, mask, sw = _check_cuda_args(
        qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window
    )
    dev = qkv.device
    if dout.device != dev or tuple(dout.shape) != (b, n, c) or dout.dtype != qkv.dtype:
        raise ValueError(
            f"dout must be {(b, n, c)} {qkv.dtype} on {dev}, got {tuple(dout.shape)} {dout.dtype}"
        )
    dout = dout.contiguous()
    if dout.data_ptr() % 16:
        dout = dout.clone()
    tiles = (n + 63) // 64
    dqkv = torch.empty_like(qkv)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=dev)
    delta = torch.empty((b, num_heads, n), dtype=torch.float32, device=dev)
    part_q = torch.empty((b, num_heads, tiles, d), dtype=torch.float32, device=dev)
    part_k = torch.empty((b, num_heads, tiles, d), dtype=torch.float32, device=dev)
    lib = _bwd_kernel_lib()
    with torch.cuda.device(dev):
        err = lib.vitok_fused_attention_bwd_bf16(
            qkv.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), _ptr(mask), dout.data_ptr(), dqkv.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), part_q.data_ptr(), part_k.data_ptr(),
            b, n, num_heads, d, sw, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, "fused_attention_bwd launch")
    BWD_LAUNCHES += 1
    # The blocks' partials, summed in a fixed order (no atomics).
    return dqkv, part_q.sum((0, 1, 2)), part_k.sum((0, 1, 2))


def fused_qkv_attention_bwd(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    patch_mask: Optional[torch.Tensor],
    dout: torch.Tensor,
    *,
    num_heads: int,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of the fused kernel: ``(dqkv, dq_scale, dk_scale)`` from the
    forward's inputs and the cotangent ``dout [B, N, C]`` of its output.

    The cotangent is zeroed on padded query rows first, as the JAX package's
    ``_fused_op_bwd`` does. On a CUDA tensor this launches the backward
    kernel (bf16, head dim 64 or 128) or raises; on a CPU tensor it runs
    :func:`fused_qkv_attention_bwd_plain`. The gain gradients are fp32.
    """
    args = (qkv, q_scale, k_scale, cos, sin, patch_mask)
    if qkv.is_cuda:
        if patch_mask is not None:
            dout = dout * patch_mask.to(dout.dtype)[..., None]
        return _fused_bwd_cuda(*args, dout, num_heads, sliding_window)
    if qkv.device.type != "cpu":
        raise RuntimeError(f"no fused attention kernel for device {qkv.device}")
    return fused_qkv_attention_bwd_plain(
        *args, dout, num_heads=num_heads, sliding_window=sliding_window
    )


def _fused_forward(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    args = (qkv, q_scale, k_scale, cos, sin, patch_mask)
    if qkv.is_cuda:
        return _fused_cuda(*args, num_heads, sliding_window)
    if qkv.device.type != "cpu":
        raise RuntimeError(f"no fused attention kernel for device {qkv.device}")
    return fused_qkv_attention_plain(*args, num_heads=num_heads, sliding_window=sliding_window)


class _FusedAttention(torch.autograd.Function):
    """The fused forward with :func:`fused_qkv_attention_bwd` as its backward
    (the JAX package's ``_fused_op`` custom VJP). Saves only its inputs: the
    backward recomputes the probabilities. cos/sin get no gradient."""

    @staticmethod
    def forward(ctx, qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window):
        ctx.save_for_backward(qkv, q_scale, k_scale, cos, sin, patch_mask)
        ctx.num_heads = num_heads
        ctx.sliding_window = sliding_window
        return _fused_forward(
            qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window
        )

    @staticmethod
    def backward(ctx, dout):
        qkv, q_scale, k_scale, cos, sin, patch_mask = ctx.saved_tensors
        dqkv, dqs, dks = fused_qkv_attention_bwd(
            qkv, q_scale, k_scale, cos, sin, patch_mask, dout,
            num_heads=ctx.num_heads, sliding_window=ctx.sliding_window,
        )
        return dqkv, dqs.to(q_scale.dtype), dks.to(k_scale.dtype), None, None, None, None, None


# ---------------------------------------------------------------------------
# Forward with the int8 quantize epilogue (kernel #2)
# ---------------------------------------------------------------------------


def _q8_budget_estimate(n: int, cg: int, c: int) -> int:
    return 16 * n * cg + 10 * n * n + 3 * n * c


def _pick_group_channels_q8(c: int, d: int, n: int) -> int:
    """The JAX package's head-group pick for its int8-epilogue kernel (0: the
    shape cannot host it). Only its being non-zero matters here: the CUDA
    kernel shares the heads out over a cluster instead."""
    best = 0
    cg = d
    while cg <= c:
        if (
            c % cg == 0
            and cg % 128 == 0
            and _q8_budget_estimate(n, cg, c) <= _Q8_BUDGET
            and (cg < c or c == d)
        ):
            best = cg
        cg += d
    return best


def can_fuse_q8(n: int, c: int, num_heads: int) -> bool:
    """Whether an int8 block at this shape takes
    :func:`fused_qkv_attention_q8`: the JAX package's shape gate without its
    backend check, behind the same opt-in ``VITOK_Q8_EPILOGUE``."""
    if not _ENABLE_Q8 or c % num_heads:
        return False
    d = c // num_heads
    return (
        n <= MAX_FUSED_TOKENS and n % 8 == 0 and d % 64 == 0
        and _pick_group_channels_q8(c, d, n) > 0
    )


def _q8_cluster_size(num_heads: int, d: int) -> int:
    """Blocks of a cluster that share a row's heads: the largest divisor of
    H up to 8 whose slab of ``H / cs`` heads fits in shared memory beside the
    kernel's three tiles."""
    tiles = (3 * 2 * 64 * (d + 8) + 8 * d + 64 + 15) // 16 * 16
    for cs in range(min(8, num_heads), 0, -1):
        if num_heads % cs == 0:
            slab = 2 * 64 * (num_heads // cs * d + 8) + 4 * 64
            if tiles + slab <= _SMEM_LIMIT:
                return cs
    raise ValueError(f"no cluster of at most 8 blocks hosts {num_heads} heads of {d} channels")


def fused_qkv_attention_q8_plain(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_fused_kernel_q8`` in plain PyTorch: the fused forward's result in
    ``qkv.dtype``, then the per-token quantize over all C channels
    (``absmax / 127`` floored at 1e-12, ``round(x / scale)`` half to even,
    clipped to +-127)."""
    out = fused_qkv_attention_plain(
        qkv, q_scale, k_scale, cos, sin, patch_mask,
        num_heads=num_heads, sliding_window=sliding_window,
    )
    return quantize_activation(out)


def _fused_q8_cuda(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window):
    global Q8_LAUNCHES
    b, n, c, d, q_scale, k_scale, cos, sin, mask, sw = _check_cuda_args(
        qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window
    )
    dev = qkv.device
    cs = _q8_cluster_size(num_heads, d)
    out_q = torch.empty((b, n, c), dtype=torch.int8, device=dev)
    out_scale = torch.empty((b, n, 1), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        err = lib.vitok_fused_attention_q8_bf16(
            qkv.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), _ptr(mask), out_q.data_ptr(), out_scale.data_ptr(),
            b, n, num_heads, d, cs, sw, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, "fused_attention_q8 launch")
    Q8_LAUNCHES += 1
    return out_q, out_scale


def fused_qkv_attention_q8(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_qkv_attention` with the per-token int8 quantize as the
    kernel's epilogue: ``(q_int8 [B, N, C], scale [B, N, 1] fp32)`` for
    ``ops.quant.int8_matmul_prequant``; the attention output never reaches
    device memory in bf16. Inference only (no gradient). On the card the
    codes equal ``quantize_activation`` of the forward kernel's output bit for
    bit: both kernels run one attention body. On a CUDA tensor it launches
    the kernel or raises; on a CPU tensor it runs the plain version.
    """
    args = (qkv, q_scale, k_scale, cos, sin, patch_mask)
    if qkv.is_cuda:
        return _fused_q8_cuda(*args, num_heads, sliding_window)
    if qkv.device.type != "cpu":
        raise RuntimeError(f"no fused attention kernel for device {qkv.device}")
    return fused_qkv_attention_q8_plain(*args, num_heads=num_heads, sliding_window=sliding_window)


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
        impl: ``"auto"`` (the fused kernel where :func:`can_fuse` and no
            gradient is asked for, else the unfused composition), ``"fused"``
            (force the kernel), or an attention impl name for the unfused
            path (``"flash"``, ``"xla"``).

    Under autograd (grad enabled and ``qkv`` or a gain requiring it),
    ``"fused"`` runs the kernel with :func:`fused_qkv_attention_bwd` as its
    backward on both devices, and ``"auto"`` takes the unfused composition,
    as the JAX package's blocks do in training.

    Returns:
        ``[B, N, C]`` in qkv's dtype.
    """
    n, c = qkv.shape[1], qkv.shape[-1] // 3
    needs_grad = torch.is_grad_enabled() and qkv.requires_grad
    if impl == "fused" or (impl == "auto" and not needs_grad and can_fuse(n, c, num_heads)):
        if torch.is_grad_enabled() and (
            qkv.requires_grad or q_scale.requires_grad or k_scale.requires_grad
        ):
            return _FusedAttention.apply(
                qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window
            )
        return _fused_forward(
            qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window
        )
    return unfused_qkv_attention(
        qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window, attn_impl=impl
    )


__all__ = [
    "fused_qkv_attention",
    "fused_qkv_attention_plain",
    "fused_qkv_attention_bwd",
    "fused_qkv_attention_bwd_plain",
    "fused_qkv_attention_q8",
    "fused_qkv_attention_q8_plain",
    "unfused_qkv_attention",
    "can_fuse",
    "can_fuse_bwd",
    "can_fuse_q8",
    "MAX_FUSED_TOKENS",
]
