"""Fused QK-norm + rotate-half RoPE + masked attention from the flat QKV.

Port of ``vitok_tpu/ops/fused_attention.py``: the input is the raw
``[B, N, 3C]`` QKV projection output (q | k | v planes along channels), the
output the flat ``[B, N, C]`` attention result. On a bf16 CUDA tensor
:func:`fused_qkv_attention` launches two hand-written Hopper kernels of
``vitok_torch/csrc/fused_attention_sm90.cu`` (together they replace the TPU
kernel ``_fused_kernel``): :func:`fused_qk_prologue`, which normalises and
rotates k once into a bf16 scratch, and the wgmma attention kernel, which
normalises its own q tile. On
an fp32 CUDA tensor it launches ``fused_attention_f32_sm90_kernel`` of
``csrc/fused_attention_ab_f32_sm90.cu``, the fp32 walker (products on the
tensor cores at fp32 accuracy, a block walking the cells
:func:`f32_walk_split` gives it); on a CPU tensor it runs
:func:`fused_qkv_attention_plain`, the same function in plain PyTorch. The
CUDA path never falls back.

Under autograd the forward also writes each row's log-sum-exp, and the
backward is a kernel too (:func:`fused_qkv_attention_bwd`: the prologue, then
``csrc/fused_attention_bwd.cu``, replacing ``_fused_bwd_kernel``); it takes
the forward's output and log-sum-exp. :func:`fused_qkv_attention_q8`
(the prologue, then ``fused_attention_q8_sm90_kernel`` in
``csrc/fused_attention_sm90.cu``, replacing ``_fused_kernel_q8``) is the
forward with a per-token int8 quantize as its epilogue, for the int8 block's
out-projection; it runs the redesigned forward's attention body.
:func:`fused_qkv_attention_mma` is the mma.sync forward kept beside the
redesign (the A/B entry points' arm B), in bf16 and, on FMA products, in
fp32. Each kernel has its plain version beside it and its own launch count.

From ``FLASH_MIN_TOKENS`` tokens the model's unfused composition hands a
call on a bf16 CUDA tensor to :func:`flash_qkv_attention`: the prologue
writes q and k normed and rotated, and the flash kernel (#4,
``csrc/flash_attention.cu``) reads them as views of that scratch, with v a
view of ``qkv`` (:func:`takes_flash_fold` is its gate). Under autograd its
backward (:func:`flash_qkv_attention_bwd`) runs the prologue again, then
the flash backward kernels #5 and #6 (``csrc/flash_attention_bwd.cu``) in
their fold instances, which end in the q/k norm and rotation backward.

Masking is key-side only, as in the TPU kernel: padded query rows attend to
the valid keys. The unfused composition (:func:`unfused_qkv_attention`)
masks two-sided, so the two agree on valid rows.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Optional, Tuple

import torch

from vitok_torch.ops import _build
from vitok_torch.ops import flash_attention as fl
from vitok_torch.ops.attention import dot_product_attention, flash_route, head_dim_routes
from vitok_torch.ops.norms import rms_norm
from vitok_torch.ops.quant import quantize_activation
from vitok_torch.ops.rope import apply_rotary_emb

MAX_FUSED_TOKENS = 1024
KERNEL_HEAD_DIMS = (64, 128)
_NEG_FILL = -1e30
_DEAD_LSE = 1e30  # the log-sum-exp of a padded query row: the backward's p is 0 there
_LOG2E = 1.4426950408889634

_RMS_EPS = 1e-6

# Launches of each CUDA kernel since its count was last set to 0: the bf16
# forward (wgmma), the q/k prologue it and the backward run first, the
# backward, the forward with the int8 epilogue, the fp32 forward (the fp32
# walker), and the mma.sync forward's bf16 and fp32 instances.
LAUNCHES = 0
PROLOGUE_LAUNCHES = 0
BWD_LAUNCHES = 0
Q8_LAUNCHES = 0
F32_LAUNCHES = 0
MMA_LAUNCHES = 0
F32_MMA_LAUNCHES = 0

# The fp32 walker's kernels by the kind its C entry takes: the forward (#1)
# and the A/B kernels batch block (#10), pack (#11) and contig (#13).
F32_WALK_KINDS = ("fwd", "bb", "pack", "contig")

# The int8 epilogue is opt-in, as in the JAX package (``VITOK_Q8_EPILOGUE``).
_ENABLE_Q8 = os.environ.get("VITOK_Q8_EPILOGUE", "0") not in ("", "0")
# The JAX package's per-cell budget (bytes) behind its int8-epilogue shape
# gate; kept so that both packages route the same shapes.
_Q8_BUDGET = 13 * 1024 * 1024
_SMEM_LIMIT = 232448  # dynamic shared memory a block may use on sm_90


def can_fuse(n: int, c: int, num_heads: int, *, cuda: bool = False) -> bool:
    """Whether a block at this shape routes to the fused kernel.

    The JAX package's gate (``fused_attention.py:979-989``): at most
    ``MAX_FUSED_TOKENS`` tokens, ``n % 8 == 0``, head dim a multiple of 64
    and a 128-lane head group dividing C. For a CUDA tensor (``cuda``) the
    head dim must also be in ``KERNEL_HEAD_DIMS`` (``head_dim_routes``).
    """
    if c % num_heads:
        return False
    d = c // num_heads
    group = d * 128 // math.gcd(d, 128)
    return n <= MAX_FUSED_TOKENS and n % 8 == 0 and head_dim_routes(d, cuda) and c % group == 0


def _rms_inv(x32: torch.Tensor) -> torch.Tensor:
    """``rsqrt(mean(x^2) + eps)`` over the last axis (fp32 ``[..., 1]``),
    summed in the order of the kernels' tile code (``csrc/norm_rope.cuh``):
    a thread's 8 channels and their rotate-half partners squared and added
    in turn, then the D/16 threads' sums pairwise. So the plain versions
    round q and k to bf16 where the kernels do; other head dims take
    ``mean``."""
    d = x32.shape[-1]
    if d % 16:
        return torch.rsqrt(x32.square().mean(-1, keepdim=True) + _RMS_EPS)
    xr = x32[..., : d // 2].unflatten(-1, (d // 16, 8))
    xi = x32[..., d // 2:].unflatten(-1, (d // 16, 8))
    ss = torch.zeros(xr.shape[:-1], dtype=torch.float32, device=x32.device)
    for e in range(8):
        ss = ss + xr[..., e] * xr[..., e]
        ss = ss + xi[..., e] * xi[..., e]
    while ss.shape[-1] > 1:
        ss = ss[..., 0::2] + ss[..., 1::2]
    return torch.rsqrt(ss / d + _RMS_EPS)


def _qk_norm_rope(q, k, q_scale, k_scale, cos, sin):
    """QK-RMSNorm (``_rms_inv``'s statistics, times the fp32 gain, cast to
    the input dtype) and the rotate-half RoPE in that dtype."""
    norm = lambda x, scale: ((x.float() * _rms_inv(x.float())) * scale.float()).to(x.dtype)
    return apply_rotary_emb(norm(q, q_scale), norm(k, k_scale), cos, sin, convention="half")


def _asks_grad(qkv, q_scale, k_scale) -> bool:
    """Whether autograd would want a gradient of this call."""
    return torch.is_grad_enabled() and (qkv.requires_grad or q_scale.requires_grad or k_scale.requires_grad)


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
    return_lse: bool = False,
):
    """The kernel's function in plain PyTorch (``_attend_cell``).

    fp32 norm statistics (summed in the kernels' order: ``_rms_inv``),
    rotation in ``qkv.dtype``, fp32 logits scaled by
    ``log2(e)/sqrt(d)``, key-side mask and window filled with -1e30, ``exp2``
    against the full-row max, P cast to v's dtype before PV, fp32
    accumulation, then division by the fp32 row sum.

    With ``return_lse`` it returns ``(out, lse)``: each row's log-sum-exp of
    those logits in log2 units, fp32 ``[B, H, N]``, and 1e30 on padded query
    rows (what the kernel writes for the backward).
    """
    b, n, c3 = qkv.shape
    q, k, v = _split_qkv(qkv, num_heads)
    d = q.shape[-1]
    q, k = _qk_norm_rope(q, k, q_scale, k_scale, cos, sin)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / d ** 0.5 * _LOG2E)
    if patch_mask is not None:
        s = s.masked_fill(~patch_mask.bool()[:, None, None, :], _NEG_FILL)
    if sliding_window is not None:
        idx = torch.arange(n, device=qkv.device)
        outside = (idx[:, None] - idx[None, :]).abs() > sliding_window
        s = s.masked_fill(outside, _NEG_FILL)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / p.sum(-1).transpose(1, 2)[..., None]
    out = o.to(qkv.dtype).reshape(b, n, c3 // 3)
    if not return_lse:
        return out
    lse = m[..., 0] + torch.log2(p.sum(-1))
    if patch_mask is not None:
        lse = lse.masked_fill(~patch_mask.bool()[:, None, :], _DEAD_LSE)
    return out, lse


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


def _check_rows(n: int) -> None:
    """The wgmma kernels copy a tile's row statistics 16 bytes at a time."""
    if n % 8:
        raise ValueError(f"the wgmma fused attention kernels take N a multiple of 8, got {n}")


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def fused_qk_prologue_plain(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    num_heads: int,
    out: Optional[torch.Tensor] = None,
    dout: Optional[torch.Tensor] = None,
    with_q: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The prologue kernel's function in plain PyTorch: q and k normalised
    and rotated as the forward does (``_norm_rope_half``), as ``[B, N, 2C]``
    in ``qkv.dtype`` (q channels, then k; without ``with_q`` k alone,
    ``[B, N, C]``, as the forward asks for it); with ``out`` and ``dout``
    (the forward's output and its cotangent, ``[B, N, C]``) also
    ``delta [B, H, N]`` in fp32, each row's sum over a head's channels of
    ``dout * out``."""
    b, n, _ = qkv.shape
    q, k, _v = _split_qkv(qkv, num_heads)
    q, k = _qk_norm_rope(q, k, q_scale, k_scale, cos, sin)
    qk = torch.cat([q.reshape(b, n, -1), k.reshape(b, n, -1)], dim=-1) if with_q else k.reshape(b, n, -1)
    if out is None:
        return qk, None
    prod = dout.float() * out.float()
    return qk, prod.view(b, n, num_heads, -1).sum(-1).transpose(1, 2).contiguous()


def _prologue_cuda(qkv, q_scale, k_scale, cos, sin, num_heads, out=None, dout=None, with_q=True):
    global PROLOGUE_LAUNCHES
    b, n, c, d, q_scale, k_scale, cos, sin, _, _ = _check_cuda_args(
        qkv, q_scale, k_scale, cos, sin, None, num_heads, None
    )
    dev = qkv.device
    parts = 2 if with_q else 1
    qk = torch.empty((b, n, parts * c), dtype=qkv.dtype, device=dev)
    delta = None
    if out is not None:
        for name, t in (("out", out), ("dout", dout)):
            if t.device != dev or tuple(t.shape) != (b, n, c) or t.dtype != qkv.dtype or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous {(b, n, c)} {qkv.dtype} tensor on {dev}")
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
        delta = torch.empty((b, num_heads, n), dtype=torch.float32, device=dev)
    lib = _sm90_lib()
    with torch.cuda.device(dev):  # the C entry launches on the current device
        err = lib.vitok_fused_qk_prologue_bf16(
            qkv.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            _ptr(out), _ptr(dout), qk.data_ptr(), _ptr(delta), b, n, num_heads, d, parts,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, "fused_qk_prologue launch")
    PROLOGUE_LAUNCHES += 1
    return qk, delta


def fused_qk_prologue(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    num_heads: int,
    out: Optional[torch.Tensor] = None,
    dout: Optional[torch.Tensor] = None,
    with_q: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """q and k normalised and rotated once (``[B, N, 2C]``; k alone,
    ``[B, N, C]``, without ``with_q``), and with ``out``/``dout`` the
    backward's ``delta``: the prologue the redesigned forward (k alone) and
    backward (q, k and delta) run first. On a CUDA tensor this launches the
    prologue kernel (bf16, head dim 64 or 128) or raises; on a CPU tensor it
    runs :func:`fused_qk_prologue_plain`."""
    if (out is None) != (dout is None):
        raise ValueError("give both out and dout, or neither")
    args = (qkv, q_scale, k_scale, cos, sin)
    if qkv.is_cuda:
        return _prologue_cuda(*args, num_heads, out, dout, with_q)
    if qkv.device.type != "cpu":
        raise RuntimeError(f"no fused attention kernel for device {qkv.device}")
    return fused_qk_prologue_plain(*args, num_heads=num_heads, out=out, dout=dout, with_q=with_q)


def _fused_cuda(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window, want_lse=False):
    """The redesigned forward on a bf16 tensor (the prologue, then the wgmma
    kernel): ``(out, lse or None)``; an fp32 tensor takes the fp32 walker,
    which writes no lse: asked for one (under autograd), it raises before
    anything launches, since the backward has no fp32 instance."""
    if qkv.dtype == torch.float32:
        if want_lse:
            raise TypeError("fused_qkv_attention under autograd takes bfloat16 qkv on a CUDA tensor: the backward "
                            "kernel (#3) has no fp32 instance (ROADMAP.md Queue 3), got torch.float32")
        return _attend_f32(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window), None
    _check_rows(qkv.shape[1])
    kn, _ = _prologue_cuda(qkv, q_scale, k_scale, cos, sin, num_heads, with_q=False)
    return _attend_sm90(qkv, kn, q_scale, cos, sin, patch_mask, num_heads, sliding_window, want_lse)


def _attend_sm90(qkv, kn, q_scale, cos, sin, patch_mask, num_heads, sliding_window, want_lse=False):
    """The wgmma attention kernel on the prologue's normed k ``kn`` and the
    q and v planes of ``qkv``: ``(out, lse or None)``."""
    global LAUNCHES
    b, n, c, d, q_scale, _, cos, sin, mask, sw = _check_cuda_args(
        qkv, q_scale, q_scale, cos, sin, patch_mask, num_heads, sliding_window
    )
    dev = qkv.device
    _check_rows(n)
    if kn.shape != (b, n, c) or kn.dtype != qkv.dtype or kn.device != dev or not kn.is_contiguous():
        raise ValueError(f"kn must be a contiguous {(b, n, c)} {qkv.dtype} tensor on {dev}")
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=dev)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=dev) if want_lse else None
    lib = _sm90_lib()
    with torch.cuda.device(dev):
        err = lib.vitok_fused_attention_sm90_bf16(
            kn.data_ptr(), qkv.data_ptr(), q_scale.data_ptr(), cos.data_ptr(), sin.data_ptr(), _ptr(mask),
            out.data_ptr(), _ptr(lse), b, n, num_heads, d, sw, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, "fused_attention launch")
    LAUNCHES += 1
    return out, lse


def f32_walk_split(b: int, n: int, h: int, d: int, sms: int) -> Tuple[int, int]:
    """``(bb, hpb)``: the images and heads of a 64-query tile that one block
    of the fp32 forward walks, for ``b`` images of ``n`` tokens and ``h``
    heads of ``d`` channels on a card of ``sms`` SMs. ``bb`` divides ``b``
    and ``hpb`` divides ``h``; images are never packed (the pack is #11's
    function, not #1's). The split changes only the speed: a cell's result
    does not depend on the block it runs in.

    The rule, from the fp32 walker's splits measured on an H100 (PERF.md).
    A block runs one step (one key tile of one cell) while its producer
    prepares the next, and what it overlaps is its own steps and, where an SM
    holds two blocks (the forward's kernel at d = 64), the other block's:

    - where a cell is one or two key tiles (``n`` <= 128), a block takes
      about 24 steps (12 with two blocks an SM): at the 5B fp32 shape (d 128,
      N 64, B 256, H 24) two images x 12 heads (D2, 0.4548 ms) and
      12 heads (G, 0.4652) read fastest of the unpacked splits, one cell a
      block 0.7627;
    - a longer cell overlaps within itself, so a block takes about 8 steps (4
      with two blocks an SM), at least one cell: at the 350M width (d 64, N
      256, B 16, a tail and a dead image) one block an SM read two heads a
      block fastest (C128, 0.1240 ms, against 4 heads 0.1325 and 8 0.1379,
      whose fewer blocks left SMs idle while short images finished early),
      two blocks an SM one cell a block (``chip_smoke.py``'s sweep);
    - heads first, at most half of them (no split of more was measured),
      then images;
    - while the grid has fewer blocks than the card holds at once, images and
      then heads are given back.
    """
    if min(b, n, h, d, sms) < 1:
        raise ValueError(f"b, n, h, d and sms must be positive, got {(b, n, h, d, sms)}")
    per_sm = 2 if d == 64 else 1  # blocks an SM of the forward's kernel
    tiles = -(-n // 64)
    cells = max(1, (24 if tiles <= 2 else 8) // per_sm // tiles)
    divisors = lambda x, most: [v for v in range(1, x + 1) if x % v == 0 and v <= most]
    hpb = divisors(h, min(cells, max(1, h // 2)))[-1]
    bb = divisors(b, cells // hpb)[-1]
    while tiles * (h // hpb) * (b // bb) < sms * per_sm and bb * hpb > 1:
        if bb > 1:
            bb = divisors(b, bb - 1)[-1]
        else:
            hpb = divisors(h, hpb - 1)[-1]
    return bb, hpb


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _walk_f32_cuda(qkv, q_scale, k_scale, cos, sin, mask, num_heads, *, bb, hpb, sw=-1, kind="fwd"):
    """One launch of an fp32 walker kernel (``kind`` one of
    ``F32_WALK_KINDS``) on an fp32 ``qkv``, q and k normed in the kernel:
    ``bb`` images x ``hpb`` heads a block, each image its own softmax with
    window ``sw`` (-1 for none; the pack: one softmax over its ``bb``
    images, no window). The other arguments as :func:`_check_cuda_args`
    returns them. Counts nothing: its callers count."""
    b, n, c3 = qkv.shape
    out = torch.empty((b, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lib = _f32_lib()
    with torch.cuda.device(qkv.device):
        err = lib.vitok_fused_attention_walk_f32(
            qkv.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(), cos.data_ptr(), sin.data_ptr(), _ptr(mask),
            out.data_ptr(), b, n, num_heads, c3 // 3 // num_heads, bb, hpb, sw, F32_WALK_KINDS.index(kind),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(lib, err, f"fp32 walker ({kind}) launch")
    return out


def f32_walk_attributes(d: int, kind: str, bb: int = 1) -> dict:
    """Registers and local memory (spills) a thread, blocks an SM and shared
    memory a block of one fp32 walker kernel (``kind`` one of
    ``F32_WALK_KINDS``) at head dim ``d`` with ``bb`` images a block, as the
    compiler and the card report them."""
    out = (ctypes.c_int * 4)()
    lib = _f32_lib()
    _build.check(lib, lib.vitok_fused_attention_walk_f32_attributes(d, F32_WALK_KINDS.index(kind), bb, out),
                 f"fp32 walker ({kind}) attributes")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2], smem_bytes=out[3])


def _attend_f32(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window):
    """The fp32 forward: ``fused_attention_f32_sm90_kernel`` at the split
    :func:`f32_walk_split` picks for this shape and card."""
    global F32_LAUNCHES
    b, n, c, d, q_scale, k_scale, cos, sin, mask, sw = _check_cuda_args(
        qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window, dtypes=(torch.float32,)
    )
    bb, hpb = f32_walk_split(b, n, num_heads, d, _sm_count(qkv.device.index))
    out = _walk_f32_cuda(qkv, q_scale, k_scale, cos, sin, mask, num_heads, bb=bb, hpb=hpb, sw=sw, kind="fwd")
    F32_LAUNCHES += 1
    return out


def _mma_cuda(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window):
    """The mma.sync forward of ``csrc/fused_attention.cu``: its bf16
    instance, or its fp32 one (FMA products)."""
    global MMA_LAUNCHES, F32_MMA_LAUNCHES
    b, n, c, d, q_scale, k_scale, cos, sin, mask, sw = _check_cuda_args(
        qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window,
        dtypes=(torch.bfloat16, torch.float32),
    )
    dev = qkv.device
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=dev)
    lib = _kernel_lib()
    f32 = qkv.dtype == torch.float32
    entry = lib.vitok_fused_attention_f32 if f32 else lib.vitok_fused_attention_mma_bf16
    with torch.cuda.device(dev):  # the C entry launches on the current device
        err = entry(
            qkv.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), _ptr(mask), out.data_ptr(),
            b, n, num_heads, d, sw, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, "fused_attention_mma launch")
    if f32:
        F32_MMA_LAUNCHES += 1
    else:
        MMA_LAUNCHES += 1
    return out


def fused_qkv_attention_mma(
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
    """The forward on the mma.sync kernel of ``csrc/fused_attention.cu``
    (bf16, or fp32 on FMA products), kept beside the redesigns: the A/B entry
    points' arm B, whose body the int8 epilogue and #12 share bit for bit,
    and in fp32 the closest reference to the plain version. On a CUDA tensor
    it launches that kernel or raises; on a CPU tensor it runs
    :func:`fused_qkv_attention_plain`."""
    args = (qkv, q_scale, k_scale, cos, sin, patch_mask)
    if qkv.is_cuda:
        return _mma_cuda(*args, num_heads, sliding_window)
    if qkv.device.type != "cpu":
        raise RuntimeError(f"no fused attention kernel for device {qkv.device}")
    return fused_qkv_attention_plain(*args, num_heads=num_heads, sliding_window=sliding_window)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("fused_attention")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for fn, argtypes in (
        (lib.vitok_fused_attention_mma_bf16, [ptr] * 7 + [i] * 5 + [ptr]),
        (lib.vitok_fused_attention_f32, [ptr] * 7 + [i] * 5 + [ptr]),
    ):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _sm90_lib() -> ctypes.CDLL:
    lib = _build.load("fused_attention_sm90")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for fn, argtypes in (
        (lib.vitok_fused_qk_prologue_bf16, [ptr] * 9 + [i] * 5 + [ptr]),
        (lib.vitok_fused_k_prologue_q8, [ptr] * 5 + [i] * 4 + [ptr]),
        (lib.vitok_fused_attention_sm90_bf16, [ptr] * 8 + [i] * 5 + [ptr]),
        (lib.vitok_fused_attention_q8_sm90_bf16, [ptr] * 8 + [i] * 6 + [ptr]),
    ):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _f32_lib() -> ctypes.CDLL:
    """``csrc/fused_attention_ab_f32_sm90.cu``: the fp32 walker's kernels
    (the fp32 forward and the A/B kernels #10, #11, #13 in fp32)."""
    lib = _build.load("fused_attention_ab_f32_sm90")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for fn, argtypes in (
        (lib.vitok_fused_attention_walk_f32, [ptr] * 7 + [i] * 8 + [ptr]),
        (lib.vitok_fused_attention_walk_f32_attributes, [i] * 3 + [ptr]),
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
        fn.argtypes = [ptr] * 13 + [i] * 5 + [ptr]
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# Backward (kernel #3)
# ---------------------------------------------------------------------------


def can_fuse_bwd(n: int, c: int, num_heads: int, *, cuda: bool = False) -> bool:
    """Whether the backward kernel takes this shape: wherever the forward
    kernel does. (The JAX package's gate is tighter, on the TPU's VMEM; it
    falls back to the unfused VJP at 1024 tokens. ROADMAP.md Queue 3.)"""
    return can_fuse(n, c, num_heads, cuda=cuda)


def _rotate_half_bwd(dz: torch.Tensor, cos32: torch.Tensor, sin32: torch.Tensor) -> torch.Tensor:
    """Transpose of the rotate-half rotation in fp32: ``dz [..., D]``."""
    d2 = dz.shape[-1] // 2
    dzr, dzi = dz[..., :d2], dz[..., d2:]
    return torch.cat([dzr * cos32 + dzi * sin32, dzi * cos32 - dzr * sin32], dim=-1)


def _norm_rope_bwd(dz, x32, r, scale, cos32, sin32):
    """The rotation's transpose and the RMSNorm backward in fp32 (the
    kernels' ``norm_rope_bwd_tile``): from the fp32 gradient ``dz`` of the
    normed, rotated rows ``[B, N, H, D]``, the raw rows ``x32``, their
    ``r = _rms_inv(x32)``, the gain and the tables ``[B, N, 1, D/2]`` (fp32
    values of the rounded tables), ``(dx, dscale)``: the raw rows' gradient
    and the gain's, summed over rows, heads and samples."""
    d = x32.shape[-1]
    dy = _rotate_half_bwd(dz, cos32, sin32)
    dscale = (dy * x32 * r).sum((0, 1, 2))
    gy = dy * scale.float()
    dx = gy * r - x32 * (r * r * r / d) * (gy * x32).sum(-1, keepdim=True)
    return dx, dscale


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
    out: Optional[torch.Tensor] = None,
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

    Given the forward's output ``out [B, N, C]``, ``delta`` is instead
    ``sum_c dO * out`` in fp32 over each head's channels (the same quantity,
    since ``out = sum_k p v``, from the output rounded to ``qkv.dtype``): the
    redesigned kernel's function, as the JAX package's flash backward forms it.

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
        r = _rms_inv(x32)
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
    if out is None:
        delta = (dp * p).sum(-1, keepdim=True)
    else:
        delta = (do32 * out.reshape(b, n, num_heads, d).float()).sum(-1).transpose(1, 2)[..., None]
    dsb = (p * (dp - delta) * inv_sqrt_d).to(dt).float()
    dqrot = torch.einsum("bhqk,bkhd->bqhd", dsb, krot)
    dkrot = torch.einsum("bhqk,bqhd->bkhd", dsb, qrot)

    cos32, sin32 = cos_b.float(), sin_b.float()
    dq, dqs = _norm_rope_bwd(dqrot, q32, rq, q_scale, cos32, sin32)
    dk, dks = _norm_rope_bwd(dkrot, k32, rk, k_scale, cos32, sin32)
    dqkv = torch.stack([dq.to(dt), dk.to(dt), dv.to(dt)], dim=2).reshape(b, n, c3)
    return dqkv, dqs, dks


def _fused_bwd_cuda(qkv, q_scale, k_scale, cos, sin, patch_mask, dout, num_heads, sliding_window, out, lse):
    global BWD_LAUNCHES
    b, n, c, d, q_scale, k_scale, cos, sin, mask, sw = _check_cuda_args(
        qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window
    )
    dev = qkv.device
    _check_rows(n)
    if dout.device != dev or tuple(dout.shape) != (b, n, c) or dout.dtype != qkv.dtype:
        raise ValueError(
            f"dout must be {(b, n, c)} {qkv.dtype} on {dev}, got {tuple(dout.shape)} {dout.dtype}"
        )
    dout = dout.contiguous()
    if dout.data_ptr() % 16:
        dout = dout.clone()
    if out is None or lse is None:  # the forward first: its output and row log-sum-exp
        out, lse = _fused_cuda(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window,
                               want_lse=True)
    if tuple(lse.shape) != (b, num_heads, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous {(b, num_heads, n)} float32 tensor")
    qk, delta = _prologue_cuda(qkv, q_scale, k_scale, cos, sin, num_heads, out.contiguous(), dout)
    tiles = (n + 63) // 64
    dqkv = torch.empty_like(qkv)
    part_q = torch.empty((b, num_heads, tiles, d), dtype=torch.float32, device=dev)
    part_k = torch.empty((b, num_heads, tiles, d), dtype=torch.float32, device=dev)
    lib = _bwd_kernel_lib()
    with torch.cuda.device(dev):
        err = lib.vitok_fused_attention_bwd_bf16(
            qkv.data_ptr(), qk.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), _ptr(mask), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dqkv.data_ptr(), part_q.data_ptr(), part_k.data_ptr(),
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
    out: Optional[torch.Tensor] = None,
    lse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of the fused kernel: ``(dqkv, dq_scale, dk_scale)`` from the
    forward's inputs and the cotangent ``dout [B, N, C]`` of its output.

    ``out`` and ``lse`` are the forward's output and row log-sum-exp
    (``fused_qkv_attention_plain(..., return_lse=True)`` or the kernel's);
    without them the forward runs first. The cotangent is zeroed on padded
    query rows first, as the JAX package's ``_fused_op_bwd`` does. On a CUDA
    tensor this launches the prologue and the backward kernel (bf16, head dim
    64 or 128) or raises; on a CPU tensor it runs
    :func:`fused_qkv_attention_bwd_plain` with ``out``. The gain gradients
    are fp32.
    """
    args = (qkv, q_scale, k_scale, cos, sin, patch_mask)
    kw = dict(num_heads=num_heads, sliding_window=sliding_window)
    if qkv.is_cuda:
        if patch_mask is not None:
            dout = dout * patch_mask.to(dout.dtype)[..., None]
        return _fused_bwd_cuda(*args, dout, num_heads, sliding_window, out, lse)
    if qkv.device.type != "cpu":
        raise RuntimeError(f"no fused attention kernel for device {qkv.device}")
    if out is None:
        out = fused_qkv_attention_plain(*args, **kw)
    return fused_qkv_attention_bwd_plain(*args, dout, out=out, **kw)


def _fused_forward(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window, want_lse=False):
    """The kernels on a CUDA tensor, the plain version on a CPU tensor:
    ``(out, lse)``, lse None unless asked for (which an fp32 CUDA tensor
    refuses: the backward has no fp32 instance)."""
    args = (qkv, q_scale, k_scale, cos, sin, patch_mask)
    if qkv.is_cuda:
        return _fused_cuda(*args, num_heads, sliding_window, want_lse)
    if qkv.device.type != "cpu":
        raise RuntimeError(f"no fused attention kernel for device {qkv.device}")
    kw = dict(num_heads=num_heads, sliding_window=sliding_window)
    if want_lse:
        return fused_qkv_attention_plain(*args, return_lse=True, **kw)
    return fused_qkv_attention_plain(*args, **kw), None


class _FusedAttention(torch.autograd.Function):
    """The fused forward with :func:`fused_qkv_attention_bwd` as its backward
    (the JAX package's ``_fused_op`` custom VJP). Saves its inputs, its
    output and the rows' log-sum-exp: the backward forms p from them without
    a statistics pass. cos/sin get no gradient."""

    @staticmethod
    def forward(ctx, qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window):
        out, lse = _fused_forward(
            qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window, want_lse=True
        )
        ctx.save_for_backward(qkv, q_scale, k_scale, cos, sin, patch_mask, out, lse)
        ctx.num_heads = num_heads
        ctx.sliding_window = sliding_window
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, q_scale, k_scale, cos, sin, patch_mask, out, lse = ctx.saved_tensors
        dqkv, dqs, dks = fused_qkv_attention_bwd(
            qkv, q_scale, k_scale, cos, sin, patch_mask, dout,
            num_heads=ctx.num_heads, sliding_window=ctx.sliding_window, out=out, lse=lse,
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


def can_fuse_q8(n: int, c: int, num_heads: int, *, cuda: bool = False) -> bool:
    """Whether an int8 block at this shape takes
    :func:`fused_qkv_attention_q8`: the JAX package's shape gate without its
    backend check, behind the same opt-in ``VITOK_Q8_EPILOGUE``; for a CUDA
    tensor (``cuda``) a head dim in ``KERNEL_HEAD_DIMS``."""
    if not _ENABLE_Q8 or c % num_heads:
        return False
    d = c // num_heads
    return (
        n <= MAX_FUSED_TOKENS and n % 8 == 0 and head_dim_routes(d, cuda)
        and _pick_group_channels_q8(c, d, n) > 0
    )


# The int8-epilogue kernel's shared memory (``Q8Smem`` of
# ``csrc/fused_attention_sm90.cu``): the forward kernel's Q tile, two-stage K
# and V ring, key states and gain, then the bf16 slab of a block's heads but
# the last (64 rows of ``(heads - 1) * d + 8``; the last head's rows go over
# the K slots), the row maxima, and 1 KB of alignment slack.
def _q8_smem_bytes(heads: int, d: int) -> int:
    tile = 64 * d * 2
    return 5 * tile + 2 * 64 + 4 * d + 2 * 64 * ((heads - 1) * d + 8) + 4 * 64 + 1024


def _q8_cluster_size(num_heads: int, d: int) -> int:
    """Blocks of a cluster that share a row's heads. At d = 128, where a
    block of three or more heads fills an SM alone, two heads a block (a
    cluster of H / 2, non-portable above 8) where H is even and H / 2 <= 16;
    else the divisor of H up to 8 nearest 4 (the larger of two) whose
    ``H / cs`` heads fit in shared memory beside the forward's tiles, a
    portable cluster. On an H100, 4 read fastest at the 350M width against
    2, 8 and one head a block, and two heads a block (12) faster than 4 at
    the 5B width (PERF.md, PR 13)."""
    if d == 128 and num_heads % 2 == 0 and num_heads // 2 <= 16:
        return num_heads // 2
    fits = [cs for cs in range(1, min(8, num_heads) + 1)
            if num_heads % cs == 0 and _q8_smem_bytes(num_heads // cs, d) <= _SMEM_LIMIT]
    if not fits:
        raise ValueError(f"no cluster of at most 8 blocks hosts {num_heads} heads of {d} channels")
    return min(fits, key=lambda cs: (abs(cs - 4), -cs))


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
    """The prologue (k), then the int8-epilogue kernel in clusters of
    :func:`_q8_cluster_size` blocks: ``(codes, scales)``."""
    global Q8_LAUNCHES
    b, n, c, d, q_scale, k_scale, cos, sin, mask, sw = _check_cuda_args(
        qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window
    )
    dev = qkv.device
    _check_rows(n)
    cs = _q8_cluster_size(num_heads, d)
    kn, _ = _prologue_cuda(qkv, q_scale, k_scale, cos, sin, num_heads, with_q=False)
    out_q = torch.empty((b, n, c), dtype=torch.int8, device=dev)
    out_scale = torch.empty((b, n, 1), dtype=torch.float32, device=dev)
    lib = _sm90_lib()
    with torch.cuda.device(dev):
        err = lib.vitok_fused_attention_q8_sm90_bf16(
            kn.data_ptr(), qkv.data_ptr(), q_scale.data_ptr(), cos.data_ptr(), sin.data_ptr(), _ptr(mask),
            out_q.data_ptr(), out_scale.data_ptr(), b, n, num_heads, d, cs, sw,
            torch.cuda.current_stream(dev).cuda_stream,
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
    codes and scales equal ``quantize_activation`` of
    ``fused_qkv_attention(..., impl="fused")`` (the redesigned forward) bit
    for bit: both run the q/k prologue and one wgmma attention body. On a
    CUDA tensor it launches the prologue and the kernel or raises; on a CPU
    tensor it runs the plain version.
    """
    args = (qkv, q_scale, k_scale, cos, sin, patch_mask)
    if qkv.is_cuda:
        return _fused_q8_cuda(*args, num_heads, sliding_window)
    if qkv.device.type != "cpu":
        raise RuntimeError(f"no fused attention kernel for device {qkv.device}")
    return fused_qkv_attention_q8_plain(*args, num_heads=num_heads, sliding_window=sliding_window)


# ---------------------------------------------------------------------------
# The high-resolution fold: the q/k prologue, then the flash kernel (#4)
# ---------------------------------------------------------------------------


def flash_qkv_attention_plain(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    sliding_window: Optional[int] = None,
    return_lse: bool = False,
):
    """The fold's function in plain PyTorch: :func:`fused_qk_prologue_plain`
    (q and k normalised and rotated, ``_rms_inv``'s sum order), then
    ``flash_attention_plain`` on q, k and v. The same function as
    :func:`unfused_qkv_attention` on the flash route, up to the order of the
    RMSNorm sum. Returns ``[B, N, C]`` in qkv's dtype, padded rows 0, and
    with ``return_lse`` also the flash forward's natural-log row
    log-sum-exp ``[B, H, N]`` (what the backward reads)."""
    b, n, c3 = qkv.shape
    qk, _ = fused_qk_prologue_plain(qkv, q_scale, k_scale, cos, sin, num_heads=num_heads)
    q, k = qk.view(b, n, 2, num_heads, -1).unbind(2)
    v = _split_qkv(qkv, num_heads)[2]
    res = fl.flash_attention_plain(q, k, v, patch_mask, sliding_window, return_lse=return_lse)
    if return_lse:
        return res[0].reshape(b, n, c3 // 3), res[1]
    return res.reshape(b, n, c3 // 3)


def flash_qkv_attention_bwd_plain(
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
    out: torch.Tensor,
    lse: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fold's backward in plain PyTorch, given the forward's output
    ``out [B, N, C]`` and natural-log ``lse [B, H, N]``: the cotangent
    zeroed on padded rows; :func:`fused_qk_prologue_plain` (qrot, krot and
    ``delta = sum dO * O``); ``flash_attention_bwd_plain`` on those views
    with dqrot and dkrot kept in fp32; then the rotation's transpose and the
    RMSNorm backward in fp32 on the raw q and k (``_norm_rope_bwd``, the
    fused backward's). The JAX package's autodiff of ``unfused_qkv_attention``
    on its flash route rounds dqrot and dkrot to the input dtype first
    (ROADMAP.md Queue 3). Returns ``(dqkv [B, N, 3C] in qkv.dtype,
    dq_scale [D], dk_scale [D])`` with the gain gradients in fp32."""
    b, n, c3 = qkv.shape
    dt = qkv.dtype
    g = dout if patch_mask is None else dout * patch_mask.to(dout.dtype)[..., None]
    g = g.to(dt)
    qk, delta = fused_qk_prologue_plain(qkv, q_scale, k_scale, cos, sin, num_heads=num_heads, out=out, dout=g)
    qrot, krot = qk.view(b, n, 2, num_heads, -1).unbind(2)
    q, k, v = _split_qkv(qkv, num_heads)
    heads = lambda t: t.reshape(b, n, num_heads, -1)
    dqrot, dkrot, dv = fl.flash_attention_bwd_plain(qrot, krot, v, heads(out), lse, heads(g), patch_mask,
                                                    sliding_window, delta=delta, round_qk=False)
    cos32 = cos.to(dt).float()[:, :, None, :]
    sin32 = sin.to(dt).float()[:, :, None, :]
    q32, k32 = q.float(), k.float()
    dq, dqs = _norm_rope_bwd(dqrot, q32, _rms_inv(q32), q_scale, cos32, sin32)
    dk, dks = _norm_rope_bwd(dkrot, k32, _rms_inv(k32), k_scale, cos32, sin32)
    dqkv = torch.stack([dq.to(dt), dk.to(dt), dv.to(dt)], dim=2).reshape(b, n, c3)
    return dqkv, dqs, dks


def _flash_fold_cuda(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window, want_lse=False):
    """The prologue (q and k), then #4 on strided views: ``(out, lse or None)``."""
    b, n, c3 = qkv.shape
    qk, _ = _prologue_cuda(qkv, q_scale, k_scale, cos, sin, num_heads, with_q=True)
    q, k = qk.view(b, n, 2, num_heads, -1).unbind(2)
    v = _split_qkv(qkv, num_heads)[2]
    res = fl._flash_cuda(q, k, v, patch_mask, sliding_window, want_lse)
    out, lse = res if want_lse else (res, None)
    return out.reshape(b, n, c3 // 3), lse


def _flash_fold_bwd_cuda(qkv, q_scale, k_scale, cos, sin, patch_mask, dout, num_heads, sliding_window, out, lse):
    """The fold's backward on the card: the prologue (qrot, krot, delta),
    then the dq and dk/dv kernels' fold instances into one dqkv, then the
    gains' partials summed in a fixed order (no atomics)."""
    b, n, c, d, q_scale, k_scale, cos, sin, mask, sw = _check_cuda_args(
        qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window
    )
    dev = qkv.device
    if dout.device != dev or tuple(dout.shape) != (b, n, c) or dout.dtype != qkv.dtype:
        raise ValueError(f"dout must be {(b, n, c)} {qkv.dtype} on {dev}, got {tuple(dout.shape)} {dout.dtype}")
    if tuple(lse.shape) != (b, num_heads, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous {(b, num_heads, n)} float32 tensor")
    if mask is not None:
        dout = dout * mask.to(dout.dtype)[..., None]
    dout = dout.contiguous()
    if dout.data_ptr() % 16:
        dout = dout.clone()
    qk, delta = _prologue_cuda(qkv, q_scale, k_scale, cos, sin, num_heads, out.contiguous(), dout)
    counts = None if mask is None else fl.key_counts(mask)
    dqkv = torch.empty_like(qkv)
    parts = torch.empty((2, b, num_heads, (n + 63) // 64, d), dtype=torch.float32, device=dev)
    fl.flash_dq_fold_cuda(qkv, qk, q_scale, cos, sin, mask, counts, dout, lse, delta, dqkv, parts[0], num_heads, sw)
    fl.flash_dkv_fold_cuda(qkv, qk, k_scale, cos, sin, mask, counts, dout, lse, delta, dqkv, parts[1], num_heads, sw)
    dqs, dks = parts.sum((1, 2, 3))
    return dqkv, dqs, dks


def flash_qkv_attention_bwd(
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
    out: torch.Tensor,
    lse: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`flash_qkv_attention`: ``(dqkv, dq_scale,
    dk_scale)`` from the forward's inputs, its output ``out [B, N, C]`` and
    log-sum-exp ``lse``, and the cotangent ``dout [B, N, C]``.

    On a CUDA tensor (bf16, head dim 64 or 128) four launches and a sum: the
    q/k prologue with ``out`` and ``dout`` (qrot, krot and delta), the dq and
    dk/dv kernels' fold instances (``flash_dq_fold_cuda``,
    ``flash_dkv_fold_cuda``; their epilogues run the norm and rotation
    backward into dqkv), and the gains' partials summed; it raises on what
    the kernels do not take. On a CPU tensor it runs
    :func:`flash_qkv_attention_bwd_plain`. The gain gradients are fp32."""
    args = (qkv, q_scale, k_scale, cos, sin, patch_mask)
    if qkv.is_cuda:
        return _flash_fold_bwd_cuda(*args, dout, num_heads, sliding_window, out, lse)
    if qkv.device.type != "cpu":
        raise RuntimeError(f"no fused attention kernel for device {qkv.device}")
    return flash_qkv_attention_bwd_plain(*args, dout, num_heads=num_heads, sliding_window=sliding_window,
                                         out=out, lse=lse)


def _flash_fold_forward(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window, want_lse=False):
    """The fold's kernels on a CUDA tensor, its plain version on a CPU
    tensor: ``(out, lse or None)``."""
    args = (qkv, q_scale, k_scale, cos, sin, patch_mask)
    if qkv.is_cuda:
        return _flash_fold_cuda(*args, num_heads, sliding_window, want_lse)
    if qkv.device.type != "cpu":
        raise RuntimeError(f"no fused attention kernel for device {qkv.device}")
    res = flash_qkv_attention_plain(*args, num_heads=num_heads, sliding_window=sliding_window,
                                    return_lse=want_lse)
    return res if want_lse else (res, None)


class _FlashQKVAttention(torch.autograd.Function):
    """The fold with :func:`flash_qkv_attention_bwd` as its backward (looked
    up at call time). Saves its inputs, its output and the rows'
    log-sum-exp, not the prologue's ``[B, N, 2C]`` scratch: the backward runs
    the prologue again. cos/sin get no gradient."""

    @staticmethod
    def forward(ctx, qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window):
        out, lse = _flash_fold_forward(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window,
                                       want_lse=True)
        ctx.save_for_backward(qkv, q_scale, k_scale, cos, sin, patch_mask, out, lse)
        ctx.num_heads = num_heads
        ctx.sliding_window = sliding_window
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, q_scale, k_scale, cos, sin, patch_mask, out, lse = ctx.saved_tensors
        dqkv, dqs, dks = flash_qkv_attention_bwd(
            qkv, q_scale, k_scale, cos, sin, patch_mask, dout,
            num_heads=ctx.num_heads, sliding_window=ctx.sliding_window, out=out, lse=lse,
        )
        return dqkv, dqs.to(q_scale.dtype), dks.to(k_scale.dtype), None, None, None, None, None


def flash_qkv_attention(
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
    """QK-norm + rotate-half RoPE + flash attention from flat QKV, at high
    resolution (``vitok_tpu``'s ``unfused_qkv_attention`` on its flash
    route, whose XLA glue the prologue replaces).

    On a CUDA tensor (bf16, head dim 64 or 128) two launches: the q/k
    prologue (:func:`fused_qk_prologue` with ``with_q``: q and k normed and
    rotated into a ``[B, N, 2C]`` scratch), then the flash kernel on q and k
    as strided views of that scratch and v as a view of ``qkv``. On a CPU
    tensor it runs :func:`flash_qkv_attention_plain`. Under autograd (grad
    enabled and ``qkv`` or a gain requiring it) the call goes through an
    autograd Function, on both devices, whose forward also keeps the rows'
    log-sum-exp and whose backward is :func:`flash_qkv_attention_bwd`.
    Returns ``[B, N, C]``, padded query rows 0.
    """
    args = (qkv, q_scale, k_scale, cos, sin, patch_mask)
    if _asks_grad(qkv, q_scale, k_scale):
        return _FlashQKVAttention.apply(*args, num_heads, sliding_window)
    return _flash_fold_forward(*args, num_heads, sliding_window)[0]


def takes_flash_fold(qkv: torch.Tensor, q_scale: torch.Tensor, k_scale: torch.Tensor, num_heads: int,
                     attn_impl: str) -> bool:
    """Whether :func:`unfused_qkv_attention` hands this call to
    :func:`flash_qkv_attention`: a contiguous bf16 tensor on the card, a
    call bound for the flash kernel (``"auto"`` from ``FLASH_MIN_TOKENS``
    tokens, or ``"flash"``) and a head dim in ``KERNEL_HEAD_DIMS``, with or
    without a gradient asked for. On the CPU, and in fp32 on the card,
    nothing changes: the composition runs (under autograd through the flash
    kernel's autograd Function)."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    if not qkv.is_cuda or qkv.dtype != torch.bfloat16 or not qkv.is_contiguous() or c % num_heads:
        return False
    d = c // num_heads
    return d in KERNEL_HEAD_DIMS and flash_route(n, d, attn_impl, cuda=True)


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
    """The unfused composition the kernel replaces (two-sided mask). Where
    :func:`takes_flash_fold` opens, :func:`flash_qkv_attention` computes it
    instead (the prologue and the flash kernel, and under autograd their
    backward: the same function on valid rows, up to the order of the
    RMSNorm sum and, in the backward, of rounding, ROADMAP.md Queue 3)."""
    if takes_flash_fold(qkv, q_scale, k_scale, num_heads, attn_impl):
        return flash_qkv_attention(qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads=num_heads,
                                   sliding_window=sliding_window)
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
            gradient is asked for, else the unfused composition, which
            :func:`takes_flash_fold` may hand to :func:`flash_qkv_attention`), ``"fused"``
            (force the kernel), or an attention impl name for the unfused
            path (``"flash"``, ``"xla"``).

    Under autograd (grad enabled and ``qkv`` or a gain requiring it),
    ``"fused"`` runs the kernel with :func:`fused_qkv_attention_bwd` as its
    backward on both devices (on the card in bf16 only: an fp32 CUDA tensor
    raises TypeError before anything launches), and ``"auto"`` takes the
    unfused composition, as the JAX package's blocks do in training.

    Returns:
        ``[B, N, C]`` in qkv's dtype.
    """
    n, c = qkv.shape[1], qkv.shape[-1] // 3
    needs_grad = torch.is_grad_enabled() and qkv.requires_grad
    if impl == "fused" or (impl == "auto" and not needs_grad and can_fuse(n, c, num_heads, cuda=qkv.is_cuda)):
        if _asks_grad(qkv, q_scale, k_scale):
            return _FusedAttention.apply(
                qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window
            )
        return _fused_forward(
            qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window
        )[0]
    return unfused_qkv_attention(
        qkv, q_scale, k_scale, cos, sin, patch_mask, num_heads, sliding_window, attn_impl=impl
    )


__all__ = [
    "fused_qkv_attention",
    "fused_qkv_attention_plain",
    "fused_qkv_attention_bwd",
    "fused_qkv_attention_bwd_plain",
    "fused_qkv_attention_mma",
    "fused_qk_prologue",
    "fused_qk_prologue_plain",
    "fused_qkv_attention_q8",
    "fused_qkv_attention_q8_plain",
    "flash_qkv_attention",
    "flash_qkv_attention_plain",
    "flash_qkv_attention_bwd",
    "flash_qkv_attention_bwd_plain",
    "takes_flash_fold",
    "unfused_qkv_attention",
    "can_fuse",
    "can_fuse_bwd",
    "can_fuse_q8",
    "f32_walk_split",
    "MAX_FUSED_TOKENS",
]
