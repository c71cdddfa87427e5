"""Int8 inference: dynamic per-token int8 activations x int8 weights.

Port of ``vitok_tpu/ops/quant.py``, the JAX package's stand-in for the
reference's torchao ``quantize()``:

* weights: per-output-channel symmetric int8 (absmax / 127, floor 1e-12);
* activations: per-token symmetric int8, computed on the fly;
* products accumulate in int32 and rescale in fp32.

Weights keep ``nn.Linear``'s ``[out, in]`` layout (the JAX package stores
``[in, out]``): ``weight_int8 [out, in]`` int8 and ``scale [out]`` fp32, so
``torch._int_mm(xq, weight_int8.t())`` is the TN product cuBLASLt's int8
path takes. That product (``int8_matmul_prequant``) is an XLA op outside any
Pallas kernel in the JAX package, and here a library call.

Three block kernels are hand-written for Hopper (``vitok_torch/csrc``), each
with its plain PyTorch version beside it:

* :func:`fused_rmsnorm_quant` (``rmsnorm_quant.cu``, replaces
  ``_rmsnorm_quant_kernel``): fp32 RMSNorm x gain, then per-token int8,
  on bf16 or fp32 rows;
* :func:`fused_ffn_int8` (``ffn_int8.cu``, replaces ``_ffn_int8_kernel``):
  the int8 fc1 product over both SwiGLU halves on wgmma, dequantize, f32
  ``silu(g) * v``, exact per-token requantization, with ``t`` kept in the
  shared memory of a thread-block cluster (:func:`ffn_int8_plan`);
* :func:`fused_silu_quant` (``silu_quant.cu``, replaces
  ``_silu_quant_kernel``): f32 ``silu(g) * v`` over the bf16 or fp32 fc1
  output, then per-token int8.

The two row kernels share one design (``csrc/row_stream.cuh``): a persistent
grid of row groups that stream their rows through shared memory, cut by
:func:`rmsnorm_quant_plan` and :func:`silu_quant_plan`.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises, and adds one to its entry of ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vitok_torch.ops import _build

# Block linears that are quantized (embeds and heads stay in the compute
# dtype), as module paths inside a block.
QUANT_LINEARS = ("attn.qkv_proj", "attn.out_proj", "ffn.fc1", "ffn.fc2")
_BLOCK_STACKS = ("encoder_blocks", "decoder_blocks")
_SCALE_FLOOR = 1e-12

# Kernel launches since each count was last set to 0.
LAUNCHES: Dict[str, int] = {"rmsnorm_quant": 0, "ffn_int8": 0, "silu_quant": 0}


# ---------------------------------------------------------------------------
# The recipe
# ---------------------------------------------------------------------------


def _div(t: torch.Tensor, d: float) -> torch.Tensor:
    """``t / d`` as an IEEE division, as the JAX package and the kernels
    divide: PyTorch's CUDA kernels multiply by the reciprocal of a Python
    number divisor, and ``1 / 127`` is not exact."""
    return t / torch.full((), d, dtype=t.dtype, device=t.device)


def _absmax_scale(t: torch.Tensor) -> torch.Tensor:
    """``max(absmax(t) / 127, 1e-12)`` over the last axis, kept."""
    return torch.clamp_min(_div(t.abs().amax(-1, keepdim=True), 127.0), _SCALE_FLOOR)


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of ``[..., out, in]``.

    Returns ``(weight_int8 [..., out, in], scale [..., out] fp32)``: absmax
    over ``in`` / 127, floored at 1e-12, ``round(w / scale)`` (half to even)
    clipped to +-127. The same codes and scales as the JAX package's
    ``quantize_weight`` on the transposed kernel.
    """
    w32 = weight.float()
    scale = _absmax_scale(w32)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(-1)


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token dynamic symmetric int8: ``x -> (x_int8, scale [..., 1])``,
    dividing by the scale."""
    x32 = x.float()
    scale = _absmax_scale(x32)
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8), scale


def _int_mm(x2: torch.Tensor, w_int8: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``x2 [M, K] @ w_int8 [N, K]^T``.

    ``torch._int_mm`` on either device: cuBLASLt's int8 path on the card
    (which takes M > 16 and K, N multiples of 8), integer arithmetic on
    the CPU.
    """
    m, k = x2.shape
    n = w_int8.shape[0]
    if w_int8.shape[1] != k:
        raise ValueError(f"int8 product: x is [{m}, {k}] but the weight is {tuple(w_int8.shape)}")
    if x2.is_cuda and (m <= 16 or k % 8 or n % 8):
        raise ValueError(
            f"torch._int_mm on CUDA takes M > 16 and K, N multiples of 8; got M={m}, K={k}, N={n}"
        )
    if not x2.is_cuda and x2.device.type != "cpu":
        raise RuntimeError(f"no int8 product for device {x2.device}")
    return torch._int_mm(x2.contiguous(), w_int8.t())


def int8_matmul_prequant(
    xq: torch.Tensor,
    a_scale: torch.Tensor,
    w_int8: torch.Tensor,
    w_scale: torch.Tensor,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """int8 x int8 product of pre-quantized activations, int32 accumulation,
    then ``(acc * a_scale) * w_scale`` in fp32, cast to ``out_dtype``.

    ``xq [..., K]`` int8, ``a_scale [..., 1]``; ``w_int8 [N, K]``,
    ``w_scale [N]``. Returns ``[..., N]``.
    """
    k = xq.shape[-1]
    acc = _int_mm(xq.reshape(-1, k), w_int8)
    out = acc.float() * a_scale.reshape(-1, 1).float() * w_scale
    return out.to(out_dtype).reshape(*xq.shape[:-1], w_int8.shape[0])


def int8_linear(x: torch.Tensor, w_int8: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Dynamic per-token int8 activations x int8 weights; ``x.dtype`` out."""
    xq, a_scale = quantize_activation(x)
    return int8_matmul_prequant(xq, a_scale, w_int8, w_scale, x.dtype)


# ---------------------------------------------------------------------------
# Padded SwiGLU layout
# ---------------------------------------------------------------------------


def pad_ffn_dim(f: int) -> int:
    """Next multiple of 128 (``8208 -> 8320``)."""
    return ((f + 127) // 128) * 128


def pad_fc1_weight(weight: torch.Tensor) -> torch.Tensor:
    """Zero-pad both SwiGLU halves of an fc1 weight ``[..., 2F, C]`` to
    ``[..., 2F', C]`` (``F' = pad_ffn_dim(F)``): rows ``[v | 0 | g | 0]``.

    The JAX package's ``pad_fc1_kernel`` in this layout. Exact: a pad row
    gives ``silu(0) * 0 = 0``, and splitting the hidden at ``F'`` keeps v
    and g paired.
    """
    f = weight.shape[-2] // 2
    fp = pad_ffn_dim(f)
    if fp == f:
        return weight
    pad = (0, 0, 0, fp - f)
    return torch.cat([F.pad(weight[..., :f, :], pad), F.pad(weight[..., f:, :], pad)], dim=-2)


def pad_fc2_weight(weight: torch.Tensor) -> torch.Tensor:
    """Zero-pad fc2's input columns ``[..., C, F] -> [..., C, F']`` to match
    :func:`pad_fc1_weight` (``pad_fc2_kernel`` in this layout)."""
    f = weight.shape[-1]
    fp = pad_ffn_dim(f)
    return weight if fp == f else F.pad(weight, (0, fp - f))


def quantize_block_linear(name: str, weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_weight` of a block linear's weight, fc1 and fc2
    (``name``) padded to 128-aligned SwiGLU halves first, as
    ``quantize_block_params`` does."""
    if name == "fc1":
        weight = pad_fc1_weight(weight)
    elif name == "fc2":
        weight = pad_fc2_weight(weight)
    return quantize_weight(weight)


# ---------------------------------------------------------------------------
# Gates: the JAX package's shape conditions, without its TPU backend check
# ---------------------------------------------------------------------------


def can_fuse_ffn(m: int, c: int, f2: int) -> bool:
    """Whether ``M`` token rows of width ``c`` with a padded fc1 of ``f2``
    outputs take :func:`fused_ffn_int8` (``_ffn_shapes_fusable``)."""
    fp = f2 // 2
    return f2 % 256 == 0 and fp % 128 == 0 and c % 128 == 0 and m % 8 == 0


def can_fuse_silu_quant(n: int) -> bool:
    """Whether a block of ``n`` tokens takes the one-pass norm/SwiGLU
    quantize kernels (``can_fuse_silu_quant``'s shape condition)."""
    return n % 8 == 0


# ---------------------------------------------------------------------------
# Kernel #9: RMSNorm + quantize
# ---------------------------------------------------------------------------


def _silu(g: torch.Tensor) -> torch.Tensor:
    """``g * sigmoid(g)``, ``jax.nn.silu``'s definition; the kernels compute
    ``sigmoid`` as PyTorch's CUDA kernel does, ``1 / (1 + exp(-g))`` in IEEE
    fp32 ops, so kernel and plain version give the same bits on the card."""
    return g * torch.sigmoid(g)


def _sum_squares(x32: torch.Tensor) -> torch.Tensor:
    """``sum(x^2)`` over the last axis in fp64 (``[..., 1]``), added in the
    order of ``rmsnorm_quant.cu`` wherever it takes the width: each lane's
    chunks (``lane + lanes * i``) and their channels in turn, then the
    butterfly over each warp (offsets 16 to 1), then the warps' partials in
    warp order. The squares of fp32 values are exact in fp64 and their sum
    is not, so the order can decide a rounding; other widths take ``sum``."""
    c = x32.shape[-1]
    sq = x32.double().square()
    if c % 8 or not 8 <= c <= _MAX_NORM_C:
        return sq.sum(-1, keepdim=True)
    lanes, vec, per = _row_split(c, _NORM_X_WORDS)
    sq = torch.nn.functional.pad(sq, (0, per * lanes * vec - c)).unflatten(-1, (per, lanes, vec))
    ss = torch.zeros(sq.shape[:-3] + (lanes,), dtype=torch.float64, device=sq.device)
    for i in range(per):
        for e in range(vec):
            ss = ss + sq[..., i, :, e]
    ss = ss.unflatten(-1, (lanes // 32, 32))
    lane = torch.arange(32, device=ss.device)
    for off in (16, 8, 4, 2, 1):
        ss = ss + ss[..., lane ^ off]
    total = ss[..., 0, 0]
    for w in range(1, lanes // 32):
        total = total + ss[..., w, 0]
    return total.unsqueeze(-1)


def fused_rmsnorm_quant_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """``_rmsnorm_quant_kernel`` in plain PyTorch: ``var = mean(x^2)``,
    ``y = x * rsqrt(var + eps) * gain`` in fp32, per-token absmax scale,
    then ``round(y / scale)``. The fp32 normed value is quantized directly
    (no round trip through the compute dtype).

    The sum of squares is taken in fp64 in the kernel's order
    (:func:`_sum_squares`) and rounded once to fp32; rsqrt is an IEEE square
    root and division. The kernel does the same, so both give the same
    bits: one code in a million off by a step is enough to move a 28-block
    int8 model's output by a few percent (PERF.md).
    """
    x32 = x.float()
    var = _div(_sum_squares(x32), x.shape[-1]).float()
    y = x32 * torch.reciprocal(torch.sqrt(var + eps)) * scale.float()
    a_scale = _absmax_scale(y)
    q = torch.clamp(torch.round(y / a_scale), -127, 127).to(torch.int8)
    return q, a_scale


def fused_rmsnorm_quant(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """``quantize_activation(rms_norm(x, scale))`` in one pass over x.

    Args:
        x: ``[..., C]`` residual stream (bf16 or fp32 on the card).
        scale: ``[C]`` norm gain.

    Returns:
        ``(q [..., C] int8, a_scale [..., 1] fp32)``.
    """
    if not x.is_cuda:
        _require_cpu(x, "rmsnorm_quant")
        return fused_rmsnorm_quant_plain(x, scale, eps)
    _require_rows(x, "rmsnorm_quant")
    c, dev = x.shape[-1], x.device
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    a_scale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=dev)
    if x.numel():
        plan = row_quant_plan("rmsnorm_quant", x.numel() // c, c, x.dtype, dev)
        _rmsnorm_quant_cuda(x, _gain(scale, dev, c), q, a_scale, plan, eps)
    return q, a_scale


def _rmsnorm_quant_cuda(x, gain, q, a_scale, plan: RowPlan, eps: float) -> None:
    """The launch of ``rmsnorm_quant.cu`` on ``plan``."""
    c = x.shape[-1]
    err = _fn("vitok_rmsnorm_quant")(
        x.data_ptr(), gain.data_ptr(), q.data_ptr(), a_scale.data_ptr(), x.numel() // c, c, eps,
        _DTYPE_CODES[x.dtype], plan.lanes, plan.vec, plan.per, plan.stages, plan.grid, x.device.index,
        _stream(x),
    )
    _check(err, "rmsnorm_quant", "launch")
    LAUNCHES["rmsnorm_quant"] += 1


# ---------------------------------------------------------------------------
# Kernel #7: int8 fc1 + SwiGLU + requantize
# ---------------------------------------------------------------------------


def fused_ffn_int8_plain(
    hq: torch.Tensor, h_scale: torch.Tensor, w_int8: torch.Tensor, w_scale: torch.Tensor
):
    """``_ffn_int8_kernel`` in plain PyTorch.

    Exact int32 accumulation; ``v = (acc_v * hs) * sv`` and the same for g;
    ``t = silu(g) * v`` in f32; the row absmax over the f32 ``t``; then ``t``
    staged as bf16 and quantized as ``round(bf16(t) * rcp)`` with
    ``rcp = 1 / scale``: a multiplication by the reciprocal, where
    :func:`quantize_activation` and :func:`fused_silu_quant` divide. Both are
    kept as the JAX package has them. ``silu(g) = g * sigmoid(g)``.
    """
    fp = w_int8.shape[0] // 2
    acc = _int_mm(hq, w_int8).float()
    hs = h_scale.reshape(-1, 1).float()
    v = acc[:, :fp] * hs * w_scale[:fp]
    g = acc[:, fp:] * hs * w_scale[fp:]
    t = _silu(g) * v
    t_scale = _absmax_scale(t)
    rcp = torch.reciprocal(t_scale)
    tq = torch.clamp(torch.round(t.to(torch.bfloat16).float() * rcp), -127, 127).to(torch.int8)
    return tq, t_scale


# The plan of ffn_int8.cu: 64 t-columns a tile (64 v and 64 g rows of W),
# 128 int8 channels a ring stage, a cluster of 8 blocks (portable) or, where
# 8 cannot stage t beside three ring stages, 16 (non-portable), at least
# three ring stages and at most four.
_FFN_TILE_COLS = 64
_FFN_BK = 128
_FFN_CLUSTERS = (8, 16)
_FFN_MIN_STAGES = 3
_FFN_MAX_STAGES = 4
_SMEM_LIMIT = 232448  # dynamic shared memory a block may use on sm_90


class FfnPlan(NamedTuple):
    """How ``ffn_int8.cu`` cuts one call: ``rows`` token rows a cluster (64 or
    128: one or two m64 products a k-step for each consumer warpgroup),
    ``cluster`` blocks a cluster, each
    owning the t-columns ``col_ranges[rank]`` (``[lo, hi)``, whole 64-column
    tiles), ``stages`` ring slots, and ``smem_bytes`` of dynamic shared
    memory a block."""

    rows: int
    cluster: int
    stages: int
    col_ranges: Tuple[Tuple[int, int], ...]
    smem_bytes: int


def _ffn_smem_bytes(rows: int, cluster: int, stages: int, fp: int) -> int:
    """``FfnSmem(rows, cs, stages, Fp).bytes`` of ``ffn_int8.cu``: the ring
    (an hq box and a 128-row W tile a stage), the staged bf16 t of the most
    tiles a rank owns (rows padded by 16 bytes), the two consumer
    warpgroups' row maxima and the rows' reciprocals, two mbarriers a stage,
    and 1 KB of alignment slack."""
    tiles = fp // _FFN_TILE_COLS
    per = -(-tiles // cluster)
    stage = rows * _FFN_BK + 2 * _FFN_TILE_COLS * _FFN_BK
    return stages * stage + rows * (per * _FFN_TILE_COLS * 2 + 16) + 3 * rows * 4 + 2 * stages * 8 + 1024


def ffn_int8_plan(m: int, c: int, fp: int) -> FfnPlan:
    """The tiling of :func:`fused_ffn_int8` for ``m`` token rows, width ``c``
    and ``fp`` SwiGLU columns: a cluster of ``min(8, fp / 64)`` blocks, or
    of ``min(16, fp / 64)`` where 8 cannot host the shape, splits the
    ``fp / 64`` tiles of a row tile between them (rank r owns tiles
    ``[r T / cs, (r + 1) T / cs)``, as the kernel computes them); 128 rows
    where three ring stages fit beside the staged t, else 64 (and 64
    whenever ``m <= 64``); as many stages as fit, three or four. Raises
    ``ValueError`` for a shape no plan hosts."""
    if m <= 0 or m % 8 or c <= 0 or c % _FFN_BK or fp <= 0 or fp % 128:
        raise ValueError(f"ffn_int8 takes M a positive multiple of 8 and C, F' multiples of 128; "
                         f"got M={m}, C={c}, F'={fp}")
    tiles = fp // _FFN_TILE_COLS
    for cluster in sorted({min(cs, tiles) for cs in _FFN_CLUSTERS}):
        for rows in (64,) if m <= 64 else (128, 64):
            fits = [s for s in range(_FFN_MIN_STAGES, _FFN_MAX_STAGES + 1)
                    if _ffn_smem_bytes(rows, cluster, s, fp) <= _SMEM_LIMIT]
            if fits:
                stages = fits[-1]
                ranges = tuple((r * tiles // cluster * _FFN_TILE_COLS, (r + 1) * tiles // cluster * _FFN_TILE_COLS)
                               for r in range(cluster))
                return FfnPlan(rows, cluster, stages, ranges, _ffn_smem_bytes(rows, cluster, stages, fp))
    raise ValueError(f"ffn_int8: F'={fp} is too wide for one cluster of {_FFN_CLUSTERS[-1]} blocks to keep t in "
                     f"shared memory ({_SMEM_LIMIT} bytes a block)")


def ffn_int8_attributes(plan: FfnPlan, fp: int) -> dict:
    """The kernel instance of ``plan`` on the card: registers and spill
    bytes a thread, clusters that can be resident at once, and shared
    memory a block."""
    out = (ctypes.c_int * 4)()
    lib = _lib("ffn_int8")
    _build.check(lib, lib.vitok_ffn_int8_attributes(plan.rows, plan.cluster, plan.stages, fp, out),
                 "ffn_int8 attributes")
    return dict(registers=out[0], spill_bytes=out[1], max_active_clusters=out[2], smem_bytes=out[3])


def fused_ffn_int8(
    hq: torch.Tensor, h_scale: torch.Tensor, w_int8: torch.Tensor, w_scale: torch.Tensor
):
    """Fused int8 fc1 product + SwiGLU + per-token int8 requantization.

    Replaces ``int8_matmul_prequant(hq, h_scale, fc1) -> fused_silu_quant``
    without the ``[M, 2F']`` bf16 hidden. The fc1 weight must be in the
    padded layout (:func:`pad_fc1_weight`), and the shapes must pass
    :func:`can_fuse_ffn`.

    Args:
        hq: ``[M, C]`` int8 activations; h_scale: ``[M, 1]`` fp32.
        w_int8: ``[2F', C]`` int8 (v rows, then g rows); w_scale: ``[2F']``.

    Returns:
        ``(tq [M, F'] int8, t_scale [M, 1] fp32)`` for fc2's
        :func:`int8_matmul_prequant`.
    """
    if not hq.is_cuda:
        _require_cpu(hq, "ffn_int8")
        return fused_ffn_int8_plain(hq, h_scale, w_int8, w_scale)
    if hq.dim() != 2 or w_int8.dim() != 2 or hq.dtype != torch.int8 or w_int8.dtype != torch.int8:
        raise ValueError("ffn_int8 takes int8 hq [M, C] and int8 w_int8 [2F', C]")
    m, c = hq.shape
    f2 = w_int8.shape[0]
    if w_int8.shape[1] != c or not can_fuse_ffn(m, c, f2):
        raise ValueError(f"ffn_int8 does not take M={m}, C={c}, w_int8 {tuple(w_int8.shape)} "
                         "(can_fuse_ffn: C and F' multiples of 128, M of 8)")
    dev = hq.device
    hq = hq.contiguous()
    w_int8 = _on(w_int8, dev, (f2, c), "w_int8").contiguous()
    if hq.data_ptr() % 16 or w_int8.data_ptr() % 16:
        raise ValueError("ffn_int8: hq and w_int8 must be 16-byte aligned")
    hs = _on(h_scale.reshape(-1), dev, (m,), "h_scale").float().contiguous()
    ws = _aligned(_on(w_scale, dev, (f2,), "w_scale").float().contiguous())
    fp = f2 // 2
    plan = ffn_int8_plan(m, c, fp)
    tq = torch.empty((m, fp), dtype=torch.int8, device=dev)
    t_scale = torch.empty((m, 1), dtype=torch.float32, device=dev)
    lib = _lib("ffn_int8")
    with torch.cuda.device(dev):
        err = lib.vitok_ffn_int8(
            hq.data_ptr(), hs.data_ptr(), w_int8.data_ptr(), ws.data_ptr(), tq.data_ptr(),
            t_scale.data_ptr(), m, c, fp, plan.rows, plan.cluster, plan.stages, _stream(hq),
        )
    _build.check(lib, err, "ffn_int8 launch")
    LAUNCHES["ffn_int8"] += 1
    return tq, t_scale


# ---------------------------------------------------------------------------
# Kernel #8: SwiGLU + quantize
# ---------------------------------------------------------------------------


def fused_silu_quant_plain(hid: torch.Tensor):
    """``_silu_quant_kernel`` in plain PyTorch: ``t = silu(g) * v`` in f32
    (``silu(g) = g * sigmoid(g)``), absmax over the f32 ``t``,
    ``round(t / scale)`` (division)."""
    fp = hid.shape[-1] // 2
    v, g = hid[..., :fp].float(), hid[..., fp:].float()
    t = _silu(g) * v
    scale = _absmax_scale(t)
    return torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8), scale


def fused_silu_quant(hid: torch.Tensor):
    """``quantize_activation(silu(g) * v)`` in one pass over the fc1 output.

    Args:
        hid: ``[..., 2F']`` (v in the first F' channels, g in the rest; bf16
            or fp32 on the card).

    Returns:
        ``(q [..., F'] int8, scale [..., 1] fp32)``.
    """
    if not hid.is_cuda:
        _require_cpu(hid, "silu_quant")
        return fused_silu_quant_plain(hid)
    _require_rows(hid, "silu_quant")
    f2 = hid.shape[-1]
    fp = f2 // 2
    if f2 % 16 or not 0 < fp <= _MAX_SILU_FP:
        raise ValueError(f"silu_quant takes 2F' a multiple of 16 with F' up to {_MAX_SILU_FP}, got 2F'={f2}")
    rows, dev = hid.numel() // f2, hid.device
    q = torch.empty((*hid.shape[:-1], fp), dtype=torch.int8, device=dev)
    scale = torch.empty((*hid.shape[:-1], 1), dtype=torch.float32, device=dev)
    if rows:
        _silu_quant_cuda(hid, q, scale, row_quant_plan("silu_quant", rows, fp, hid.dtype, dev))
    return q, scale


def _silu_quant_cuda(hid, q, scale, plan: RowPlan) -> None:
    """The launch of ``silu_quant.cu`` on ``plan``."""
    fp = hid.shape[-1] // 2
    err = _fn("vitok_silu_quant")(
        hid.data_ptr(), q.data_ptr(), scale.data_ptr(), hid.numel() // (2 * fp), fp, _DTYPE_CODES[hid.dtype],
        plan.lanes, plan.vec, plan.per, plan.stages, plan.grid, hid.device.index, _stream(hid),
    )
    _check(err, "silu_quant", "launch")
    LAUNCHES["silu_quant"] += 1


# ---------------------------------------------------------------------------
# The row kernels' plan (#9 and #8): persistent row streaming
# ---------------------------------------------------------------------------

# The rules of csrc/row_stream.cuh, rmsnorm_quant.cu and silu_quant.cu.
_ROW_LANES = (32, 64, 128, 256)  # lanes a row: one warp, or 2-8 warps joined by a named barrier
_NORM_X_WORDS = 48      # y values a lane holds in fp32 registers (#9, kXWords)
_SILU_T_WORDS = 64      # t values a lane holds in fp32 registers (#8, kTWords)
_MAX_NORM_C = 8192
_MAX_SILU_FP = 16384
H100_SMS = 132
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


class RowPlan(NamedTuple):
    """How ``rmsnorm_quant.cu`` or ``silu_quant.cu`` cuts one call.

    ``lanes`` lanes hold a row (``warps_per_row`` warps). A lane owns
    ``per`` chunks of ``vec`` adjacent channels (chunk ``lane + lanes * i``),
    the same in every row, and stores each chunk's codes in one ``vec``-byte
    store. A block of ``threads`` threads holds ``rows_per_block`` row
    groups and ``smem_bytes`` of dynamic shared memory (#9: with the gain);
    ``grid`` blocks (``blocks_per_sm`` on each SM, so one wave), and group
    ``g`` walks rows ``g, g + G, ...`` (``G = grid * rows_per_block``), each
    row copied into a ring of ``stages`` row slots (2: one row ahead; 1 where
    two rows do not fit a block).
    """

    lanes: int
    warps_per_row: int
    vec: int
    per: int
    threads: int
    rows_per_block: int
    stages: int
    smem_bytes: int
    blocks_per_sm: int
    grid: int


def _row_itemsize(dtype: torch.dtype, what: str) -> int:
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the {what} CUDA kernel takes bfloat16 or float32, got {dtype}")
    return 2 if dtype == torch.bfloat16 else 4


def _row_split(n: int, words: int) -> Tuple[int, int, int]:
    """(lanes a row, channels a chunk, chunks a lane) for rows of ``n``
    channels: chunks of 16 (8 where ``n % 16 == 8``), and the fewest lanes
    from a warp up that hold the row in at most ``words`` values a lane."""
    vec = 16 if n % 16 == 0 else 8
    units = n // vec
    for lanes in _ROW_LANES:
        per = -(-units // lanes)
        if per <= words // vec:
            return lanes, vec, per
    raise ValueError(f"{n} channels: wider than the row kernels' limits")


def _row_smem(kernel: str, n: int, itemsize: int, lanes: int, vec: int, per: int, stages: int) -> int:
    """Dynamic shared bytes of a block (``NormSmem`` / ``silu_smem_bytes``):
    the groups' rings, #9's gain, and each group's partials where a row
    spans several warps (fp64 and fp32 for #9, fp32 for #8)."""
    groups = max(128, lanes) // lanes
    red_warps = lanes // 32 if lanes > 32 else 0
    if kernel == "rmsnorm_quant":
        return groups * (stages * n * itemsize + red_warps * 12) + per * vec * lanes * 4
    return groups * (stages * 2 * n * itemsize + red_warps * 4)


def _row_plan(kernel: str, m: int, n: int, itemsize: int, words: int, sms: int, blocks_per_sm: int) -> RowPlan:
    lanes, vec, per = _row_split(n, words)
    threads = max(128, lanes)
    for stages in (2, 1):
        smem = _row_smem(kernel, n, itemsize, lanes, vec, per, stages)
        if smem <= _SMEM_LIMIT:
            break
    else:
        raise ValueError(f"{kernel}: a row of {n} channels does not fit one block's shared memory")
    if blocks_per_sm < 1:
        raise ValueError(f"{kernel}: the instance for {n} channels fits no SM")
    groups = threads // lanes
    grid = min(-(-m // groups), sms * blocks_per_sm)
    return RowPlan(lanes, lanes // 32, vec, per, threads, groups, stages, smem, blocks_per_sm, grid)


@functools.lru_cache(maxsize=512)
def rmsnorm_quant_plan(m: int, c: int, dtype: torch.dtype = torch.bfloat16, sms: int = H100_SMS,
                       blocks_per_sm: int = 1) -> RowPlan:
    """The plan of :func:`fused_rmsnorm_quant` for ``m`` rows of width ``c``
    in ``dtype`` on a card of ``sms`` SMs that each host ``blocks_per_sm``
    blocks of the plan's instance (the wrapper reads both from the card:
    :func:`row_quant_plan`). A warp a row while a lane holds at most 48
    values of x (C 1536), wider rows over more warps; the gain in shared
    memory. The split (lanes, vec, per) depends on ``c`` alone, and so does
    the order in which the kernel and :func:`fused_rmsnorm_quant_plain` add
    the squares. Raises ``ValueError`` outside C a multiple of 8 up to 8192,
    ``TypeError`` for another dtype."""
    itemsize = _row_itemsize(dtype, "rmsnorm_quant")
    if m < 1 or c < 8 or c % 8 or c > _MAX_NORM_C:
        raise ValueError(f"rmsnorm_quant takes M >= 1 and C a multiple of 8 up to {_MAX_NORM_C}, got M={m}, C={c}")
    return _row_plan("rmsnorm_quant", m, c, itemsize, _NORM_X_WORDS, sms, blocks_per_sm)


@functools.lru_cache(maxsize=512)
def silu_quant_plan(m: int, fp: int, dtype: torch.dtype = torch.bfloat16, sms: int = H100_SMS,
                    blocks_per_sm: int = 1) -> RowPlan:
    """The plan of :func:`fused_silu_quant` for ``m`` rows of ``2 fp``
    inputs in ``dtype`` on a card of ``sms`` SMs that each host
    ``blocks_per_sm`` blocks of the plan's instance (as
    :func:`rmsnorm_quant_plan`): a warp a row while a lane holds at most 64
    values of t (F' 2048), wider rows over more warps. Raises ``ValueError``
    outside F' a multiple of 8 up to 16384, ``TypeError`` for another
    dtype."""
    itemsize = _row_itemsize(dtype, "silu_quant")
    if m < 1 or fp < 8 or fp % 8 or fp > _MAX_SILU_FP:
        raise ValueError(f"silu_quant takes M >= 1 and F' a multiple of 8 up to {_MAX_SILU_FP}, got M={m}, F'={fp}")
    return _row_plan("silu_quant", m, fp, itemsize, _SILU_T_WORDS, sms, blocks_per_sm)


_ROW_PLANS = {"rmsnorm_quant": rmsnorm_quant_plan, "silu_quant": silu_quant_plan}
_OCCUPANCY: Dict[tuple, Tuple[int, int]] = {}


def _occupancy(kernel: str, n: int, dtype: torch.dtype, dev: torch.device) -> Tuple[int, int]:
    """(SMs, blocks of the instance one SM hosts) on ``dev``, asked of the
    card once per instance and card."""
    key = (kernel, n, dtype, dev.index)
    occ = _OCCUPANCY.get(key)
    if occ is None:
        with torch.cuda.device(dev):
            blocks = row_quant_attributes(kernel, _ROW_PLANS[kernel](1, n, dtype), n, dtype)["blocks_per_sm"]
            occ = _OCCUPANCY[key] = (torch.cuda.get_device_properties(dev).multi_processor_count, blocks)
    return occ


def row_quant_plan(kernel: str, m: int, n: int, dtype: torch.dtype, dev: torch.device) -> RowPlan:
    """The plan the wrapper of ``kernel`` ("rmsnorm_quant" with ``n = C``,
    or "silu_quant" with ``n = F'``) launches for ``m`` rows on the card
    ``dev``: one wave of the blocks its instance fits there."""
    return _ROW_PLANS[kernel](m, n, dtype, *_occupancy(kernel, n, dtype, dev))


def row_quant_attributes(kernel: str, plan: RowPlan, n: int, dtype: torch.dtype) -> dict:
    """The kernel instance of ``plan`` (``kernel`` "rmsnorm_quant" with
    ``n = C``, or "silu_quant" with ``n = F'``) on the current card:
    registers and spill bytes a thread, blocks one SM hosts, and shared
    memory a block."""
    out = (ctypes.c_int * 4)()
    err = _fn(f"vitok_{kernel}_attributes")(n, _DTYPE_CODES[dtype], plan.lanes, plan.vec, plan.per, plan.stages, out)
    _check(err, kernel, "attributes")
    return dict(registers=out[0], spill_bytes=out[1], blocks_per_sm=out[2], smem_bytes=out[3])


# ---------------------------------------------------------------------------
# Launch helpers
# ---------------------------------------------------------------------------

_ARGTYPES = {  # C entry point: (library, argument types)
    "vitok_rmsnorm_quant": ("rmsnorm_quant", "ppppiifiiiiiiip"),
    "vitok_rmsnorm_quant_attributes": ("rmsnorm_quant", "iiiiiip"),
    "vitok_ffn_int8": ("ffn_int8", "ppppppiiiiiip"),
    "vitok_ffn_int8_attributes": ("ffn_int8", "iiiip"),
    "vitok_silu_quant": ("silu_quant", "pppiiiiiiiiip"),
    "vitok_silu_quant_attributes": ("silu_quant", "iiiiiip"),
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
_FNS: Dict[str, object] = {}


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    for fn_name, (lib_name, sig) in _ARGTYPES.items():
        if lib_name == name:
            fn = getattr(lib, fn_name)
            if fn.argtypes is None:
                fn.argtypes = [_CTYPES[ch] for ch in sig]
                fn.restype = ctypes.c_int
    return lib


def _fn(fn_name: str):
    """A C entry point, its argument types set, looked up once."""
    fn = _FNS.get(fn_name)
    if fn is None:
        fn = _FNS[fn_name] = getattr(_lib(_ARGTYPES[fn_name][0]), fn_name)
    return fn


def _check(err: int, lib_name: str, what: str) -> None:
    if err:
        _build.check(_lib(lib_name), err, f"{lib_name} {what}")


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s card."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _require_cpu(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cpu":
        raise RuntimeError(f"no {what} kernel for device {t.device}")


def _require_rows(x: torch.Tensor, what: str) -> None:
    """The row kernels' input: bf16 or fp32, contiguous, 16-byte aligned."""
    _row_itemsize(x.dtype, what)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: input must be contiguous and 16-byte aligned")


def _gain(scale: torch.Tensor, dev: torch.device, c: int) -> torch.Tensor:
    """#9's gain as the kernel reads it: the tensor itself where it already
    is a contiguous, 16-byte aligned fp32 ``[C]`` on ``dev``."""
    if (scale.dtype == torch.float32 and scale.device == dev and scale.shape == (c,) and scale.is_contiguous()
            and scale.data_ptr() % 16 == 0):
        return scale
    return _aligned(_on(scale, dev, (c,), "scale").float().contiguous())


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous parameter vector the kernels read 8 or 16 bytes at a
    time, copied if a view left it unaligned."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _on(t: torch.Tensor, dev: torch.device, shape, name: str) -> torch.Tensor:
    if t.device != dev or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)} on {dev}, got {tuple(t.shape)} on {t.device}")
    return t


# ---------------------------------------------------------------------------
# State-dict helpers (gates for the quality tests, and the negative control)
# ---------------------------------------------------------------------------


def _is_block_linear_weight(key: str) -> bool:
    parts = key.split(".")
    return (
        len(parts) == 5 and parts[0] in _BLOCK_STACKS and parts[-1] == "weight"
        and ".".join(parts[2:4]) in QUANT_LINEARS
    )


def gate_sensitive_params(
    state: Mapping[str, torch.Tensor], seed: int = 0, lo: float = 0.5, hi: float = 1.5
) -> Dict[str, torch.Tensor]:
    """Every ``layer_scale.gamma`` replaced by U(lo, hi) values (numpy,
    ``seed``); every other entry shared, not copied.

    The reference LayerScale init (1e-4) scales every quantized block's
    contribution down by four orders of magnitude, which makes an
    int8-vs-full-precision quality gate near-vacuous: gates run at the O(1)
    gains trained checkpoints reach.
    """
    rng = np.random.default_rng(seed)
    out = dict(state)
    for key in sorted(state):
        if key.endswith("layer_scale.gamma"):
            g = state[key]
            draw = torch.from_numpy(rng.uniform(lo, hi, tuple(g.shape)).astype(np.float32))
            out[key] = draw.to(dtype=g.dtype, device=g.device)
    return out


def degrade_block_weights(state: Mapping[str, torch.Tensor], bits: int = 4) -> Dict[str, torch.Tensor]:
    """Negative control for quality gates: every block linear weight snapped
    to a symmetric per-output-channel ``bits``-bit grid, kept in its dtype
    (the model still runs its full-precision path). At 4 bits the weight
    noise is about 8x the int8 level: a gate that does not fail on it is
    vacuous."""
    qmax = float(2 ** (bits - 1) - 1)
    out = dict(state)
    for key, w in state.items():
        if _is_block_linear_weight(key):
            w32 = w.float()
            scale = torch.clamp_min(w32.abs().amax(-1, keepdim=True) / qmax, _SCALE_FLOOR)
            out[key] = (torch.round(w32 / scale) * scale).to(w.dtype)
    return out


def is_quantized(state_or_module) -> bool:
    """Whether a state dict (or a module's) holds int8 block weights."""
    state = state_or_module
    if isinstance(state_or_module, torch.nn.Module):
        state = state_or_module.state_dict()
    return any(k.endswith(".weight_int8") for k in state)


def quantize_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's ``quantize_block_params``: every block linear ``weight``
    (fc1/fc2 padded first) becomes ``weight_int8`` + ``scale``; every other
    entry, and entries already quantized, are kept. Idempotent."""
    out: Dict[str, torch.Tensor] = {}
    for key, w in state.items():
        if not _is_block_linear_weight(key):
            out[key] = w
            continue
        prefix = key[: -len("weight")]
        name = prefix.split(".")[-2]
        out[prefix + "weight_int8"], out[prefix + "scale"] = quantize_block_linear(name, w)
    return out


__all__ = [
    "quantize_weight",
    "int8_linear",
    "quantize_state_dict",
    "is_quantized",
]
