"""Flash attention over NaFlex token sequences, forward and backward.

Port of ``vitok_tpu/ops/flash_attention.py``: the forward (``_attn_kernel``,
its launcher ``_flash_fwd`` and the public ``flash_attention``) and the
backward (``_dq_kernel``, ``_dkv_kernel``, their launcher ``_flash_bwd``),
tied together by a ``torch.autograd.Function`` as the JAX package ties them
with a custom vjp. Layout ``[B, N, H, D]`` in and out. On CUDA tensors
:func:`flash_attention` and :func:`flash_attention_bwd` launch the
hand-written Hopper kernels in ``vitok_torch/csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu`` (bf16), or their fp32 instances in
``csrc/flash_attention_f32.cu`` (products on the tensor cores at fp32
accuracy: each operand split into three bf16 pieces, six products a
product); on CPU tensors they run
:func:`flash_attention_plain` and :func:`flash_attention_bwd_plain`, the same
functions in plain PyTorch. The CUDA paths never fall back.

Semantics, as the TPU kernel has them: the patch mask is applied key-side
and padded query rows are zeroed; a row with no live key (no valid key
inside its window) gives 0; the optional log-sum-exp is ``m + log(l)``, or
+1e30 for such a row. The backward zeroes the cotangent on padded query
rows, recomputes ``p = exp(s - lse)`` from that log-sum-exp, and gives 0 on
padded rows of dq, dk and dv. The JAX package takes its kernel backward
above 2048 tokens and a materialised recompute at or below; here the
backward kernels run whenever the forward kernel ran.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from vitok_torch.ops import _build

# Head dims each family of CUDA kernels has instances for. The gates open no
# other head dim on the card, and the wrappers raise on one.
FWD_HEAD_DIMS = (64, 128, 192, 256)      # the bf16 forward: the q/k prologue, #1, #2 and #4 (plain and fold)
BWD_HEAD_DIMS = (64, 128, 192, 256)      # the bf16 backward: #3, #5, #6 (plain and fold) and the prologue's delta
F32_FWD_HEAD_DIMS = (64, 128, 192, 256)  # the fp32 forward: the q/k prologue, #1 (the fp32 walker), #2 and #4
F32_BWD_HEAD_DIMS = (64, 128, 192, 256)  # the fp32 backward: the walker's lse instance, #3, #5, #6, the delta
AB_HEAD_DIMS = (64, 128, 192, 256)      # the A/B kernels #10-#13 and #12's int8 q/k prologue
MMA_HEAD_DIMS = (64, 128)                # the kept mma.sync forward (arm B of the A/B entry points)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_NEG_FILL = -1e30
_DEAD_LSE = 1e30
LOG2E = 1.4426950408889634  # times a natural-log lse: the exponent in log2 units
_DEFAULT_BLOCK_K = 512  # the TPU kernel's key block, which sets where p is rounded
_PLAIN_BLOCK_Q = 1024   # query rows per step of the plain version (memory only)

# Launches of each CUDA kernel since its count was last set to 0: the
# forward, the dq kernel and the dk/dv kernel, and their fp32 instances.
LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
F32_LAUNCHES = 0
DQ_F32_LAUNCHES = 0
DKV_F32_LAUNCHES = 0

# The fp32 library's kernels by the index its attributes entry takes.
F32_KERNELS = ("fwd", "dq", "dkv", "dq_fold", "dkv_fold")


def kernel_head_dims(dtype: torch.dtype, grad: bool = False) -> Tuple[int, ...]:
    """The head dims at which a call in ``dtype`` finds every kernel it runs
    on the card: those of the forward (bf16 and fp32: 64-256), or with a
    gradient asked for (``grad``) of the backward too (bf16 and fp32:
    64-256)."""
    if dtype == torch.float32:
        return F32_BWD_HEAD_DIMS if grad else F32_FWD_HEAD_DIMS
    return BWD_HEAD_DIMS if grad else FWD_HEAD_DIMS


def check_head_dim(d: int, dims: Tuple[int, ...], what: str) -> None:
    """Raise unless head dim ``d`` is one of ``dims`` (a kernel family's)."""
    if d not in dims:
        raise ValueError(f"{what} take head_dim in {dims}, got {d}")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def key_counts(patch_mask: torch.Tensor) -> torch.Tensor:
    """``[2, B]`` int32: one past each sample's last valid key (the TPU
    kernel's live KV range, exact for any mask), then the number of leading
    valid keys (below it no key needs the mask)."""
    mask = patch_mask.bool()
    n = mask.shape[1]
    idx = torch.arange(n, device=mask.device, dtype=torch.int32)
    valid = torch.where(mask, idx + 1, 0).amax(1)
    lead = torch.where(mask, n, idx).amin(1)
    return torch.stack([valid, lead]).to(torch.int32)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The kernel's function in plain PyTorch (``_attn_kernel``).

    q is prescaled in its own dtype, ``(q.float() * (1/sqrt(d))).to(q.dtype)``;
    logits are fp32; masked and out-of-window keys are filled with -1e30. The
    online recurrence walks the JAX package's default key blocks,
    ``min(512, round_up(N, 128))`` keys, so p is rounded at the same running
    maxima: ``exp``, p zeroed for filled logits and dead rows, l
    summed from the fp32 p, p cast to v's dtype before PV. Key blocks that
    hold no live key of a query block are skipped (they add exactly 0).
    Queries go in blocks, so memory stays O(block * N).

    Returns ``[B, N, H, D]`` in v's dtype, and with ``return_lse`` also the
    fp32 log-sum-exp ``[B, H, N]`` (+1e30 for rows with no live key).
    """
    b, n, h, d = q.shape
    block_k = min(_DEFAULT_BLOCK_K, _round_up(n, 128))
    sw = sliding_window
    dev = q.device
    qt = (q.float() * (1.0 / d ** 0.5)).to(q.dtype).transpose(1, 2)  # [B, H, N, D]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    key_ok = q_ok = None
    live = n
    if patch_mask is not None:
        q_ok = patch_mask.bool()
        key_ok = q_ok[:, None, None, :]
        live = int(key_counts(q_ok)[0].max().item())
    out = torch.zeros((b, n, h, d), dtype=v.dtype, device=dev)
    lse = torch.full((b, h, n), _DEAD_LSE, dtype=torch.float32, device=dev) if return_lse else None
    half_neg = _NEG_FILL / 2
    for q0 in range(0, n, _PLAIN_BLOCK_Q):
        q1 = min(n, q0 + _PLAIN_BLOCK_Q)
        lo, hi = 0, live
        if sw is not None:
            lo, hi = max(0, q0 - sw), min(live, q1 + sw)
        qb = qt[:, :, q0:q1].float()
        m = torch.full((b, h, q1 - q0, 1), _NEG_FILL, device=dev)
        l = torch.zeros((b, h, q1 - q0, 1), device=dev)
        acc = torch.zeros((b, h, q1 - q0, d), device=dev)
        for k0 in range(lo // block_k * block_k, hi, block_k):
            k1 = min(n, k0 + block_k)
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kt[:, :, k0:k1].float())
            keep = None if key_ok is None else key_ok[..., k0:k1]
            if sw is not None:
                qpos = torch.arange(q0, q1, device=dev)[:, None]
                kpos = torch.arange(k0, k1, device=dev)[None, :]
                window = (qpos - kpos).abs() <= sw
                keep = window if keep is None else keep & window
            if keep is not None:
                s = s.masked_fill(~keep, _NEG_FILL)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            dead = m_new <= half_neg
            p = torch.where(dead | (s <= half_neg), 0.0, p)
            alpha = torch.where(dead, 0.0, alpha)
            l = l * alpha + p.sum(-1, keepdim=True)
            m = m_new
            pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vt[:, :, k0:k1].float())
            acc = acc * alpha + pv
        o = acc / torch.where(l == 0.0, 1.0, l)
        if q_ok is not None:
            o = o * q_ok[:, None, q0:q1, None]
        out[:, q0:q1] = o.transpose(1, 2).to(v.dtype)
        if return_lse:
            lse[:, :, q0:q1] = torch.where(l > 0.0, m + torch.log(torch.where(l == 0.0, 1.0, l)),
                                           _DEAD_LSE)[..., 0]
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    grad_out: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    *,
    delta: Optional[torch.Tensor] = None,
    round_qk: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain PyTorch (``_dq_kernel``,
    ``_dkv_kernel``).

    The cotangent is zeroed on padded query rows; ``qs`` is q prescaled in
    its own dtype; ``p = exp(qs k^T - lse)`` in fp32, 0 for masked keys and
    pairs outside the window; ``delta = sum_d dO * O`` in fp32 (or the given
    ``delta [B, H, N]``, formed so from a cotangent zeroed on padded rows);
    ``ds = p * (dO v^T - delta)``; p and ds are cast to the input dtype
    before ``dv = p^T dO``, ``dq = scale * ds k`` and ``dk = scale * ds^T q``
    (the unscaled q); fp32 accumulators, cast on the way out. Queries go in
    blocks, so memory stays O(block * N).

    Returns ``(dq, dk, dv)``, each ``[B, N, H, D]`` in its input's dtype;
    without ``round_qk`` dq and dk stay fp32 (the fold's norm and rotation
    backward reads them so).
    """
    b, n, h, d = q.shape
    sw = sliding_window
    dev = q.device
    dt = q.dtype
    scale = 1.0 / d ** 0.5
    g = grad_out
    key_ok = None
    live = n
    if patch_mask is not None:
        pm = patch_mask.bool()
        g = g * pm[:, :, None, None].to(g.dtype)
        key_ok = pm[:, None, None, :]
        live = int(key_counts(pm)[0].max().item())
    qt = q.transpose(1, 2)                                          # [B, H, N, D]
    qst = (q.float() * scale).to(dt).transpose(1, 2)
    kt, vt, gt = k.transpose(1, 2).float(), v.transpose(1, 2).float(), g.transpose(1, 2)
    if delta is None:
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2)   # [B, H, N]
    dq = torch.zeros((b, h, n, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, h, n, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, h, n, d), dtype=torch.float32, device=dev)
    for q0 in range(0, n, _PLAIN_BLOCK_Q):
        q1 = min(n, q0 + _PLAIN_BLOCK_Q)
        lo, hi = 0, live
        if sw is not None:
            lo, hi = max(0, q0 - sw), min(live, q1 + sw)
        if hi <= lo:
            continue
        kb, vb = kt[:, :, lo:hi], vt[:, :, lo:hi]
        gb = gt[:, :, q0:q1].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qst[:, :, q0:q1].float(), kb)
        p = torch.exp(s - lse[:, :, q0:q1, None])
        keep = None if key_ok is None else key_ok[..., lo:hi]
        if sw is not None:
            qpos = torch.arange(q0, q1, device=dev)[:, None]
            kpos = torch.arange(lo, hi, device=dev)[None, :]
            window = (qpos - kpos).abs() <= sw
            keep = window if keep is None else keep & window
        if keep is not None:
            p = torch.where(keep, p, 0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", gb, vb)
        ds = (p * (dp - delta[:, :, q0:q1, None])).to(dt).float()
        p = p.to(dt).float()
        dq[:, :, q0:q1] = scale * torch.einsum("bhqk,bhkd->bhqd", ds, kb)
        dv[:, :, lo:hi] += torch.einsum("bhqk,bhqd->bhkd", p, gb)
        dk[:, :, lo:hi] += scale * torch.einsum("bhqk,bhqd->bhkd", ds, qt[:, :, q0:q1].float())
    dq, dk = dq.transpose(1, 2), dk.transpose(1, 2)
    if round_qk:
        dq, dk = dq.to(dt), dk.to(k.dtype)
    return dq, dk, dv.transpose(1, 2).to(v.dtype)


def _check_strides(name: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} needs a contiguous last dim, got strides {t.stride()}")
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"flash_attention: {name} needs a 16-byte aligned base and strides that "
                         f"are multiples of 8 elements, got strides {t.stride()}")


def _check_qkv(q, k, v, grad=False):
    """Shape, head dim, dtype, device and strides the CUDA kernels take;
    ``grad``: the backward's head dims."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, N, H, D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    check_head_dim(q.shape[-1], kernel_head_dims(q.dtype, grad),
                   f"the flash CUDA kernels in {str(q.dtype).replace('torch.', '')}"
                   + (" with their backward" if grad else ""))
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"the flash CUDA kernels take bfloat16 or float32 q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
            f"{v.dtype}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_strides(name, t)


def _mask_and_counts(patch_mask, b, n, dev):
    if patch_mask is None:
        return None, None
    if patch_mask.device != dev or tuple(patch_mask.shape) != (b, n):
        raise ValueError(f"patch_mask must be {(b, n)} on {dev}")
    mask = patch_mask.bool().contiguous()
    return mask, key_counts(mask)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _flash_cuda(q, k, v, patch_mask, sliding_window, return_lse):
    global LAUNCHES
    _check_qkv(q, k, v)
    b, n, h, d = q.shape
    dev = q.device
    mask, counts = _mask_and_counts(patch_mask, b, n, dev)
    sw = -1 if sliding_window is None else int(sliding_window)
    out = torch.empty((b, n, h, d), dtype=v.dtype, device=dev)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=dev) if return_lse else None

    global F32_LAUNCHES
    f32 = q.dtype == torch.float32
    lib = _f32_kernel_lib() if f32 else _kernel_lib()
    entry = lib.vitok_flash_attention_f32 if f32 else lib.vitok_flash_attention_bf16
    with torch.cuda.device(dev):  # the C entry launches on the current device
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            _ptr(mask), _ptr(counts), out.data_ptr(), _ptr(lse),
            b, n, h, d, sw, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, "flash_attention launch")
    if f32:
        F32_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return (out, lse) if return_lse else out


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.vitok_flash_attention_bf16
    if fn.argtypes is None:
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr] * 3 + [ll] * 9 + [ptr] * 4 + [i] * 5 + [ptr]
        fn.restype = ctypes.c_int
        lib.vitok_flash_attention_attributes.argtypes = [i, ptr]
        lib.vitok_flash_attention_attributes.restype = ctypes.c_int
    return lib


def flash_attributes(d: int) -> dict:
    """Registers and local memory (spills) a thread, blocks an SM and shared
    memory a block of the bf16 forward kernel at head dim ``d``, as the
    compiler and the card report them."""
    out = (ctypes.c_int * 4)()
    lib = _kernel_lib()
    _build.check(lib, lib.vitok_flash_attention_attributes(d, out), "flash forward attributes")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2], smem_bytes=out[3])


def _bwd_kernel_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    if lib.vitok_flash_bwd_dq_bf16.argtypes is None:
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vitok_flash_bwd_dq_bf16.argtypes = [ptr] * 5 + [ll] * 15 + [ptr] * 5 + [i] * 5 + [ptr]
        lib.vitok_flash_bwd_dq_bf16.restype = ctypes.c_int
        lib.vitok_flash_bwd_dkv_bf16.argtypes = [ptr] * 4 + [ll] * 12 + [ptr] * 6 + [i] * 5 + [ptr]
        lib.vitok_flash_bwd_dkv_bf16.restype = ctypes.c_int
        for fn in (lib.vitok_flash_bwd_dq_fold_bf16, lib.vitok_flash_bwd_dkv_fold_bf16):
            fn.argtypes = [ptr] * 12 + [i] * 5 + [ptr]
            fn.restype = ctypes.c_int
        lib.vitok_flash_bwd_attributes.argtypes = [i] * 3 + [ptr]
        lib.vitok_flash_bwd_attributes.restype = ctypes.c_int
    return lib


def _f32_kernel_lib() -> ctypes.CDLL:
    """``csrc/flash_attention_f32.cu``: the fp32 instances of #4-#6 (and the
    fold instances the fused backward's fp32 instance runs)."""
    lib = _build.load("flash_attention_f32")
    ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn, argtypes in (
        (lib.vitok_flash_attention_f32, [ptr] * 3 + [ll] * 9 + [ptr] * 4 + [i] * 5 + [ptr]),
        (lib.vitok_flash_bwd_dq_f32, [ptr] * 5 + [ll] * 15 + [ptr] * 5 + [i] * 5 + [ptr]),
        (lib.vitok_flash_bwd_dkv_f32, [ptr] * 4 + [ll] * 12 + [ptr] * 6 + [i] * 5 + [ptr]),
        (lib.vitok_flash_bwd_fold_f32, [i, ctypes.c_float] + [ptr] * 12 + [i] * 5 + [ptr]),
        (lib.vitok_flash_f32_attributes, [i] * 2 + [ptr]),
    ):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def flash_f32_attributes(which: str, d: int) -> dict:
    """Registers and local memory (spills) a thread, blocks an SM and shared
    memory a block of one fp32 kernel (``which`` one of ``F32_KERNELS``) at
    head dim ``d``, as the compiler and the card report them."""
    out = (ctypes.c_int * 4)()
    lib = _f32_kernel_lib()
    _build.check(lib, lib.vitok_flash_f32_attributes(F32_KERNELS.index(which), d, out),
                 f"flash fp32 ({which}) attributes")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2], smem_bytes=out[3])


def flash_bwd_attributes(which: str, d: int, fold: bool = False) -> dict:
    """Registers and local memory (spills) a thread, blocks an SM and shared
    memory a block of the dq (``which="dq"``) or dk/dv (``"dkv"``) kernel at
    head dim ``d`` (``fold``: its fold instance), as the compiler and the
    card report them."""
    out = (ctypes.c_int * 4)()
    lib = _bwd_kernel_lib()
    _build.check(lib, lib.vitok_flash_bwd_attributes(("dq", "dkv").index(which), d, int(fold), out),
                 f"flash backward ({which}) attributes")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2], smem_bytes=out[3])


def _kernel_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels can read it: unit channel stride, 16-byte aligned
    base, strides that are multiples of 8. Autograd hands the cotangent over
    in whatever layout the consumer had; a layout the kernels cannot read is
    copied here, explicitly."""
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        t = t.contiguous()
    _check_strides(name, t)
    return t


def _check_row_values(name: str, t: torch.Tensor, shape, dev) -> None:
    if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32 {shape} on {dev}")


def _flash_bwd_inputs(q, k, v, out, lse, grad_out, patch_mask):
    _check_qkv(q, k, v, grad=True)
    b, n, h, d = q.shape
    dev = q.device
    for name, t in (("out", out), ("grad_out", grad_out)):
        if tuple(t.shape) != (b, n, h, d) or t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"{name} must be {q.dtype} {(b, n, h, d)} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    _check_row_values("lse", lse, (b, h, n), dev)
    out = _kernel_layout("out", out)
    grad_out = _kernel_layout("grad_out", grad_out)
    mask, counts = _mask_and_counts(patch_mask, b, n, dev)
    return out, grad_out, mask, counts


def flash_dq_cuda(q, k, v, out, lse, grad_out, patch_mask=None, sliding_window=None):
    """The dq kernel on CUDA tensors: returns dq ``[B, N, H, D]`` and
    ``delta = sum_d dO * O`` (fp32 ``[B, H, N]``, 0 on padded query rows),
    which the kernel forms for its own rows and the dk/dv kernel reads."""
    global DQ_LAUNCHES, DQ_F32_LAUNCHES
    out, grad_out, mask, counts = _flash_bwd_inputs(q, k, v, out, lse, grad_out, patch_mask)
    b, n, h, d = q.shape
    dev = q.device
    sw = -1 if sliding_window is None else int(sliding_window)
    dq = torch.empty((b, n, h, d), dtype=q.dtype, device=dev)
    delta = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    f32 = q.dtype == torch.float32
    lib = _f32_kernel_lib() if f32 else _bwd_kernel_lib()
    entry = lib.vitok_flash_bwd_dq_f32 if f32 else lib.vitok_flash_bwd_dq_bf16
    with torch.cuda.device(dev):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), grad_out.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *grad_out.stride()[:3],
            *out.stride()[:3],
            lse.data_ptr(), _ptr(mask), _ptr(counts), delta.data_ptr(), dq.data_ptr(),
            b, n, h, d, sw, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, "flash_attention dq launch")
    if f32:
        DQ_F32_LAUNCHES += 1
    else:
        DQ_LAUNCHES += 1
    return dq, delta


def flash_dkv_cuda(q, k, v, lse, delta, grad_out, patch_mask=None, sliding_window=None):
    """The dk/dv kernel on CUDA tensors, given the delta of :func:`flash_dq_cuda`."""
    global DKV_LAUNCHES, DKV_F32_LAUNCHES
    _check_qkv(q, k, v, grad=True)
    b, n, h, d = q.shape
    dev = q.device
    if grad_out.dtype != q.dtype:
        raise ValueError(f"grad_out must be {q.dtype}, got {grad_out.dtype}")
    grad_out = _kernel_layout("grad_out", grad_out)
    _check_row_values("lse", lse, (b, h, n), dev)
    _check_row_values("delta", delta, (b, h, n), dev)
    mask, counts = _mask_and_counts(patch_mask, b, n, dev)
    sw = -1 if sliding_window is None else int(sliding_window)
    dk = torch.empty((b, n, h, d), dtype=k.dtype, device=dev)
    dv = torch.empty((b, n, h, d), dtype=v.dtype, device=dev)
    f32 = q.dtype == torch.float32
    lib = _f32_kernel_lib() if f32 else _bwd_kernel_lib()
    entry = lib.vitok_flash_bwd_dkv_f32 if f32 else lib.vitok_flash_bwd_dkv_bf16
    with torch.cuda.device(dev):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), grad_out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *grad_out.stride()[:3],
            lse.data_ptr(), delta.data_ptr(), _ptr(mask), _ptr(counts),
            dk.data_ptr(), dv.data_ptr(),
            b, n, h, d, sw, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, "flash_attention dk/dv launch")
    if f32:
        DKV_F32_LAUNCHES += 1
    else:
        DKV_LAUNCHES += 1
    return dk, dv


def fold_bwd_launch(which: int, qkv, qk, gain, cos, sin, mask, counts, dout, lse, delta, dqkv, part, num_heads,
                    sw, lse_factor: float = LOG2E):
    """One launch of a fold instance, ``which`` 0 dq, 1 dk/dv: bf16 from
    ``csrc/flash_attention_bwd.cu``, fp32 from ``csrc/flash_attention_f32.cu``.
    ``lse_factor`` times the stored lse is the exponent in log2 units:
    ``LOG2E`` for the flash forward's natural-log lse; the fp32 instances
    also take 1, the fp32 fused walker's log2 lse, as the fused backward
    (#3) launches them. Arguments as :func:`flash_dq_fold_cuda` takes them.
    Counts nothing: its callers count."""
    b, n, c3 = qkv.shape
    args = (qkv.data_ptr(), qk.data_ptr(), gain.data_ptr(), cos.data_ptr(), sin.data_ptr(), _ptr(mask),
            _ptr(counts), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), part.data_ptr(),
            b, n, num_heads, c3 // 3 // num_heads, sw, torch.cuda.current_stream(qkv.device).cuda_stream)
    if qkv.dtype == torch.float32:
        lib = _f32_kernel_lib()
        with torch.cuda.device(qkv.device):
            err = lib.vitok_flash_bwd_fold_f32(which, lse_factor, *args)
    else:
        if lse_factor != LOG2E:
            raise ValueError(f"the bf16 fold instances take a natural-log lse, got lse_factor {lse_factor}")
        lib = _bwd_kernel_lib()
        entry = ("vitok_flash_bwd_dq_fold_bf16", "vitok_flash_bwd_dkv_fold_bf16")[which]
        with torch.cuda.device(qkv.device):
            err = getattr(lib, entry)(*args)
    _build.check(lib, err, f"flash_attention {('dq', 'dk/dv')[which]} fold launch ({qkv.dtype})")


def flash_dq_fold_cuda(qkv, qk, q_scale, cos, sin, mask, counts, dout, lse, delta, dqkv, part_q, num_heads, sw):
    """The dq kernel's fold instance (bf16 or fp32, as ``qkv``): from the
    flat ``qkv [B, N, 3C]``, the q/k prologue's ``qk [B, N, 2C]`` and
    ``delta``, the cotangent ``dout [B, N, C]`` (zero on padded rows) and the
    forward's ``lse``, writes dqkv's q plane (the norm and rotation backward
    of dqrot) and the q gain's partials ``part_q [B, H, ceil(N / 64), D]``.
    The caller has checked and laid out every argument
    (``ops.fused_attention``)."""
    global DQ_LAUNCHES, DQ_F32_LAUNCHES
    fold_bwd_launch(0, qkv, qk, q_scale, cos, sin, mask, counts, dout, lse, delta, dqkv, part_q, num_heads, sw)
    if qkv.dtype == torch.float32:
        DQ_F32_LAUNCHES += 1
    else:
        DQ_LAUNCHES += 1


def flash_dkv_fold_cuda(qkv, qk, k_scale, cos, sin, mask, counts, dout, lse, delta, dqkv, part_k, num_heads, sw):
    """The dk/dv kernel's fold instance: as :func:`flash_dq_fold_cuda`, for
    dqkv's k plane (through the norm and rotation backward), its v plane and
    the k gain's partials."""
    global DKV_LAUNCHES, DKV_F32_LAUNCHES
    fold_bwd_launch(1, qkv, qk, k_scale, cos, sin, mask, counts, dout, lse, delta, dqkv, part_k, num_heads, sw)
    if qkv.dtype == torch.float32:
        DKV_F32_LAUNCHES += 1
    else:
        DKV_LAUNCHES += 1


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    grad_out: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`flash_attention`: ``(dq, dk, dv)`` from the inputs,
    the forward's output and log-sum-exp, and the output's cotangent.

    On CUDA tensors (bf16 at head dim 64, 128, 192 or 256, or fp32 at 64 or
    128) the dq and dk/dv kernels; on CPU tensors
    :func:`flash_attention_bwd_plain`.
    """
    if q.is_cuda:
        dq, delta = flash_dq_cuda(q, k, v, out, lse, grad_out, patch_mask, sliding_window)
        dk, dv = flash_dkv_cuda(q, k, v, lse, delta, grad_out, patch_mask, sliding_window)
        return dq, dk, dv
    if q.device.type != "cpu":
        raise RuntimeError(f"no flash attention kernel for device {q.device}")
    return flash_attention_bwd_plain(q, k, v, out, lse, grad_out, patch_mask, sliding_window)


def _flash_forward(q, k, v, patch_mask, sliding_window, return_lse, grad=False):
    """The kernel, or its plain version on a CPU tensor; ``grad``: the
    backward follows, so a head dim it has no instance for raises first."""
    if q.is_cuda:
        if grad:
            check_head_dim(q.shape[-1], kernel_head_dims(q.dtype, True), "the flash CUDA kernels' backward")
        return _flash_cuda(q, k, v, patch_mask, sliding_window, return_lse)
    if q.device.type != "cpu":
        raise RuntimeError(f"no flash attention kernel for device {q.device}")
    return flash_attention_plain(q, k, v, patch_mask, sliding_window, return_lse)


class _FlashAttention(torch.autograd.Function):
    """Forward saves q, k, v, the output and the log-sum-exp; backward calls
    :func:`flash_attention_bwd` (looked up at call time)."""

    @staticmethod
    def forward(ctx, q, k, v, patch_mask, sliding_window):
        out, lse = _flash_forward(q, k, v, patch_mask, sliding_window, True, grad=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.patch_mask = patch_mask
        ctx.sliding_window = sliding_window
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, grad_out, _grad_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, grad_out, ctx.patch_mask, ctx.sliding_window)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Flash attention over NaFlex token sequences.

    Differentiable in q, k and v: when grad is enabled and one of them
    requires it, the call goes through an autograd Function whose backward
    is :func:`flash_attention_bwd`, on both devices.

    Args:
        q, k, v: ``[B, N, H, D]``. On the card: bf16 or fp32 (head dim
            64, 128, 192 or 256, under autograd too), unit channel stride (v
            may be a strided view, e.g. into the flat QKV output).
        patch_mask: optional ``[B, N]`` bool, True = valid token.
        sliding_window: optional half-width; query i sees keys ``|i-j| <= sw``.
        return_lse: also return the fp32 log-sum-exp ``[B, H, N]``.

    Returns:
        ``[B, N, H, D]`` in v's dtype (padded query rows 0), and the LSE
        with ``return_lse``.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out, lse = _FlashAttention.apply(q, k, v, patch_mask, sliding_window)
        return (out, lse) if return_lse else out
    return _flash_forward(q, k, v, patch_mask, sliding_window, return_lse)


__all__ = [
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "key_counts",
]
