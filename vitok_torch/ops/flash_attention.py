"""Flash attention forward over NaFlex token sequences.

Port of the forward of ``vitok_tpu/ops/flash_attention.py`` (``_attn_kernel``,
its launcher ``_flash_fwd`` and the public ``flash_attention``). Layout
``[B, N, H, D]`` in and out. On a CUDA tensor :func:`flash_attention`
launches the hand-written Hopper kernel in
``vitok_torch/csrc/flash_attention.cu``; on a CPU tensor it runs
:func:`flash_attention_plain`, the same function in plain PyTorch. The CUDA
path never falls back.

Semantics, as the TPU kernel has them: the patch mask is applied key-side
and padded query rows are zeroed; a row with no live key (no valid key
inside its window) gives 0; the optional log-sum-exp is ``m + log(l)``, or
+1e30 for such a row. The backward (``_dq_kernel``/``_dkv_kernel``) waits for
the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from vitok_torch.ops import _build

KERNEL_HEAD_DIMS = (64, 128)
_NEG_FILL = -1e30
_DEAD_LSE = 1e30
_DEFAULT_BLOCK_K = 512  # the TPU kernel's key block, which sets where p is rounded
_PLAIN_BLOCK_Q = 1024   # query rows per step of the plain version (memory only)

# Launches of the CUDA kernel since the count was last set to 0.
LAUNCHES = 0


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


def _check_strides(name: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} needs a contiguous last dim, got strides {t.stride()}")
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"flash_attention: {name} needs a 16-byte aligned base and strides that "
                         f"are multiples of 8 elements, got strides {t.stride()}")


def _flash_cuda(q, k, v, patch_mask, sliding_window, return_lse):
    global LAUNCHES
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, N, H, D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, n, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash CUDA kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(
            f"the flash CUDA kernel takes bfloat16 q, k, v, got {q.dtype}, {k.dtype}, {v.dtype} "
            "(fp32 has no kernel instance yet: ROADMAP.md Queue 3)"
        )
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("q, k, v must lie on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_strides(name, t)
    mask = counts = None
    if patch_mask is not None:
        if patch_mask.device != dev or tuple(patch_mask.shape) != (b, n):
            raise ValueError(f"patch_mask must be {(b, n)} on {dev}")
        mask = patch_mask.bool().contiguous()
        counts = key_counts(mask)
    sw = -1 if sliding_window is None else int(sliding_window)
    out = torch.empty((b, n, h, d), dtype=v.dtype, device=dev)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=dev) if return_lse else None

    lib = _kernel_lib()
    with torch.cuda.device(dev):  # the C entry launches on the current device
        err = lib.vitok_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            mask.data_ptr() if mask is not None else None,
            counts.data_ptr() if counts is not None else None,
            out.data_ptr(), lse.data_ptr() if lse is not None else None,
            b, n, h, d, sw, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, "flash_attention launch")
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.vitok_flash_attention_bf16
    if fn.argtypes is None:
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr] * 3 + [ll] * 9 + [ptr] * 4 + [i] * 5 + [ptr]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Flash attention over NaFlex token sequences.

    Args:
        q, k, v: ``[B, N, H, D]``. On the card: bf16, head dim 64 or 128,
            unit channel stride (v may be a strided view, e.g. into the flat
            QKV output).
        patch_mask: optional ``[B, N]`` bool, True = valid token.
        sliding_window: optional half-width; query i sees keys ``|i-j| <= sw``.
        return_lse: also return the fp32 log-sum-exp ``[B, H, N]``.

    Returns:
        ``[B, N, H, D]`` in v's dtype (padded query rows 0), and the LSE
        with ``return_lse``.
    """
    if q.is_cuda:
        return _flash_cuda(q, k, v, patch_mask, sliding_window, return_lse)
    if q.device.type != "cpu":
        raise RuntimeError(f"no flash attention kernel for device {q.device}")
    return flash_attention_plain(q, k, v, patch_mask, sliding_window, return_lse)


__all__ = ["flash_attention", "flash_attention_plain", "key_counts"]
