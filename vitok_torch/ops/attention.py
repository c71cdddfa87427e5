"""Multi-head attention for NaFlex patch sequences (``vitok_tpu/ops/attention.py``).

Layout ``[B, N, H, D]``. One interface takes the patch mask and a sliding
window together. Routing follows the JAX package: the flash kernel
(``ops/flash_attention.py``) serves ``N >= FLASH_MIN_TOKENS`` at head dims
that are a multiple of 64; below that, and at other head dims, the unfused
composition here runs. On a CUDA tensor the head dim must also be one at
which every kernel the call runs has an instance (``kernel_head_dims``): 64,
128, 192 or 256, in bf16 and fp32, forward and backward. Elsewhere the
unfused composition runs there, the same function.
"""

from __future__ import annotations

from typing import Optional

import torch

from vitok_torch.ops.flash_attention import flash_attention, kernel_head_dims

FLASH_MIN_TOKENS = 2048


def head_dim_routes(d: int, cuda: bool, dtype: torch.dtype = torch.bfloat16, grad: bool = False) -> bool:
    """Whether a kernel's gate opens at head dim ``d``: the JAX package's
    multiple of 64, and on a CUDA tensor (``cuda``) a head dim at which the
    kernels of a call in ``dtype`` have instances (``kernel_head_dims``;
    ``grad``: a gradient is asked for, so the backward's too)."""
    return d % 64 == 0 and (not cuda or d in kernel_head_dims(dtype, grad))


def flash_route(n: int, d: int, impl: str, cuda: bool, dtype: torch.dtype = torch.bfloat16,
                grad: bool = False) -> bool:
    """Whether :func:`dot_product_attention` takes the flash kernel for
    ``N = n`` tokens of head dim ``d``: ``"flash"`` always, ``"auto"`` from
    ``FLASH_MIN_TOKENS`` tokens where :func:`head_dim_routes` opens."""
    return impl == "flash" or (impl == "auto" and n >= FLASH_MIN_TOKENS and head_dim_routes(d, cuda, dtype, grad))


def make_attention_mask(
    patch_mask: Optional[torch.Tensor],
    n: int,
    sliding_window: Optional[int] = None,
    device=None,
) -> Optional[torch.Tensor]:
    """Boolean ``[B, 1, N, N]`` (or ``[1, 1, N, N]``) mask, True = attend.

    Pairwise patch validity (two-sided) combined with an optional window
    ``|i - j| <= sliding_window`` over flattened token order.
    """
    mask = None
    if patch_mask is not None:
        pm = patch_mask.bool()
        mask = (pm[:, :, None] & pm[:, None, :])[:, None]
    if sliding_window is not None:
        if patch_mask is not None:
            device = patch_mask.device
        idx = torch.arange(n, device=device)
        window = ((idx[:, None] - idx[None, :]).abs() <= sliding_window)[None, None]
        mask = window if mask is None else (mask & window)
    return mask


def _xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """Unfused attention with fp32 logits and softmax, -1e30 fill.

    q, k, v: ``[B, N, H, D]``; mask: ``[B|1, 1, N, N]`` bool (True = attend).
    The products run on float32 copies of the inputs, which is exact for
    bf16 operands and matches an fp32-accumulating bf16 matmul.
    """
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / d ** 0.5)
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Masked, optionally sliding-window, multi-head attention.

    Args:
        q, k, v: ``[B, N, H, D]``.
        patch_mask: optional ``[B, N]`` bool, True = valid token.
        sliding_window: optional half-width; query i sees keys ``|i-j| <= sw``.
        impl: ``"auto"``, ``"flash"`` (the flash kernel at any N: the JAX
            package's ``"pallas"``), ``"xla"`` (the unfused composition,
            named as in the JAX package) or ``"halo:<axis>"`` (a token shard
            of a sequence-parallel forward: ``vitok_torch.parallel.sequence``'s
            halo attention over the process group registered for ``axis``).

    Returns:
        ``[B, N, H, D]`` in the dtype of ``v``.
    """
    n, d = q.shape[1], q.shape[-1]
    if impl.startswith("halo:"):
        from vitok_torch.parallel.sequence import halo_attention

        if sliding_window is None:
            raise ValueError("halo attention requires a sliding window")
        return halo_attention(q, k, v, patch_mask, sliding_window, axis=impl.split(":", 1)[1])
    if impl not in ("auto", "flash", "xla"):
        raise ValueError(f"Unknown attention impl: {impl!r}. Use 'auto', 'flash', 'xla' or 'halo:<axis>'.")
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if flash_route(n, d, impl, q.is_cuda, q.dtype, grad):
        return flash_attention(q, k, v, patch_mask=patch_mask, sliding_window=sliding_window)
    return _xla_attention(q, k, v, make_attention_mask(patch_mask, n, sliding_window, q.device))


__all__ = ["dot_product_attention", "make_attention_mask", "flash_route", "head_dim_routes", "FLASH_MIN_TOKENS"]
