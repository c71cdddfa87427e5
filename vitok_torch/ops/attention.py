"""Multi-head attention for NaFlex patch sequences (``vitok_tpu/ops/attention.py``).

Layout ``[B, N, H, D]``. One interface takes the patch mask and a sliding
window together. Routing follows the JAX package: its flash kernel serves
``N >= 2048``; below that the unfused composition here runs. The flash
kernel has no Hopper port yet, so a CUDA tensor at ``N >= 2048`` raises
rather than falling back to the ``[B, H, N, N]`` composition in silence.
"""

from __future__ import annotations

from typing import Optional

import torch

FLASH_MIN_TOKENS = 2048


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
        impl: ``"auto"`` or ``"xla"`` (the unfused composition, named as in
            the JAX package).

    Returns:
        ``[B, N, H, D]`` in the dtype of ``v``.
    """
    n, d = q.shape[1], q.shape[-1]
    if impl not in ("auto", "xla"):
        raise ValueError(f"Unknown attention impl: {impl!r}. Use 'auto' or 'xla'.")
    if impl == "auto" and q.is_cuda and n >= FLASH_MIN_TOKENS and d % 64 == 0:
        raise NotImplementedError(
            f"attention at N={n} >= {FLASH_MIN_TOKENS} tokens needs the flash forward "
            "kernel (vitok_tpu/ops/flash_attention.py::_attn_kernel), which has no "
            "Hopper port yet: see ROADMAP.md Queue 2, 'flash forward'. "
            "Pass impl='xla' to run the unfused composition explicitly."
        )
    return _xla_attention(q, k, v, make_attention_mask(patch_mask, n, sliding_window, q.device))


__all__ = ["dot_product_attention", "make_attention_mask", "FLASH_MIN_TOKENS"]
