"""SwiGLU MLP as a plain tensor function (``vitok_tpu/ops/mlp.py``).

``fc1`` projects to ``2 * hidden``: the first half is the value ``v``, the
second the gate ``g``; the output is ``fc2(silu(g) * v)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def round_hidden_dim(hidden_dim: int) -> int:
    """Nearest multiple of 16, ties upward."""
    return ((hidden_dim + 8) // 16) * 16


def swiglu(x: torch.Tensor, fc1_weight: torch.Tensor, fc2_weight: torch.Tensor) -> torch.Tensor:
    """Apply the SwiGLU MLP.

    Args:
        x: ``[..., D]``.
        fc1_weight: ``[2H, D]`` (``nn.Linear`` layout, the transpose of the
            JAX package's ``[D, 2H]`` kernel).
        fc2_weight: ``[D, H]``.
    """
    v, g = F.linear(x, fc1_weight.to(x.dtype)).chunk(2, -1)
    return F.linear(F.silu(g) * v, fc2_weight.to(x.dtype))


__all__ = ["swiglu", "round_hidden_dim"]
