"""Compute primitives: plain tensor functions and the Hopper kernels' wrappers."""

from vitok_torch.ops.attention import dot_product_attention, make_attention_mask
from vitok_torch.ops.mlp import round_hidden_dim, swiglu
from vitok_torch.ops.norms import layer_norm, layer_scale, rms_norm
from vitok_torch.ops.rope import (
    apply_rotary_emb,
    compute_2d_freqs_cis,
    compute_inv_freq,
    rope_half_permutation,
)

__all__ = [
    "compute_inv_freq",
    "compute_2d_freqs_cis",
    "apply_rotary_emb",
    "rope_half_permutation",
    "rms_norm",
    "layer_norm",
    "layer_scale",
    "swiglu",
    "round_hidden_dim",
    "dot_product_attention",
    "make_attention_mask",
]
