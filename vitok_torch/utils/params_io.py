"""Checkpoint interchange into the port's ``AE`` state dict.

Two sources:

* the JAX package's stacked params pytree (numpy arrays, depth leading,
  Linear kernels ``[in, out]``, q/k channels already in rotate-half order):
  :func:`from_jax_params` unstacks and transposes to ``nn.Linear``'s
  ``[out, in]``; a quantized pytree's int8 block kernels stay int8;
* released flat checkpoints (``encoder_blocks.N.attn.qkv_proj.weight`` ...,
  q/k channels in the interleaved RoPE order): :func:`released_state_to_module_state`
  permutes the q/k projection rows and QK-norm gains to rotate-half order,
  as ``vitok_tpu/utils/params_io.py::torch_state_to_pytree`` does.

The module's state dict uses the released names, so nothing else is renamed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from vitok_torch.ops.rope import rope_half_permutation

# (flat suffix, pytree path within a block, transpose?)
_BLOCK_ENTRIES = [
    ("norm1.weight", ("norm1", "scale"), False),
    ("attn.qkv_proj.weight", ("attn", "qkv", "kernel"), True),
    ("attn.out_proj.weight", ("attn", "out", "kernel"), True),
    ("attn.norm_q.weight", ("attn", "norm_q", "scale"), False),
    ("attn.norm_k.weight", ("attn", "norm_k", "scale"), False),
    ("ffn.fc1.weight", ("ffn", "fc1", "kernel"), True),
    ("ffn.fc2.weight", ("ffn", "fc2", "kernel"), True),
    ("layer_scale.gamma", ("layer_scale", "gamma"), False),
]
# A quantized block linear (``quantize_block_params``): ``kernel_int8
# [depth, in, out]`` becomes ``weight_int8 [out, in]`` (int8), ``scale
# [depth, out]`` the fp32 ``scale``.
_INT8_ENTRIES = [
    (suffix[: -len("weight")], path[:-1]) for suffix, path, transpose in _BLOCK_ENTRIES if transpose
]
_TOP_LINEAR = ("patch_embed", "to_code", "decoder_embed", "to_pixels")
_STACKS = ("encoder_blocks", "decoder_blocks")


def _tensor(a, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype))  # a writable, contiguous copy


def _node(tree, path):
    for p in path:
        tree = tree.get(p) if isinstance(tree, Mapping) else None
        if tree is None:
            return None
    return tree


def from_jax_params(params: Mapping[str, Any], cfg=None) -> Dict[str, torch.Tensor]:
    """JAX params pytree (numpy leaves) -> ``AE`` state dict (CPU tensors:
    fp32, and int8 for the block kernels of a quantized pytree).

    ``cfg`` (an ``AEConfig``), when given, checks the stacked depths.
    """
    state: Dict[str, torch.Tensor] = {}
    for name in _TOP_LINEAR:
        if name in params:
            state[f"{name}.weight"] = _tensor(np.asarray(params[name]["kernel"]).T)
            if "bias" in params[name]:
                state[f"{name}.bias"] = _tensor(params[name]["bias"])
    for stack_name in _STACKS:
        if stack_name not in params:
            continue
        stack = params[stack_name]
        depth = None
        for suffix, path, transpose in _BLOCK_ENTRIES:
            node = _node(stack, path)
            if node is None:
                continue  # e.g. no layer_scale, or an int8 linear
            arr = np.asarray(node)
            depth = arr.shape[0]
            for i in range(depth):
                state[f"{stack_name}.{i}.{suffix}"] = _tensor(arr[i].T if transpose else arr[i])
        for prefix, path in _INT8_ENTRIES:
            node = _node(stack, path)
            if node is None or "kernel_int8" not in node:
                continue
            q, scale = np.asarray(node["kernel_int8"]), np.asarray(node["scale"])
            depth = q.shape[0]
            for i in range(depth):
                state[f"{stack_name}.{i}.{prefix}weight_int8"] = _tensor(q[i].T, np.int8)
                state[f"{stack_name}.{i}.{prefix}scale"] = _tensor(scale[i])
        if cfg is not None and depth is not None:
            expected = cfg.encoder_depth if stack_name == "encoder_blocks" else cfg.decoder_depth
            if depth != expected:
                raise ValueError(f"{stack_name}: params depth {depth} != config {expected}")
    if not state:
        raise ValueError("No recognizable ViTok params found")
    return state


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.asarray(v)


def released_state_to_module_state(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Released flat state dict (interleaved q/k order) -> ``AE`` state dict.

    Permutes the q and k output rows of every ``attn.qkv_proj.weight``
    (``[3W, W]``) and the ``norm_q``/``norm_k`` gains to rotate-half order.
    A ``_orig_mod.`` prefix (``torch.compile``) is stripped.
    """
    out: Dict[str, torch.Tensor] = {}
    for key, v in state.items():
        key = key[len("_orig_mod."):] if key.startswith("_orig_mod.") else key
        arr = _to_numpy(v).astype(np.float32)
        if key.endswith(("attn.norm_q.weight", "attn.norm_k.weight")):
            arr = arr[rope_half_permutation(arr.shape[-1])]
        out[key] = arr
    for key in list(out):
        if key.endswith("attn.qkv_proj.weight"):
            head_dim = out[key.replace("qkv_proj", "norm_q")].shape[-1]
            w = out[key]
            three_w, fan_in = w.shape
            a = w.reshape(3, three_w // 3 // head_dim, head_dim, fan_in).copy()
            a[:2] = a[:2][:, :, rope_half_permutation(head_dim)]
            out[key] = a.reshape(three_w, fan_in)
    return {k: _tensor(v) for k, v in out.items()}


__all__ = ["from_jax_params", "released_state_to_module_state"]
