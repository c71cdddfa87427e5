"""Checkpoint interchange into and out of the port's ``AE`` and ``DiT`` state
dicts.

Two sources, each with its way back (:func:`to_jax_params`,
:func:`module_state_to_released_state`):

* the JAX package's stacked params pytree (numpy arrays, depth leading,
  Linear kernels ``[in, out]``, q/k channels already in rotate-half order):
  :func:`from_jax_params` unstacks and transposes to ``nn.Linear``'s
  ``[out, in]``; a quantized pytree's int8 block kernels stay int8;
* released flat checkpoints (``encoder_blocks.N.attn.qkv_proj.weight`` ...,
  q/k channels in the interleaved RoPE order): :func:`released_state_to_module_state`
  permutes the q/k projection rows and QK-norm gains to rotate-half order,
  as ``vitok_tpu/utils/params_io.py::torch_state_to_pytree`` does.

The module's state dict uses the released names, so nothing else is renamed.

A DiT's pytree (:func:`dit_from_jax_params`, :func:`dit_to_jax_params`) has
the same block entries plus the adaLN ``mod`` linear with its bias; both
packages keep a DiT's q/k channels in rotate-half order, so nothing is
permuted. Int8 pytrees go both ways.

The eval backbones' pytrees go one way, into the port's modules:
:func:`inception_from_jax_params` (the BN-folded FID InceptionV3, HWIO
kernels) and :func:`vit_from_jax_params` (the DINO ViT, stacked depth-leading,
to timm's flat names).
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
# A DiT block adds the adaLN modulation linear (with a bias).
_DIT_BLOCK_ENTRIES = _BLOCK_ENTRIES + [
    ("mod.weight", ("mod", "kernel"), True),
    ("mod.bias", ("mod", "bias"), False),
]
# DiT linears outside the blocks: (module path, pytree path).
_DIT_LINEARS = [
    ("input_proj", ("input_proj",)),
    ("t_embed.fc1", ("t_embed", "fc1")),
    ("t_embed.fc2", ("t_embed", "fc2")),
    ("final.mod", ("final", "mod")),
    ("final.proj", ("final", "proj")),
]
_DIT_TENSORS = ("ctx_embed", "cls_token", "reg_token")


def _tensor(a, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype))  # a writable, contiguous copy


def _node(tree, path):
    for p in path:
        tree = tree.get(p) if isinstance(tree, Mapping) else None
        if tree is None:
            return None
    return tree


def _stack_to_state(stack, stack_name: str, state: Dict[str, torch.Tensor], entries):
    """Unstack one depth-leading block stack into ``state``; returns its depth."""
    depth = None
    for suffix, path, transpose in entries:
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
    return depth


def _state_to_stack(state: Mapping[str, Any], stack_name: str, entries) -> Dict[str, Any]:
    """Stack the blocks of ``stack_name`` depth-leading; {} if there are none."""
    depth = 1 + max((int(k.split(".")[1]) for k in state if k.startswith(stack_name + ".")), default=-1)
    stack: Dict[str, Any] = {}
    if depth == 0:
        return stack

    def put(path, value):
        node = stack
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    for suffix, path, transpose in entries:
        if f"{stack_name}.0.{suffix}" not in state:
            continue
        layers = [_to_numpy(state[f"{stack_name}.{i}.{suffix}"]) for i in range(depth)]
        put(path, np.stack([a.T if transpose else a for a in layers]))
    for prefix, path in _INT8_ENTRIES:
        if f"{stack_name}.0.{prefix}weight_int8" not in state:
            continue
        codes = [state[f"{stack_name}.{i}.{prefix}weight_int8"] for i in range(depth)]
        put(path + ("kernel_int8",), np.stack([np.asarray(c.detach().cpu().numpy()).T for c in codes]))
        put(path + ("scale",), np.stack([_to_numpy(state[f"{stack_name}.{i}.{prefix}scale"])
                                         for i in range(depth)]))
    return stack


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
        depth = _stack_to_state(params[stack_name], stack_name, state, _BLOCK_ENTRIES)
        if cfg is not None and depth is not None:
            expected = cfg.encoder_depth if stack_name == "encoder_blocks" else cfg.decoder_depth
            if depth != expected:
                raise ValueError(f"{stack_name}: params depth {depth} != config {expected}")
    if not state:
        raise ValueError("No recognizable ViTok params found")
    return state


def to_jax_params(state: Mapping[str, Any]) -> Dict[str, Any]:
    """``AE`` state dict -> the JAX package's stacked params pytree of numpy
    arrays (fp32; int8 block kernels stay int8): the inverse of
    :func:`from_jax_params`, so trained weights go back. Optimizer state is
    not carried across."""
    params: Dict[str, Any] = {}
    for name in _TOP_LINEAR:
        if f"{name}.weight" in state:
            params[name] = {"kernel": np.ascontiguousarray(_to_numpy(state[f"{name}.weight"]).T)}
            if f"{name}.bias" in state:
                params[name]["bias"] = _to_numpy(state[f"{name}.bias"])
    for stack_name in _STACKS:
        stack = _state_to_stack(state, stack_name, _BLOCK_ENTRIES)
        if stack:
            params[stack_name] = stack
    if not params:
        raise ValueError("No recognizable ViTok params found")
    return params


def dit_from_jax_params(params: Mapping[str, Any], cfg=None) -> Dict[str, torch.Tensor]:
    """The JAX package's DiT params pytree (numpy leaves; ``blocks`` stacked
    depth-leading, Linear kernels ``[in, out]``) -> ``DiT`` state dict (CPU
    tensors). ``cfg`` (a ``DiTConfig``), when given, checks the depth."""
    if "blocks" not in params or "input_proj" not in params:
        raise ValueError("No recognizable DiT params found")
    state: Dict[str, torch.Tensor] = {}
    for name, path in _DIT_LINEARS:
        node = _node(params, path)
        state[f"{name}.weight"] = _tensor(np.asarray(node["kernel"]).T)
        state[f"{name}.bias"] = _tensor(node["bias"])
    for name in _DIT_TENSORS:
        if name in params:
            state[name] = _tensor(params[name])
    depth = _stack_to_state(params["blocks"], "blocks", state, _DIT_BLOCK_ENTRIES)
    if cfg is not None and depth != cfg.depth:
        raise ValueError(f"blocks: params depth {depth} != config {cfg.depth}")
    return state


def dit_to_jax_params(state: Mapping[str, Any]) -> Dict[str, Any]:
    """``DiT`` state dict -> the JAX package's DiT params pytree of numpy
    arrays: the inverse of :func:`dit_from_jax_params`."""
    if "input_proj.weight" not in state:
        raise ValueError("No recognizable DiT params found")
    params: Dict[str, Any] = {}
    for name, path in _DIT_LINEARS:
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = {
            "kernel": np.ascontiguousarray(_to_numpy(state[f"{name}.weight"]).T),
            "bias": _to_numpy(state[f"{name}.bias"]),
        }
    for name in _DIT_TENSORS:
        if name in state:
            params[name] = _to_numpy(state[name])
    params["blocks"] = _state_to_stack(state, "blocks", _DIT_BLOCK_ENTRIES)
    return params


def inception_from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's folded FID-Inception pytree (``{conv: {"w": HWIO,
    "b": [O]}}``, numpy leaves) -> ``InceptionV3`` state dict (OIHW, fp32)."""
    state: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        state[f"{name}.weight"] = _tensor(np.asarray(node["w"]).transpose(3, 2, 0, 1))
        state[f"{name}.bias"] = _tensor(node["b"])
    return state


# (timm suffix in block i, pytree path under "blocks", transpose?)
_VIT_BLOCK_ENTRIES = [
    ("norm1.weight", ("norm1", "scale"), False),
    ("norm1.bias", ("norm1", "bias"), False),
    ("attn.qkv.weight", ("qkv", "kernel"), True),
    ("attn.qkv.bias", ("qkv", "bias"), False),
    ("attn.proj.weight", ("proj", "kernel"), True),
    ("attn.proj.bias", ("proj", "bias"), False),
    ("norm2.weight", ("norm2", "scale"), False),
    ("norm2.bias", ("norm2", "bias"), False),
    ("mlp.fc1.weight", ("fc1", "kernel"), True),
    ("mlp.fc1.bias", ("fc1", "bias"), False),
    ("mlp.fc2.weight", ("fc2", "kernel"), True),
    ("mlp.fc2.bias", ("fc2", "bias"), False),
]


def vit_from_jax_params(params: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The JAX package's DINO ViT pytree (numpy leaves, ``blocks`` stacked
    depth-leading, kernels ``[in, out]``) -> ``DinoViT`` state dict under
    timm's flat names: the inverse of the JAX ``torch_vit_state_to_pytree``.
    ``cfg`` (a ``ViTCfg``) gives the width and patch of the patch embed and
    checks the depth."""
    pe_kernel = np.asarray(params["patch_embed"]["kernel"])  # [3 * P * P, D], (c, ph, pw) order
    state = {
        "patch_embed.proj.weight": _tensor(pe_kernel.T.reshape(cfg.width, 3, cfg.patch, cfg.patch)),
        "patch_embed.proj.bias": _tensor(params["patch_embed"]["bias"]),
        "cls_token": _tensor(params["cls_token"]),
        "pos_embed": _tensor(params["pos_embed"]),
        "norm.weight": _tensor(params["norm"]["scale"]),
        "norm.bias": _tensor(params["norm"]["bias"]),
    }
    for suffix, path, transpose in _VIT_BLOCK_ENTRIES:
        arr = np.asarray(_node(params["blocks"], path))
        if arr.shape[0] != cfg.depth:
            raise ValueError(f"blocks.{'.'.join(path)}: params depth {arr.shape[0]} != config {cfg.depth}")
        for i in range(cfg.depth):
            state[f"blocks.{i}.{suffix}"] = _tensor(arr[i].T if transpose else arr[i])
    return state


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.asarray(v)


def _permute_qk(state: Mapping[str, Any], inverse: bool) -> Dict[str, torch.Tensor]:
    """Reorder the q and k output rows of every ``attn.qkv_proj.weight``
    (``[3W, W]``) and the ``norm_q``/``norm_k`` gains between the released
    interleaved RoPE order and rotate-half order (``inverse``: back)."""
    out: Dict[str, np.ndarray] = {}
    for key, v in state.items():
        key = key[len("_orig_mod."):] if key.startswith("_orig_mod.") else key
        out[key] = _to_numpy(v).astype(np.float32)
    perm = lambda d: np.argsort(rope_half_permutation(d)) if inverse else rope_half_permutation(d)
    for key in list(out):
        if key.endswith(("attn.norm_q.weight", "attn.norm_k.weight")):
            out[key] = out[key][perm(out[key].shape[-1])]
        elif key.endswith("attn.qkv_proj.weight"):
            head_dim = out[key.replace("qkv_proj", "norm_q")].shape[-1]
            w = out[key]
            three_w, fan_in = w.shape
            a = w.reshape(3, three_w // 3 // head_dim, head_dim, fan_in).copy()
            a[:2] = a[:2][:, :, perm(head_dim)]
            out[key] = a.reshape(three_w, fan_in)
    return {k: _tensor(v) for k, v in out.items()}


def released_state_to_module_state(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Released flat state dict (interleaved q/k order) -> ``AE`` state dict
    (rotate-half order). A ``_orig_mod.`` prefix (``torch.compile``) is
    stripped."""
    return _permute_qk(state, inverse=False)


def module_state_to_released_state(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``AE`` state dict (full precision) -> released flat layout, fp32: the
    inverse of :func:`released_state_to_module_state`."""
    if any(k.endswith("weight_int8") for k in state):
        raise ValueError("an int8 state dict has no released layout: export the full-precision weights")
    return _permute_qk(state, inverse=True)


_HALVES = {"encoder": ("patch_embed", "to_code", "encoder_blocks"),
           "decoder": ("decoder_embed", "to_pixels", "decoder_blocks")}


def load_safetensors_params(paths, cfg=None) -> Dict[str, torch.Tensor]:
    """``AE`` state dict from released-layout safetensors: one file (a full
    model) or a mapping like ``{"encoder": path, "decoder": path}`` (the
    released split artifacts). ``cfg`` (an ``AEConfig``), when given,
    checks that the files hold its block stacks at its depths."""
    from safetensors.torch import load_file

    flat: Dict[str, torch.Tensor] = {}
    for path in ([paths] if isinstance(paths, str) else list(paths.values())):
        flat.update(load_file(path))
    state = released_state_to_module_state(flat)
    if cfg is not None:
        for stack, depth, present in (("encoder_blocks", cfg.encoder_depth, cfg.encoder),
                                      ("decoder_blocks", cfg.decoder_depth, cfg.decoder)):
            got = 1 + max((int(k.split(".")[1]) for k in state if k.startswith(stack + ".")), default=-1)
            if present and got != depth:
                raise ValueError(f"{stack}: the files hold {got} blocks, the config {depth}")
    return state


def save_safetensors_params(state: Mapping[str, Any], path: str, component=None) -> None:
    """Write an ``AE`` state dict (full precision) to one safetensors file
    in the released flat layout (fp32). ``component`` of ``"encoder"`` or
    ``"decoder"`` keeps that half only (the released split artifacts)."""
    from safetensors.torch import save_file

    flat = module_state_to_released_state(state)
    if component in _HALVES:
        flat = {k: v for k, v in flat.items() if k.startswith(_HALVES[component])}
    save_file({k: v.contiguous() for k, v in flat.items()}, path)


__all__ = [
    "load_safetensors_params",
    "save_safetensors_params",
    "from_jax_params",
    "to_jax_params",
    "dit_from_jax_params",
    "dit_to_jax_params",
    "inception_from_jax_params",
    "vit_from_jax_params",
    "released_state_to_module_state",
    "module_state_to_released_state",
]
