"""Pretrained model registry and local loading (port of ``vitok_tpu/pretrained.py``).

The same 9 released models (name -> hub repo, split encoder/decoder
safetensors, variant string). Weights are read only from a local directory
laid out as ``$VITOK_PRETRAINED_DIR/{name}/encoder.safetensors`` and
``decoder.safetensors``; nothing is downloaded.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from vitok_torch.models.ae import AEConfig
from vitok_torch.utils.params_io import released_state_to_module_state

_FILES = ["encoder.safetensors", "decoder.safetensors"]
_MODELS: Dict[str, Tuple[str, list, str]] = {
    "350M-f16x16": ("philippehansen/ViTok-v2-350M-f16x16", _FILES, "Ld4-Ld24/1x16x16"),
    "350M-f16x32": ("philippehansen/ViTok-v2-350M-f16x32", _FILES, "Ld4-Ld24/1x16x32"),
    "350M-f16x64": ("philippehansen/ViTok-v2-350M-f16x64", _FILES, "Ld4-Ld24/1x16x64"),
    "5B-f16x16": ("philippehansen/ViTok-v2-5B-f16x16", _FILES, "Td4-T/1x16x16"),
    "5B-f16x32": ("philippehansen/ViTok-v2-5B-f16x32", _FILES, "Td4-T/1x16x32"),
    "5B-f16x64": ("philippehansen/ViTok-v2-5B-f16x64", _FILES, "Td4-T/1x16x64"),
    "5B-f32x64": ("philippehansen/ViTok-v2-5B-f32x64", _FILES, "Td4-T/1x32x64"),
    "5B-f32x128": ("philippehansen/ViTok-v2-5B-f32x128", _FILES, "Td4-T/1x32x128"),
    "5B-f32x256": ("philippehansen/ViTok-v2-5B-f32x256", _FILES, "Td4-T/1x32x256"),
}


def list_pretrained() -> list:
    return list(_MODELS)


def get_pretrained_info(name: str) -> Tuple[str, list, str]:
    if name not in _MODELS:
        raise KeyError(f"Unknown model: {name}. Available: {list(_MODELS)}")
    return _MODELS[name]


def _local_file(name: str, filename: str) -> str:
    root = os.environ.get("VITOK_PRETRAINED_DIR")
    if not root:
        raise FileNotFoundError(
            f"weights for {name} are read from $VITOK_PRETRAINED_DIR/{name}/{filename}; "
            "VITOK_PRETRAINED_DIR is not set (this package does not download)"
        )
    path = os.path.join(root, name, filename)
    if not os.path.exists(path):
        raise FileNotFoundError(f"weights for {name} not found: {path}")
    return path


def load_pretrained_params(
    name: str, component: Optional[str] = None
) -> Tuple[AEConfig, Dict[str, torch.Tensor]]:
    """Load a released model as ``(AEConfig, AE state dict)``.

    ``component`` of ``"encoder"`` or ``"decoder"`` loads that half only.
    Build the model with ``AE(state_dict=sd, **dataclasses.asdict(cfg))``.

    The released weights are fp32. For int8 serving, quantize this fp32
    state dict (``vitok_torch.ops.quant.quantize_state_dict``) before building
    a bf16 model from it: its codes are then those of the JAX package's
    ``quantize_block_params``. ``AE.quantize()`` on a bf16-held model
    quantizes the bf16-rounded weights, which may differ by one code step.
    """
    from safetensors.torch import load_file

    _, filenames, variant = get_pretrained_info(name)
    cfg = AEConfig.from_variant(
        variant, encoder=component != "decoder", decoder=component != "encoder"
    )
    flat: Dict[str, torch.Tensor] = {}
    if component != "decoder":
        flat.update(load_file(_local_file(name, filenames[0])))
    if component != "encoder":
        flat.update(load_file(_local_file(name, filenames[1])))
    return cfg, released_state_to_module_state(flat)


__all__ = ["load_pretrained_params", "list_pretrained", "get_pretrained_info"]
