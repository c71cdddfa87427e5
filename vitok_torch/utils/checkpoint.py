"""Checkpoint/resume with ``torch.save`` and safetensors export.

Port of ``vitok_tpu/utils/checkpoint.py`` for one device: a checkpoint keeps
the parameters, the optimizer state, the EMA and the step together in
``{path}/state.pt``; ``export_safetensors`` writes the released split layout
(``encoder.safetensors`` + ``decoder.safetensors``, flat module names, q/k
channels back in the interleaved RoPE order) that both packages' loaders
read.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch

from vitok_torch.utils.params_io import module_state_to_released_state

_FILE = "state.pt"
_ENCODER_KEYS = ("patch_embed", "to_code", "encoder_blocks")
_DECODER_KEYS = ("decoder_embed", "to_pixels", "decoder_blocks")


def save_checkpoint(state: Any, path: str) -> None:
    """Save a ``TrainState`` to ``{path}/state.pt`` (overwrites, atomically)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    payload = {
        "step": int(state.step),
        "params": state.model.state_dict(),
        "opt_state": state.opt_state,
        "ema_params": state.ema_params,
    }
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def load_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """Restore a checkpoint. With ``target`` (a ``TrainState`` of the same
    model and optimizer) its tensors are overwritten in place, on their
    devices and in their dtypes, and ``target`` is returned; without it the
    saved dictionary is returned on the CPU."""
    payload = torch.load(os.path.join(os.path.abspath(path), _FILE), map_location="cpu", weights_only=True)
    if target is None:
        return payload
    target.model.load_state_dict(payload["params"])
    opt, saved = target.opt_state, payload["opt_state"]
    opt["count"] = int(saved["count"])
    with torch.no_grad():
        for key in ("mu", "nu"):
            if len(opt[key]) != len(saved[key]):
                raise ValueError(f"checkpoint optimizer state {key}: {len(saved[key])} tensors, "
                                 f"expected {len(opt[key])}")
            for dst, src in zip(opt[key], saved[key]):
                dst.copy_(src)
        if target.ema_params is not None:
            if saved_ema := payload["ema_params"]:
                for name, dst in target.ema_params.items():
                    dst.copy_(saved_ema[name])
    target.step = int(payload["step"])
    return target


def export_safetensors(params: Mapping[str, torch.Tensor], out_dir: str, split: bool = True) -> list:
    """Write parameters (an ``AE`` state dict, or the EMA dictionary) as
    fp32 safetensors in the released flat layout.

    ``split=True`` writes ``encoder.safetensors`` and ``decoder.safetensors``
    (whichever halves are present); otherwise one ``model.safetensors``.
    Returns the paths written.
    """
    from safetensors.torch import save_file

    flat: Dict[str, torch.Tensor] = module_state_to_released_state(params)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    if split:
        for comp, keys in (("encoder", _ENCODER_KEYS), ("decoder", _DECODER_KEYS)):
            part = {k: v for k, v in flat.items() if k.startswith(keys)}
            if part:
                path = os.path.join(out_dir, f"{comp}.safetensors")
                save_file(part, path)
                written.append(path)
    else:
        path = os.path.join(out_dir, "model.safetensors")
        save_file(flat, path)
        written.append(path)
    return written


__all__ = ["save_checkpoint", "load_checkpoint", "export_safetensors"]
