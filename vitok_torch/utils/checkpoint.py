"""Checkpoint/resume with ``torch.save`` and safetensors export.

Port of ``vitok_tpu/utils/checkpoint.py`` for one device: a checkpoint keeps
the parameters, the optimizer state, the EMA and the step together in
``{path}/state.pt``; ``export_safetensors`` writes the released split layout
(``encoder.safetensors`` + ``decoder.safetensors``, flat module names, q/k
channels back in the interleaved RoPE order) that both packages' loaders
read.

A state laid over a mesh (``state.layout``) is saved as the same full
single-device ``state.pt``: every rank takes part in gathering each tensor
whole (on a pipe mesh each decoder block from its stage), and the mesh's
first process writes. Loading slices each rank's part
of the full tensors back, so a checkpoint moves between layouts.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch

from vitok_torch.utils.params_io import module_state_to_released_state

_FILE = "state.pt"
_ENCODER_KEYS = ("patch_embed", "to_code", "encoder_blocks")
_DECODER_KEYS = ("decoder_embed", "to_pixels", "decoder_blocks")


def _state_indices(state: Any) -> Dict[str, list]:
    """The parameter index of each entry of the optimizer state's lists."""
    matrix = None
    if "momentum" in state.opt_state:  # Muon: momentum on the matrices, Adam on the rest
        from vitok_torch.muon import matrix_mask

        matrix = list(matrix_mask(state.model).values())
    return state.layout.state_indices(state.opt_state, matrix)


def _full_payload(state: Any) -> Dict[str, Any]:
    """The single-device payload of a sharded state (a collective: every
    rank of the layout calls it)."""
    from vitok_torch.parallel.sharding import local

    layout = state.layout
    names = layout.names
    params = {n: layout.full(i, local(p).detach()) for i, (n, p) in enumerate(state.model.named_parameters())}
    opt = dict(state.opt_state)
    for key, idx in _state_indices(state).items():
        opt[key] = [layout.full(i, t) for i, t in zip(idx, state.opt_state[key])]
    ema = None
    if state.ema_params is not None:
        ema = {n: layout.full(names.index(n), t) for n, t in state.ema_params.items()}
    return {"step": int(state.step), "params": params, "opt_state": opt, "ema_params": ema}


def save_checkpoint(state: Any, path: str) -> None:
    """Save a ``TrainState`` to ``{path}/state.pt`` (overwrites, atomically).
    A sharded state is gathered whole (every rank calls this) and written by
    the mesh's first process; the others wait for the file."""
    path = os.path.abspath(path)
    layout = getattr(state, "layout", None)
    if layout is None:
        payload = {
            "step": int(state.step),
            "params": state.model.state_dict(),
            "opt_state": state.opt_state,
            "ema_params": state.ema_params,
        }
    elif getattr(layout, "pipe", False):
        from vitok_torch.parallel.pipeline import full_payload

        payload = full_payload(state)
    else:
        payload = _full_payload(state)
    writer = layout is None or int(layout.mesh.mesh.flatten()[0]) == torch.distributed.get_rank()
    if writer:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, _FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, _FILE))
    if layout is not None:
        torch.distributed.barrier()


def load_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """Restore a checkpoint. With ``target`` (a ``TrainState`` of the same
    model and optimizer) its tensors are overwritten in place, on their
    devices and in their dtypes, and ``target`` is returned; without it the
    saved dictionary is returned on the CPU."""
    payload = torch.load(os.path.join(os.path.abspath(path), _FILE), map_location="cpu", weights_only=True)
    if target is None:
        return payload
    layout = getattr(target, "layout", None)
    if getattr(layout, "pipe", False):
        from vitok_torch.parallel.pipeline import load_staged

        return load_staged(target, payload)
    if layout is not None:
        return _load_sharded(target, payload)
    target.model.load_state_dict(payload["params"])
    opt, saved = target.opt_state, payload["opt_state"]
    lists = sorted(k for k, v in opt.items() if isinstance(v, list))
    if lists != sorted(k for k, v in saved.items() if isinstance(v, list)):
        raise ValueError(f"checkpoint optimizer state holds {sorted(saved)}, expected {sorted(opt)}")
    opt["count"] = int(saved["count"])
    with torch.no_grad():
        for key in lists:  # AdamW's mu/nu, Muon's momentum and its Adam's mu/nu
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


@torch.no_grad()
def _load_sharded(target: Any, payload: Dict[str, Any]) -> Any:
    """Each rank's parts of a full payload into a sharded state."""
    from vitok_torch.parallel.sharding import local

    layout = target.layout
    names = layout.names
    saved_params = payload["params"]
    if sorted(saved_params) != sorted(names):
        raise ValueError("checkpoint parameters do not match the model's")
    for i, (n, p) in enumerate(target.model.named_parameters()):
        dst = local(p)
        dst.copy_(layout.local_of(i, saved_params[n].to(dst.device)))
    saved = payload["opt_state"]
    indices = _state_indices(target)
    if sorted(indices) != sorted(k for k, v in saved.items() if isinstance(v, list)):
        raise ValueError(f"checkpoint optimizer state holds {sorted(saved)}, expected {sorted(target.opt_state)}")
    target.opt_state["count"] = int(saved["count"])
    for key, idx in indices.items():
        if len(saved[key]) != len(idx):
            raise ValueError(f"checkpoint optimizer state {key}: {len(saved[key])} tensors, expected {len(idx)}")
        for i, dst, src in zip(idx, target.opt_state[key], saved[key]):
            dst.copy_(layout.local_of(i, src.to(dst.device)))
    if target.ema_params is not None and payload["ema_params"]:
        for n, dst in target.ema_params.items():
            dst.copy_(layout.local_of(names.index(n), payload["ema_params"][n].to(dst.device)))
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
