"""Entry points: a forward step of the flagship tokenizer, and a
multi-process dry run.

The port's counterparts of ``__graft_entry__.py``'s functions:

* :func:`entry` returns ``(fn, example_args)``: the 350M-f16x64 tokenizer
  (``Ld4-Ld24/1x16x64``, random weights from seed 0, bf16) and a NaFlex
  batch of two 256-token images, on the card unless ``device="cpu"``;
  ``fn(*example_args)`` is the forward (encode, then decode).
* :func:`dryrun_multichip` runs one training step over an ``n``-process
  ``(data, fsdp, model)`` mesh (DDP, FSDP2 and tensor parallelism
  together), and for ``n`` of 2 or 4 the pipeline meshes, each against one
  process, through ``vitok_torch.scripts.dryrun_multiprocess`` (gloo
  processes on the CPU, as the JAX entry re-runs itself on a virtual CPU
  mesh).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

ENTRY_VARIANT = "Ld4-Ld24/1x16x64"  # 350M-f16x64


def entry_batch(b: int = 2, n: int = 256, grid=(16, 16), pixels_per_token: int = 768, seed: int = 0,
                device="cuda") -> Dict[str, torch.Tensor]:
    """The JAX entry's NaFlex batch (``_make_batch``: numpy draws from
    ``seed``, a dense ``grid`` of patches of 16 px per image) as tensors on
    ``device``."""
    rng = np.random.default_rng(seed)
    gr, gc = grid
    nv = gr * gc
    yy, xx = np.meshgrid(np.arange(gr), np.arange(gc), indexing="ij")
    d = {
        "patches": np.zeros((b, n, pixels_per_token), np.float32),
        "patch_mask": np.zeros((b, n), bool),
        "row_idx": np.zeros((b, n), np.int32),
        "col_idx": np.zeros((b, n), np.int32),
        "orig_height": np.full((b,), gr * 16, np.int32),
        "orig_width": np.full((b,), gc * 16, np.int32),
    }
    d["patches"][:, :nv] = rng.standard_normal((b, nv, pixels_per_token)).astype(np.float32)
    d["patch_mask"][:, :nv] = True
    d["row_idx"][:, :nv] = yy.ravel()
    d["col_idx"][:, :nv] = xx.ravel()
    return {k: torch.from_numpy(v).to(device) for k, v in d.items()}


def entry(device="cuda") -> Tuple[Callable, Tuple[Any, Dict[str, torch.Tensor]]]:
    """``(fn, (model, batch))``: ``fn(model, batch)`` is the tokenizer's
    forward on the NaFlex batch."""
    from vitok_torch.models.ae import AE, decode_variant

    model = AE(**decode_variant(ENTRY_VARIANT), seed=0, device=device)
    batch = entry_batch(pixels_per_token=model.cfg.pixels_per_token, device=model.device)

    def fn(model, batch):
        return model(batch)

    return fn, (model, batch)


def multichip_meshes(n: int):
    """The dry run's meshes over ``n`` processes: ``model=2`` where ``n`` is
    even, then ``fsdp=2`` where the rest is even, the rest on ``data`` (the
    JAX entry's factoring); and the pipeline's: ``pipe=2`` for two
    processes, ``pipe=4`` and ``data=2,pipe=2`` for four."""
    model = 2 if n % 2 == 0 else 1
    rem = n // model
    fsdp = 2 if rem % 2 == 0 else 1
    meshes = [{"data": rem // fsdp, "fsdp": fsdp, "model": model}]
    meshes += {2: [{"pipe": 2}], 4: [{"pipe": 4}, {"data": 2, "pipe": 2}]}.get(n, [])
    return meshes


def dryrun_multichip(n_devices: int) -> Dict[str, Any]:
    """One sharded training step of a tiny AE over ``n_devices`` gloo
    processes (the forward, AdamW and Muon steps, gradient accumulation,
    a checkpoint, selective recomputation, a DiT step and the int8 forward
    under ``model``), and the pipeline's decode, gradients and steps for 2
    or 4 processes, each against one process. Raises ``AssertionError``
    naming what disagrees; returns the reports."""
    from vitok_torch.scripts import dryrun_multiprocess as dm

    meshes = multichip_meshes(n_devices)
    reports = dm.launch(n_devices, meshes)
    bad = {}
    for axes in meshes:
        name = dm.mesh_name(axes)
        split = axes.get("model", 1) > 1
        found = sorted({b for rep in reports[name] for b in dm.failures(rep, split, "pipe" in axes)})
        if found:
            bad[name] = found
    if bad:
        raise AssertionError(f"dryrun_multichip: layouts disagree with one process: {bad}")
    print(f"dryrun_multichip OK: {n_devices} processes, meshes {[dm.mesh_name(m) for m in meshes]}; every layout "
          "equals one process")
    return reports


__all__ = ["ENTRY_VARIANT", "dryrun_multichip", "entry", "entry_batch", "multichip_meshes"]
