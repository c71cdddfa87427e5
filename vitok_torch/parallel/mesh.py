"""Process groups and device meshes for data, FSDP and tensor parallelism.

The port's counterpart of ``vitok_tpu/parallel/mesh.py``: one
``torch.distributed.device_mesh.DeviceMesh`` whose named axes say how the
model and the batch are laid over the processes (one process a card, as
``torchrun`` starts them). The axis names are the JAX package's:

* ``data``: batch parallelism (DDP, or the replicated dimension of HSDP);
* ``fsdp``: parameter sharding (FSDP2's ``fully_shard``);
* ``model``: tensor parallelism over attention heads and the FFN hidden;
* ``seq``: token sharding for sequence parallelism
  (:mod:`vitok_torch.parallel.sequence`);
* ``pipe``: pipeline stages over the decoder blocks
  (:mod:`vitok_torch.parallel.pipeline`).

:func:`initialize_distributed` reads what ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and starts
the default process group: NCCL on the card, gloo when the CPU is asked for.
A failed start raises; nothing falls back.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
AXES = (DATA_AXIS, FSDP_AXIS, MODEL_AXIS, SEQ_AXIS, PIPE_AXIS)


def _device_type(device) -> str:
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"the process groups run on 'cuda' (NCCL) or 'cpu' (gloo), got {device!r}")
    return kind


def backend_for(device) -> str:
    """``nccl`` for the card, ``gloo`` for the CPU."""
    return "nccl" if _device_type(device) == "cuda" else "gloo"


def initialize_distributed(device="cuda", init_method: Optional[str] = None, rank: Optional[int] = None,
                           world_size: Optional[int] = None) -> Tuple[int, int, int]:
    """Start the default process group from ``torchrun``'s environment (or
    the arguments), and return ``(rank, world_size, local_rank)``.

    In a single process without ``RANK``/``WORLD_SIZE`` (and no arguments)
    it starts nothing and returns ``(0, 1, 0)``. On the card
    (``device="cuda"``) it sets the current device from ``LOCAL_RANK`` and
    starts NCCL; ``device="cpu"`` starts gloo. ``init_method`` defaults to
    ``env://`` (``MASTER_ADDR``/``MASTER_PORT``); tests pass a
    ``file://`` path. An error from ``init_process_group`` propagates.
    """
    kind = _device_type(device)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    env_rank, env_world = os.environ.get("RANK"), os.environ.get("WORLD_SIZE")
    rank = int(env_rank) if rank is None and env_rank is not None else rank
    world_size = int(env_world) if world_size is None and env_world is not None else world_size
    if rank is None or world_size is None:
        if rank is not None or world_size is not None:
            raise ValueError("initialize_distributed: give both rank and world_size, or neither")
        return 0, 1, 0
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    kwargs = {}
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(device='cuda'): no CUDA device; pass device='cpu' for gloo")
        torch.cuda.set_device(local_rank)
        kwargs["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(backend_for(kind), init_method=init_method or "env://", rank=rank,
                            world_size=world_size, **kwargs)
    return rank, world_size, local_rank


def _single_process_group(kind: str) -> None:
    """A world of one in this process (no address needed): what
    :func:`create_mesh` starts when no group exists."""
    kwargs = {"device_id": torch.device("cuda", torch.cuda.current_device())} if kind == "cuda" else {}
    dist.init_process_group(backend_for(kind), store=dist.HashStore(), rank=0, world_size=1, **kwargs)


def mesh_sizes(axes: Optional[Dict[str, int]], world: int) -> Dict[str, int]:
    """The axis sizes of a mesh over ``world`` processes: ``axes`` with its
    one ``-1`` (at most one) given the rest; all processes on ``data`` by
    default. Raises ``ValueError`` where the sizes do not multiply to the
    world."""
    sizes = dict(axes) if axes else {DATA_AXIS: world}
    unknown = [k for k in sizes if k not in AXES]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; the axes are {AXES}")
    wildcards = [k for k, v in sizes.items() if v == -1]
    if len(wildcards) > 1:
        raise ValueError("At most one axis may be -1")
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if any(v < 1 for k, v in sizes.items() if k not in wildcards):
        raise ValueError(f"mesh axis sizes must be positive, got {sizes}")
    if wildcards:
        if world % fixed:
            raise ValueError(f"{world} processes not divisible by fixed axes {fixed}")
        sizes[wildcards[0]] = world // fixed
    total = math.prod(sizes.values())
    if total != world:
        raise ValueError(f"Mesh axes {sizes} require {total} processes but {world} are available")
    return sizes


def create_mesh(axes: Optional[Dict[str, int]] = None, device="cuda"):
    """A named ``DeviceMesh`` over every process of the default group (a
    world of one in this process where none was started).

    Args:
        axes: ordered mapping axis name -> size, e.g. ``{"data": 2, "fsdp":
            2, "model": 2}``; a single ``-1`` takes the processes left. All
            processes on ``data`` by default. An axis of size 1 is kept: it
            still selects its layer (``fsdp=1`` wraps the model in FSDP2).
        device: ``"cuda"`` (NCCL) or ``"cpu"`` (gloo).
    """
    from torch.distributed.device_mesh import init_device_mesh

    kind = _device_type(device)
    if not dist.is_initialized():
        _single_process_group(kind)
    sizes = mesh_sizes(axes, dist.get_world_size())
    return init_device_mesh(kind, tuple(sizes.values()), mesh_dim_names=tuple(sizes))


def parse_mesh(spec: Optional[str]) -> Optional[Dict[str, int]]:
    """``"data=2,fsdp=2"`` -> ``{"data": 2, "fsdp": 2}`` in order (the
    CLIs' ``--mesh``); None for an empty spec."""
    if not spec:
        return None
    axes = {}
    for part in spec.split(","):
        if part.strip():
            name, _, size = part.partition("=")
            axes[name.strip()] = int(size)
    return axes


def cli_mesh(spec: Optional[str], device, allowed=(DATA_AXIS, FSDP_AXIS, MODEL_AXIS), hint: str = ""):
    """The process group and mesh of a training CLI under ``torchrun``:
    ``(mesh or None, rank, world, device)``. ``device`` is the CLI's
    ``--device``; on the card each process takes ``cuda:LOCAL_RANK``. No
    mesh where one process runs without ``--mesh``. Axes outside ``allowed``
    raise ``SystemExit``."""
    axes = parse_mesh(spec)
    bad = sorted(set(axes or ()) - set(allowed))
    if bad:
        raise SystemExit(f"--mesh {spec}: this CLI takes the axes {list(allowed)}, not {bad}{hint}")
    kind = _device_type(device)
    rank, world, local_rank = initialize_distributed(kind)
    dev = torch.device("cuda", local_rank) if kind == "cuda" and world > 1 else torch.device(device)
    if axes is None and world == 1:
        return None, rank, world, dev
    return create_mesh(axes, device=kind), rank, world, dev


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name`` of ``mesh`` (0 where the mesh lacks it)."""
    names = mesh.mesh_dim_names or ()
    return mesh.shape[names.index(name)] if name in names else 0


__all__ = [
    "AXES",
    "DATA_AXIS",
    "FSDP_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "SEQ_AXIS",
    "axis_size",
    "backend_for",
    "create_mesh",
    "initialize_distributed",
    "cli_mesh",
    "mesh_sizes",
    "parse_mesh",
]
