"""Multi-process dryrun: the distributed layouts, run for real on the CPU.

The port's counterpart of the JAX package's ``scripts/dryrun_multiprocess.py``:
it spawns N processes joined by gloo (a ``file://`` rendezvous in a
temporary folder, no port), lays a tiny AE over each mesh given
(``data``, ``data x fsdp``, ``fsdp x model``, ``model``, ...), and in every
process holds the sharded forward, one AdamW step and one Muon step
against the same model unsharded in that process on the whole batch, and a
checkpoint of the sharded state against the single-device layout; then a
step under selective recomputation (``remat_save``), one step of a tiny
DiT, and, where ``model`` splits the blocks, the int8 forward. It prints
one JSON report and exits 1 if a layout disagrees.

    python -m vitok_torch.scripts.dryrun_multiprocess --processes 4 \\
        --mesh data=4 --mesh data=2,fsdp=2 --mesh fsdp=2,model=2 --mesh model=4

The tests spawn their workers through :func:`spawn` and the jobs here: the
``spawn`` start method needs an importable target.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from vitok_torch.parallel.mesh import parse_mesh

VARIANT = "w256_d1_h4-w256_d1_h4/1x16x8"
GLOBAL_BATCH = 8
TOKENS = 16
GRIDS = [(4, 4), (3, 4), (4, 2), (2, 3), (4, 4), (1, 4), (3, 3), (4, 3)]
LR = 3e-4
LOSS = dict(ssim_weight=0.1, tile_size=32, n_tiles=2, patch=16, ssim_grid=(4, 4))
DIT_CODE, DIT_CLASSES = 8, 10


def mesh_name(axes: Dict[str, int]) -> str:
    return ",".join(f"{k}={v}" for k, v in axes.items())


def make_global_batch(seed: int = 0, b: int = GLOBAL_BATCH, n: int = TOKENS, grids=GRIDS, patch: int = 16):
    """A numpy NaFlex batch, the same in every process: sample i a dense
    ``grids[i]`` grid, tail padding; and SSIM tile origins for it."""
    rng = np.random.default_rng(seed)
    dim = patch * patch * 3
    d = {
        "patches": np.zeros((b, n, dim), np.float32),
        "patch_mask": np.zeros((b, n), bool),
        "row_idx": np.zeros((b, n), np.int32),
        "col_idx": np.zeros((b, n), np.int32),
        "orig_height": np.array([g[0] * patch for g in grids[:b]], np.int32),
        "orig_width": np.array([g[1] * patch for g in grids[:b]], np.int32),
    }
    for i, (gr, gc) in enumerate(grids[:b]):
        nv = gr * gc
        yy, xx = np.meshgrid(np.arange(gr), np.arange(gc), indexing="ij")
        d["patches"][i, :nv] = rng.standard_normal((nv, dim))
        d["patch_mask"][i, :nv] = True
        d["row_idx"][i, :nv] = yy.ravel()
        d["col_idx"][i, :nv] = xx.ravel()
    tiles = (rng.integers(0, 9, (b, LOSS["n_tiles"])), rng.integers(0, 9, (b, LOSS["n_tiles"])))
    return d, tiles


def build_model(variant: str = VARIANT, seed: int = 0, **overrides):
    """A trainable fp32 AE on the CPU, its gains and LayerScale ~ U(0.5,
    1.5) from numpy, the same in every process."""
    from vitok_torch.models.ae import AE, AEConfig

    cfg = AEConfig.from_variant(variant, **overrides)
    model = AE(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__}, seed=seed, device="cpu",
               compute_dtype=torch.float32, param_dtype=torch.float32, trainable=True)
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("norm1.weight", "norm_q.weight", "norm_k.weight", "layer_scale.gamma")):
                p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, tuple(p.shape)).astype(np.float32)))
    return model


def build_dit(seed: int = 0):
    """A trainable fp32 DiT on the CPU (width 256, four heads, two blocks,
    8-channel latents, 10 classes), its adaLN ``mod`` weights ~
    U(+-0.05) from numpy (adaLN-zero would gate every block off)."""
    from vitok_torch.models.dit import DiT

    model = DiT(width=256, depth=2, heads=4, code_width=DIT_CODE, text_dim=DIT_CLASSES, seed=seed, device="cpu",
                compute_dtype=torch.float32, param_dtype=torch.float32, trainable=True)
    rng = np.random.default_rng(seed + 2)
    with torch.no_grad():
        for blk in model.blocks:
            blk.mod.weight.copy_(torch.from_numpy(rng.uniform(-0.05, 0.05, tuple(blk.mod.weight.shape))
                                                  .astype(np.float32)))
    return model


def dit_step(model, z, labels, draws):
    """One AdamW step (constant LR, clipping at 1.0, EMA) of the flow-matching
    loss with the given draws: ``(state, loss)``."""
    from vitok_torch import train_lib as tl
    from vitok_torch.scripts.train_dit import make_dit_train_step

    tx = tl.create_optimizer(tl.create_schedule("constant", LR, 100, warmup_frac=0.0))
    state = tl.create_train_state(model, tx, ema=True)
    return make_dit_train_step(tx, DIT_CLASSES)(state, z, labels, draws=draws)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _rows(t, lo, hi):
    return tuple(torch.as_tensor(x)[lo:hi] for x in t)


def one_step(model, optimizer: str, batch, tiles, grad_accum: int = 1, loss: Optional[Dict[str, Any]] = None):
    """One train step (constant LR, clipping at 1.0, EMA) of ``model`` on
    ``batch`` (the loss of :data:`LOSS`, or ``loss``): ``(state, metrics)``."""
    from vitok_torch import train_lib as tl

    tx = tl.create_optimizer(tl.create_schedule("constant", LR, 100, warmup_frac=0.0), optimizer=optimizer)
    state = tl.create_train_state(model, tx)
    step = tl.make_train_step(tx, tl.LossConfig(**(LOSS if loss is None else loss)), grad_accum=grad_accum)
    return step(state, batch, tile_indices=tiles)


def _max_abs(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> float:
    return max(float((a[k].detach().float() - b[k].detach().float()).abs().max()) for k in b)


def compare_layout(axes: Dict[str, int], workdir: str) -> Dict[str, Any]:
    """In this process: the tiny AE laid over ``axes`` against itself
    unsharded on the whole batch. Returns the largest differences."""
    from vitok_torch.parallel import create_mesh, shard_batch, shard_params
    from vitok_torch.parallel.sharding import local
    from vitok_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    mesh = create_mesh(axes, device="cpu")
    gbatch, gtiles = make_global_batch()
    batch = _torch_batch(gbatch)
    report: Dict[str, Any] = {}

    ref = build_model()
    want = ref(batch)["patches"]
    model = build_model()
    layout = shard_params(model, mesh)
    local_batch = shard_batch(batch, mesh)
    rank, size = layout.data_rank, layout.data_size
    lo, hi = rank * GLOBAL_BATCH // size, (rank + 1) * GLOBAL_BATCH // size
    got = layout.module(local_batch)["patches"]
    valid = local_batch["patch_mask"]
    report["forward_max_abs"] = float((got - want[lo:hi])[valid].abs().max())

    for opt in ("adamw", "muon"):
        ref = build_model()
        ref_state, ref_m = one_step(ref, opt, batch, _rows(gtiles, 0, GLOBAL_BATCH))
        model = build_model()
        layout = shard_params(model, mesh)
        state, m = one_step(model, opt, local_batch, _rows(gtiles, lo, hi))
        full = {n: layout.full(i, local(p).detach()) for i, (n, p) in enumerate(model.named_parameters())}
        ema = {n: layout.full(layout.names.index(n), t) for n, t in state.ema_params.items()}
        loss, ref_loss = float(m["loss/total"]), float(ref_m["loss/total"])
        report[opt] = {
            "params_max_abs": _max_abs(full, dict(ref.named_parameters())),
            "ema_max_abs": _max_abs(ema, ref_state.ema_params),
            "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
            "grad_norm_rel": abs(float(m["grad_norm"]) - float(ref_m["grad_norm"])) / float(ref_m["grad_norm"]),
            "moved": _max_abs(full, dict(build_model().named_parameters())),
        }
        if opt == "adamw":
            # The sharded state saves as the single-device checkpoint, and
            # loads back into a fresh sharded state.
            ckpt = os.path.join(workdir, "ckpt_" + mesh_name(axes).replace(",", "_").replace("=", ""))
            save_checkpoint(state, ckpt)
            payload = load_checkpoint(ckpt)
            report["checkpoint_params_max_abs"] = _max_abs(payload["params"], full)
            report["checkpoint_mu_max_abs"] = max(
                float((payload["opt_state"]["mu"][i] - layout.full(i, t)).abs().max())
                for i, t in enumerate(state.opt_state["mu"]))
            fresh = build_model(seed=5)
            flayout = shard_params(fresh, mesh)
            from vitok_torch import train_lib as tl

            tx = tl.create_optimizer(tl.create_schedule("constant", LR, 100, warmup_frac=0.0))
            target = load_checkpoint(ckpt, target=tl.create_train_state(fresh, tx))
            back = {n: flayout.full(i, local(p).detach()) for i, (n, p) in enumerate(fresh.named_parameters())}
            report["checkpoint_reload_max_abs"] = _max_abs(back, full)
            report["checkpoint_step"] = target.step

    # Gradient accumulation over the shard's rows (two microbatches) against
    # the whole batch in one (the JAX TestShardedGradAccum).
    ref = build_model()
    _, ref_m = one_step(ref, "adamw", batch, _rows(gtiles, 0, GLOBAL_BATCH))
    model = build_model()
    layout = shard_params(model, mesh)
    _, m = one_step(model, "adamw", local_batch, _rows(gtiles, lo, hi), grad_accum=2)
    full = {n: layout.full(i, local(p).detach()) for i, (n, p) in enumerate(model.named_parameters())}
    report["accum"] = {"params_max_abs": _max_abs(full, dict(ref.named_parameters())),
                       "loss_rel": abs(float(m["loss/total"]) - float(ref_m["loss/total"])) / float(ref_m["loss/total"])}

    # Selective recomputation: every block under checkpoint 1 keeping qkv
    # and the FFN hidden, its replay inside the block's call.
    remat = dict(checkpoint=1, remat_save=("qkv_out", "ffn_hid"))
    ref = build_model(**remat)
    _, ref_m = one_step(ref, "adamw", batch, _rows(gtiles, 0, GLOBAL_BATCH))
    model = build_model(**remat)
    layout = shard_params(model, mesh)
    _, m = one_step(model, "adamw", local_batch, _rows(gtiles, lo, hi))
    full = {n: layout.full(i, local(p).detach()) for i, (n, p) in enumerate(model.named_parameters())}
    report["remat"] = {"params_max_abs": _max_abs(full, dict(ref.named_parameters())),
                       "loss_rel": abs(float(m["loss/total"]) - float(ref_m["loss/total"])) / float(ref_m["loss/total"])}

    # The DiT: one flow-matching step, the draws fixed.
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.standard_normal((GLOBAL_BATCH, TOKENS, DIT_CODE)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, DIT_CLASSES, GLOBAL_BATCH))
    draws = {"sigma": torch.from_numpy(rng.uniform(0, 1, GLOBAL_BATCH).astype(np.float32)),
             "eps": torch.from_numpy(rng.standard_normal(z.shape).astype(np.float32)),
             "drop": torch.from_numpy(rng.uniform(0, 1, GLOBAL_BATCH) < 0.25)}
    ref = build_dit()
    _, ref_loss = dit_step(ref, z, labels, draws)
    model = build_dit()
    layout = shard_params(model, mesh)
    _, loss = dit_step(model, z[lo:hi], labels[lo:hi], {k: v[lo:hi] for k, v in draws.items()})
    full = {n: layout.full(i, local(p).detach()) for i, (n, p) in enumerate(model.named_parameters())}
    report["dit"] = {"params_max_abs": _max_abs(full, dict(ref.named_parameters())),
                     "loss_rel": abs(float(loss) - float(ref_loss)) / float(ref_loss),
                     "moved": _max_abs(full, dict(build_dit().named_parameters()))}

    if layout.tp:
        # int8 inference: qkv and out sliced, the FFN whole on each rank.
        want = build_model().quantize()(batch)["patches"]
        model = build_model().quantize()
        layout = shard_params(model, mesh)
        got = layout.module(local_batch)["patches"]
        report["int8_forward_max_abs"] = float((got - want[lo:hi])[valid].abs().max())
    return report


def metrics_mean(rank: int, world: int) -> float:
    """``MeanCovAccumulator`` over each process's rows, all-reduced, against
    the mean of all rows (the JAX ``TestDistributedMetrics``)."""
    from vitok_torch.metrics import MeanCovAccumulator

    x = np.random.default_rng(0).standard_normal((64, 16))
    acc = MeanCovAccumulator(16)
    acc.update(x[rank::world])
    acc.allreduce()
    mu, cov = acc.finalize()
    return max(float(np.abs(mu - x.mean(0)).max()), float(np.abs(cov - np.cov(x, rowvar=False)).max()))


def layouts_job(rank: int, world: int, workdir: str, meshes: Sequence[Dict[str, int]]) -> None:
    out = {mesh_name(axes): compare_layout(axes, workdir) for axes in meshes}
    out["metrics"] = {"mean_cov_max_abs": metrics_mean(rank, world)}
    with open(os.path.join(workdir, f"layouts_{rank}.json"), "w") as f:
        json.dump(out, f)


def sequence_job(rank: int, world: int, workdir: str) -> None:
    """Sequence parallelism over ``seq=world``: the halo attention, the
    token-sharded forward and its loss and gradients, with and without
    padding, saved for the test to hold against the single-device port and
    the JAX package; then a ``data=world`` AdamW step of the same model."""
    from vitok_torch.parallel import (create_mesh, place_batch_token_sharded, sequence_parallel_forward,
                                      sequence_parallel_value_and_grad, shard_batch, shard_params)
    from vitok_torch.parallel.sequence import halo_attention, token_axis
    from vitok_torch.parallel.sharding import local

    mesh = create_mesh({"seq": world}, device="cpu")
    group = mesh["seq"].get_group()
    saved: Dict[str, np.ndarray] = {}
    # halo attention against the global windowed attention
    rng = np.random.default_rng(3)
    b, n, h, d, sw = 2, 32, 2, 64, 5
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32)) for _ in range(3))
    pm = torch.from_numpy(np.arange(n)[None, :] < np.array([[n], [23]]))
    nl = n // world
    sl = slice(rank * nl, (rank + 1) * nl)
    with token_axis(group):
        saved["halo"] = halo_attention(q[:, sl], k[:, sl], v[:, sl], pm[:, sl], sw).numpy()
    for padded in (False, True):
        tag = "pad" if padded else "full"
        grids = [(4, 4), (2, 4)] if padded else [(4, 4), (4, 4)]
        gbatch, _ = make_global_batch(seed=4, b=2, n=16, grids=grids)
        model = build_model(sw=2)
        shard = place_batch_token_sharded(_torch_batch(gbatch), mesh)
        saved[f"fwd_{tag}"] = sequence_parallel_forward(model, shard, mesh)["patches"].numpy()
        loss, grads = sequence_parallel_value_and_grad(model, shard, mesh)
        saved[f"loss_{tag}"] = np.asarray(float(loss))
        for (name, _), g in zip(model.named_parameters(), grads):
            saved[f"grad_{tag}/{name}"] = g.numpy()
    # a data-parallel AdamW step (Charbonnier loss), for the JAX package's step
    dmesh = create_mesh({"data": world}, device="cpu")
    gbatch, _ = make_global_batch(seed=6, b=2 * world)
    model = build_model()
    layout = shard_params(model, dmesh)
    state, metrics = one_step(model, "adamw", shard_batch(_torch_batch(gbatch), dmesh), None,
                              loss=dict(ssim_weight=0.0))
    saved["data_loss"] = np.asarray(float(metrics["loss/total"]))
    saved["data_grad_norm"] = np.asarray(float(metrics["grad_norm"]))
    for i, (name, p) in enumerate(model.named_parameters()):
        saved[f"data_param/{name}"] = layout.full(i, local(p).detach()).numpy()
    np.savez(os.path.join(workdir, f"sequence_{rank}.npz"), **saved)


def ddp_job(rank: int, world: int, workdir: str) -> None:
    """``data=world`` on the one device that ``workdir/job.pt`` names (on a
    card every process on ``cuda:0``, gloo carrying the CUDA gradients): one
    AdamW step of the model and batch that the job holds
    (``attn_impl="fused"``), each rank on its rows; rank 0 saves the loss,
    the parameters and its kernel launches."""
    from vitok_torch import AE, decode_variant
    from vitok_torch import train_lib as tl
    from vitok_torch.ops import fused_attention as fa
    from vitok_torch.parallel import create_mesh, shard_batch, shard_params

    job = torch.load(os.path.join(workdir, "job.pt"), weights_only=True)
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    model = AE(**{**decode_variant(job["variant"]), "attn_impl": "fused"},
               state_dict={k: v.to(device) for k, v in job["state"].items()}, device=device,
               param_dtype=torch.float32, trainable=True)
    layout = shard_params(model, create_mesh({"data": world}, device=device.type))
    tx = tl.create_optimizer(tl.create_schedule("constant", job["lr"], 10, warmup_frac=0.0))
    state = tl.create_train_state(model, tx)
    batch = shard_batch({k: v.to(device) if hasattr(v, "to") else v for k, v in job["inputs"].items()},
                        layout.mesh)
    fa.LAUNCHES = fa.BWD_LAUNCHES = fa.PROLOGUE_LAUNCHES = 0
    state, metrics = tl.make_train_step(tx, tl.LossConfig(ssim_weight=0.0))(state, batch)
    if device.type == "cuda":
        torch.cuda.synchronize()
    if rank == 0:
        torch.save({"loss": float(metrics["loss/total"]),
                    "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
                    "launches": {"fused_attention": fa.LAUNCHES, "fused_attention_bwd": fa.BWD_LAUNCHES,
                                 "fused_qk_prologue": fa.PROLOGUE_LAUNCHES}},
                   os.path.join(workdir, f"ddp_{rank}.pt"))


def _entry(rank: int, world: int, job: str, workdir: str, kwargs: Dict[str, Any]) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(workdir, "rendezvous"), rank=rank,
                            world_size=world)
    try:
        globals()[job](rank, world, workdir, **kwargs)
    finally:
        dist.destroy_process_group()


def spawn(job: str, nprocs: int, workdir: str, **kwargs) -> None:
    """Run ``job(rank, world, workdir, **kwargs)`` of this module in
    ``nprocs`` fresh processes joined by gloo through a ``file://``
    rendezvous in ``workdir``; raises if any of them fails."""
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    # A parent run from stdin or -c has no main file for the children to
    # import again: hide the name meanwhile (the job lives in this module).
    main = sys.modules["__main__"]
    path = getattr(main, "__file__", None)
    hidden = path is not None and getattr(main, "__spec__", None) is None and not os.path.exists(path)
    if hidden:
        del main.__file__
    try:
        mp.start_processes(_entry, args=(nprocs, job, workdir, kwargs), nprocs=nprocs, join=True,
                           start_method="spawn")
    finally:
        if hidden:
            main.__file__ = path


LIMITS = {"mean_cov_max_abs": 1e-6, "forward_max_abs": 1e-5, "int8_forward_max_abs": 1e-5, "params_max_abs": 1e-5,
          "ema_max_abs": 1e-5, "loss_rel": 1e-5, "checkpoint_params_max_abs": 0.0, "checkpoint_mu_max_abs": 0.0,
          "checkpoint_reload_max_abs": 0.0}
# Where ``model`` splits the blocks, the row-parallel partial sums add in
# another order, which the first Adam step carries to the parameters.
SPLIT_PARAMS_MAX_ABS = 3e-5


def failures(report: Dict[str, Any], split: bool = False) -> List[str]:
    """The entries of a layout report beyond :data:`LIMITS` (``split``: a
    mesh with ``model``, held to :data:`SPLIT_PARAMS_MAX_ABS`)."""
    limits = {**LIMITS, "params_max_abs": SPLIT_PARAMS_MAX_ABS} if split else LIMITS
    bad = []
    for key, value in report.items():
        if isinstance(value, dict):
            bad += [f"{key}.{k}" for k in failures(value, split)]
        elif key in limits and value > limits[key]:
            bad.append(key)
    return bad


def launch(n_processes: int = 4, meshes: Optional[Sequence[Dict[str, int]]] = None,
           workdir: Optional[str] = None) -> Dict[str, Any]:
    """Spawn ``n_processes`` gloo workers that each hold every mesh of
    ``meshes`` against the single-process model; returns ``{mesh: [each
    rank's report]}``."""
    meshes = list(meshes or ({"data": n_processes},))
    with tempfile.TemporaryDirectory() as tmp:
        wd = workdir or tmp
        spawn("layouts_job", n_processes, wd, meshes=meshes)
        reports = []
        for r in range(n_processes):
            with open(os.path.join(wd, f"layouts_{r}.json")) as f:
                reports.append(json.load(f))
    return {name: [rep[name] for rep in reports] for name in [mesh_name(m) for m in meshes] + ["metrics"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=4)
    ap.add_argument("--mesh", action="append", default=None,
                    help="a layout, e.g. data=2,fsdp=2 (repeat the flag for several; default data=N)")
    args = ap.parse_args(argv)
    meshes = [parse_mesh(m) for m in args.mesh] if args.mesh else None
    result = launch(args.processes, meshes)
    bad = {m: sorted({b for rep in reps for b in failures(rep, "model=" in m)}) for m, reps in result.items()}
    bad = {m: b for m, b in bad.items() if b}
    print(json.dumps({"ok": not bad, "processes": args.processes, "failed": bad, "layouts": result}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
