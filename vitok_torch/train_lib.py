"""Training core: LR schedules, AdamW with clipping, EMA, the loss stack and
the train step.

Port of ``vitok_tpu/train_lib.py`` for one device. The JAX package builds
its optimizer from optax and keeps params, optimizer state and EMA in one
immutable pytree; here the model is an ``nn.Module`` whose parameters are
updated in place, and the optimizer is written out on tensors with the optax
formulas (``clip_by_global_norm`` then ``adamw``), so the same gradients
give the same steps:

* AdamW with weight decay on matrix weights only (``nn.Linear.weight``;
  never norm gains, biases or LayerScale), bias-corrected moments,
  ``eps`` added outside the square root, decay added to the update before
  the learning rate scales it; optionally a bf16 first moment;
* cosine / linear / exponential / constant schedules with linear warm-up;
  the update of step ``t`` (0-based) uses ``schedule(t)``;
* an fp32 EMA copy of the parameters, updated after each step;
* gradient accumulation over microbatches in fp32 before one update.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from vitok_torch.losses import charbonnier_loss, perceptual_loss, ssim_loss
from vitok_torch.models.ae import AE
from vitok_torch.pp.ops import sample_tiles

Schedule = Callable[[int], float]


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def create_schedule(
    name: str,
    base_lr: float,
    total_steps: int,
    warmup_frac: float = 0.05,
    end_lr_frac: float = 0.0,
    decay_rate: float = 0.1,
) -> Schedule:
    """LR schedule ``step -> lr``: "cosine" | "linear" | "exponential" |
    "constant", after a linear warm-up from 0 over
    ``int(total_steps * warmup_frac)`` steps (the optax schedules the JAX
    package joins, written out)."""
    warmup = max(int(total_steps * warmup_frac), 0)
    decay_steps = max(total_steps - warmup, 1)
    if name == "cosine":
        def main(t):
            t = min(t, decay_steps)
            cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
            return base_lr * ((1.0 - end_lr_frac) * cosine + end_lr_frac)
    elif name == "linear":
        def main(t):
            frac = 1.0 - min(max(t, 0), decay_steps) / decay_steps
            return (base_lr - base_lr * end_lr_frac) * frac + base_lr * end_lr_frac
    elif name == "exponential":
        def main(t):
            return base_lr if t <= 0 else base_lr * decay_rate ** (t / decay_steps)
    elif name == "constant":
        def main(t):
            return base_lr
    else:
        raise ValueError(f"Unknown schedule: {name}")
    if warmup == 0:
        return main

    def schedule(step):
        if step < warmup:
            return base_lr * min(max(step, 0), warmup) / warmup
        return main(step - warmup)

    return schedule


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> whether it gets weight decay: the weight of every
    ``nn.Linear`` and the DiT's class table ``ctx_embed``, nothing else (the
    JAX package's leaf-name mask keeps ``kernel`` and ``ctx_embed`` leaves)."""
    decayed = {id(m.weight) for m in model.modules() if isinstance(m, nn.Linear)}
    return {name: id(p) in decayed or name.rsplit(".", 1)[-1] == "ctx_embed"
            for name, p in model.named_parameters()}


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over a list of tensors, a 0-d fp32 tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)).float())


class AdamW:
    """Global-norm clipping then AdamW, on lists of tensors.

    ``init(model)`` gives the state (step count and the two moments per
    parameter); ``update(params, grads, state)`` clips ``grads`` in place,
    advances the moments and updates ``params`` in place.
    """

    def __init__(self, schedule: Schedule, weight_decay=1e-4, b1=0.9, b2=0.99, eps=1e-8,
                 grad_clip: Optional[float] = 1.0, moment_dtype: Optional[torch.dtype] = None):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip = grad_clip
        self.moment_dtype = moment_dtype

    def init(self, model: nn.Module) -> Dict[str, Any]:
        params = list(model.parameters())
        self._decayed = list(decay_mask(model).values())
        return {
            "count": 0,
            "mu": [torch.zeros_like(p, dtype=self.moment_dtype or p.dtype) for p in params],
            "nu": [torch.zeros_like(p) for p in params],
        }

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict[str, Any]) -> None:
        if self.grad_clip:
            g_norm = global_norm(grads)
            # t / g_norm * max_norm where the norm reaches max_norm, else t.
            factor = torch.where(g_norm < self.grad_clip, torch.ones_like(g_norm),
                                 self.grad_clip / g_norm)
            torch._foreach_mul_(grads, factor)
        lr = self.schedule(state["count"])
        state["count"] += 1
        count = state["count"]
        b1, b2 = self.b1, self.b2
        mu_store, nu = state["mu"], state["nu"]
        low = self.moment_dtype is not None and any(m.dtype != g.dtype for m, g in zip(mu_store, grads))
        mu = [m.to(g.dtype) for m, g in zip(mu_store, grads)] if low else mu_store
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(nu, 1.0 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, 1.0 - b1 ** count)
        torch._foreach_div_(upd, denom)
        del denom
        if low:  # the moment is stored rounded; this step used it unrounded
            for m, m32 in zip(mu_store, mu):
                m.copy_(m32)
        if self.weight_decay:
            pairs = [(u, p) for u, p, d in zip(upd, params, self._decayed) if d]
            if pairs:
                torch._foreach_add_([u for u, _ in pairs], [p for _, p in pairs], alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)


def create_optimizer(
    schedule: Schedule,
    weight_decay: float = 1e-4,
    b1: float = 0.9,
    b2: float = 0.99,
    grad_clip: float = 1.0,
    optimizer: str = "adamw",
    momentum: float = 0.95,
    moment_dtype: Optional[torch.dtype] = None,
) -> AdamW:
    """AdamW (decay on matrix weights only) with global-norm clipping.

    ``moment_dtype=torch.bfloat16`` stores the first moment in bf16 (the
    second stays fp32). ``optimizer="muon"`` is not ported.
    """
    if optimizer == "muon":
        raise NotImplementedError(
            "the Muon optimizer (vitok_tpu/muon.py) is not ported yet: ROADMAP.md Queue 1 item 10"
        )
    if optimizer != "adamw":
        raise ValueError(f"Unknown optimizer: {optimizer}")
    return AdamW(schedule, weight_decay=weight_decay, b1=b1, b2=b2, grad_clip=grad_clip,
                 moment_dtype=moment_dtype)


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the params), the optimizer state, the
    fp32 EMA of the parameters (by name, or None) and the step count."""

    step: int
    model: AE
    opt_state: Dict[str, Any]
    ema_params: Optional[Dict[str, torch.Tensor]]


def create_train_state(model: AE, tx: AdamW, ema: bool = True) -> TrainState:
    return TrainState(
        step=0,
        model=model,
        opt_state=tx.init(model),
        ema_params={n: p.detach().float().clone() for n, p in model.named_parameters()} if ema else None,
    )


@torch.no_grad()
def update_ema(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], decay: float = 0.999) -> None:
    """fp32 lerp EMA, in place: ``e = e * decay + p * (1 - decay)``."""
    es = list(ema.values())
    ps = [params[n].detach().float() for n in ema]
    torch._foreach_mul_(es, decay)
    torch._foreach_add_(es, ps, alpha=1.0 - decay)


# ---------------------------------------------------------------------------
# Loss + step
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Static loss weights (the reference trainer's defaults)."""

    charbonnier_weight: float = 1.0
    ssim_weight: float = 0.1
    perceptual_weight: float = 0.0  # needs a feature_fn
    charbonnier_eps: float = 1e-3
    tile_size: int = 256
    n_tiles: int = 2
    patch: int = 16
    # Dense grid (rows, cols) for the SSIM branch; None disables it.
    ssim_grid: Optional[Tuple[int, int]] = None


def unpatchify_dense_static(d: Dict[str, Any], grid_rows: int, grid_cols: int, patch: int) -> torch.Tensor:
    """Dense unpatchify at a fixed grid (reshape only): masked tokens 0."""
    patches = d["patches"]
    mask = d.get("patch_mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=patches.device).bool()
        patches = torch.where(mask[..., None], patches, torch.zeros((), dtype=patches.dtype, device=patches.device))
    b = patches.shape[0]
    n = grid_rows * grid_cols
    c = patches.shape[-1] // (patch * patch)
    x = patches[:, :n].reshape(b, grid_rows, grid_cols, c, patch, patch)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(b, c, grid_rows * patch, grid_cols * patch)


def compute_loss(
    model: AE,
    batch: Dict[str, Any],
    loss_cfg: LossConfig,
    generator: Optional[torch.Generator] = None,
    feature_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    drop_uniforms: Optional[torch.Tensor] = None,
    tile_indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training forward + loss stack. Returns ``(loss, metrics)``.

    Randomness (drop path, then tile origins) comes from ``generator``;
    ``drop_uniforms`` ``[decoder_depth, B]`` and ``tile_indices``
    ``(start_y, start_x)`` replace the draws where given.
    """
    dev = model.device
    batch = {k: (torch.as_tensor(v).to(dev) if hasattr(v, "shape") else v) for k, v in batch.items()}
    out = model(batch, deterministic=False, generator=generator, drop_uniforms=drop_uniforms)
    mask = batch.get("patch_mask")
    l_char = charbonnier_loss(out["patches"], batch["patches"], mask, eps=loss_cfg.charbonnier_eps)
    loss = loss_cfg.charbonnier_weight * l_char
    metrics = {"loss/charbonnier": l_char.detach()}

    want_tiles = loss_cfg.ssim_weight or (loss_cfg.perceptual_weight and feature_fn is not None)
    if want_tiles and loss_cfg.ssim_grid is not None:
        gr, gc = loss_cfg.ssim_grid
        recon = unpatchify_dense_static(out, gr, gc, loss_cfg.patch)
        target = unpatchify_dense_static(batch, gr, gc, loss_cfg.patch)
        th = min(loss_cfg.tile_size, gr * loss_cfg.patch)
        tw = min(loss_cfg.tile_size, gc * loss_cfg.patch)
        # Both branches are cropped at the same origins.
        tiles_r, idx = sample_tiles(
            recon, batch["orig_height"], batch["orig_width"], n_tiles=loss_cfg.n_tiles,
            tile_size=(th, tw), indices=tile_indices, generator=generator,
        )
        tiles_t, _ = sample_tiles(
            target, batch["orig_height"], batch["orig_width"], n_tiles=loss_cfg.n_tiles,
            tile_size=(th, tw), indices=idx,
        )
        flat_r, flat_t = tiles_r.flatten(0, 1), tiles_t.flatten(0, 1)
        if loss_cfg.ssim_weight:
            l_ssim = ssim_loss(flat_r, flat_t)
            loss = loss + loss_cfg.ssim_weight * l_ssim
            metrics["loss/ssim"] = l_ssim.detach()
        if loss_cfg.perceptual_weight and feature_fn is not None:
            l_perc = perceptual_loss(feature_fn, flat_r, flat_t)
            loss = loss + loss_cfg.perceptual_weight * l_perc
            metrics["loss/perceptual"] = l_perc.detach()

    metrics["loss/total"] = loss.detach()
    return loss, metrics


def _slice_batch(batch: Dict[str, Any], lo: int, hi: int) -> Dict[str, Any]:
    return {k: (v[lo:hi] if hasattr(v, "shape") and getattr(v, "ndim", 0) > 0 else v)
            for k, v in batch.items()}


def make_train_step(
    tx: AdamW,
    loss_cfg: LossConfig = LossConfig(),
    ema_decay: float = 0.999,
    feature_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    grad_accum: int = 1,
):
    """Build the train step ``(state, batch, rng=None) -> (state, metrics)``.

    ``rng`` is a ``torch.Generator`` to draw from, or an integer seed: then
    each step draws from a fresh generator seeded from the seed and
    ``state.step`` (as the JAX package folds the step into its key), so a
    resumed run repeats an uninterrupted one.

    The step updates the state's model, optimizer state and EMA in place and
    returns the same state object with ``step`` advanced. Metrics are 0-d
    tensors on the model's device (nothing is read back here).
    ``grad_accum > 1`` splits the batch along axis 0 into that many
    microbatches (it must divide the batch size), sums their gradients in
    fp32 and takes one optimizer step on their mean; each microbatch's loss
    is its own masked mean. ``drop_uniforms`` and ``tile_indices`` (see
    :func:`compute_loss`) may be passed through for the whole batch.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def step(state: TrainState, batch: Dict[str, Any], rng=None, drop_uniforms=None, tile_indices=None):
        model = state.model
        generator = rng
        if isinstance(rng, int):
            generator = torch.Generator(device=model.device).manual_seed(rng * 1_000_003 + state.step)
        params = [p for p in model.parameters()]
        b = len(batch["patches"])
        if b % grad_accum:
            raise ValueError(f"batch size {b} not divisible by grad_accum {grad_accum}")
        mb = b // grad_accum
        grads = metrics = None
        for i in range(grad_accum):
            lo, hi = i * mb, (i + 1) * mb
            loss, m = compute_loss(
                model, batch if grad_accum == 1 else _slice_batch(batch, lo, hi), loss_cfg, generator,
                feature_fn=feature_fn,
                drop_uniforms=None if drop_uniforms is None else torch.as_tensor(drop_uniforms)[:, lo:hi],
                tile_indices=None if tile_indices is None else tuple(torch.as_tensor(t)[lo:hi] for t in tile_indices),
            )
            g = [x.float() for x in torch.autograd.grad(loss, params)]
            if grads is None:
                grads, metrics = g, m
            else:
                torch._foreach_add_(grads, g)
                metrics = {k: v + m[k] for k, v in metrics.items()}
            del loss, g
        if grad_accum > 1:
            torch._foreach_div_(grads, float(grad_accum))
            metrics = {k: v / grad_accum for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)  # before clipping
        tx.update(params, [g.to(p.dtype) for g, p in zip(grads, params)], state.opt_state)
        if state.ema_params is not None:
            update_ema(state.ema_params, dict(model.named_parameters()), ema_decay)
        state.step += 1
        return state, metrics

    return step


__all__ = [
    "create_schedule",
    "create_optimizer",
    "decay_mask",
    "global_norm",
    "AdamW",
    "TrainState",
    "create_train_state",
    "update_ema",
    "LossConfig",
    "compute_loss",
    "unpatchify_dense_static",
    "make_train_step",
]
