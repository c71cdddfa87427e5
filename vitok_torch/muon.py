"""Muon (MomentUm Orthogonalized by Newton-Schulz), with Adam on the rest.

Port of ``vitok_tpu/muon.py``. The weight of every ``nn.Linear`` (the JAX
package's ``kernel`` leaves) takes NS-orthogonalized Nesterov momentum;
every other parameter (norm gains, LayerScale gammas, biases, the DiT's
class table ``ctx_embed``) takes Adam. Global-norm clipping runs first, over
all gradients. Muon takes no weight decay, as in the JAX package.

The orthogonalization is quintic Newton-Schulz in bf16 with the JAX
package's rounding points: the first Gram matrix in fp32 gives the
normalizer ``||G||_F`` and the first step, every later product is rounded
to bf16, and the polynomial is evaluated in bf16. Matrices of one shape are
orthogonalized together as one batched product, as the JAX package does a
scan-stacked ``[depth, in, out]`` leaf.

The torch weight is ``[out, in]``, the transpose of the JAX kernel; the
polar factor commutes with the transpose, and the scale
``max(1, in / out) ** 0.5`` is written in the torch orientation.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from vitok_torch.parallel.sharding import local
from vitok_torch.train_lib import Schedule, adam_direction, clip_by_global_norm_

# Quintic Newton-Schulz coefficients (the standard Muon constants).
_NS_COEFFS = (3.4445, -4.7750, 2.0315)


def _gram_f32(x: torch.Tensor) -> torch.Tensor:
    """``x @ x^T`` of a bf16 ``[..., m, n]`` tensor in fp32 (the products of
    bf16 values are exact in fp32): one bf16 product with fp32 output on
    the card, the fp32 product of the upcast values on the host."""
    if x.is_cuda:
        x3 = x.reshape(-1, *x.shape[-2:])
        return torch.bmm(x3, x3.mT, out_dtype=torch.float32).reshape(*x.shape[:-1], x.shape[-2])
    x32 = x.float()
    return torch.matmul(x32, x32.mT)


def newton_schulz_orthogonalize(g: torch.Tensor, steps: int = 4) -> torch.Tensor:
    """Approximate the orthogonal polar factor of ``g`` (``[..., m, n]``),
    in bf16; the iteration runs on the transpose when ``m > n``. Every bf16
    product accumulates in fp32 and is rounded once.

    Per step ``G = X X^T`` once, then ``X <- a X + (b G + c G^2) X``; the
    first step's ``G`` is the fp32 Gram matrix of the unscaled input over
    ``sigma2 = ||G||_F + 1e-12`` (``>= sigma_max^2``), and the input is
    scaled by ``sqrt(sigma2)``.
    """
    bf16 = torch.bfloat16
    a, b, c = (torch.tensor(v, dtype=bf16, device=g.device) for v in _NS_COEFFS)
    transpose = g.shape[-2] > g.shape[-1]
    x = g.to(bf16)
    if transpose:
        x = x.mT

    def poly_step(x, gram):
        poly = b * gram + c * torch.matmul(gram, gram)
        return a * x + torch.matmul(poly, x)

    g1 = _gram_f32(x)
    sigma2 = g1.square().sum((-2, -1), keepdim=True).sqrt() + 1e-12
    x = (x.float() / sigma2.sqrt()).to(bf16)
    x = poly_step(x, (g1 / sigma2).to(bf16))
    for _ in range(max(steps - 1, 0)):
        x = poly_step(x, torch.matmul(x, x.mT))
    return x.mT if transpose else x


def matrix_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> whether Muon orthogonalizes it: the weight of every
    ``nn.Linear`` (the JAX package's ``_is_matrix``: leaves named ``kernel``
    with ndim >= 2). ``ctx_embed`` is not one, though weight decay takes it."""
    linear = {id(m.weight) for m in model.modules() if isinstance(m, nn.Linear)}
    return {name: id(p) in linear and p.ndim >= 2 for name, p in model.named_parameters()}


def muon_directions(grads: List[torch.Tensor], momentum_buf: List[torch.Tensor], momentum: float = 0.95,
                    nesterov: bool = True, ns_steps: int = 4, whole=None, part=None) -> List[torch.Tensor]:
    """``scale_by_muon``: advance the momentum ``m <- momentum * m + g`` in
    place (stored in the buffer's dtype, then read back) and return the
    unscaled-by-lr directions ``scale * NS(momentum * m + g)`` in the
    gradients' dtype, ``scale = max(1, in / out) ** 0.5``.

    Sharded matrices (FSDP, tensor parallelism): ``whole(k, t)`` gives the
    k-th matrix's whole tensor from this rank's part ``t`` and ``part(k,
    full)`` takes this rank's part back; Newton-Schulz runs on the whole
    matrix (the JAX package gets this from XLA)."""
    low = any(m.dtype != g.dtype for m, g in zip(momentum_buf, grads))
    mom = [m.to(g.dtype) for m, g in zip(momentum_buf, grads)] if low else momentum_buf
    torch._foreach_mul_(mom, momentum)
    torch._foreach_add_(mom, grads)
    if low:  # stored rounded, and the direction reads the stored value
        for m, m32 in zip(momentum_buf, mom):
            m.copy_(m32)
        mom = [m.to(g.dtype) for m, g in zip(momentum_buf, grads)]
    if nesterov:
        mom = torch._foreach_mul(mom, momentum)
        torch._foreach_add_(mom, grads)
    if whole is not None:
        mom = [whole(k, m) for k, m in enumerate(mom)]
    by_shape: Dict[tuple, List[int]] = {}
    for i, m in enumerate(mom):
        by_shape.setdefault(tuple(m.shape), []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(mom)
    for shape, idx in by_shape.items():
        ortho = newton_schulz_orthogonalize(torch.stack([mom[i].to(torch.bfloat16) for i in idx]), ns_steps)
        scale = torch.tensor(max(1.0, shape[-1] / shape[-2]) ** 0.5, dtype=torch.bfloat16, device=ortho.device)
        ortho = ortho * scale
        for k, i in enumerate(idx):
            out[i] = (ortho[k] if part is None else part(i, ortho[k])).to(grads[i].dtype)
    return out


class Muon:
    """Global-norm clipping, then Muon on the matrices and Adam on the rest.

    ``init(model)`` gives the state: the step count, the momentum of each
    matrix (in ``moment_dtype`` when given) and Adam's two fp32 moments of
    each other parameter. ``update(params, grads, state)`` clips ``grads``
    in place and updates ``params`` in place: the matrices by
    ``-lr * direction``, the rest by ``-adam_lr_scale * lr * adam``, with
    ``lr = schedule(count)``.
    """

    def __init__(self, schedule: Schedule, momentum: float = 0.95, nesterov: bool = True, ns_steps: int = 4,
                 adam_b1: float = 0.9, adam_b2: float = 0.99, adam_eps: float = 1e-8, adam_lr_scale: float = 1.0,
                 grad_clip: Optional[float] = 1.0, moment_dtype: Optional[torch.dtype] = None):
        self.schedule = schedule
        self.momentum, self.nesterov, self.ns_steps = momentum, nesterov, ns_steps
        self.b1, self.b2, self.eps = adam_b1, adam_b2, adam_eps
        self.adam_lr_scale = adam_lr_scale
        self.grad_clip = grad_clip
        self.moment_dtype = moment_dtype

    def init(self, model: nn.Module) -> Dict[str, Any]:
        return self.init_params([local(p) for p in model.parameters()], list(matrix_mask(model).values()))

    def init_params(self, params: List[torch.Tensor], is_matrix: List[bool]) -> Dict[str, Any]:
        """The state of ``params`` (in ``update``'s order), with Muon on
        those ``is_matrix`` marks and Adam on the rest."""
        self._matrix = list(is_matrix)
        mats = [p for p, m in zip(params, self._matrix) if m]
        rest = [p for p, m in zip(params, self._matrix) if not m]
        return {
            "count": 0,
            "momentum": [torch.zeros_like(p, dtype=self.moment_dtype or p.dtype) for p in mats],
            "mu": [torch.zeros_like(p) for p in rest],
            "nu": [torch.zeros_like(p) for p in rest],
        }

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict[str, Any],
               layout=None) -> None:
        """``params`` and ``grads``: each rank's local tensors; ``layout``
        (sharded ones) gives the global norm and the whole matrices."""
        if self.grad_clip:
            clip_by_global_norm_(grads, self.grad_clip, layout)
        lr = self.schedule(state["count"])
        state["count"] += 1
        mat_p = [p for p, m in zip(params, self._matrix) if m]
        mat_g = [g for g, m in zip(grads, self._matrix) if m]
        rest_p = [p for p, m in zip(params, self._matrix) if not m]
        rest_g = [g for g, m in zip(grads, self._matrix) if not m]
        if mat_p:
            whole = part = None
            if layout is not None and (layout.fsdp or layout.tp):
                index = [i for i, m in enumerate(self._matrix) if m]
                whole = lambda k, t: layout.full(index[k], t)
                part = lambda k, t: layout.local_of(index[k], t)
            dirs = muon_directions(mat_g, state["momentum"], self.momentum, self.nesterov, self.ns_steps,
                                   whole, part)
            torch._foreach_add_(mat_p, dirs, alpha=-lr)
        if rest_p:
            upd = adam_direction(rest_g, state["mu"], state["nu"], state["count"], self.b1, self.b2, self.eps)
            torch._foreach_add_(rest_p, upd, alpha=-self.adam_lr_scale * lr)


__all__ = ["Muon", "newton_schulz_orthogonalize", "muon_directions", "matrix_mask"]
