"""Evaluation metrics: Fréchet distances (FID/FDD), SSIM, PSNR.

Port of ``vitok_tpu/metrics.py``: the same update/gather accumulator design,
fp64 mean + covariance streamed on the host, the eps-regularised ``sqrtm``
Fréchet distance, and per-image SSIM/PSNR at native size. SSIM and PSNR run
on the images' device through ``vitok_torch.losses``, one call per shape
group; feature extractors are pluggable callables (``vitok_torch.eval_features``).
Across processes the accumulators are summed over ``torch.distributed`` when a
process group is initialised, and nothing happens otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vitok_torch.losses import psnr as _psnr_fn, ssim as _ssim_fn

FeatureFn = Callable[[Sequence[torch.Tensor]], np.ndarray]


# ---------------------------------------------------------------------------
# Fréchet distance
# ---------------------------------------------------------------------------


def calculate_frechet_distance(
    mu1: np.ndarray,
    sigma1: np.ndarray,
    mu2: np.ndarray,
    sigma2: np.ndarray,
    eps: float = 1e-6,
) -> float:
    """Classic FID formula in fp64, with an eps-regularised ``sqrtm`` retry
    when the product of the covariances has no finite square root."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    # ``sqrtm`` without ``disp``, which newer scipy drops: the same array
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def _allreduce_sum(values: np.ndarray) -> np.ndarray:
    """Sum of ``values`` (fp64) over the processes of the default group, or
    ``values`` itself without one."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return values
    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
    t = torch.from_numpy(np.ascontiguousarray(values, np.float64)).to(device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# Streaming fp64 mean + covariance
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MeanCovAccumulator:
    """Streams n, Σx and Σ(x xᵀ) in fp64; mergeable across processes."""

    dim: int
    n: float = 0.0
    s: Optional[np.ndarray] = None
    outer: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.s is None:
            self.s = np.zeros((self.dim,), np.float64)
        if self.outer is None:
            self.outer = np.zeros((self.dim, self.dim), np.float64)

    def update(self, feats: np.ndarray) -> None:
        f = np.asarray(feats, np.float64)
        self.n += f.shape[0]
        self.s += f.sum(axis=0)
        self.outer += f.T @ f

    def merge(self, other: "MeanCovAccumulator") -> None:
        self.n += other.n
        self.s += other.s
        self.outer += other.outer

    def allreduce(self) -> None:
        """Sum over the processes of the default ``torch.distributed`` group."""
        summed = _allreduce_sum(np.concatenate([[self.n], self.s, self.outer.ravel()]))
        self.n = float(summed[0])
        self.s = summed[1 : 1 + self.dim]
        self.outer = summed[1 + self.dim :].reshape(self.dim, self.dim)

    def finalize(self):
        if self.n < 2:
            raise ValueError("Need >= 2 samples for covariance")
        mu = self.s / self.n
        cov = (self.outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov


@dataclasses.dataclass
class MeanAccumulator:
    total: float = 0.0
    count: float = 0.0

    def update(self, values) -> None:
        v = np.asarray(values, np.float64).ravel()
        self.total += v.sum()
        self.count += v.size

    def allreduce(self) -> None:
        summed = _allreduce_sum(np.array([self.total, self.count], np.float64))
        self.total, self.count = float(summed[0]), float(summed[1])

    def finalize(self) -> float:
        return self.total / max(self.count, 1.0)


# ---------------------------------------------------------------------------
# SSIM / PSNR at native size
# ---------------------------------------------------------------------------


def compute_ssim(ref: torch.Tensor, recon: torch.Tensor, data_range: float = 2.0) -> float:
    """SSIM for one image pair ``[C, H, W]`` (adaptive odd kernel <= 11)."""
    return float(_ssim_fn(ref[None], recon[None], data_range=data_range, reduce=True))


def compute_psnr(ref: torch.Tensor, recon: torch.Tensor, data_range: float = 2.0) -> float:
    return float(_psnr_fn(ref[None], recon[None], data_range=data_range))


# ---------------------------------------------------------------------------
# MetricCalculator
# ---------------------------------------------------------------------------


class MetricCalculator:
    """update/gather metric accumulator over (reference, reconstruction) pairs.

    Args:
        metrics: subset of {"fid", "fdd", "ssim", "psnr"}.
        fid_feature_fn / fdd_feature_fn: callables mapping a list of
            ``[C, H, W]`` images in [-1, 1] to ``[B, F]`` numpy features
            (``vitok_torch.eval_features``: InceptionV3 pool-2048 for FID,
            a DINO ViT CLS token for FDD).
        chunk: feature-extraction micro-batch (64, as the reference).
    """

    def __init__(
        self,
        metrics: Sequence[str] = ("ssim", "psnr"),
        fid_feature_fn: Optional[FeatureFn] = None,
        fdd_feature_fn: Optional[FeatureFn] = None,
        chunk: int = 64,
        data_range: float = 2.0,
    ):
        self.metrics = tuple(metrics)
        self.chunk = chunk
        self.data_range = data_range
        self._fid_fn = fid_feature_fn
        self._fdd_fn = fdd_feature_fn
        if "fid" in self.metrics and fid_feature_fn is None:
            raise ValueError("fid metric requires fid_feature_fn")
        if "fdd" in self.metrics and fdd_feature_fn is None:
            raise ValueError("fdd metric requires fdd_feature_fn")
        # name -> (reference, reconstruction) accumulators, made at the first update
        self._frechet: Dict[str, Tuple[MeanCovAccumulator, MeanCovAccumulator]] = {}
        self._ssim = MeanAccumulator()
        self._psnr = MeanAccumulator()
        self._n_images = 0

    def _extract(self, fn: FeatureFn, images: List[torch.Tensor]) -> np.ndarray:
        feats = [np.asarray(fn(images[i : i + self.chunk])) for i in range(0, len(images), self.chunk)]
        return np.concatenate(feats, axis=0)

    def update(self, refs: List[torch.Tensor], recons: List[torch.Tensor]) -> None:
        """Accumulate a batch of per-image tensors ``[C, H, W]`` in [-1, 1]."""
        if len(refs) != len(recons):
            raise ValueError(f"{len(refs)} references for {len(recons)} reconstructions")
        self._n_images += len(refs)

        if "ssim" in self.metrics or "psnr" in self.metrics:
            # SSIM and PSNR are per image: same-shape pairs stacked give the
            # same numbers in one call per shape instead of one per image.
            groups: dict = {}
            for r, x in zip(refs, recons):
                groups.setdefault(tuple(r.shape), []).append((r, x))
            for pairs in groups.values():
                rs = torch.stack([r for r, _ in pairs])
                xs = torch.stack([x for _, x in pairs])
                if "ssim" in self.metrics:
                    self._ssim.update(
                        _ssim_fn(rs, xs, data_range=self.data_range, reduce=False).cpu().numpy())
                if "psnr" in self.metrics:
                    self._psnr.update(
                        _psnr_fn(rs, xs, data_range=self.data_range, reduce=False).cpu().numpy())

        for name, fn in (("fid", self._fid_fn), ("fdd", self._fdd_fn)):
            if name not in self.metrics:
                continue
            f_ref = self._extract(fn, refs)
            f_rec = self._extract(fn, recons)
            acc_ref, acc_rec = self._frechet.setdefault(
                name, (MeanCovAccumulator(f_ref.shape[1]), MeanCovAccumulator(f_rec.shape[1])))
            acc_ref.update(f_ref)
            acc_rec.update(f_rec)

    def gather(self) -> Dict[str, float]:
        """Final stats, summed across processes first."""
        out: Dict[str, float] = {"n_images": float(self._n_images)}
        if "ssim" in self.metrics:
            self._ssim.allreduce()
            out["ssim"] = self._ssim.finalize()
        if "psnr" in self.metrics:
            self._psnr.allreduce()
            out["psnr"] = self._psnr.finalize()
        for name, (acc_ref, acc_rec) in self._frechet.items():
            acc_ref.allreduce()
            acc_rec.allreduce()
            mu1, s1 = acc_ref.finalize()
            mu2, s2 = acc_rec.finalize()
            out[name] = calculate_frechet_distance(mu1, s1, mu2, s2)
        return out


__all__ = [
    "calculate_frechet_distance",
    "MeanCovAccumulator",
    "MeanAccumulator",
    "MetricCalculator",
    "compute_ssim",
    "compute_psnr",
]
