"""Data loading for training and tokenization."""

from vitok_torch.data.loaders import (
    HF_DATASETS,
    PrefetchingLoader,
    brace_expand,
    create_dataloader,
    iter_samples,
    iter_tar_samples,
    resolve_source,
    to_rgb,
)
from vitok_torch.pp.io import patch_collate_fn

__all__ = ["create_dataloader", "iter_samples", "to_rgb", "PrefetchingLoader", "HF_DATASETS", "brace_expand",
           "resolve_source", "iter_tar_samples", "patch_collate_fn"]
