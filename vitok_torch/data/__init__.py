"""Data loading for training and tokenization."""

from vitok_torch.data.loaders import (
    PrefetchingLoader,
    create_dataloader,
    iter_samples,
    to_rgb,
)

__all__ = ["create_dataloader", "iter_samples", "to_rgb", "PrefetchingLoader"]
