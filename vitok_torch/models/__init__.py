"""The NaFlex autoencoder and the DiT over its latents."""

from vitok_torch.models.ae import AE, AEConfig, decode_variant
from vitok_torch.models.dit import DiT, DiTConfig

__all__ = ["AE", "AEConfig", "decode_variant", "DiT", "DiTConfig"]
