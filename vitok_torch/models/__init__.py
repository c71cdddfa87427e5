"""The NaFlex autoencoder and the DiT over its latents."""

from vitok_torch.models.ae import AE, AEConfig, Model, decode_variant, num_params
from vitok_torch.models.dit import DiT, DiTConfig

__all__ = ["AE", "AEConfig", "Model", "decode_variant", "num_params", "DiT", "DiTConfig"]
