"""The NaFlex autoencoder."""

from vitok_torch.models.ae import AE, AEConfig, decode_variant

__all__ = ["AE", "AEConfig", "decode_variant"]
