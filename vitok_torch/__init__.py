"""vitok_torch: ViTok-v2 NaFlex image tokenizer in PyTorch for one NVIDIA H100.

A port of ``vitok_tpu`` (JAX/Pallas), which stays the reference. bf16
tokenizer inference: ``preprocess`` -> ``AE.encode`` -> ``AE.decode`` ->
``postprocess``, with the fused QK-norm + RoPE + masked attention in a
hand-written Hopper kernel. Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

from vitok_torch.models.ae import AE, AEConfig, decode_variant
from vitok_torch.pp.io import postprocess, preprocess
from vitok_torch.pp.ops import unpack, unpatchify
from vitok_torch.pretrained import load_pretrained_params

__version__ = "0.1.0"

__all__ = [
    "AE",
    "AEConfig",
    "decode_variant",
    "preprocess",
    "postprocess",
    "unpatchify",
    "unpack",
    "load_pretrained_params",
]
