"""vitok_torch: ViTok-v2 NaFlex image tokenizer in PyTorch for one NVIDIA H100.

A port of ``vitok_tpu`` (JAX/Pallas), which stays the reference. Tokenizer
inference in bf16, and in int8 after ``AE.quantize()``: ``preprocess`` ->
``AE.encode`` -> ``AE.decode`` -> ``postprocess``, at any resolution and
with sliding windows, and bucketed serving (``ServingPipeline``). The fused
QK-norm + RoPE + masked attention (up to 1024 tokens), the flash attention
forward (2048 tokens and up) and the int8 block's RMSNorm + quantize, fused
fc1 + SwiGLU + requantize and SwiGLU + quantize are hand-written Hopper
kernels. Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from vitok_torch.models.ae import AE, AEConfig, decode_variant
from vitok_torch.pp.io import postprocess, preprocess
from vitok_torch.pp.ops import unpack, unpatchify
from vitok_torch.pretrained import load_pretrained_params
from vitok_torch.serving import ServingPipeline, TokenBucketer

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
    "ServingPipeline",
    "TokenBucketer",
]
