"""vitok_torch: ViTok-v2 NaFlex image tokenizer in PyTorch for one NVIDIA H100.

A port of ``vitok_tpu`` (JAX/Pallas), which stays the reference. Tokenizer
inference in bf16, and in int8 after ``AE.quantize()``: ``preprocess`` ->
``AE.encode`` -> ``AE.decode`` -> ``postprocess``, at any resolution and
with sliding windows, and bucketed serving (``ServingPipeline``); and
single-device tokenizer training (``train_lib``, ``losses``, ``data``,
``python -m vitok_torch.scripts.train_vae``); and the generation family:
the ``DiT`` over ViTok latents, the UniPC flow sampler (``unipc``),
``python -m vitok_torch.scripts.generate`` and
``python -m vitok_torch.scripts.train_dit``. The fused QK-norm + RoPE +
masked attention (up to 1024 tokens), its backward and its int8-epilogue
instance, the flash attention forward and its two backward kernels (2048
tokens and up) and the int8 block's RMSNorm + quantize, fused fc1 + SwiGLU +
requantize and SwiGLU + quantize are hand-written Hopper kernels. Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

from vitok_torch.models.ae import AE, AEConfig, decode_variant
from vitok_torch.models.dit import DiT, DiTConfig
from vitok_torch.pp.io import postprocess, preprocess
from vitok_torch.pp.ops import unpack, unpatchify
from vitok_torch.pretrained import load_pretrained_params
from vitok_torch.serving import ServingPipeline, TokenBucketer
from vitok_torch.unipc import FlowUniPCMultistepScheduler, sample_flow_unipc_device

__version__ = "0.1.0"

__all__ = [
    "AE",
    "AEConfig",
    "decode_variant",
    "DiT",
    "DiTConfig",
    "FlowUniPCMultistepScheduler",
    "sample_flow_unipc_device",
    "preprocess",
    "postprocess",
    "unpatchify",
    "unpack",
    "load_pretrained_params",
    "ServingPipeline",
    "TokenBucketer",
]
