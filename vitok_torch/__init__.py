"""vitok_torch: ViTok-v2 NaFlex image tokenizer in PyTorch for one NVIDIA H100.

A port of ``vitok_tpu`` (JAX/Pallas), which stays the reference. Tokenizer
inference in bf16, and in int8 after ``AE.quantize()``: ``preprocess`` ->
``AE.encode`` -> ``AE.decode`` -> ``postprocess``, at any resolution and
with sliding windows, and bucketed serving (``ServingPipeline``); and
single-device tokenizer training (``train_lib``, ``losses``, ``data``,
``python -m vitok_torch.scripts.train_vae``); and the generation family:
the ``DiT`` over ViTok latents, the UniPC flow sampler (``unipc``),
``python -m vitok_torch.scripts.generate`` and
``python -m vitok_torch.scripts.train_dit``; and eval: rFID/rFDD/SSIM/PSNR
(``metrics``, ``eval_features``, the FID InceptionV3 and the DINO ViT under
``models``, ``python -m vitok_torch.scripts.eval_vae``). The fused QK-norm + RoPE +
masked attention (up to 1024 tokens), its backward and its int8-epilogue
instance, the flash attention forward and its two backward kernels (2048
tokens and up) and the int8 block's RMSNorm + quantize, fused fc1 + SwiGLU +
requantize and SwiGLU + quantize are hand-written Hopper kernels. Entry points run on the card unless the caller
passes ``device="cpu"``. The distributed layers (data, FSDP2, tensor,
sequence and pipeline parallelism) are ``vitok_torch.parallel``.

As in the JAX package, the preprocessing registry, the loaders and the
pretrained registry are re-exported lazily (``build_transform``, ``OPS``,
``patchify_image``, ``create_dataloader``, ``patch_collate_fn``,
``load_pretrained``, ``list_pretrained``, ``get_pretrained_info``).
"""

from vitok_torch.models.ae import AE, AEConfig, Model, decode_variant
from vitok_torch.models.dit import DiT, DiTConfig
from vitok_torch.pp.io import postprocess, preprocess
from vitok_torch.pp.ops import unpack, unpatchify
from vitok_torch.pretrained import load_pretrained_params
from vitok_torch.serving import ServingPipeline, TokenBucketer
from vitok_torch.unipc import FlowUniPCMultistepScheduler, sample_flow_unipc_device

__version__ = "0.1.0"

# Imported on first use, so that ``import vitok_torch`` stays light.
_LAZY = {
    "build_transform": "vitok_torch.pp.registry",
    "OPS": "vitok_torch.pp.ops",
    "patchify_image": "vitok_torch.pp.ops",
    "create_dataloader": "vitok_torch.data.loaders",
    "patch_collate_fn": "vitok_torch.pp.io",
    "load_pretrained": "vitok_torch.pretrained",
    "list_pretrained": "vitok_torch.pretrained",
    "get_pretrained_info": "vitok_torch.pretrained",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'vitok_torch' has no attribute {name!r}")


__all__ = [
    "AE",
    "AEConfig",
    "Model",
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
    *sorted(_LAZY),
]
