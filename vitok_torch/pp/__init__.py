"""NaFlex preprocessing: host ops, the pp-string DSL, preprocess/postprocess."""

from vitok_torch.pp.io import patch_collate_fn, postprocess, preprocess
from vitok_torch.pp.ops import (
    OPS,
    fit_to_token_budget,
    patchify,
    patchify_array,
    patchify_image,
    sample_tile_indices,
    sample_tiles,
    unpack,
    unpatchify,
)
from vitok_torch.pp.registry import build_transform, parse_op

__all__ = [
    "OPS",
    "patchify",
    "patchify_array",
    "patchify_image",
    "unpatchify",
    "unpack",
    "sample_tile_indices",
    "sample_tiles",
    "fit_to_token_budget",
    "build_transform",
    "parse_op",
    "preprocess",
    "postprocess",
    "patch_collate_fn",
]
