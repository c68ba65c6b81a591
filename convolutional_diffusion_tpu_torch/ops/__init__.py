"""Compute primitives: patch extraction and the fused flash-score sweep."""

from .flash_score import flash_score_update, state_from_kernel, state_to_kernel
from .patches import center_index, extract_patches, pad_image, patch_centers

__all__ = [
    "flash_score_update",
    "state_to_kernel",
    "state_from_kernel",
    "extract_patches",
    "pad_image",
    "patch_centers",
    "center_index",
]
