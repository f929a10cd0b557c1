"""Bilinear sampling with challenge-parity semantics, world-to-grid
transforms, and the C library's float32 sine and cosine."""
from strajnet_tpu_torch.core.sampling import (
    BorderType,
    PixelType,
    ResamplingType,
    dense_image_warp,
    interpolate_bilinear,
    sample,
)
from strajnet_tpu_torch.core.grid import transform_to_image_coordinates

__all__ = [
    "BorderType",
    "PixelType",
    "ResamplingType",
    "dense_image_warp",
    "interpolate_bilinear",
    "sample",
    "transform_to_image_coordinates",
]
