"""Post-processing of styled outputs: video assembly, texture and image
masking."""

from stylemesh_tpu_torch.texturing.mask_image import mask_image
from stylemesh_tpu_torch.texturing.mask_texture import (
    compute_texture_mask,
    mask_texture,
)
from stylemesh_tpu_torch.texturing.video import video_from_files

__all__ = ["compute_texture_mask", "mask_texture", "mask_image",
           "video_from_files"]
