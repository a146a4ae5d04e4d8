"""The port's kernels and the plain PyTorch ops around them. Importing the
package registers the kernels as ``comet::`` operators (``library.py``)."""

from . import library  # noqa: F401
from .bilinear import (
    bilinear_sample, interp_matrix_align_corners, resize_bilinear_align_corners, sample_features,
)
from .corr import (
    avg_pool_2x2, build_fmap_pyramid, corr_pyramid_sample, corr_volume_pyramid_sample,
    extract_patches, extract_patches_ex,
)
