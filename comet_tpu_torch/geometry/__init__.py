from .cameras import CameraSet, make_camera_set
from .codecs import (
    INTRINSICS_TABLE,
    Intrinsics,
    decode_relative_uvz,
    decode_relative_xyz,
    encode_relative_uvz,
    encode_relative_xyz,
)
from .embeddings import (
    embed_2d_coords,
    sincos_1d_from_grid,
    sincos_2d_pos_embed,
    sincos_2d_pos_embed_grid,
    sincos_time_embed,
)
from .quaternions import quat_conjugate, quat_invert, quat_multiply, quat_standardize
