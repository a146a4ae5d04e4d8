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
from .quaternions import (
    euler_xyz_from_matrix,
    geodesic_angle_from_matrices,
    matrix_to_quat,
    quat_conjugate,
    quat_invert,
    quat_multiply,
    quat_normalize,
    quat_standardize,
    quat_to_matrix,
    random_quaternions,
    rotation_angle_from_quats,
    se3_inverse_row_convention,
    se3_matrix_row_convention,
)
