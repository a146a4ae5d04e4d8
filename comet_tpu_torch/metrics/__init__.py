from .pose_metrics import (
    quat_to_matrix_np,
    matrix_to_quat_np,
    se3_row_np,
    se3_inverse_row_np,
    euler_xyz_from_matrix_np,
    rotation_angle_deg,
    translation_angle_deg,
    all_pairs_indices,
    pairwise_se3_errors,
    relative_frame_errors,
    auc_histogram,
    auc_from_histogram_prefix,
)
