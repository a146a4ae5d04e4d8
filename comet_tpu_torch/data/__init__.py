from .datasets import (
    AMDDataset,
    DCADataset,
    SequenceSample,
    VideoPoseDataset,
    make_bbox_square,
    mask_bbox,
    sample_evenly,
    sample_with_max_gap,
)
from .device_pipeline import DevicePreprocessDataset, preprocess_frames, preprocess_mask
from .fixtures import generate_amd_fixture, generate_dca_fixture
from .keypoints import (
    denormalize_image,
    detect_corners,
    filter_and_pad,
    grid_points,
    seed_query_points,
)
