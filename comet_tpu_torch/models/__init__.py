from .blocks import AttnBlock, CrossAttnBlock, InstanceNorm, Mlp, MultiHeadAttention, ResidualBlock
from .encoders import BasicEncoder, ShallowEncoder
from .update_former import EfficientUpdateFormer
from .tracker import BaseTracker, TrackerOutput, tracker_transformer_dim
from .refine import compute_score_fn, refine_track
from .vit import DinoViT, ViTBlock
from .camera_predictor import CameraPredictions, CameraPredictor
from .comet import COMET, build_comet, decode_predictions, encode_gt, pose_loss
