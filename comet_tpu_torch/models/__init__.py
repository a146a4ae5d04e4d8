from .comet import COMET, build_comet, decode_predictions, encode_gt, pose_loss
