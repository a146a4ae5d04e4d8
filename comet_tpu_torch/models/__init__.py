from .comet import COMET, build_comet, decode_predictions
