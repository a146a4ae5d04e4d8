from .export import export_sequence_json
from .serialization import cast_params_for_inference, load_params, save_params
