from .export import export_sequence_json
from .serialization import (
    cast_params_for_inference, load_params, load_params_msgpack, save_params, save_params_msgpack,
)
