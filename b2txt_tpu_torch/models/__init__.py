from .gru_decoder import GRUDecoder, extract_patches, param_count
from .torch_import import (
    load_torch_checkpoint,
    params_from_jax,
    params_from_state_dict,
    params_to_jax,
    state_dict_from_params,
)
