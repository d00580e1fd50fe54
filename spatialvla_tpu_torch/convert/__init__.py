from .bridge import from_numpy_tree, map_tree, to_numpy_tree
from .export_hf import (
    config_to_hf,
    export_hf_checkpoint,
    spatialvla_to_state_dict,
)
from .params import (
    ego3d_from_state_dict,
    gemma2_from_state_dict,
    siglip_from_state_dict,
    spatialvla_from_state_dict,
)

__all__ = [
    "config_to_hf",
    "ego3d_from_state_dict",
    "export_hf_checkpoint",
    "from_numpy_tree",
    "gemma2_from_state_dict",
    "map_tree",
    "siglip_from_state_dict",
    "spatialvla_from_state_dict",
    "spatialvla_to_state_dict",
    "to_numpy_tree",
]
