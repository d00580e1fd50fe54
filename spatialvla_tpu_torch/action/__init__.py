from .bin_policy import (
    RANGE_BINS,
    adapt_spatial_embeddings,
    gaussian_bin_policy,
    make_bin_policy,
    norm_meshgrid,
    uniform_bin_policy,
)
from .tokenizer import (
    ACTION_TOKEN,
    DEFAULT_NUM_BINS,
    GripperTokenizer,
    RotationTokenizer,
    SpatialActionTokenizer,
    TranslationTokenizer,
    UniformActionTokenizer,
    cartesian_to_spherical,
    spherical_to_cartesian,
)

__all__ = [
    "ACTION_TOKEN",
    "DEFAULT_NUM_BINS",
    "RANGE_BINS",
    "GripperTokenizer",
    "RotationTokenizer",
    "SpatialActionTokenizer",
    "TranslationTokenizer",
    "UniformActionTokenizer",
    "adapt_spatial_embeddings",
    "cartesian_to_spherical",
    "gaussian_bin_policy",
    "make_bin_policy",
    "norm_meshgrid",
    "spherical_to_cartesian",
    "uniform_bin_policy",
]
