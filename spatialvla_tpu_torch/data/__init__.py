from . import augment, native, oxe_registry, standardize, statistics, tfds_schema, tfrecord, transforms
from .loader import VLABatcher
from .oxe_registry import (
    DATASET_CONFIGS,
    NAMED_MIXTURES,
    ActionEncoding,
    OXEDatasetConfig,
    StateEncoding,
    get_config,
    resolve_mixture,
)
from .pipeline import (
    FrameTransformConfig,
    InterleavedRLDSDataset,
    RLDSDataSource,
    TrajTransformConfig,
)
