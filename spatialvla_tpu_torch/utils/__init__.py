"""Tree utilities (``utils/tree.py``) and profiling helpers
(``utils/profiling.py``) of the port."""
from .profiling import sync, timeit, trace
from .tree import (children, count_params, iter_leaves, leaves_with_paths, map_with_paths,
                   param_summary, path_str)

__all__ = [
    "children",
    "count_params",
    "iter_leaves",
    "leaves_with_paths",
    "map_with_paths",
    "param_summary",
    "path_str",
    "sync",
    "timeit",
    "trace",
]
