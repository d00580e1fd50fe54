"""Tree utilities of the port (``utils/tree.py``)."""
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
]
