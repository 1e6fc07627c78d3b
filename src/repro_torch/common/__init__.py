"""Tree helpers of the port (``repro.common``)."""
from repro_torch.common.pytree import (
    key_str,
    replace,
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_map_n,
    tree_map_with_path,
)

__all__ = ["key_str", "replace", "tree_leaves", "tree_leaves_with_path",
           "tree_map", "tree_map_n",
           "tree_map_with_path"]
