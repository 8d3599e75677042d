"""Logging and device helpers."""
from repro_torch.utils.tree import (
    tree_size_bytes,
    tree_num_params,
    tree_flatten_with_names,
    tree_allclose,
    tree_any_nan,
)
from repro_torch.utils.logging import get_logger
