"""Parameter bridge from the reference's layout to the port's.

The reference keeps one pytree whose `params["layers"]` leaves carry a
leading layer axis (it scans over them); the port keeps a list of
per-layer dicts (it loops).  Weights keep the reference's (d_in, d_out)
layout in both, so `x @ w` is the same product.  The bridge goes through
numpy; bfloat16 and float8 arrays (ml_dtypes on the numpy side) cross as
raw bits, so every leaf arrives bit-exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

# numpy (ml_dtypes) dtype name -> (torch dtype, same-width carrier)
_BITCAST = {"bfloat16": (torch.bfloat16, np.uint16),
            "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8)}


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)                  # a writable, contiguous host copy
    if a.dtype.name in _BITCAST:
        dtype, carrier = _BITCAST[a.dtype.name]
        return torch.from_numpy(a.view(carrier)).view(dtype).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_tree, cfg: ModelConfig, device):
    """Reference param pytree (numpy leaves) -> the port's params on
    `device`: the stacked leading-L `layers` axis is split into
    `cfg.num_layers` per-layer dicts."""
    out = {k: _map(v, lambda a: tensor_from_numpy(a, device))
           for k, v in np_tree.items() if k != "layers"}
    out["layers"] = [
        _map(np_tree["layers"], lambda a, i=i: tensor_from_numpy(a[i], device))
        for i in range(cfg.num_layers)]
    return out
