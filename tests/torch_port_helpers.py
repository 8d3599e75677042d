"""Shared helpers of the PyTorch-port tests (`test_torch_*.py`): config
and parameter bridging between the JAX reference and the port."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import jax

from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.convert import _BITCAST, _map, params_from_jax


def port_cfg(cfg) -> PortConfig:
    """The port's ModelConfig with every field of a reference config."""
    return PortConfig(**dataclasses.asdict(cfg))


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def port_params(params, cfg, device="cpu"):
    """Reference params (jax arrays) -> the port's params on `device`."""
    return params_from_jax(np_tree(params), port_cfg(cfg), device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy; bfloat16/float8 come back as their raw bits
    (uint16/uint8) — compare them against the reference's `.view` of the
    same carrier."""
    t = t.detach().cpu().contiguous()
    for dtype, carrier in _BITCAST.values():
        if t.dtype == dtype:
            return t.view(torch.uint16 if carrier is np.uint16
                          else torch.uint8).numpy()
    return t.numpy()


def params_to_numpy(params):
    """The port's params -> the reference's layout as numpy (layers
    restacked over a leading axis; bf16/fp8 leaves as raw bits)."""
    out = {k: _map(v, tensor_to_numpy)
           for k, v in params.items() if k != "layers"}
    per_layer = [_map(p, tensor_to_numpy) for p in params["layers"]]

    def stack(path_trees):
        first = path_trees[0]
        if isinstance(first, dict):
            return {k: stack([t[k] for t in path_trees]) for k in first}
        return np.stack(path_trees)
    out["layers"] = stack(per_layer)
    return out
