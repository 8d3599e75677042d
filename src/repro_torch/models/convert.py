"""Parameter bridge from the reference's layout to the port's.

The reference stacks repeated blocks on leading axes (it scans over
them); the port keeps lists (it loops): `layers` (L, ...) becomes a list
of L per-layer dicts (dense, MoE and ssm families), and for the hybrid
family `mamba` (G, P, ...) a
G x P nested list, `shared` (num_shared_blocks, ...) a list of block
dicts and `group_proj` (G, 2d, d) a list of G matrices.  Weights keep
the reference's (d_in, d_out) layout in both, so `x @ w` is the same
product.  ResNet-50's convolution weights are the exception: HWIO in the
reference, OIHW in `channels_last` in the port (`resnet_params_from_jax`).  The bridge goes through numpy; bfloat16 and float8 arrays
(ml_dtypes on the numpy side) cross as raw bits, so every leaf arrives
bit-exact.
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


def _unstack(tree, shape, fn, index=()):
    """Nested lists of `shape` whose entries are `tree` with its leading
    axes indexed, each leaf through `fn`."""
    if not shape:
        return _map(tree, lambda a: fn(a[index]))
    return [_unstack(tree, shape[1:], fn, index + (i,))
            for i in range(shape[0])]


def stacked_axes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The reference's stacked top-level keys of `cfg`'s family and the
    lengths of their leading axes."""
    if cfg.family == "hybrid":
        G = cfg.num_layers // cfg.shared_attn_period
        return {"mamba": (G, cfg.shared_attn_period),
                "shared": (cfg.num_shared_blocks,), "group_proj": (G,)}
    return {"layers": (cfg.num_layers,)}


def params_from_jax(np_tree, cfg: ModelConfig, device):
    """Reference param pytree (numpy leaves) -> the port's params on
    `device`, every stacked key split into lists (`stacked_axes`)."""
    def to(a):
        return tensor_from_numpy(a, device)
    stacked = stacked_axes(cfg)
    out = {k: _map(v, to) for k, v in np_tree.items() if k not in stacked}
    for k, shape in stacked.items():
        out[k] = _unstack(np_tree[k], shape, to)
    return out


def resnet_params_from_jax(np_tree, device):
    """Reference ResNet-50 params (numpy leaves; conv weights HWIO) ->
    the port's (`models/resnet.py`: conv weights OIHW in
    `channels_last`, the rest as they are) on `device`."""
    def conv(p):
        w = tensor_from_numpy(np.transpose(p["w"], (3, 2, 0, 1)), device)
        return {"w": w.contiguous(memory_format=torch.channels_last),
                "scale": tensor_from_numpy(p["scale"], device),
                "bias": tensor_from_numpy(p["bias"], device)}
    out = {}
    for name, p in np_tree.items():
        if name == "fc":
            out[name] = _map(p, lambda a: tensor_from_numpy(a, device))
        elif name == "conv1":
            out[name] = conv(p)
        else:
            out[name] = {k: conv(v) for k, v in p.items()}
    return out
