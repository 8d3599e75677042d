"""Shared helpers of the PyTorch-port tests (`test_torch_*.py`): config
and parameter bridging between the JAX reference and the port, for the
dense, MoE and hybrid families, and the one-thread module fixture."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import jax

from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.convert import (_BITCAST, _map, params_from_jax,
                                       stacked_axes)


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


def params_to_numpy(params, cfg):
    """The port's params -> the reference's layout as numpy (every
    stacked key restacked over its leading axes; bf16/fp8 leaves as raw
    bits)."""
    stacked = stacked_axes(port_cfg(cfg))
    out = {k: _map(v, tensor_to_numpy)
           for k, v in params.items() if k not in stacked}

    def stack(trees):
        first = trees[0]
        if isinstance(first, list):
            return stack([stack(t) for t in trees])
        if isinstance(first, dict):
            return {k: stack([t[k] for t in trees]) for k in first}
        if isinstance(first, torch.Tensor):
            return np.stack([tensor_to_numpy(t) for t in trees])
        return np.stack(trees)
    for k in stacked:
        out[k] = stack(params[k])
    return out


def jax_family_params(cfg, seed: int = 0):
    """(reference params, the port's params on the CPU) for `cfg`."""
    from repro.models import registry
    params = registry.get_family(cfg).init(jax.random.key(seed), cfg)
    return params, port_params(params, cfg)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The TINY models' ops are too small to split: one intra-op thread
    for the module (it holds in threads started later too), so the
    port's steps do not wait on a thread pool that other test workers'
    pools crowd out.  A module takes it with
    `from torch_port_helpers import one_torch_thread  # noqa: F401`."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
