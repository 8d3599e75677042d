"""Training step: gradient accumulation over microbatches, clipping,
optimizer update.

Port of `repro.train.train_step` on one device.  `make_grad_fn` runs
`grad_accum` microbatches (the batch's rows split in order) through the
family's `loss_fn` and `torch.autograd.grad`, sums their f32 gradients
and divides once (with one microbatch the gradients keep the parameters'
dtype, as the reference's do); `train_step(state, batch)` clips them by
the global norm and updates the parameters and moments in place.  Live activation memory is
one microbatch's; remat is the model's own policy (`cfg.remat`).  The
reference's sharding helpers (`state_shardings`, the gradients' pinning
to the parameter sharding) go with sharded training (ROADMAP.md queue
A, A.6 part two (item 12)).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import Optimizer, clip_by_global_norm
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def init_train_state(cfg: ModelConfig, optimizer: Optimizer, *, seed=0,
                     params=None, device=None) -> TrainState:
    """A fresh state at step 0: `params` (e.g. the reference's, carried
    across by `models.convert.params_from_jax`) or the family's own
    seeded init on `device` (None: CUDA, raising without a GPU, as every
    entry point of the port).  Every parameter requires grad."""
    if params is None:
        params = registry.get_family(cfg).init(seed, cfg,
                                               resolve_device(device))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def state_like(state: TrainState, device="meta") -> TrainState:
    """The state's structure with every tensor on `device` uninitialised
    (a restore target that holds no memory on "meta")."""
    def like(x):
        return torch.empty_like(x, device=device) \
            if isinstance(x, torch.Tensor) else x
    return tree_map(like, state)


def restore_train_state(mgr, like: TrainState, *, step=None, device=None):
    """(TrainState restored from `mgr`'s checkpoint into the structure
    of `like` (e.g. `state_like(state)`), manifest); every parameter
    requires grad."""
    state, manifest = mgr.restore(like, step=step, device=device)
    for p in tree_leaves(state.params):
        p.requires_grad_(True)
    return state, manifest


def batch_to(batch: dict, device) -> dict:
    """A host batch (numpy arrays) as tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _split_microbatches(batch, grad_accum: int):
    def split(x):
        b = x.shape[0]
        if b % grad_accum:
            raise ValueError(
                f"batch {b} not divisible by grad_accum {grad_accum}")
        return x.reshape((grad_accum, b // grad_accum) + tuple(x.shape[1:]))
    split_batch = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split_batch.items()}
            for i in range(grad_accum)]


def make_grad_fn(cfg: ModelConfig, *, grad_accum: int = 1):
    """Returns `grad_fn(params, batch) -> (loss, grads)`: the mean loss
    (a 0-d f32 tensor) and the gradients in the parameters' structure,
    averaged over `grad_accum` microbatches (the batch's rows split in
    order) as f32 sums divided once; with one microbatch they keep the
    parameters' dtype, as the reference's do."""
    fam = registry.get_family(cfg)

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        if grad_accum == 1:
            loss = fam.loss_fn(params, cfg, batch)
            grads = list(torch.autograd.grad(loss, leaves))
            loss = loss.detach().float()
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for mb in _split_microbatches(batch, grad_accum):
                l = fam.loss_fn(params, cfg, mb)
                for acc, g in zip(grads, torch.autograd.grad(l, leaves)):
                    acc.add_(g.float())
                loss = loss + l.detach()
            loss = loss / grad_accum
            for acc in grads:
                acc.div_(grad_accum)
        by_leaf = {id(p): g for p, g in zip(leaves, grads)}
        return loss, tree_map(lambda p: by_leaf[id(p)], params)

    return grad_fn


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *,
                    grad_accum: int = 1):
    """Returns `train_step(state, batch) -> (state, metrics)`, batch a
    dict of tensors on the parameters' device: `make_grad_fn`'s loss and
    gradients, clipped by the global norm and applied by the optimizer in
    place.  Metrics are 0-d f32 tensors ("loss", "grad_norm", "step")
    that stay on the device until read."""
    grad_fn = make_grad_fn(cfg, grad_accum=grad_accum)

    def train_step(state: TrainState, batch):
        loss, grads = grad_fn(state.params, batch)
        grads, grad_norm = clip_by_global_norm(grads,
                                               optimizer.config.clip_norm)
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params, state.step)
        metrics = {"loss": loss, "grad_norm": grad_norm.float(),
                   "step": torch.tensor(float(state.step))}
        return TrainState(step=state.step + 1, params=params,
                          opt_state=opt_state), metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    fam = registry.get_family(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        return fam.loss_fn(params, cfg, batch)

    return eval_step
