"""The ranks of `test_torch_seq_parallel.py`'s 4-rank gloo world.

Spawned ranks import this module (torch, numpy and repro_torch only;
neither JAX nor the reference package) and run `cases`: every sharded
training case of the world in turn, each on its own bound mesh under its
rule table, from the reference's weights, returning numpy results (the
losses, the gathered parameters, the layout log of the first step) to
the parent, which holds them against the reference.  Then the autograd
shift and reduce-scatter on a (1, 4) mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distribution import collectives as C
from repro_torch.distribution.sharding import (DEFAULT_RULES,
                                               SEQUENCE_PARALLEL_RULES,
                                               AxisRules)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.utils.tree import tree_flatten_with_names

OPT = dict(total_steps=10, warmup_steps=0, peak_lr=1e-3)
TABLES = {"default": DEFAULT_RULES, "seq_parallel": SEQUENCE_PARALLEL_RULES}


def mesh(shape):
    return make_mesh(shape, ("data", "model"), device="cpu").bind()


def train_case(rank, case: dict) -> dict:
    """`case["steps"]` sharded steps of `case["cfg"]` on `case["mesh"]`
    under `case["rules"]`, from the reference's weights."""
    cfg = ModelConfig(**case["cfg"])
    m = mesh(case["mesh"])
    rules = AxisRules(dict(TABLES[case["rules"]]))
    opt = make_optimizer(OptimizerConfig(**OPT))
    state = TS.init_train_state(
        cfg, opt, params=params_from_jax(case["params"], cfg, "cpu"),
        mesh=m, rules=rules)
    step = TS.make_train_step(cfg, opt, grad_accum=case["grad_accum"],
                              mesh=m, rules=rules)
    losses, log, split = [], None, None
    for _ in range(case["steps"]):
        state, met = step(state, case["batch"])
        losses.append(float(met["loss"]))
        if log is None:
            lay = step.grad_fn.layout
            log = [(axes, shape, tuple(spec)) for axes, shape, spec in lay.log]
            split = (lay.seq_split, lay.trunk_split)
    full = TS.gather_state(state, step.plan.shardings, m)
    params = None
    if full is not None:
        params = {n: x.detach().float().numpy().copy()
                  for n, x in tree_flatten_with_names(full.params)}
    return {"losses": losses, "params": params, "log": log, "split": split}


def collective_case(rank, inp: dict):
    """`ring_shift_grad` by one and `reduce_scatter_grad` along dim 1 on
    a (1, 4) mesh, each with this rank's weights on its output."""
    g = mesh((1, 4)).group("model")
    x = torch.tensor(inp["shift_x"][rank], requires_grad=True)
    y = C.ring_shift_grad(x, g, 1)
    (y * torch.as_tensor(inp["shift_w"][rank])).sum().backward()
    u = torch.tensor(inp["rs_x"][rank], requires_grad=True)
    z = C.reduce_scatter_grad(u, g, 1)
    (z * torch.as_tensor(inp["rs_w"][rank])).sum().backward()
    return (y.detach().numpy(), x.grad.numpy(), z.detach().numpy(),
            u.grad.numpy())


def cases(rank: int, inp: dict) -> dict:
    out = {name: train_case(rank, case)
           for name, case in inp["cases"].items()}
    out["collectives"] = collective_case(rank, inp)
    return out
