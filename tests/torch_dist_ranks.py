"""The ranks of `test_torch_distributed.py`'s 4-rank gloo world.

Spawned ranks import this module (it imports neither JAX nor the
reference package: only torch, numpy and repro_torch) and run `cases`:
every case of the world in turn, each on its own bound mesh, returning
numpy results to the parent, which holds them against the reference.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.distribution import collectives as C
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.train import train_step as TS
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import elastic_restore
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.utils.tree import tree_flatten_with_names, tree_map

OPT = dict(total_steps=10, warmup_steps=0, peak_lr=1e-3)


def mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, device="cpu").bind()


def np_params(tree) -> dict:
    """{reference leaf name: numpy copy} of a tree of tensors."""
    return {n: x.detach().float().numpy().copy()
            for n, x in tree_flatten_with_names(tree)}


def batch_t(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _train(cfg, m, params, batch, steps, grad_accum, opt_name="adamw"):
    opt = make_optimizer(OptimizerConfig(name=opt_name, **OPT))
    state = TS.init_train_state(cfg, opt, params=params, mesh=m)
    step = TS.make_train_step(cfg, opt, grad_accum=grad_accum, mesh=m)
    losses = []
    for _ in range(steps):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
    full = TS.gather_state(state, step.plan.shardings, m)
    return losses, (np_params(full.params) if full is not None else None)


def dense_case(rank, inp, shape):
    cfg = ModelConfig(**inp["dense_cfg"])
    params = params_from_jax(inp["dense_params"], cfg, "cpu")
    return _train(cfg, mesh(shape), params, inp["dense_batch"], 2, 2)


def moe_case(rank, inp):
    """The "ep" forward with full weights under the (2, 2) mesh, and the
    sharded step's gradients (gathered)."""
    cfg = ModelConfig(**inp["moe_cfg"])
    m = mesh((2, 2))
    params = params_from_jax(inp["moe_params"], cfg, "cpu")
    fam = registry.get_family(cfg)
    from repro_torch.distribution.sharding import use_mesh
    with use_mesh(m), torch.no_grad():
        logits = fam.forward(params, cfg, batch_t(inp["moe_batch"]))
    opt = make_optimizer(OptimizerConfig(**OPT))
    state = TS.init_train_state(cfg, opt, params=params, mesh=m)
    gf = TS.make_sharded_grad_fn(cfg, opt, m)
    loss, grads = gf(state.params, inp["moe_batch"])
    full = tree_map(lambda g, s: s.gather(g), grads, gf.plan.shardings.params)
    return logits.numpy(), float(loss), np_params(full)


def vocab_case(rank, inp):
    """embed_tokens under a (2, 2) mesh on the full table: the lookup and
    this rank's gradient of (x ** 2).sum()."""
    from repro_torch.distribution.sharding import use_mesh
    from repro_torch.models import layers as L
    cfg = ModelConfig(**inp["dense_cfg"])
    emb = torch.tensor(inp["vocab_emb"], requires_grad=True)
    toks = torch.as_tensor(inp["vocab_toks"])
    with use_mesh(mesh((2, 2))):
        x = L.embed_tokens(emb, cfg, toks)
    (x ** 2).sum().backward()
    return x.detach().numpy(), emb.grad.numpy()


def ring_case(rank, inp):
    g = mesh((4, 1)).group("world")
    x = torch.as_tensor(inp["ring_x"][rank])
    return C.ring_allreduce_int8(x, g).numpy()


def bucket_case(rank, inp):
    from repro_torch.distribution.sharding import use_mesh
    m = mesh((4, 1))
    tree = {k: torch.as_tensor(v[rank]) for k, v in inp["bucket"].items()}
    with use_mesh(m):
        got = C.bucket_psum(tree, "data", bucket_bytes=64)
    want = {k: C.all_reduce(v, m.group("data")) for k, v in tree.items()}
    return ({k: v.numpy() for k, v in got.items()},
            {k: v.numpy() for k, v in want.items()})


def autograd_case(rank, inp):
    """The autograd collectives on a (4, 1) mesh: `AllGather` (backward:
    the reduce-scatter), `ReduceFromTP` (the identity), `CopyToTP` (the
    all-reduce), each with this rank's weights w on its output."""
    g = mesh((4, 1)).group("data")
    w = torch.as_tensor(inp["ag_w"][rank])
    x, z, u = (torch.tensor(inp["ag_x"][rank], requires_grad=True)
               for _ in range(3))
    y = C.all_gather_grad(x, [(g, 0)])
    (y * w).sum().backward()
    r = C.reduce_from_tp(z, g)
    (r * w[:2]).sum().backward()
    (C.copy_to_tp(u, g) * w[:2]).sum().backward()
    return (y.detach().numpy(), x.grad.numpy(), r.detach().numpy(),
            z.grad.numpy(), u.grad.numpy())


def compressed_case(rank, inp):
    m = mesh((4, 1), ("pod", "data"))
    out, err = [], None
    for call in inp["compressed"]:
        tree = {k: torch.as_tensor(v[rank]) for k, v in call.items()}
        red, err = C.compressed_tree_psum(tree, m, "pod", err)
        out.append(({k: v.numpy() for k, v in red.items()},
                     {k: v.numpy() for k, v in err.items()}))
    return out


def gpipe_case(rank, inp):
    from repro_torch.distribution.pipeline import (pipelined_forward,
                                                   stage_params_split)
    m = mesh((4,), ("stage",))
    w = torch.as_tensor(inp["gpipe_w"])
    xs = torch.as_tensor(inp["gpipe_x"])
    return pipelined_forward(lambda h, wi: torch.tanh(h @ wi),
                             stage_params_split(w, 4), xs, m).numpy()


def family_case(rank, inp, fam):
    """One sharded step of the port's TINY `fam` on (2, 2), from the
    port's own seeded weights (the parent runs the single-device step)."""
    cfg = ModelConfig(**inp[f"{fam}_cfg"])
    params = registry.get_family(cfg).init(0, cfg, torch.device("cpu"))
    return _train(cfg, mesh((2, 2)), params, inp[f"{fam}_batch"], 1, 1)


def elastic_case(rank, inp):
    """The reference's 1x1 checkpoint restored on (2, 2) (gathered back),
    then one step there, a checkpoint, a restore on (4, 1) and one more
    step."""
    cfg = ModelConfig(**inp["dense_cfg"])
    opt = make_optimizer(OptimizerConfig(**OPT))
    m = mesh((2, 2))
    state, manifest = elastic_restore(CheckpointManager(inp["ckpt"]), cfg,
                                      opt, m)
    sh = TS.state_shardings(cfg, opt, m)
    restored = TS.gather_state(state, sh, m)
    first = None
    if restored is not None:
        first = (restored.step, np_params(restored.params),
                 np_params(restored.opt_state))
    losses = []
    step = TS.make_train_step(cfg, opt, grad_accum=1, mesh=m)
    state, met = step(state, inp["dense_batches"][state.step])
    losses.append(float(met["loss"]))
    path = os.path.join(inp["tmp"], "sharded_ckpt")
    mgr = CheckpointManager(path, async_save=False) if rank == 0 else None
    TS.save_sharded(mgr, state, step.plan.shardings, m)
    C.all_reduce(torch.zeros(1), m.group("world"), name="barrier")
    m = mesh((4, 1))
    state, manifest2 = elastic_restore(CheckpointManager(path), cfg, opt, m)
    step = TS.make_train_step(cfg, opt, grad_accum=1, mesh=m)
    state, met = step(state, inp["dense_batches"][state.step])
    losses.append(float(met["loss"]))
    return first, losses, manifest2["metadata"].get("mesh")


def cases(rank: int, inp: dict) -> dict:
    """Every case of the world on this rank."""
    out = {"dense_2x2": dense_case(rank, inp, (2, 2)),
           "dense_1x4": dense_case(rank, inp, (1, 4)),
           "moe": moe_case(rank, inp),
           "vocab": vocab_case(rank, inp),
           "ring": ring_case(rank, inp),
           "bucket": bucket_case(rank, inp),
           "compressed": compressed_case(rank, inp),
           "autograd": autograd_case(rank, inp),
           "gpipe": gpipe_case(rank, inp),
           "ssm": family_case(rank, inp, "ssm"),
           "hybrid": family_case(rank, inp, "hybrid"),
           "elastic": elastic_case(rank, inp),
           "coords": make_mesh((2, 2), ("data", "model"), "cpu").coords(rank)}
    return out


def sleeper(rank: int, seconds: float):
    """A world that outlasts its timeout."""
    import time
    time.sleep(seconds)
    return rank


def failer(rank: int):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    C.all_reduce(torch.zeros(1), mesh((2, 1)).group("world"))
    return rank

