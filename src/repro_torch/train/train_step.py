"""Training step: gradient accumulation over microbatches, clipping,
optimizer update.

Port of `repro.train.train_step`.  On one device, `make_grad_fn` runs
`grad_accum` microbatches (the batch's rows split in order) through the
family's `loss_fn` and `torch.autograd.grad`, sums their f32 gradients
and divides once (with one microbatch the gradients keep the parameters'
dtype, as the reference's do); `train_step(state, batch)` clips them by
the global norm and updates the parameters and moments in place.  Live
activation memory is one microbatch's; remat is the model's own policy
(`cfg.remat`).

On a bound mesh (`launch/mesh.py` `Mesh.bind`; one process per position)
`make_train_step(..., mesh=)` is the SPMD step the reference gets from
`jit(in_shardings=state_shardings(...))`, with every cross-rank move made
explicitly (`distribution/collectives.py`):

  * data parallel over ("pod", "data"): each rank trains on its rows of
    every global microbatch (`local_rows`), its loss weighted by its share
    of the microbatch's labelled positions, so the ranks' weighted losses
    sum to the reference's global mean;
  * FSDP: every leaf, its gradient and its optimizer moments are stored as
    this rank's shard under `state_shardings` (the ZeRO-3 analogue).  A
    layer's shards are all-gathered into the weights it computes with
    just before it runs, inside its remat region (`_ShardedParams`), and
    freed with it; the gradient of a gathered weight is accumulated whole
    over the microbatches and reduce-scattered back to the shard once
    after the accumulation (the reference's `_pin` / `constrain_grads`:
    one reduction, not one per microbatch);
  * tensor parallel over "model", weights stationary: attention heads,
    MLP columns, the vocab (lookup, head and loss) and, under the "ep"
    dispatch, the experts stay this rank's slice (tagged for the layers,
    `collectives.mark_tp`); every other model-sharded leaf (the Mamba
    mixer, the hybrid's shared block) is all-gathered over "model" like
    an FSDP shard and computed replicated;
  * clipping sums each leaf's squares once: a leaf replicated over an
    axis counts only on the rank at index 0 of that axis.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.distribution import collectives as C
from repro_torch.distribution.sharding import (NamedSharding, P,
                                               current_rules,
                                               logical_to_spec, spec_axes,
                                               param_shardings,
                                               use_mesh, use_param_gather,
                                               use_rules, AxisRules)
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import (LeafReduction, Optimizer,
                                         clip_by_global_norm,
                                         use_leaf_reduction)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import named_groups, tree_leaves, tree_map


@dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def init_train_state(cfg: ModelConfig, optimizer: Optimizer, *, seed=0,
                     params=None, device=None, mesh=None,
                     rules=None) -> TrainState:
    """A fresh state at step 0: `params` (e.g. the reference's, carried
    across by `models.convert.params_from_jax`) or the family's own
    seeded init on `device` (None: CUDA, raising without a GPU, as every
    entry point of the port).  Every parameter requires grad.

    With a bound `mesh` of more than one position the state is this
    rank's shards under `state_shardings`: the full parameters (given, or
    drawn on the rank's device, the same on every rank) are cut and
    freed, and the moments are zeros of the shards' shapes (factored as
    the FULL leaves are)."""
    if mesh is not None and mesh.size > 1:
        return _init_sharded_state(cfg, optimizer, seed, params, mesh, rules)
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
                    grad_accum: int = 1, mesh=None, rules=None):
    """Returns `train_step(state, batch) -> (state, metrics)`, batch a
    dict of tensors on the parameters' device: `make_grad_fn`'s loss and
    gradients, clipped by the global norm and applied by the optimizer in
    place.  Metrics are 0-d f32 tensors ("loss", "grad_norm", "step")
    that stay on the device until read.

    With a bound `mesh` of more than one position it is the sharded step
    (module docstring): `state` holds this rank's shards
    (`init_train_state(..., mesh=)` or `train.elastic.elastic_restore`)
    and `batch` is the GLOBAL batch (host arrays or tensors, the same on
    every rank), of which the step takes this rank's rows."""
    if mesh is not None and mesh.size > 1:
        return _make_sharded_step(cfg, optimizer, grad_accum, mesh, rules)
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


# ------------------------------------------------------- the state on a mesh

def state_shapes(cfg: ModelConfig, optimizer: Optimizer) -> TrainState:
    """TrainState on the "meta" device: every leaf's shape and dtype,
    nothing allocated (planning, `state_shardings`, restore targets)."""
    params = registry.get_family(cfg).init(0, cfg, torch.device("meta"))
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def state_logical_axes(cfg: ModelConfig, optimizer: Optimizer,
                       shapes: TrainState | None = None) -> TrainState:
    """Logical-axes tree matching TrainState (step is replicated): the
    parameters' per-layer axes and the optimizer state's stacked ones."""
    p_axes = registry.get_family(cfg).param_axes(cfg)
    shapes = shapes or state_shapes(cfg, optimizer)
    return TrainState(step=(), params=p_axes,
                      opt_state=optimizer.state_axes(p_axes,
                                                     shapes.opt_state))


def state_shardings(cfg: ModelConfig, optimizer: Optimizer, mesh=None,
                    rules=None, shapes: TrainState | None = None):
    """TrainState of `NamedSharding`s on `mesh` (the step's is
    replicated)."""
    from repro_torch.distribution.sharding import current_mesh
    mesh = mesh or current_mesh()
    shapes = shapes or state_shapes(cfg, optimizer)
    axes = state_logical_axes(cfg, optimizer, shapes)
    rules = _rules(rules)
    return TrainState(
        step=NamedSharding(mesh, P()),
        params=param_shardings(axes.params, shapes.params, mesh, rules),
        opt_state=param_shardings(axes.opt_state, shapes.opt_state, mesh,
                                  rules))


def _rules(rules) -> AxisRules:
    if rules is None:
        return current_rules()
    return AxisRules(dict(rules)) if isinstance(rules, dict) else rules


def shard_state(full: TrainState, shardings: TrainState, mesh) -> TrainState:
    """This rank's shards of a full state (tensors anywhere, "meta" for
    zeros), on the rank's device; the parameters require grad."""
    dev = mesh.device

    def cut(x, sh):
        if not isinstance(x, torch.Tensor):
            return x
        if x.device.type == "meta":
            return torch.zeros(sh.shard_shape(x.shape), dtype=x.dtype,
                               device=dev)
        return sh.shard(x.detach(), mesh.rank).to(dev)
    params = tree_map(cut, full.params, shardings.params)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return TrainState(step=full.step, params=params,
                      opt_state=tree_map(cut, full.opt_state,
                                         shardings.opt_state))


def _init_sharded_state(cfg, optimizer, seed, params, mesh, rules):
    shapes = state_shapes(cfg, optimizer)
    sh = state_shardings(cfg, optimizer, mesh, rules, shapes)
    if params is None:
        params = registry.get_family(cfg).init(seed, cfg, mesh.device)
    full = TrainState(step=0, params=params, opt_state=shapes.opt_state)
    return shard_state(full, sh, mesh)


def gather_state(state: TrainState, shardings: TrainState, mesh):
    """The full state from every rank's shards (every rank of the mesh
    calls it; leaf by leaf, so one full leaf at a time is on the card).
    Rank 0 gets the full TrainState on the host, the other ranks None."""
    keep = mesh.rank == 0

    def full(x, sh):
        if not isinstance(x, torch.Tensor):
            return x
        f = sh.gather(x.detach())
        return f.cpu() if keep else None
    out = tree_map(full, state, shardings)
    return out if keep else None


def save_sharded(mgr, state: TrainState, shardings: TrainState, mesh,
                 metadata: dict | None = None):
    """Rank 0 writes the sharded run's checkpoint from the gathered full
    arrays (the reference's layout, which either package restores), with
    the mesh in its metadata; every rank takes part in the gathers."""
    full = gather_state(state, shardings, mesh)
    if full is not None:
        mgr.save(full, full.step,
                 metadata={"mesh": dict(mesh.shape), **(metadata or {})})


# ------------------------------------------------------- the sharded step

LAYER_KEYS = ("layers", "mamba", "shared", "group_proj")


def local_rows(global_batch: int, grad_accum: int, dp_index: int,
               dp: int) -> list[int]:
    """This data-parallel rank's rows of the global batch, microbatch by
    microbatch: microbatch j is rows [j B / ga, (j + 1) B / ga) (the
    reference's split) and the rank holds the dp_index-th of its dp equal
    slices."""
    if global_batch % (grad_accum * dp):
        raise ValueError(f"global batch {global_batch} is not a multiple of "
                         f"grad_accum {grad_accum} x dp width {dp}")
    mb = global_batch // grad_accum
    per = mb // dp
    return [j * mb + dp_index * per + r for j in range(grad_accum)
            for r in range(per)]


def _tp_axes(cfg: ModelConfig, name: str, m: int) -> set[str]:
    """The logical axes that leaf `name` (its path, list indices dropped)
    keeps as this rank's model-axis slice in compute, on a model axis of
    `m` ranks; its other model-sharded dims are gathered.  Attention
    splits whole heads: its columns stay sliced only where the head count
    divides over the axis (the rule resolves on the columns, hq * hd,
    which may divide where the heads do not); kv heads that do not divide
    are gathered and computed replicated."""
    path = name.split("/")
    if name in ("embed", "head"):
        return {"vocab"}
    if path[0] != "layers":
        return set()
    if path[1] == "attn":
        if cfg.num_heads % m:
            return set()
        return {"heads", "kv_heads"} if cfg.num_kv_heads % m == 0 \
            else {"heads"}
    if path[1] == "mlp" or path[1:3] == ["moe", "shared"]:
        return {"mlp"}
    if path[1:3] == ["moe", "experts"] and cfg.moe_dispatch == "ep":
        return {"expert"}
    return set()


class _Leaf:
    """One parameter leaf's plan: its storage sharding, the gathers
    (dim, mesh axis) that make its compute weight, in order, and whether
    the compute weight is a tensor-parallel slice."""

    def __init__(self, name, sharding, gathers, tp):
        self.name, self.sharding = name, sharding
        self.gathers, self.tp = gathers, tp


def _plan_leaf(cfg, mesh, name, axes, sharding) -> _Leaf:
    keep = _tp_axes(cfg, name, mesh.shape.get("model", 1))
    gathers, tp = [], False
    for dim, (ax, entry) in enumerate(zip(axes, sharding.spec)):
        for a in reversed(spec_axes(entry)):          # minor axis first
            if a == "model" and ax in keep:
                tp = True
            else:
                gathers.append((dim, a))
    return _Leaf(name, sharding, gathers, tp)


def _data_axes(mesh) -> list[str]:
    return [a for a in mesh.axis_names if a != "model"]


def _finalize_grad(full, leaf: _Leaf, mesh):
    """The accumulated whole gradient of a compute weight -> the
    gradient of this rank's shard: a model-axis gather of a weight every
    model rank computed alike takes this rank's block; a data-axis gather
    is reduce-scattered; a leaf replicated over a data axis is summed
    over it."""
    g = full
    for dim, axis in reversed(leaf.gathers):          # major axis first
        grp = mesh.group(axis)
        if axis == "model":
            n = g.shape[dim] // grp.size
            g = g.narrow(dim, grp.index * n, n)
        else:
            g = C.reduce_scatter(g, grp, dim, name="fsdp_reduce_scatter")
    for axis in _data_axes(mesh):
        if leaf.sharding.is_replicated_over(axis):
            g = C.all_reduce(g, mesh.group(axis), name="dp_all_reduce")
    return g.contiguous()


def _owner(leaf: _Leaf, mesh) -> bool:
    """Whether this rank counts the leaf in the global norm: index 0 of
    every axis the leaf is replicated over."""
    me = mesh.my_coords
    return all(me[a] == 0 for a in mesh.axis_names
               if leaf.sharding.is_replicated_over(a))


class _ShardedParams:
    """The sharded step's parameter plan on one rank."""

    def __init__(self, cfg, optimizer, mesh, rules):
        self.mesh = mesh
        self.rules = _rules(rules)
        with use_rules(self.rules):
            self.shapes = state_shapes(cfg, optimizer)
            axes = state_logical_axes(cfg, optimizer, self.shapes)
            self.shardings = state_shardings(cfg, optimizer, mesh,
                                             self.rules, self.shapes)
        ax = {n: parts[0] for n, parts, _ in named_groups(axes.params)}
        full = {n: (lead, parts[0].shape)
                for n, parts, lead in named_groups(self.shapes.params)}
        self.leaves = {}
        for name, parts, _ in named_groups(self.shardings.params):
            self.leaves[name] = _plan_leaf(cfg, mesh, name, ax[name],
                                           parts[0])
        self.full_shape = {n: tuple(lead) + tuple(shape)
                           for n, (lead, shape) in full.items()}

    def by_shard(self, params) -> dict:
        """id(shard) -> its leaf plan, for this state's shard tensors."""
        return {id(p): self.leaves[name]
                for name, parts, _ in named_groups(params) for p in parts}

    def reduction(self) -> LeafReduction:
        mesh = self.mesh

        def allsum(x, axes):
            for a in axes:
                x = C.all_reduce(x, mesh.group(a), name="optimizer_all_reduce")
            return x
        return LeafReduction(
            spec=lambda name: (None,) * (len(self.full_shape[name])
                                         - len(self.leaves[name].sharding.spec))
            + tuple(self.leaves[name].sharding.spec),
            full_shape=lambda name: self.full_shape[name],
            allsum=allsum)


def make_sharded_grad_fn(cfg: ModelConfig, optimizer: Optimizer, mesh, *,
                         grad_accum: int = 1, rules=None):
    """The sharded step's gradient part on a bound mesh: `grad_fn(params,
    batch) -> (loss, grads)`, params this rank's shards, batch the GLOBAL
    batch; loss the global mean (the same on every rank), grads the
    gradients of this rank's shards, reduced over the data-parallel ranks
    and averaged over the microbatches (f32 when there are several, as
    `make_grad_fn`'s).  `grad_fn.plan` is the parameter plan."""
    plan = _ShardedParams(cfg, optimizer, mesh, rules)
    fam = registry.get_family(cfg)
    dp = mesh.group("dp")
    model_group = mesh.group("model") if "model" in mesh.axis_names else None

    def grad_fn(params, batch):
        dev = mesh.device
        first = next(iter(batch.values()))
        rows = torch.as_tensor(local_rows(first.shape[0], grad_accum,
                                          dp.index, dp.size))
        local = {k: torch.as_tensor(np.asarray(v) if not isinstance(
                     v, torch.Tensor) else v)[rows].to(dev)
                 for k, v in batch.items()}
        mbs = (_split_microbatches(local, grad_accum) if grad_accum > 1
               else [local])
        n = torch.stack([(mb["labels"] >= 0).sum() for mb in mbs]).float()
        weights = n / torch.clamp(C.all_reduce(n, dp, name="dp_count"),
                                  min=1.0)
        by_shard = plan.by_shard(params)
        acc: dict = {}
        acc_dtype = torch.float32 if grad_accum > 1 else None

        def weight_of(shard):
            leaf = by_shard.get(id(shard))
            if leaf is None:
                return shard

            def sink(g, key=id(shard)):
                if key in acc:
                    acc[key].add_(g)
                else:
                    acc[key] = g.to(acc_dtype or g.dtype, copy=True)
            w = C.all_gather_grad(
                shard, [(mesh.group(a), dim) for dim, a in leaf.gathers],
                sink)
            if leaf.tp:
                C.mark_tp(w, model_group)
            return w

        loss = torch.zeros((), dtype=torch.float32, device=dev)
        with use_mesh(mesh), use_rules(plan.rules), \
                use_param_gather(weight_of):
            for j, mb in enumerate(mbs):
                cparams = {k: (v if k in LAYER_KEYS else
                               tree_map(weight_of, v))
                           for k, v in params.items()}
                l = fam.loss_fn(cparams, cfg, mb)
                (l * weights[j]).backward()
                loss = loss + l.detach().float() * weights[j]
        loss = C.all_reduce(loss, dp, name="dp_loss") / grad_accum
        grads_by_id = {}
        for name, parts, _ in named_groups(params):
            leaf = plan.leaves[name]
            for p in parts:
                full = acc.pop(id(p), None)
                if full is None:       # a leaf this batch did not use
                    full = torch.zeros(
                        _compute_shape(p.shape, leaf, mesh),
                        dtype=acc_dtype or p.dtype, device=dev)
                g = _finalize_grad(full, leaf, mesh)
                grads_by_id[id(p)] = g / grad_accum if grad_accum > 1 else g
        return loss, tree_map(lambda p: grads_by_id[id(p)], params)

    grad_fn.plan = plan
    return grad_fn


def sharded_global_norm(grads, plan, mesh) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf over all ranks, each
    leaf's shards counted once: a leaf replicated over an axis counts on
    the rank at index 0 of that axis only."""
    total = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for name, parts, _ in named_groups(grads):
        if _owner(plan.leaves[name], mesh):
            for g in parts:
                total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(C.all_reduce(total, mesh.group("world"),
                                   name="grad_norm"))


def _make_sharded_step(cfg, optimizer, grad_accum, mesh, rules):
    grad_fn = make_sharded_grad_fn(cfg, optimizer, mesh,
                                   grad_accum=grad_accum, rules=rules)
    plan = grad_fn.plan

    def train_step(state: TrainState, batch):
        loss, grads = grad_fn(state.params, batch)
        grads, grad_norm = clip_by_global_norm(
            grads, optimizer.config.clip_norm,
            norm=sharded_global_norm(grads, plan, mesh))
        with use_leaf_reduction(plan.reduction()):
            params, opt_state = optimizer.update(
                grads, state.opt_state, state.params, state.step)
        metrics = {"loss": loss, "grad_norm": grad_norm.float(),
                   "step": torch.tensor(float(state.step))}
        return TrainState(step=state.step + 1, params=params,
                          opt_state=opt_state), metrics

    train_step.plan = plan
    return train_step


def _compute_shape(shape, leaf: _Leaf, mesh) -> tuple[int, ...]:
    shape = list(shape)
    for dim, axis in leaf.gathers:
        shape[dim] *= mesh.shape[axis]
    return tuple(shape)


def make_eval_step(cfg: ModelConfig):
    fam = registry.get_family(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        return fam.loss_fn(params, cfg, batch)

    return eval_step
