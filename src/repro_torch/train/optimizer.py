"""Optimizers, from scratch: AdamW, Adafactor, SGD-momentum.

Port of `repro.train.optimizer`.  Moments are f32; every update is
computed in f32 and cast to the parameter's dtype, as the reference
computes it.  The learning-rate schedule is computed in f32 tensors (not
Python doubles), so it equals the reference's f32 schedule.

The reference's math sees its own layout, where repeated blocks are
stacked on leading axes: weight decay applies to leaves of two or more
dimensions, Adafactor factors the last two dimensions of a stacked leaf
and clips its update by the RMS over the whole stacked leaf.  The port
keeps a list of per-layer tensors instead (`utils.tree.named_groups`
gives each reference leaf's parts and the list lengths `lead` that stack
them) and keeps the optimizer state in the reference's stacked layout
and names, so checkpoints match.  AdamW and SGD-momentum are elementwise:
each part is updated against its own rows of the stacked moments (views,
nothing copied), with weight decay decided by the stacked leaf's rank,
len(lead) + the part's.  Adafactor stacks one reference leaf at a time,
since its factored moments and its RMS clip span the stack.  Parameters
and moments are updated IN PLACE (under `torch.no_grad`), so a step never
holds two copies of either.

`state_axes` gives the logical sharding axes of the state, in its
stacked layout: a stacked leaf's axes are the per-layer parameter axes
behind one "stage" entry per list level, as the reference's; Adafactor's
factored moments drop the dimension they average over.  On a mesh the
sharded train step keeps every moment as this rank's shard: AdamW and
SGD-momentum are elementwise and need nothing more, and Adafactor's
means and its RMS clip, which span a leaf's shards, are summed over the
ranks holding them (`use_leaf_reduction`).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.utils.tree import named_groups, stack_parts

F32 = torch.float32


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"                  # adamw | adafactor | sgdm
    peak_lr: float = 3e-4
    end_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # adafactor
    min_dim_size_to_factor: int = 128
    decay_offset: float = 1e-3


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=F32)


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to end_lr_frac * peak (a 0-d f32
    tensor on the CPU; `step` an int or a 0-d tensor)."""
    step = torch.as_tensor(step).to(F32).cpu()
    warm = _f32(cfg.peak_lr) * step / _f32(max(1, cfg.warmup_steps))
    prog = torch.clamp((step - _f32(cfg.warmup_steps))
                       / _f32(max(1, cfg.total_steps - cfg.warmup_steps)),
                       0.0, 1.0)
    # (1 - end_lr_frac) * 0.5 is a Python double in the reference too
    cos = _f32(cfg.peak_lr) * (
        _f32(cfg.end_lr_frac) + _f32((1 - cfg.end_lr_frac) * 0.5)
        * (_f32(1) + torch.cos(_f32(torch.pi) * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, summed per
    reference leaf in the reference's order."""
    total = None
    for _, parts, _ in named_groups(tree):
        sq = sum(torch.sum(torch.square(p.float())) for p in parts)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm, norm=None):
    """(grads scaled IN PLACE so their global norm is at most max_norm,
    the norm before scaling); each leaf keeps its dtype and is multiplied
    in f32, as the reference multiplies it.  `norm` is the global norm
    where the caller has it (the sharded step sums it over the ranks)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.minimum(torch.ones((), dtype=F32, device=norm.device),
                          max_norm / torch.clamp(norm, min=1e-9))
    with torch.no_grad():
        for _, parts, _ in named_groups(grads):
            for g in parts:
                if g.dtype == F32:
                    g.mul_(scale)
                else:
                    g.copy_(g.float().mul_(scale))
    return grads, norm


@dataclass(frozen=True)
class Optimizer:
    config: OptimizerConfig
    init: Callable[[Any], Any]
    # (grads, state, params, step) -> (params, state), both in place
    update: Callable[[Any, Any, Any, Any], tuple[Any, Any]]
    # (param axes, state shapes) -> the state's logical axes
    state_axes: Callable[..., Any] = None


def stacked_axes(param_axes) -> dict:
    """The port's parameter axes (per-layer lists) in the optimizer
    state's stacked layout: {name path: axes}, one "stage" entry in front
    per list level, as the reference's stacked leaves carry."""
    out: dict = {}
    for name, parts, lead in named_groups(param_axes):
        _set(out, name, ("stage",) * len(lead) + tuple(parts[0]))
    return out


# -------------------------------------------- reductions over shards
#
# Under the sharded step a leaf's moments are this rank's shard.  Where
# Adafactor averages over a dimension (its factored moments, its RMS
# clip) the average spans every shard: `LeafReduction` sums a local sum
# over the ranks that hold the leaf's other blocks along those dims.

@dataclass(frozen=True)
class LeafReduction:
    """spec(name) -> the stacked leaf's spec entries (one per dim);
    full_shape(name) -> its full stacked shape; allsum(x, axes) -> x
    summed over the mesh axes `axes`."""
    spec: Callable[[str], tuple]
    full_shape: Callable[[str], tuple]
    allsum: Callable[[torch.Tensor, tuple], torch.Tensor]


_REDUCE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_leaf_reduction", default=None)


@contextlib.contextmanager
def use_leaf_reduction(red: LeafReduction):
    token = _REDUCE.set(red)
    try:
        yield red
    finally:
        _REDUCE.reset(token)


def _mean(x, name: str, dims: tuple[int, ...], leaf_ndim: int,
          keepdim: bool = False):
    """x's mean over `dims` (negative, counted from the end of the
    stacked leaf `name`, whose dims x keeps in order from its end); over
    every shard of the leaf under a `LeafReduction`."""
    red = _REDUCE.get()
    if red is None:
        if len(dims) == x.dim() and not keepdim:
            return torch.mean(x)
        return x.mean(dim=dims[0] if len(dims) == 1 else dims,
                      keepdim=keepdim)
    from repro_torch.distribution.sharding import spec_axes
    spec, full = red.spec(name), red.full_shape(name)
    leaf = [leaf_ndim + d for d in dims]
    axes = tuple(a for d in leaf if d < len(spec) for a in spec_axes(spec[d]))
    total = red.allsum(x.sum(dim=dims, keepdim=keepdim), axes)
    return total / math.prod(full[d] for d in leaf)


def _set(tree: dict, name: str, value) -> None:
    *path, leaf = name.split("/")
    for k in path:
        tree = tree.setdefault(k, {})
    tree[leaf] = value


def _get(tree: dict, name: str):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def _zeros_like_groups(params, fn):
    """A state tree in the reference's layout: fn(stacked shape, device)
    for every reference leaf of `params`."""
    out: dict = {}
    for name, parts, lead in named_groups(params):
        _set(out, name, fn(tuple(lead) + tuple(parts[0].shape),
                           parts[0].device))
    return out


def _groups(grads, params):
    """(name, grad parts, param parts, lead) per reference leaf."""
    g_parts = {n: parts for n, parts, _ in named_groups(grads)}
    for name, parts, lead in named_groups(params):
        yield name, g_parts[name], parts, lead


def _rows(stacked, lead) -> list:
    """The per-part views of a tensor stacked over `lead` (`view` raises
    where a copy would be needed, so an in-place update is never lost)."""
    if not lead:
        return [stacked]
    return list(stacked.view(-1, *stacked.shape[len(lead):]).unbind(0))


def _scalar(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=F32, device=device)


# --------------------------------------------------------------------- AdamW

def _adamw(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        zeros = lambda shape, dev: torch.zeros(shape, dtype=F32, device=dev)
        return {"m": _zeros_like_groups(params, zeros),
                "v": _zeros_like_groups(params, zeros)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = lr_schedule(cfg, step)
        t = torch.as_tensor(step).to(F32).cpu() + 1.0
        bc1 = _f32(1) - torch.pow(_f32(cfg.b1), t)
        bc2 = _f32(1) - torch.pow(_f32(cfg.b2), t)
        for name, gparts, parts, lead in _groups(grads, params):
            dev = parts[0].device
            b1, one_b1 = _scalar(cfg.b1, dev), _scalar(1 - cfg.b1, dev)
            b2, one_b2 = _scalar(cfg.b2, dev), _scalar(1 - cfg.b2, dev)
            c1, c2, eps = bc1.to(dev), bc2.to(dev), _scalar(cfg.eps, dev)
            wd, step_lr = _scalar(cfg.weight_decay, dev), lr.to(dev)
            decay = len(lead) + parts[0].dim() >= 2  # wd on matrices only
            for g, p, m, v in zip(gparts, parts,
                                  _rows(_get(state["m"], name), lead),
                                  _rows(_get(state["v"], name), lead)):
                g = g.float()
                # b1 m + (1 - b1) g, each product rounded as the
                # reference's; in place, so old and new never coexist
                m.mul_(b1).add_(one_b1 * g)
                v.mul_(b2).add_(one_b2 * torch.square(g))
                u = (m / c1) / (torch.sqrt(v / c2) + eps)
                if decay:
                    u = u + wd * p.float()
                p.copy_((p.float() - step_lr * u).to(p.dtype))
        return params, state

    def state_axes(param_axes, state_shapes=None):
        ax = stacked_axes(param_axes)
        return {"m": ax, "v": ax}

    return Optimizer(cfg, init, update, state_axes)


# ----------------------------------------------------------------- Adafactor

def _factored(shape, min_size) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_size and shape[-2] >= min_size


def _adafactor(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        out: dict = {}
        for name, parts, lead in named_groups(params):
            shape = tuple(lead) + tuple(parts[0].shape)
            dev = parts[0].device
            if _factored(shape, cfg.min_dim_size_to_factor):
                leaf = {"vr": torch.zeros(shape[:-1], dtype=F32, device=dev),
                        "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=F32,
                                          device=dev)}
            else:
                leaf = {"v": torch.zeros(shape, dtype=F32, device=dev)}
            _set(out, name, leaf)
        return {"f": out}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = lr_schedule(cfg, step)
        t = torch.as_tensor(step).to(F32).cpu() + 1.0
        beta2 = _f32(1) - torch.pow(t, _f32(-0.8))       # the paper's schedule
        new_f: dict = {}
        for name, gparts, parts, lead in _groups(grads, params):
            g = stack_parts([x.float() for x in gparts], lead)
            p = stack_parts([x.float() for x in parts], lead)
            dev = p.device
            b2, one_b2 = beta2.to(dev), (_f32(1) - beta2).to(dev)
            f = _get(state["f"], name)
            g2 = torch.square(g) + _scalar(1e-30, dev)
            nd = g.dim()
            if "vr" in f:
                vr = b2 * f["vr"] + one_b2 * _mean(g2, name, (-1,), nd)
                vc = b2 * f["vc"] + one_b2 * _mean(g2, name, (-2,), nd)
                # vr's last dim is the leaf's dim -2
                r = vr / torch.clamp(_mean(vr, name, (-1,), nd - 1,
                                           keepdim=True), min=1e-30)
                u = g / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :]
                         + _scalar(cfg.eps, dev))
                nf = {"vr": vr, "vc": vc}
            else:
                v = b2 * f["v"] + one_b2 * g2
                u = g / (torch.sqrt(v) + _scalar(cfg.eps, dev))
                nf = {"v": v}
            # update clipping (RMS <= 1) as in the adafactor paper
            rms = torch.sqrt(_mean(torch.square(u), name,
                                   tuple(range(-nd, 0)), nd)
                             + _scalar(1e-30, dev))
            u = u / torch.clamp(rms, min=1.0)
            if p.dim() >= 2:
                u = u + _scalar(cfg.weight_decay, dev) * p
            new = (p - lr.to(dev) * u).to(parts[0].dtype)
            for part, row in zip(parts, _rows(new, lead)):
                part.copy_(row)
            _set(new_f, name, nf)
        return params, {"f": new_f}

    def state_axes(param_axes, state_shapes):
        """Factored leaves drop dims: vr drops the last, vc drops dim -2."""
        out: dict = {}
        for name, parts, lead in named_groups(param_axes):
            ax = ("stage",) * len(lead) + tuple(parts[0])
            if "vr" in _get(state_shapes["f"], name):
                _set(out, name, {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]})
            else:
                _set(out, name, {"v": ax})
        return {"f": out}

    return Optimizer(cfg, init, update, state_axes)


# --------------------------------------------------------------------- SGDm

def _sgdm(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        return {"m": _zeros_like_groups(
            params, lambda shape, dev: torch.zeros(shape, dtype=F32,
                                                   device=dev))}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = lr_schedule(cfg, step)
        for name, gparts, parts, lead in _groups(grads, params):
            dev = parts[0].device
            b1, step_lr = _scalar(cfg.b1, dev), lr.to(dev)
            for g, p, m in zip(gparts, parts,
                               _rows(_get(state["m"], name), lead)):
                m.mul_(b1).add_(g.float())
                p.copy_((p.float() - step_lr * m).to(p.dtype))
        return params, state

    def state_axes(param_axes, state_shapes=None):
        return {"m": stacked_axes(param_axes)}

    return Optimizer(cfg, init, update, state_axes)


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    return {"adamw": _adamw, "adafactor": _adafactor, "sgdm": _sgdm}[cfg.name](cfg)
