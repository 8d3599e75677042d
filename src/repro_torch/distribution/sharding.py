"""Logical-axis sharding rules: the weight-stationary policy engine.

Port of `repro.distribution.sharding`.  Every parameter and activation
is annotated with LOGICAL axis names ("embed", "mlp", "heads",
"act_batch", ...).  A rule table maps logical names to mesh axes;
`logical_to_spec` resolves a full logical shape against a mesh with the
reference's divisibility fallback (a dimension that does not divide over
its mesh axes is replicated), so every architecture shards on any mesh.
The rule tables, `use_mesh` / `use_rules` and the fallback ladder are
the reference's (the active mesh and rules are process-wide here, not
per thread: `_Active`).

The default table encodes the paper's dataflow (DESIGN.md section 2):
  * weights live sharded over ("data", "model") and stay put: the VPU
    pool's resident weights (the FSDP all-gather is the one allowed move);
  * activations move: batch over the DSU axes ("pod", "data"), heads/mlp
    slices over "model" (the broadcast/return traffic);
  * intermediates (attention scores, expert buffers) stay device-local.

What differs is what a spec resolves INTO.  The reference hands its
specs to XLA's SPMD partitioner; PyTorch has none, so here a sharding is
a plain description (`NamedSharding`: a mesh and a `PartitionSpec`) from
which one rank cuts its shard of a full tensor (`NamedSharding.shard`)
and from which the full tensor is put back together (`unshard` from
every rank's shard, `gather` over the process groups of a bound mesh).
Every cross-rank move is made explicitly, by `distribution/collectives.py`,
in the sharded train step (`train/train_step.py`).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import torch


# logical axis -> preferred mesh axes (None = replicate).
DEFAULT_RULES: dict[str, tuple[str, ...] | None] = {
    # -------- parameters (stationary)
    "embed": ("data",),          # FSDP shard of the d_model dim
    "mlp": ("model",),           # tensor-parallel ffn slice
    "heads": ("model",),         # tensor-parallel attention heads
    "kv_heads": ("model",),      # falls back to replicate when < axis size
    "vocab": ("model",),         # vocab-parallel embedding / logits
    "expert": ("model",),        # expert-parallel MoE
    "expert_in": ("data",),      # FSDP dim inside each expert
    "ssm_heads": ("model",),     # SSD head parallelism
    "ssm_inner": ("model",),
    "norm": None,                # norm scales replicated
    "scalar": None,
    "stage": None,               # pipeline stage dim of stacked layers
    # -------- activations (moving)
    "act_batch": ("pod", "data"),
    "act_seq": None,             # switched to ("model",) under seq-parallel
    "act_kv_seq": ("data", "model"),  # decode KV cache: near-memory resident
    "act_cap": ("data",),        # MoE per-expert capacity rows
    "act_embed": None,
    "act_heads": ("model",),
    "act_kv_heads": ("model",),
    "act_mlp": ("model",),
    "act_vocab": ("model",),
    "act_expert": ("model",),
    "act_ssm_heads": ("model",),
    "act_state": None,
    "act_patch": None,
}

# Sequence-parallel variant: norm/residual regions sharded along seq over
# the model axis.  Its specs resolve as the reference's do; the port's
# step computes with the default activation layout (the same numbers).
SEQUENCE_PARALLEL_RULES = dict(DEFAULT_RULES, **{"act_seq": ("model",)})


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh axis
    name, or a tuple of mesh axis names (major first).  A tuple, so it
    compares equal to the reference's `jax.sharding.PartitionSpec`."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class AxisRules:
    table: dict[str, tuple[str, ...] | None] = field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def lookup(self, name: str | None) -> tuple[str, ...] | None:
        if name is None:
            return None
        if name not in self.table:
            raise KeyError(
                f"unknown logical axis {name!r}; add it to the rule table")
        return self.table[name]


class _Active:
    """The active mesh, rules and weight gather: process-wide, not per
    thread or context.  The autograd engine runs a CUDA backward, and the
    recompute of a remat region in it, on a thread of its own, which
    must see the step's mesh and gather as its forward did."""
    mesh = None
    rules = AxisRules()
    gather = None


@contextlib.contextmanager
def _using(name: str, value):
    prev = getattr(_Active, name)
    setattr(_Active, name, value)
    try:
        yield value
    finally:
        setattr(_Active, name, prev)


def use_mesh(mesh):
    return _using("mesh", mesh)


def use_rules(rules: AxisRules | dict):
    if isinstance(rules, dict):
        rules = AxisRules(dict(rules))
    return _using("rules", rules)


def current_mesh():
    return _Active.mesh


def current_rules() -> AxisRules:
    return _Active.rules


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name]


def logical_to_spec(axes, shape=None, mesh=None,
                    rules: AxisRules | None = None) -> PartitionSpec:
    """Resolve logical axis names to a PartitionSpec on `mesh`.

    Fallback ladder per dimension: use the rule's mesh axes, dropping
    trailing axes until the dimension size divides the product of the
    remaining axis sizes; axes not present on the mesh are skipped; a mesh
    axis may be used by at most one dimension (first wins).
    """
    mesh = mesh or current_mesh()
    rules = rules or current_rules()
    if mesh is None:
        return P(*([None] * len(axes)))
    used: set[str] = set()
    entries = []
    for i, name in enumerate(axes):
        want = rules.lookup(name)
        if not want:
            entries.append(None)
            continue
        cand = [a for a in want if a in mesh.axis_names and a not in used]
        dim = None if shape is None else shape[i]
        while cand:
            prod = math.prod(_axis_size(mesh, a) for a in cand)
            if dim is None or (dim % prod == 0 and dim >= prod):
                break
            cand = cand[:-1]
        if cand:
            used.update(cand)
            entries.append(tuple(cand) if len(cand) > 1 else cand[0])
        else:
            entries.append(None)
    return P(*entries)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first (() if replicated)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class NamedSharding:
    """A mesh and a spec: which block of a full tensor each mesh position
    holds.  Dimension i is cut into prod(axis sizes) equal blocks over its
    entry's axes, major first, as a `jax.sharding.NamedSharding` lays it
    out; a position holds its block of every dimension."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self):
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec!r})"

    @property
    def sharded_axes(self) -> tuple[str, ...]:
        return tuple(a for e in self.spec for a in spec_axes(e))

    def is_replicated_over(self, axis: str) -> bool:
        return axis not in self.sharded_axes

    def num_blocks(self, dim: int) -> int:
        return math.prod(self.mesh.shape[a] for a in spec_axes(self.spec[dim]))

    def shard_shape(self, shape) -> tuple[int, ...]:
        shape = tuple(shape)
        return tuple(n // self.num_blocks(i) if i < len(self.spec) else n
                     for i, n in enumerate(shape))

    def block_index(self, dim: int, coords: dict) -> int:
        """The block of dimension `dim` that the position at `coords`
        (axis name -> index) holds."""
        idx = 0
        for a in spec_axes(self.spec[dim]):
            idx = idx * self.mesh.shape[a] + coords[a]
        return idx

    def slices(self, shape, coords: dict) -> tuple[slice, ...]:
        out = []
        for i, n in enumerate(tuple(shape)):
            if i >= len(self.spec) or self.spec[i] is None:
                out.append(slice(None))
                continue
            size = n // self.num_blocks(i)
            b = self.block_index(i, coords)
            out.append(slice(b * size, (b + 1) * size))
        return tuple(out)

    def shard(self, full, rank: int):
        """Rank `rank`'s block of the full tensor (or numpy array): a
        contiguous copy, so the full one can be freed."""
        s = full[self.slices(full.shape, self.mesh.coords(rank))]
        if isinstance(s, torch.Tensor):
            return s.clone(memory_format=torch.contiguous_format)
        return s.copy()

    def unshard(self, shards: dict):
        """The full tensor from {rank: shard} (one shard per distinct
        block is enough; on the host or one device)."""
        first = next(iter(shards.values()))
        full_shape = [n * (self.num_blocks(i) if i < len(self.spec) else 1)
                      for i, n in enumerate(first.shape)]
        out = torch.empty(full_shape, dtype=first.dtype, device=first.device)
        for rank, s in shards.items():
            out[self.slices(full_shape, self.mesh.coords(rank))] = s
        return out

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from this rank's shard, over the bound mesh's
        process groups (every rank of the mesh calls it)."""
        from repro_torch.distribution import collectives as C
        x = local
        for dim, entry in enumerate(self.spec):
            for a in reversed(spec_axes(entry)):       # minor axis first
                x = C.all_gather(x, self.mesh.group(a), dim)
        return x


def named_sharding(axes, shape=None, mesh=None,
                   rules: AxisRules | None = None) -> NamedSharding:
    mesh = mesh or current_mesh()
    if mesh is None:
        raise ValueError("named_sharding requires a mesh (use_mesh)")
    return NamedSharding(mesh, logical_to_spec(axes, shape, mesh, rules))


def with_logical_constraint(x, *axes: str | None):
    """Annotate an activation with logical axes.

    The reference hands the annotation to XLA's partitioner, which may
    move data to honour it.  The port moves nothing implicitly: every
    cross-rank move is an explicit collective of the sharded step, so this
    returns `x` unchanged.  It still resolves the annotation against the
    active mesh (an unknown logical axis raises, as in the reference) and
    checks that it names one axis per dimension."""
    if len(axes) != x.dim():
        raise ValueError(f"{len(axes)} logical axes for a {x.dim()}-d tensor")
    mesh = current_mesh()
    if mesh is not None:
        logical_to_spec(tuple(axes), tuple(x.shape), mesh)
    return x


def _is_axes(x) -> bool:
    return isinstance(x, tuple)


def _map_axes(fn, axes_tree, tree):
    """fn(axes tuple, leaf) over an axes tree (tuples are its leaves) and
    a matching tree of tensors or shapes (dicts, lists, dataclasses)."""
    import dataclasses
    if _is_axes(axes_tree):
        return fn(axes_tree, tree)
    if dataclasses.is_dataclass(axes_tree) and not isinstance(axes_tree, type):
        return dataclasses.replace(axes_tree, **{
            f.name: _map_axes(fn, getattr(axes_tree, f.name),
                              getattr(tree, f.name))
            for f in dataclasses.fields(axes_tree)})
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v, tree[k]) for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [_map_axes(fn, v, tree[i]) for i, v in enumerate(axes_tree)]
    raise TypeError(f"not an axes tree: {type(axes_tree).__name__}")


def param_shardings(axes_tree, params_tree, mesh=None,
                    rules: AxisRules | None = None):
    """A tree of logical-axes tuples and a matching tree of tensors (any
    device, "meta" too) -> the tree of `NamedSharding`s."""
    mesh = mesh or current_mesh()
    if mesh is None:
        raise ValueError("param_shardings requires a mesh (use_mesh)")
    return _map_axes(
        lambda ax, leaf: named_sharding(tuple(ax), tuple(leaf.shape), mesh,
                                        rules), axes_tree, params_tree)


def spec_tree(axes_tree, params_tree, mesh=None, rules=None):
    """Like `param_shardings` but returns the PartitionSpecs."""
    mesh = mesh or current_mesh()
    return _map_axes(
        lambda ax, leaf: logical_to_spec(tuple(ax), tuple(leaf.shape), mesh,
                                         rules), axes_tree, params_tree)


# ------------------------------------------------ the layers' weight gather
#
# The sharded step keeps every parameter as this rank's shard and gathers
# a layer's weights just before the layer runs (and, under remat, again in
# the backward).  `transformer._maybe_remat` passes each layer's arguments
# through `gather_layer_params` INSIDE the remat region, so the gathered
# weights are freed with the layer's other activations.

def use_param_gather(fn):
    """Inside, `gather_layer_params` maps every tensor through `fn`
    (the sharded step's shard -> compute-weight gather)."""
    return _using("gather", fn)


def gather_layer_params(tree):
    """A layer's arguments with each parameter shard replaced by the
    weight it computes with (identity outside a sharded step)."""
    fn = _Active.gather
    if fn is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_layer_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_layer_params(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree
