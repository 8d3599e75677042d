"""Cell builders: one (arch x shape) cell = a step function + its inputs
+ their shardings on a given mesh.

Port of `repro.launch.cells`.  Kinds:
  * train   — the training step (`make_train_step`) over a TrainState
              and a global batch;
  * prefill — fam.prefill(params, batch, cache) (encoder: fam.forward);
  * decode  — fam.decode_step(params, cache, tokens): one new token
              against a seq_len contiguous cache.

The reference lowers a cell's jitted step; the port runs it.  On the
"meta" device (`device="meta"`, the default) the inputs are meta tensors
(`configs.input_specs`, `param_specs`): the step runs the plain route
(no kernel runs on meta) and allocates nothing, and `lower_cell` returns
the `launch/trace.py` Trace of that one call, the port's counterpart of
the lowered program.  On a production mesh (`make_production_mesh`,
256 or 512 positions) a train cell is rank 0's sharded step
(`train_step.make_sharded_grad_fn`: FSDP, tensor and expert parallel)
on the mesh bound with dry groups (`Mesh.bind_dry`), whose collectives
move nothing and count their bytes: the trace's shapes are per device,
as the reference's post-SPMD HLO is.  A prefill or decode cell on a mesh
runs its rows of the batch over the data axes with whole weights (the
port's serving has no tensor parallelism).  On the card (`device=
"cuda"`, one device) the inputs are real: seeded weights and tokens.

MODEL_FLOPS (the "useful flops" denominator of §Roofline) follows the
standard accounting: train = 6*N*D (fwd 2ND + bwd 4ND), inference =
2*N*D, with N = active params (MoE counts routed-in experts only) and
attention terms added explicitly.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs import (SHAPES, get_arch, input_specs,
                                 param_specs)
from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.distribution.sharding import (AxisRules, DEFAULT_RULES,
                                               SEQUENCE_PARALLEL_RULES,
                                               named_sharding,
                                               param_shardings, use_rules)
from repro_torch.launch import trace as T
from repro_torch.launch.mesh import dp_width
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.utils.tree import (tree_leaves, tree_num_params,
                                    tree_size_bytes)

RULE_TABLES = {
    "default": DEFAULT_RULES,
    "seq_parallel": SEQUENCE_PARALLEL_RULES,
}

# shapes a card runs a whole step at (one H100; `launch/dryrun.py
# --device cuda`), beside the reference's four assigned `SHAPES`
CARD_SHAPES = {
    "train_card": ShapeSpec("train_card", "train", 2_048, 8),
    "prefill_card": ShapeSpec("prefill_card", "prefill", 512, 8),
    "decode_card": ShapeSpec("decode_card", "decode", 1_024, 8),
}


@dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    spec: ArchSpec
    fn: Callable                 # positional step function
    args: tuple                  # its inputs (meta tensors on "meta")
    in_shardings: tuple
    donate_argnums: tuple
    model_flops: float           # global MODEL_FLOPS per step
    rules: AxisRules
    meta: dict

    @property
    def name(self) -> str:
        return f"{self.arch}__{self.shape.name}"


# ------------------------------------------------------- batch shardings

_BATCH_AXES = {
    "tokens": ("act_batch", "act_seq"),
    "labels": ("act_batch", "act_seq"),
    "frames": ("act_batch", "act_seq", None),
    "mask": ("act_batch", "act_seq"),
    "patch_embeds": ("act_batch", "act_patch", None),
}


def batch_shardings(batch_specs: dict, mesh, rules):
    """{key: NamedSharding} of a batch's leaves (anything with a
    `.shape`) on `mesh`."""
    return {
        k: named_sharding(_BATCH_AXES[k], tuple(v.shape), mesh, rules)
        for k, v in batch_specs.items()
    }


def cache_shardings(cfg: ModelConfig, cache_specs_tree, mesh, rules):
    fam = registry.get_family(cfg)
    return param_shardings(fam.cache_axes(), cache_specs_tree, mesh, rules)


# ---------------------------------------------------------- MODEL_FLOPS

@functools.lru_cache(maxsize=64)
def _num_params(cfg: ModelConfig) -> int:
    """The parameter count of `cfg` (its meta init, counted once)."""
    return tree_num_params(param_specs(cfg))


def active_params(cfg: ModelConfig) -> float:
    """N_active: embedding excluded, MoE counts top-k routed experts."""
    total = _num_params(cfg)
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    n = total - emb
    if cfg.family == "moe":
        per_expert = 3 * cfg.d_model * cfg.moe_d_ff
        n -= cfg.num_layers * cfg.num_experts * per_expert
        n += cfg.num_layers * cfg.experts_per_token * per_expert
    return float(max(n, 0))


def attention_flops(cfg: ModelConfig, batch: int, sq: int, skv: int,
                    train: bool) -> float:
    """2 * 2 * b * sq * skv * heads * head_dim (QK^T and PV), causal ~ /2
    when sq == skv; x3 for train (bwd)."""
    if cfg.family == "ssm":
        return 0.0
    layers = cfg.num_layers
    if cfg.family == "hybrid":
        layers = cfg.num_layers // cfg.shared_attn_period
    f = 4.0 * batch * sq * skv * cfg.num_heads * cfg.head_dim * layers
    if cfg.causal and sq == skv:
        f *= 0.5
    return f * (3.0 if train else 1.0)


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    n = active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens + attention_flops(
            cfg, shape.global_batch, shape.seq_len, shape.seq_len, True)
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens + attention_flops(
            cfg, shape.global_batch, shape.seq_len, shape.seq_len, False)
    # decode: one token per sequence against a seq_len cache
    tokens = shape.global_batch
    return 2.0 * n * tokens + attention_flops(
        cfg, shape.global_batch, 1, shape.seq_len, False)


# -------------------------------------------------------------- builders

def resolve_shape(shape) -> ShapeSpec:
    """A ShapeSpec from itself or its name (`SHAPES`, `CARD_SHAPES`)."""
    if isinstance(shape, ShapeSpec):
        return shape
    if shape in SHAPES:
        return SHAPES[shape]
    return CARD_SHAPES[shape]


def _real_batch(specs: dict, cfg: ModelConfig, dev, gen) -> dict:
    """Seeded tensors on `dev` of a batch's specs: token ids below the
    vocab, labels likewise, f32 frames and patch rows, a full mask."""
    out = {}
    for k, v in specs.items():
        shape = tuple(v.shape)
        if v.dtype == torch.bool:
            out[k] = torch.ones(shape, dtype=torch.bool, device=dev)
        elif v.dtype.is_floating_point:
            out[k] = torch.randn(shape, generator=gen).to(dev)
        else:
            out[k] = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                   dtype=torch.int32).to(dev)
    return out


def _materialize(tree, dev):
    """Meta leaves as zeros on `dev` (a cache, a state's moments)."""
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype, device=dev)
                    if isinstance(x, torch.Tensor) and x.device.type == "meta"
                    else x, tree)


def build_cell(arch: str, shape_name, mesh=None, *,
               spec: ArchSpec | None = None, device="meta",
               seed: int = 0) -> Cell:
    """The cell of `arch` at `shape_name` (a name of `SHAPES` or
    `CARD_SHAPES`, or a ShapeSpec) on `mesh` (None or one position: one
    device; a production mesh: rank 0's per-device step, module
    docstring), with inputs on `device` ("meta": shapes only)."""
    spec = spec or get_arch(arch)
    cfg = spec.model
    shape = resolve_shape(shape_name)
    rules = AxisRules(dict(RULE_TABLES[spec.rules]))
    fam = registry.get_family(cfg)
    dev = torch.device(device)
    meta = {"optimizer": spec.optimizer, "grad_accum": spec.train_grad_accum,
            "rules": spec.rules, "family": cfg.family,
            "params_total": _num_params(cfg),
            "params_active": active_params(cfg),
            "dtype": cfg.dtype, "device": dev.type, "num_layers": cfg.num_layers}
    sharded = mesh is not None and mesh.size > 1
    gen = torch.Generator().manual_seed(seed)

    if shape.kind == "train":
        opt = make_optimizer(OptimizerConfig(name=spec.optimizer))
        ga = spec.train_grad_accum
        batch = input_specs(cfg, shape)["batch"]
        if dev.type != "meta":
            batch = _real_batch(batch, cfg, dev, gen)
        if sharded:
            from repro_torch.launch.mesh import Mesh
            dry = Mesh(mesh.axis_sizes, mesh.axis_names,
                       [dev] * mesh.size).bind_dry(0)
            step = TS.make_train_step(cfg, opt, grad_accum=ga, mesh=dry,
                                      rules=rules)
            state = TS.shard_state(TS.state_shapes(cfg, opt),
                                   step.plan.shardings, dry)
            in_sh = (step.plan.shardings,
                     batch_shardings(batch, mesh, rules))
            # this rank's rows of the global batch the step takes
            local = tree_size_bytes(batch) // dp_width(mesh)
            meta["layout"] = ("rank 0 of the mesh: FSDP, tensor and expert "
                              "parallel, dry collectives")
        else:
            step = TS.make_train_step(cfg, opt, grad_accum=ga)
            if dev.type == "meta":
                state = TS.state_shapes(cfg, opt)
                for p in tree_leaves(state.params):
                    p.requires_grad_(True)
            else:
                state = TS.init_train_state(cfg, opt, seed=seed, device=dev)
            in_sh = (None, None)
            local = tree_size_bytes(batch)
        meta["argument_bytes"] = tree_size_bytes(state.params) \
            + tree_size_bytes(state.opt_state) + local
        return Cell(arch, shape, spec, step, (state, batch), in_sh, (0,),
                    model_flops(cfg, shape), rules, meta)

    rows = shape.global_batch
    if sharded:
        rows = math.ceil(shape.global_batch / dp_width(mesh))
        meta["layout"] = ("batch rows over the data axes, whole weights "
                          "on every position")
    local = ShapeSpec(shape.name, shape.kind, shape.seq_len, rows)
    specs = input_specs(cfg, local)
    if dev.type == "meta":
        params = param_specs(cfg)
    else:
        params = fam.init(seed, cfg, dev)
        specs = {k: (_real_batch(v, cfg, dev, gen) if k == "batch"
                     else _materialize(v, dev) if k == "cache"
                     else _real_batch({"t": v}, cfg, dev, gen)["t"])
                 for k, v in specs.items()}
        if shape.kind == "decode" and "pos" in specs["cache"]:
            # one new token against a full seq_len cache
            specs["cache"]["pos"].fill_(shape.seq_len - 1)
    meta["argument_bytes"] = tree_size_bytes(params) + tree_size_bytes(specs)

    if shape.kind == "prefill":
        if "cache" in specs:
            @torch.inference_mode()
            def fn(params, batch, cache):
                return fam.prefill(params, cfg, batch, cache)

            return Cell(arch, shape, spec, fn,
                        (params, specs["batch"], specs["cache"]),
                        (None, None, None), (2,),
                        model_flops(cfg, shape), rules, meta)

        @torch.inference_mode()
        def fn(params, batch):          # encoder: plain inference fwd
            return fam.forward(params, cfg, batch)

        return Cell(arch, shape, spec, fn, (params, specs["batch"]),
                    (None, None), (), model_flops(cfg, shape), rules, meta)

    @torch.inference_mode()
    def fn(params, cache, tokens):
        return fam.decode_step(params, cfg, cache, tokens)

    return Cell(arch, shape, spec, fn,
                (params, specs["cache"], specs["tokens"]),
                (None, None, None), (1,), model_flops(cfg, shape), rules,
                meta)


def lower_cell(cell: Cell, mesh=None) -> T.Trace:
    """The Trace of one call of the cell's step (the counterpart of
    jit + lower): every aten op, kernel launch and collective it
    dispatches, and its output (`Trace.output`).  Runs under the cell's
    rules; a sharded train cell binds its own dry mesh."""
    with use_rules(cell.rules):
        _, tr = T.trace_call(cell.fn, *cell.args)
    return tr
