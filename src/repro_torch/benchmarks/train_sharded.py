"""Sharded training on one host, held against the single-rank step.

    PYTHONPATH=src python -m repro_torch.benchmarks.train_sharded \
        [--device cpu] [--json out.json]

One world of `RANKS` (4) ranks (`launch/world.py` `run_world`; on one
card every rank trains on `cuda:0`, so the process groups are gloo) runs
these cases in turn, each on its own bound mesh (`launch/mesh.py`):

  * "dense": a dense config on (2, 2) = data x model, `steps` steps of
    the sharded step (FSDP over data, heads / MLP columns / vocab over
    model), its losses, the parameters after step 1 (each rank writes
    its shards, this process puts the leaves back together),
    each rank's step time, peak memory and collective bytes per step,
    and the kernels it launched;
  * "dense_f32": the same at f32 and two layers, grad_accum 2;
  * "moe": an MoE config (f32) with `moe_dispatch="ep"` on (1, 4) and a
    capacity that drops nothing: the loss and every gradient (its
    config's rules are sequence-parallel: the tokens are gathered over
    "model" before routing);
  * the layouts the reference's constraints resolve to (each under its
    config's rules; the SSD kernel route for the Mamba families):
    "seq_dense", a dense config under sequence parallelism on (1, 4)
    (each rank its quarter of the positions, K/V all-gathered, the flash
    kernel at q_offset r S / 4): training steps, and "seq_dense_f32", the
    loss and every gradient at f32 and a shorter sequence; "seq_hybrid",
    a hybrid config under sequence parallelism on (1, 4) (the Mamba conv
    halo and state carried across ranks, the shared block as the dense
    layers), and "heads_ssm" and "heads_ssm_f32", a Mamba-2 config under
    the default rules on (1, 4) (its heads split over "model"): the loss
    and every gradient ("heads_ssm" also measured, with the single
    rank's, against the single rank's f32 gradients on the same
    weights);
  * "ring": `ring_allreduce_int8` over the world against the exact sum;
  * "gpipe": `pipelined_forward` over 4 stages against the sequential
    forward;
  * "elastic": train on (2, 2), checkpoint (rank 0, gathered arrays),
    restore on (4, 1) (`elastic_restore`) and go on.

Then this process runs the single-rank references on the same weights
(every rank and this process draw them from one seed on the same kind
of device) and batches: each case's losses, leaves and gradients are
compared (relative L2 per leaf, and the f32 case at the reference test's
own bounds), and the elastic run is restored once more on one rank.
`run(spec)` returns the report; `check(report)` lists what failed.
The card's default sizes are `card_spec()`; `--device cpu` runs
`cpu_spec()`, every model cut to `reduced_for_smoke`.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import time

import numpy as np

RANKS = 4
# f32 bounds of the reference's own sharded-vs-single test
# (tests/test_multidevice.py): loss, then params (rtol, atol)
F32_LOSS_TOL = 2e-4
F32_PARAM_RTOL, F32_PARAM_ATOL = 2e-3, 2e-4
RING_TOL = 0.02                  # int8 ring, relative to the exact sum
GPIPE_TOL = 2e-5
# bf16 gradients of the Mamba families against the single rank: the
# bounds of the port's own bf16 hybrid test (tests/test_torch_train_hybrid
# .py): relative L2 per leaf, mamba/mixer/D's, the loss's relative error
SSM_BF16_GRAD_TOL, SSM_BF16_D_TOL, SSM_BF16_LOSS_RTOL = 3e-2, 0.12, 1e-2
# mamba2-130m's head split in bf16 is held to the f32 gradients of the
# same weights instead: at full width and depth the single rank's own
# bf16 gradients lie 5-7 % from them (relative L2), so two bf16 runs
# differ by as much; the sharded step's partial out_proj products are
# rounded to bf16 before their all-reduce, one rounding more a layer than
# the single rank's, and may lie this many times as far
SSM_BF16_F32_RATIO = 2.0
# the cases of the layouts the reference's constraints resolve to
TRAIN_LAYOUT_CASES = ("seq_dense",)
GRAD_LAYOUT_CASES = ("seq_dense_f32", "heads_ssm_f32", "seq_hybrid",
                     "heads_ssm")
LAYOUT_CASES = TRAIN_LAYOUT_CASES + GRAD_LAYOUT_CASES


def card_spec(work: str) -> dict:
    """The card's sizes: internlm2-1.8b and qwen3-moe-30b-a3b at full
    width, depth cut."""
    return {
        "device": "cuda", "work": work,
        "dense": {"arch": "internlm2-1.8b", "layers": 4, "mesh": (2, 2),
                  "global_batch": 8, "seq": 2048, "steps": 3,
                  "grad_accum": None},
        "dense_f32": {"arch": "internlm2-1.8b", "layers": 2, "mesh": (2, 2),
                      "global_batch": 8, "seq": 256, "steps": 1,
                      "grad_accum": 2, "f32": True},
        "moe": {"arch": "qwen3-moe-30b-a3b", "layers": 2, "mesh": (1, 4),
                "global_batch": 4, "seq": 512, "f32": True},
        "seq_dense": {"arch": "yi-9b", "layers": 2, "mesh": (1, 4),
                      "global_batch": 4, "seq": 2048, "steps": 2,
                      "grad_accum": None},
        "seq_dense_f32": {"arch": "yi-9b", "layers": 2, "mesh": (1, 4),
                          "global_batch": 4, "seq": 256, "f32": True},
        "seq_hybrid": {"arch": "zamba2-2.7b", "layers": 12, "mesh": (1, 4),
                       "global_batch": 4, "seq": 2048},
        "heads_ssm": {"arch": "mamba2-130m", "layers": 24, "mesh": (1, 4),
                      "global_batch": 4, "seq": 2048, "f32_truth": True},
        "heads_ssm_f32": {"arch": "mamba2-130m", "layers": 24,
                          "mesh": (1, 4), "global_batch": 4, "seq": 256,
                          "f32": True},
        "ring": {"n": 1 << 20},
        "gpipe": {"layers": 8, "stages": 4, "micro": 6, "mb": 16,
                  "d": 1024},
        "elastic": {"arch": "internlm2-1.8b", "save_mesh": (2, 2),
                    "restore_mesh": (4, 1), "steps": 4, "crash": 2,
                    "global_batch": 8, "seq": 64},
    }


def cpu_spec(work: str) -> dict:
    spec = card_spec(work)
    spec["device"] = "cpu"
    for k in ("dense", "dense_f32", "moe") + LAYOUT_CASES:
        spec[k].update(reduced=True, seq=32)
    for k in LAYOUT_CASES:
        spec[k]["layers"] = 4 if k == "seq_hybrid" else 2
    spec["moe"]["global_batch"] = 4
    spec["ring"]["n"] = 4096
    spec["gpipe"].update(d=16, mb=4)
    return spec


# ------------------------------------------------------------ the configs

def _cfg(case: dict):
    from repro_torch.configs import get_arch
    from repro_torch.models.config import reduced_for_smoke
    spec = get_arch(case["arch"])
    cfg = spec.model
    if case.get("reduced"):
        cfg = reduced_for_smoke(cfg, max_seq=max(64, case.get("seq", 64)))
    kw = {}
    if "layers" in case:
        kw["num_layers"] = case["layers"]
    if case.get("f32"):
        kw.update(dtype="float32", param_dtype="float32")
    if cfg.family == "moe":
        # no assignment dropped: an expert's capacity covers every token
        kw.update(moe_dispatch="ep",
                  capacity_factor=cfg.num_experts / cfg.experts_per_token)
    if cfg.family in ("ssm", "hybrid"):
        kw["ssd_impl"] = "pallas"        # the SSD kernel and its backward
    return cfg.replace(**kw), spec.rules


def _opt(case: dict, total: int | None = None):
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    return make_optimizer(OptimizerConfig(
        total_steps=total or max(2, case.get("steps", 2)), warmup_steps=0,
        peak_lr=1e-3))


def _batches(cfg, case: dict, n: int) -> list:
    from repro_torch.data import DataConfig, make_source
    src = make_source(DataConfig(seq_len=case["seq"],
                                 global_batch=case["global_batch"]), cfg)
    return [src.batch_at(i) for i in range(n)]


def _numpy_tree(tree) -> dict:
    """{reference leaf name: f32 numpy copy} of a tree of tensors."""
    from repro_torch.utils.tree import tree_flatten_with_names
    return {n: x.detach().float().cpu().numpy().copy()
            for n, x in tree_flatten_with_names(tree)}


def rel_l2(a, b) -> float:
    """|a - b| / |b| (L2; |a - b| where b is zero) of two arrays or
    tensors, computed in f32 on a's device (b is moved there)."""
    import torch
    a = torch.as_tensor(a).float()
    b = torch.as_tensor(b).to(a.device, torch.float32)
    num = float(torch.linalg.vector_norm(a - b))
    den = float(torch.linalg.vector_norm(b))
    return num / den if den else num


def _f32_close(a, b) -> bool:
    """a within the reference test's f32 parameter bounds of b, on a's
    device."""
    import torch
    b = torch.as_tensor(b).to(a.device, torch.float32)
    return bool(torch.allclose(a, b, rtol=F32_PARAM_RTOL,
                               atol=F32_PARAM_ATOL))


def _kernel_counts(reset: bool = False) -> dict:
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.grouped_matmul import ops as gm
    from repro_torch.kernels.ssd_scan import ops as ssd
    if reset:
        fa.launches = fa.BACKWARD.launches = 0
        gm.launches = gm.BACKWARD.launches = 0
        ssd.launches = ssd.BACKWARD.launches = 0
    return {"flash_attention": fa.launches,
            "flash_attention_backward": fa.BACKWARD.launches,
            "grouped_matmul": gm.launches,
            "grouped_matmul_backward": gm.BACKWARD.launches,
            "ssd_intra_chunk": ssd.launches,
            "ssd_intra_chunk_backward": ssd.BACKWARD.launches}


def expected_launches(cfg, steps: int, grad_accum: int) -> dict:
    """One rank's kernel launches in `steps` sharded steps: per
    microbatch and attention (each layer; the hybrid's each shared-block
    application) the flash forward (twice under remat) and its backward;
    under "ep" the three grouped products of the rank's experts (twice
    under remat) and their backwards; per Mamba layer under the SSD
    kernel route its forward (twice under remat) and backward, on the
    rank's heads or its block of positions."""
    mbs = steps * grad_accum
    again = 1 if cfg.remat == "none" else 2
    attn = {"dense": cfg.num_layers, "moe": cfg.num_layers, "ssm": 0,
            "hybrid": cfg.num_layers // max(1, cfg.shared_attn_period)
            }.get(cfg.family, cfg.num_layers)
    mamba = cfg.num_layers if (cfg.family in ("ssm", "hybrid")
                               and cfg.ssd_impl == "pallas") else 0
    out = {"flash_attention": mbs * attn * again,
           "flash_attention_backward": mbs * attn,
           "grouped_matmul": 0, "grouped_matmul_backward": 0,
           "ssd_intra_chunk": mbs * mamba * again,
           "ssd_intra_chunk_backward": mbs * mamba}
    if cfg.family == "moe":
        out["grouped_matmul"] = 3 * mbs * cfg.num_layers * again
        out["grouped_matmul_backward"] = 3 * mbs * cfg.num_layers
    return out


# --------------------------------------------------------------- the ranks

def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> float:
    import torch
    return (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else 0.0)


def _mesh(shape, device):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, ("data", "model"), device=device).bind()


def _save_shards(spec, name, rank, tree, shardings):
    """This rank's shards of a tree (the reference's stacked names, f32)
    to `<work>/<name>_r<rank>.npz`, with each leaf's spec; the parent
    puts the full leaves back together (`_load_full`)."""
    from repro_torch.utils.tree import named_groups
    specs = {n: [list(e) if isinstance(e, tuple) else e
                 for e in parts[0].spec]
             for n, parts, _ in named_groups(shardings)}
    arrays = _numpy_tree(tree)
    np.savez(os.path.join(spec["work"], f"{name}_r{rank}.npz"), **arrays)
    with open(os.path.join(spec["work"], f"{name}_spec.json"), "w") as f:
        json.dump(specs, f)


def _load_full(spec, name, mesh_shape) -> dict:
    """{leaf: full f32 tensor on the spec's device} from every rank's
    shards (`_save_shards`); the comparisons then run on the device."""
    import torch
    from repro_torch.distribution.sharding import NamedSharding, P
    from repro_torch.launch.mesh import make_abstract_mesh
    mesh = make_abstract_mesh(mesh_shape, ("data", "model"))
    with open(os.path.join(spec["work"], f"{name}_spec.json")) as f:
        specs = json.load(f)
    ranks = [np.load(os.path.join(spec["work"], f"{name}_r{r}.npz"))
             for r in range(RANKS)]
    out = {}
    for leaf, entries in specs.items():
        parts = {r: torch.from_numpy(z[leaf]).to(spec["device"])
                 for r, z in enumerate(ranks)}
        lead = parts[0].dim() - len(entries)
        sh = NamedSharding(mesh, P(*([None] * lead), *(
            tuple(e) if isinstance(e, list) else e for e in entries)))
        out[leaf] = sh.unshard(parts)
    for z in ranks:
        z.close()
    return out


def _train_case(rank, spec, case, name):
    """Sharded training of one dense case: losses, step seconds, peak
    memory, bytes per collective per step, kernel launches; rank 0
    writes the parameters after step 1."""
    import torch
    from repro_torch.distribution import collectives as C
    from repro_torch.distribution.sharding import AxisRules
    from repro_torch.launch.cells import RULE_TABLES
    from repro_torch.launch.mesh import dp_width
    from repro_torch.train import train_step as TS
    from repro_torch.train.elastic import elastic_plan
    cfg, rules = _cfg(case)
    rules = AxisRules(dict(RULE_TABLES[rules]))
    mesh = _mesh(case["mesh"], spec["device"])
    dev = mesh.device
    opt = _opt(case)
    ga = case["grad_accum"] or elastic_plan(case["global_batch"],
                                            dp_width(mesh)).grad_accum
    state = TS.init_train_state(cfg, opt, seed=0, mesh=mesh, rules=rules)
    step = TS.make_train_step(cfg, opt, grad_accum=ga, mesh=mesh,
                              rules=rules)
    batches = _batches(cfg, case, case["steps"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _kernel_counts(reset=True)
    losses, secs, moved = [], [], []
    for i, b in enumerate(batches):
        C.STATS.reset()
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, b)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        moved.append(C.STATS.report())
        if i == 0:
            _save_shards(spec, name, rank, state.params,
                         step.plan.shardings.params)
    launches = _kernel_counts()
    return {"losses": losses, "step_s": secs, "peak_gib": _peak(dev),
            "collectives": moved[-1], "launches": launches,
            "expected_launches": expected_launches(cfg, case["steps"], ga),
            "grad_accum": ga, **_layout_report(step.grad_fn.layout)}


def _layout_report(layout) -> dict:
    """The last step's activation layout: whether it cut the trunk over
    "model", the constraint sites its forwards logged and the checks
    made (remat recomputes included)."""
    return {"trunk_split": layout.trunk_split, "sites": len(layout.log),
            "sites_checked": layout.checked}


def _grad_case(rank, spec, case, name):
    """One sharded gradient call of `case`: the loss and the gradients
    (this rank's shards to a file), its seconds, peak memory, bytes per
    collective, this rank's kernel launches and its layout."""
    import torch
    from repro_torch.distribution import collectives as C
    from repro_torch.distribution.sharding import AxisRules
    from repro_torch.launch.cells import RULE_TABLES
    from repro_torch.train import train_step as TS
    cfg, rules = _cfg(case)
    rules = AxisRules(dict(RULE_TABLES[rules]))
    mesh = _mesh(case["mesh"], spec["device"])
    dev = mesh.device
    opt = _opt(case)
    state = TS.init_train_state(cfg, opt, seed=0, mesh=mesh, rules=rules)
    grad_fn = TS.make_sharded_grad_fn(cfg, opt, mesh, rules=rules)
    batch = _batches(cfg, case, 1)[0]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _kernel_counts(reset=True)
    C.STATS.reset()
    _sync(dev)
    t0 = time.perf_counter()
    loss, grads = grad_fn(state.params, batch)
    _sync(dev)
    secs = time.perf_counter() - t0
    launches = _kernel_counts()
    moved = C.STATS.report()
    _save_shards(spec, f"{name}_grads", rank, grads,
                 grad_fn.plan.shardings.params)
    del grads
    return {"loss": float(loss), "step_s": secs, "peak_gib": _peak(dev),
            "collectives": moved, "launches": launches,
            "expected_launches": expected_launches(cfg, 1, 1),
            **_layout_report(grad_fn.layout)}


def _ring_case(rank, spec, case):
    import torch
    from repro_torch.distribution import collectives as C
    mesh = _mesh((RANKS, 1), spec["device"])
    g = mesh.group("world")
    gen = torch.Generator(device="cpu").manual_seed(100 + rank)
    x = torch.randn(case["n"], generator=gen).to(mesh.device)
    exact = C.all_reduce(x, g)
    approx = C.ring_allreduce_int8(x, g)
    rel = float((exact - approx).abs().max() / exact.abs().max())
    return {"rel_err": rel}


def _gpipe_case(rank, spec, case):
    import torch
    from repro_torch.distribution.pipeline import (gpipe_bubble_fraction,
                                                   pipelined_forward,
                                                   stage_params_split)
    from repro_torch.launch.mesh import make_mesh
    L, S, M = case["layers"], case["stages"], case["micro"]
    mesh = make_mesh((S,), ("stage",), device=spec["device"]).bind()
    dev = mesh.device
    gen = torch.Generator(device="cpu").manual_seed(0)
    w = (torch.randn(L, case["d"], case["d"], generator=gen)
         / math.sqrt(case["d"])).to(dev)
    xs = torch.randn(M, case["mb"], case["d"], generator=gen).to(dev)

    def layer_fn(h, wi):
        return torch.tanh(h @ wi)
    want = xs
    for i in range(L):
        want = layer_fn(want, w[i])
    got = pipelined_forward(layer_fn, stage_params_split(w, S), xs, mesh)
    return {"max_abs_err": float((got - want).abs().max()),
            "bubble": gpipe_bubble_fraction(S, M)}


def _elastic_case(rank, spec, case):
    """Train on the save mesh to the crash, checkpoint from rank 0,
    restore on the restore mesh (same global batch, its own plan) and
    train on to the end."""
    import torch
    from repro_torch.distribution import collectives as C
    from repro_torch.launch.mesh import dp_width
    from repro_torch.train import train_step as TS
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.elastic import elastic_plan, elastic_restore
    cfg, _ = _cfg(dict(case, reduced=True))
    opt = _opt(case, total=case["steps"])
    batches = _batches(cfg, case, case["steps"])
    ckpt = os.path.join(spec["work"], "elastic_ckpt")
    mesh = _mesh(case["save_mesh"], spec["device"])
    plan = elastic_plan(case["global_batch"], dp_width(mesh))
    state = TS.init_train_state(cfg, opt, seed=0, mesh=mesh)
    step = TS.make_train_step(cfg, opt, grad_accum=plan.grad_accum,
                              mesh=mesh)
    losses = {}
    while state.step < case["crash"]:
        i = state.step
        state, m = step(state, batches[i])
        losses[i] = float(m["loss"])
    mgr = CheckpointManager(ckpt, async_save=False) if rank == 0 else None
    TS.save_sharded(mgr, state, step.plan.shardings, mesh,
                    {"grad_accum": plan.grad_accum})
    del state, step
    # every rank waits for rank 0's write before reading it
    C.all_reduce(torch.zeros(1, device=mesh.device), mesh.group("world"),
                 name="barrier")
    mesh = _mesh(case["restore_mesh"], spec["device"])
    plan = elastic_plan(case["global_batch"], dp_width(mesh))
    state, manifest = elastic_restore(CheckpointManager(ckpt), cfg, opt, mesh)
    step = TS.make_train_step(cfg, opt, grad_accum=plan.grad_accum,
                              mesh=mesh)
    while state.step < case["steps"]:
        i = state.step
        state, m = step(state, batches[i])
        losses[i] = float(m["loss"])
    return {"losses": losses, "restored_step": manifest["step"],
            "saved_mesh": manifest["metadata"].get("mesh")}


def rank_main(rank: int, spec: dict) -> dict:
    """Every case on this rank, in order (module docstring)."""
    import torch
    from repro_torch.distribution import collectives as C
    from repro_torch.launch.world import rank_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = _mesh((RANKS, 1), spec["device"])
    rank_device(world)
    out = {"gloo_cuda_ok": sorted(C.GLOO_CUDA_OK),
           "backend": torch.distributed.get_backend(), "case_s": {}}
    cases = [("dense", lambda: _train_case(rank, spec, spec["dense"],
                                           "dense")),
             ("dense_f32", lambda: _train_case(rank, spec, spec["dense_f32"],
                                               "dense_f32")),
             ("moe", lambda: _grad_case(rank, spec, spec["moe"], "moe")),
             ("ring", lambda: _ring_case(rank, spec, spec["ring"])),
             ("gpipe", lambda: _gpipe_case(rank, spec, spec["gpipe"])),
             ("elastic", lambda: _elastic_case(rank, spec, spec["elastic"]))]
    cases += [(k, lambda k=k: _train_case(rank, spec, spec[k], k))
              for k in TRAIN_LAYOUT_CASES]
    cases += [(k, lambda k=k: _grad_case(rank, spec, spec[k], k))
              for k in GRAD_LAYOUT_CASES]
    for name, fn in cases:
        t0 = time.perf_counter()
        out[name] = fn()
        out["case_s"][name] = time.perf_counter() - t0
        if world.device.type == "cuda":
            torch.cuda.empty_cache()
    out["staged_through_host"] = C.STATS.staged
    return out


# ---------------------------------------------------- the single-rank side

def _single_train(spec, case, n_steps):
    """(losses, step seconds, peak GiB, params after step 1) of the
    single-rank step on the same weights and batches."""
    import torch
    from repro_torch.train import train_step as TS
    from repro_torch.train.elastic import elastic_plan
    dev = torch.device(spec["device"])
    cfg, _ = _cfg(case)
    opt = _opt(case)
    ga = case["grad_accum"] or elastic_plan(case["global_batch"], 1).grad_accum
    state = TS.init_train_state(cfg, opt, seed=0, device=dev)
    step = TS.make_train_step(cfg, opt, grad_accum=ga)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, secs, after1 = [], [], None
    for i, b in enumerate(_batches(cfg, case, n_steps)):
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, TS.batch_to(b, dev))
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        if i == 0:
            after1 = _numpy_tree(state.params)
    peak = _peak(dev)
    del state, step
    return losses, secs, peak, after1


def _single_grads(spec, case):
    """(loss, gradients, seconds, launches, peak GiB, the gradients at
    f32 or None) of the single-rank gradient call on the same weights and
    batch (an MoE config under "grouped": the kernel route of one
    device); with `case["f32_truth"]` the bf16 weights are also upcast to
    f32 and their f32 gradients returned, against which both bf16 runs
    are measured."""
    import torch
    from repro_torch.train import train_step as TS
    dev = torch.device(spec["device"])
    cfg, _ = _cfg(case)
    if cfg.family == "moe":
        cfg = cfg.replace(moe_dispatch="grouped")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    opt = _opt(case)
    state = TS.init_train_state(cfg, opt, seed=0, device=dev)
    batch = TS.batch_to(_batches(cfg, case, 1)[0], dev)
    _kernel_counts(reset=True)
    _sync(dev)
    t0 = time.perf_counter()
    loss, grads = TS.make_grad_fn(cfg)(state.params, batch)
    _sync(dev)
    secs = time.perf_counter() - t0
    out = (float(loss), _numpy_tree(grads), secs, _kernel_counts(),
           _peak(dev))
    del grads
    exact = None
    if case.get("f32_truth") and cfg.compute_dtype != torch.float32:
        from repro_torch.utils.tree import tree_map
        cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
        params = tree_map(lambda p: p.detach().float().requires_grad_(),
                          state.params)
        del state
        exact = _numpy_tree(TS.make_grad_fn(cfg32)(params, batch)[1])
    return out + (exact,)


def _single_elastic(spec, case):
    """(uninterrupted losses, the losses after a restore on one rank)."""
    import torch
    from repro_torch.train import train_step as TS
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.elastic import elastic_plan, elastic_restore
    dev = torch.device(spec["device"])
    cfg, _ = _cfg(dict(case, reduced=True))
    opt = _opt(case, total=case["steps"])
    batches = _batches(cfg, case, case["steps"])
    ga = elastic_plan(case["global_batch"], 1).grad_accum
    step = TS.make_train_step(cfg, opt, grad_accum=ga)
    state = TS.init_train_state(cfg, opt, seed=0, device=dev)
    ref = {}
    for i, b in enumerate(batches):
        state, m = step(state, TS.batch_to(b, dev))
        ref[i] = float(m["loss"])
    state, _ = elastic_restore(
        CheckpointManager(os.path.join(spec["work"], "elastic_ckpt")), cfg,
        opt, None, device=dev)
    one = {}
    while state.step < case["steps"]:
        i = state.step
        state, m = step(state, TS.batch_to(batches[i], dev))
        one[i] = float(m["loss"])
    return ref, one


def _train_report(spec, name, ranks, single_s) -> dict:
    """A training case held against the single-rank steps: losses,
    every leaf after step 1, times, memory, bytes, launches, layout."""
    case, r0 = spec[name], ranks[0]
    t1 = time.perf_counter()
    losses, secs, peak, after1 = _single_train(spec, case, case["steps"])
    single_s[name] = time.perf_counter() - t1
    t2 = time.perf_counter()
    sharded = _load_full(spec, name, case["mesh"])
    errs = {k: rel_l2(sharded[k], after1[k]) for k in after1}
    close = {k: _f32_close(sharded[k], after1[k]) for k in after1}
    del sharded
    compare_s = time.perf_counter() - t2
    return {
        "mesh": case["mesh"], "layers": case["layers"],
        "tokens": case["global_batch"] * case["seq"],
        "grad_accum": r0[name]["grad_accum"],
        "sharded_losses": r0[name]["losses"], "single_losses": losses,
        "loss_abs_diff": [abs(a - b) for a, b in
                          zip(r0[name]["losses"], losses)],
        "leaf_rel_l2_after_step1": errs,
        "worst_leaf": max(errs, key=errs.get),
        "worst_rel_l2": max(errs.values()),
        "allclose_f32_bounds": all(close.values()), "compare_s": compare_s,
        "sharded_step_s": [r[name]["step_s"] for r in ranks],
        "single_step_s": secs,
        "peak_gib_per_rank": [r[name]["peak_gib"] for r in ranks],
        "single_peak_gib": peak,
        "bytes_per_step_rank0": r0[name]["collectives"]["bytes"],
        "calls_per_step_rank0": r0[name]["collectives"]["calls"],
        "launches": [r[name]["launches"] for r in ranks],
        "expected_launches": r0[name]["expected_launches"],
        **{k: r0[name].get(k) for k in ("trunk_split", "sites",
                                        "sites_checked")}}


def _grad_report(spec, name, ranks, single_s) -> dict:
    """A gradient case held against the single rank's gradients."""
    import torch
    case, r0 = spec[name], ranks[0]
    t1 = time.perf_counter()
    loss, grads, secs, single_launches, peak, exact = _single_grads(spec,
                                                                    case)
    single_s[name] = time.perf_counter() - t1
    t2 = time.perf_counter()
    sharded = _load_full(spec, f"{name}_grads", case["mesh"])
    errs = {k: rel_l2(sharded[k], grads[k]) for k in grads}
    to_f32 = {}
    if exact is not None:
        to_f32 = {"sharded_rel_l2_to_f32": {k: rel_l2(sharded[k], exact[k])
                                            for k in exact},
                  "single_rel_l2_to_f32": {
                      k: rel_l2(torch.as_tensor(grads[k]).to(
                          spec["device"]), exact[k]) for k in exact}}
    del sharded
    compare_s = time.perf_counter() - t2
    return {
        "mesh": case["mesh"], "layers": case["layers"],
        "tokens": case["global_batch"] * case["seq"],
        "sharded_loss": r0[name]["loss"], "single_loss": loss,
        "loss_abs_diff": abs(r0[name]["loss"] - loss),
        "grad_rel_l2": errs, "worst_leaf": max(errs, key=errs.get),
        "worst_rel_l2": max(errs.values()),
        "sharded_s": [r[name]["step_s"] for r in ranks],
        "single_s": secs,
        "peak_gib_per_rank": [r[name]["peak_gib"] for r in ranks],
        "single_peak_gib": peak,
        "bytes_per_step_rank0": r0[name]["collectives"]["bytes"],
        "calls_per_step_rank0": r0[name]["collectives"]["calls"],
        "launches": [r[name]["launches"] for r in ranks],
        "expected_launches": r0[name]["expected_launches"],
        "single_launches": single_launches, **to_f32,
        "compare_s": compare_s,
        **{k: r0[name].get(k) for k in ("trunk_split", "sites",
                                        "sites_checked")}}


def run(spec: dict, timeout: float = 900.0) -> dict:
    """The world's cases, then the single-rank references; the report."""
    import torch
    from repro_torch.launch.world import run_world
    os.makedirs(spec["work"], exist_ok=True)
    if spec["device"] == "cuda":
        from repro_torch.kernels import build
        build.library()          # built once, before the ranks start
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_world(rank_main, RANKS, (spec,), timeout=timeout,
                      threads=1 if spec["device"] == "cpu" else 0)
    world_s = time.perf_counter() - t0
    r0 = ranks[0]
    rep = {"device": spec["device"], "ranks": RANKS,
           "backend": r0["backend"], "rank0_case_s": r0["case_s"],
           "gloo_cuda_ok": r0["gloo_cuda_ok"],
           "staged_through_host": [r["staged_through_host"] for r in ranks],
           "world_s": world_s}
    single_s = {}
    for name in ("dense", "dense_f32") + TRAIN_LAYOUT_CASES:
        rep[name] = _train_report(spec, name, ranks, single_s)
        _free(spec)
    for name in ("moe",) + GRAD_LAYOUT_CASES:
        rep[name] = _grad_report(spec, name, ranks, single_s)
        _free(spec)
    rep["ring"] = {"rel_err": [r["ring"]["rel_err"] for r in ranks],
                   "n": spec["ring"]["n"]}
    rep["gpipe"] = {"max_abs_err": max(r["gpipe"]["max_abs_err"]
                                       for r in ranks),
                    "bubble": r0["gpipe"]["bubble"]}
    t1 = time.perf_counter()
    ref, one = _single_elastic(spec, spec["elastic"])
    single_s["elastic"] = time.perf_counter() - t1
    rep["single_case_s"] = single_s
    el = r0["elastic"]["losses"]
    rep["elastic"] = {
        "uninterrupted": ref, "sharded_then_restored": el,
        "restored_on_one_rank": one,
        "max_loss_diff": max(abs(el[i] - ref[i]) for i in el),
        "max_loss_diff_one_rank": max(abs(one[i] - ref[i]) for i in one),
        "restored_step": r0["elastic"]["restored_step"],
        "saved_mesh": r0["elastic"]["saved_mesh"]}
    return rep


def _free(spec):
    import gc
    import torch
    gc.collect()
    if spec["device"] == "cuda":
        torch.cuda.empty_cache()


def check(rep: dict, bf16_leaf_tol: float, bf16_loss_tol: float,
          f32_grad_tol: float) -> list[str]:
    """What failed: the bf16 dense runs beyond `bf16_*`, the f32 dense
    run beyond the reference test's bounds, the f32 gradients (MoE and
    the f32 layout cases) beyond `f32_grad_tol` or their loss beyond the
    reference's loss bound, the bf16 hybrid's gradients beyond
    `SSM_BF16_*`, the bf16 Mamba head split's farther from the f32
    gradients than `SSM_BF16_F32_RATIO` times the single rank's, a
    layout case whose trunk was (or was not) cut as its
    rules say, launches other than expected, the ring, GPipe or the
    elastic trajectories."""
    bad = []
    for name in ("dense", "seq_dense"):
        d = rep[name]
        if max(d["loss_abs_diff"]) > bf16_loss_tol:
            bad.append(f"{name} loss diff {max(d['loss_abs_diff'])}")
        if d["worst_rel_l2"] > bf16_leaf_tol:
            bad.append(f"{name} leaf {d['worst_leaf']} rel L2 "
                       f"{d['worst_rel_l2']}")
    f = rep["dense_f32"]
    if max(f["loss_abs_diff"]) > F32_LOSS_TOL or not f["allclose_f32_bounds"]:
        bad.append(f"dense_f32 beyond the reference's bounds: "
                   f"{f['loss_abs_diff']}, worst leaf {f['worst_leaf']} "
                   f"{f['worst_rel_l2']}")
    for name in ("moe", "seq_dense_f32", "heads_ssm_f32"):
        m = rep[name]
        if m["worst_rel_l2"] > f32_grad_tol \
                or m["loss_abs_diff"] > F32_LOSS_TOL:
            bad.append(f"{name} grad {m['worst_leaf']} rel L2 "
                       f"{m['worst_rel_l2']}, loss diff {m['loss_abs_diff']}")
    g = rep["seq_hybrid"]
    for leaf, err in g["grad_rel_l2"].items():
        tol = (SSM_BF16_D_TOL if leaf.endswith("mixer/D")
               else SSM_BF16_GRAD_TOL)
        if err > tol:
            bad.append(f"seq_hybrid grad {leaf} rel L2 {err} > {tol}")
    h = rep["heads_ssm"]
    for leaf, err in h.get("sharded_rel_l2_to_f32", {}).items():
        own = h["single_rel_l2_to_f32"][leaf]
        if err > SSM_BF16_F32_RATIO * own:
            bad.append(f"heads_ssm grad {leaf} {err} from f32, the single "
                       f"rank's {own}")
    if "sharded_rel_l2_to_f32" not in h and h["worst_rel_l2"] > f32_grad_tol:
        bad.append(f"heads_ssm (f32) grad {h['worst_leaf']} rel L2 "
                   f"{h['worst_rel_l2']}")
    for name in ("seq_hybrid", "heads_ssm"):
        g = rep[name]
        if g["loss_abs_diff"] > SSM_BF16_LOSS_RTOL * abs(g["single_loss"]):
            bad.append(f"{name} loss diff {g['loss_abs_diff']}")
    want_split = {"seq_dense": True, "seq_dense_f32": True,
                  "seq_hybrid": True, "heads_ssm": False,
                  "heads_ssm_f32": False, "moe": True}
    for name, split in want_split.items():
        if rep[name]["trunk_split"] is not split:
            bad.append(f"{name} trunk cut {rep[name]['trunk_split']}, "
                       f"its rules say {split}")
    for name in ("dense", "dense_f32", "moe") + LAYOUT_CASES:
        if rep["device"] != "cuda":       # the CPU launches no kernel
            continue
        for r, got in enumerate(rep[name]["launches"]):
            if got != rep[name]["expected_launches"]:
                bad.append(f"{name} rank {r} launched {got}, expected "
                           f"{rep[name]['expected_launches']}")
    if max(rep["ring"]["rel_err"]) >= RING_TOL:
        bad.append(f"int8 ring rel err {rep['ring']['rel_err']}")
    if rep["gpipe"]["max_abs_err"] > GPIPE_TOL:
        bad.append(f"gpipe err {rep['gpipe']['max_abs_err']}")
    e = rep["elastic"]
    if max(e["max_loss_diff"], e["max_loss_diff_one_rank"]) > F32_LOSS_TOL:
        bad.append(f"elastic losses diverged: {e}")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--work", default="build/train_sharded")
    ap.add_argument("--json", default="")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds the world's ranks may take")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        spec = cpu_spec(args.work)
    else:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass --device cpu")
        spec = card_spec(args.work)
    shutil.rmtree(args.work, ignore_errors=True)
    rep = run(spec, timeout=args.timeout)
    text = json.dumps(rep, default=float)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    shutil.rmtree(args.work, ignore_errors=True)
    return rep


if __name__ == "__main__":
    main()
