"""The bf16 expert-parallel gradients with the routing held fixed.

    PYTHONPATH=src python scripts/ep_routing_probe.py [--device cpu] \
        [--json out.json]

In bf16, qwen3-moe-30b-a3b's expert-parallel ("ep") gradients on a
(1, 4) mesh were 5-9 % apart from the single rank's, where in f32 they
agree within 5.1e-6 (2 layers, 4 ranks on one NVIDIA H100 80GB HBM3).  The explanation to test: a token whose router
probabilities are near a top-8 tie takes another expert on the mesh,
because the tensor-parallel sums before the router round in another
order.  This script holds the routing fixed and looks again:

  1. the single rank ("grouped" dispatch, bf16, the same seeded weights
     and batch as `train_sharded.py`'s MoE case) computes the loss and
     every gradient, and records each router call's top-k experts
     (`_route`, in call order: the layers' forwards, then their remat
     recomputes);
  2. one world of 4 ranks on (1, 4) "ep" computes the loss and the
     gradients twice: with its own routing, and with every router call's
     top-k taken from the single rank's (`forced_routing`: the rank's own
     probabilities at those experts, renormalised, and the router loss
     over them), and counts the (token, slot) assignments where its own
     top-k differed from the single rank's;
  3. each sharded run is compared with the single rank's, per leaf in
     relative L2 and per loss, against the dense sharded case's bounds
     (`SHARDED_BF16_TOL` of chip_smoke.py: 0.05 a leaf, 5e-3 a loss).

The report's "verdict" says whether the forced run holds those bounds.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import time

from repro_torch.benchmarks import train_sharded as TSB

RANKS = 4
LEAF_TOL, LOSS_TOL = 0.05, 5e-3      # chip_smoke.py SHARDED_BF16_TOL


def card_case(work: str) -> dict:
    return {"device": "cuda", "work": work,
            "moe": {"arch": "qwen3-moe-30b-a3b", "layers": 2,
                    "mesh": (1, RANKS), "global_batch": 4, "seq": 512}}


def cpu_case(work: str) -> dict:
    spec = card_case(work)
    spec["device"] = "cpu"
    spec["moe"].update(reduced=True, seq=32)
    return spec


def _route_forced(router_w, cfg, xf, top_e, with_aux: bool):
    """`moe._route` with the top-k experts given: this caller's own
    softmax over the router logits at those experts, renormalised, and
    the router loss over them."""
    import torch
    from repro_torch.models import layers as L
    logits = L.matmul(xf, router_w).float()
    probs = torch.softmax(logits, dim=-1)
    top_w = probs.gather(1, top_e)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    if not with_aux:
        return top_w, top_e
    E, k = cfg.num_experts, cfg.experts_per_token
    me = probs.mean(dim=0)
    flat = top_e.reshape(-1)
    ce = torch.zeros(E, dtype=torch.float32, device=xf.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=xf.device)) / (xf.shape[0] * k)
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * cfg.router_z_coef
    return top_w, top_e, aux + z


class forced_routing:
    """Within the block every `moe._route` call records its top-k
    experts (`indices` None) or takes them from `indices` in call order,
    counting where its own top-k differs (`flips`: (token, slot)
    assignments whose expert set differs, per call)."""

    def __init__(self, indices=None):
        self.indices = indices
        self.recorded, self.flips, self.calls = [], [], 0

    def __enter__(self):
        from repro_torch.models import moe
        self.orig = moe._route

        def route(router_w, cfg, xf, with_aux=False):
            out = self.orig(router_w, cfg, xf, with_aux=with_aux)
            own = out[1]
            self.calls += 1
            if self.indices is None:
                self.recorded.append(own.detach().cpu())
                return out
            forced = self.indices[self.calls - 1].to(own.device)
            same = (own.sort(-1).values == forced.sort(-1).values)
            self.flips.append(int((~same).sum()))
            return _route_forced(router_w, cfg, xf, forced, with_aux)
        moe._route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route = self.orig
        return False


def _single(spec, case):
    """The single rank: (loss, {leaf: f32 grad}, recorded top-k)."""
    import torch
    from repro_torch.train import train_step as TS
    dev = torch.device(spec["device"])
    cfg, _ = TSB._cfg(case)
    cfg = cfg.replace(moe_dispatch="grouped")
    state = TS.init_train_state(cfg, TSB._opt(case), seed=0, device=dev)
    batch = TS.batch_to(TSB._batches(cfg, case, 1)[0], dev)
    with forced_routing() as rec:
        loss, grads = TS.make_grad_fn(cfg)(state.params, batch)
    out = float(loss), TSB._numpy_tree(grads), rec.recorded
    del state, grads
    return out


def rank_main(rank: int, spec: dict) -> dict:
    """This rank's natural and forced gradients (shards to files)."""
    import torch
    from repro_torch.distribution.sharding import AxisRules
    from repro_torch.launch.cells import RULE_TABLES
    from repro_torch.launch.world import rank_device
    from repro_torch.train import train_step as TS
    torch.backends.cuda.matmul.allow_tf32 = False
    case = spec["moe"]
    world = TSB._mesh((RANKS, 1), spec["device"])
    rank_device(world)
    cfg, rules = TSB._cfg(case)
    rules = AxisRules(dict(RULE_TABLES[rules]))
    mesh = TSB._mesh(case["mesh"], spec["device"])
    state = TS.init_train_state(cfg, TSB._opt(case), seed=0, mesh=mesh,
                                rules=rules)
    grad_fn = TS.make_sharded_grad_fn(cfg, TSB._opt(case), mesh, rules=rules)
    batch = TSB._batches(cfg, case, 1)[0]
    indices = torch.load(os.path.join(spec["work"], "topk.pt"))
    out = {}
    for name, ctx in (("natural", forced_routing(None)),
                      ("forced", forced_routing(indices))):
        t0 = time.perf_counter()
        with ctx:
            loss, grads = grad_fn(state.params, batch)
        TSB._sync(mesh.device)
        TSB._save_shards(spec, f"ep_{name}", rank, grads,
                         grad_fn.plan.shardings.params)
        out[name] = {"loss": float(loss), "calls": ctx.calls,
                     "flips": ctx.flips, "s": time.perf_counter() - t0}
        del grads
    return out


def run(spec: dict, timeout: float = 600.0) -> dict:
    import torch
    from repro_torch.launch.world import run_world
    os.makedirs(spec["work"], exist_ok=True)
    if spec["device"] == "cuda":
        from repro_torch.kernels import build
        build.library()
    case = spec["moe"]
    loss, grads, recorded = _single(spec, case)
    torch.save(recorded, os.path.join(spec["work"], "topk.pt"))
    if spec["device"] == "cuda":
        torch.cuda.empty_cache()
    ranks = run_world(rank_main, RANKS, (spec,), timeout=timeout,
                      threads=1 if spec["device"] == "cpu" else 0)
    cfg, _ = TSB._cfg(case)
    tokens = case["global_batch"] * case["seq"]
    rep = {"device": spec["device"], "arch": case["arch"],
           "layers": case["layers"], "mesh": case["mesh"],
           "dtype": cfg.dtype, "tokens": tokens,
           "experts_per_token": cfg.experts_per_token,
           "num_experts": cfg.num_experts,
           "router_calls_single": len(recorded), "single_loss": loss}
    if spec["device"] == "cuda":
        rep["card"] = torch.cuda.get_device_name(0)
    for name in ("natural", "forced"):
        sharded = TSB._load_full(spec, f"ep_{name}", case["mesh"])
        errs = {k: TSB.rel_l2(sharded[k], grads[k]) for k in grads}
        r0 = ranks[0][name]
        rep[name] = {
            "loss": r0["loss"], "loss_abs_diff": abs(r0["loss"] - loss),
            "worst_leaf": max(errs, key=errs.get),
            "worst_rel_l2": max(errs.values()), "grad_rel_l2": errs,
            "router_calls": [r[name]["calls"] for r in ranks],
            "flips_per_call": [r[name]["flips"] for r in ranks],
            "seconds": [r[name]["s"] for r in ranks]}
    f = rep["forced"]
    rep["verdict"] = ("within the dense bounds" if f["worst_rel_l2"]
                      <= LEAF_TOL and f["loss_abs_diff"] <= LOSS_TOL
                      else "beyond the dense bounds")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--work", default="build/ep_routing_probe")
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        spec = cpu_case(args.work)
    else:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass --device cpu")
        spec = card_case(args.work)
    shutil.rmtree(args.work, ignore_errors=True)
    rep = run(spec)
    text = json.dumps(rep, default=float)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    shutil.rmtree(args.work, ignore_errors=True)
    return rep


if __name__ == "__main__":
    main()
