"""Training entry point: config -> mesh -> data -> step -> checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --steps 100 --mesh 1x1 --global-batch 8 --seq 256 --reduced \\
        [--device cpu] [--ckpt-dir D --ckpt-every K] [--resume]

Port of `repro.launch.train` for every family: dense (`--arch
internlm2-1.8b`, `yi-9b`, `deepseek-67b`, `nemotron-4-340b`), MoE
(`qwen3-moe-30b-a3b`, `moonshot-v1-16b-a3b`), ssm (`mamba2-130m`),
hybrid (`zamba2-2.7b`), encoder (`hubert-xlarge`: frames, mask and
codebook labels from `data.SyntheticFrames`) and vlm
(`phi-3-vision-4.2b`: token batches with seeded patch rows,
`data.WithPatches`).  `--reduced` shrinks
the model (`reduced_for_smoke`) so the loop runs on any box.  It runs
on CUDA unless given `--device cpu`, and raises where there is no card.
The loop keeps the reference's shape: a step-indexed data source (resume
replays the same batches), the straggler monitor, async checkpoints
every --ckpt-every steps, and resume from the latest one (--resume).

`--mesh DxM` other than 1x1 trains on a (data, model) mesh of D*M ranks,
one process each, spawned here ("spawn": CUDA cannot fork): rank r on
`cuda:(r % device_count)` (or the CPU with `--device cpu`), NCCL when
every rank has a card of its own, else gloo.  Each rank binds the mesh,
holds its shards of the state (`train_step.init_train_state(...,
mesh=)`, or `train.elastic.elastic_restore` on --resume, whatever mesh
wrote the checkpoint) and trains on its rows of each global batch
(`elastic_plan` over the mesh's data-parallel width); every rank's step
time feeds rank 0's straggler monitor, and rank 0 writes the checkpoints
from the gathered full arrays.  The kernels are built in this process
before the ranks start.  A rank that fails, or a world that outlasts
--timeout seconds, fails the run.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, make_source
from repro_torch.models.config import reduced_for_smoke
from repro_torch.train import train_step as TS
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import elastic_plan
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.straggler import StepTimer, StragglerMonitor
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("train")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 2x2")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="seconds a sharded run's ranks may take")
    args = ap.parse_args(argv)

    d, m = (int(x) for x in args.mesh.split("x"))
    if d * m > 1:
        return _train_sharded(args, d, m)
    device = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg = spec.model
    if args.reduced:
        cfg = reduced_for_smoke(cfg, max_seq=args.seq)
    plan = elastic_plan(args.global_batch, 1)
    opt = make_optimizer(OptimizerConfig(
        name=spec.optimizer, peak_lr=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10)))
    source = make_source(DataConfig(seq_len=args.seq,
                                    global_batch=args.global_batch), cfg)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    mon = StragglerMonitor(num_workers=1)
    state = TS.init_train_state(cfg, opt, seed=0, device=device)
    if args.resume and mgr and mgr.latest_step() is not None:
        like = TS.state_like(state)
        del state
        state, _ = TS.restore_train_state(mgr, like, device=device)
        log.info("resumed at step %d", state.step)
    step_fn = TS.make_train_step(cfg, opt, grad_accum=plan.grad_accum)

    log.info("training %s (%s) on %s: %d steps, plan=%s", args.arch,
             "reduced" if args.reduced else "full", device, args.steps, plan)
    t_start = time.perf_counter()
    losses = []
    start = state.step
    for i in range(start, args.steps):
        batch = TS.batch_to(source.batch_at(state.step), device)
        with StepTimer(mon, device=device):
            state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if (i + 1) % args.log_every == 0:
            rep = mon.report()
            log.info("step %4d loss %.4f |g| %.3f med %.0fms",
                     state.step, losses[-1], float(metrics["grad_norm"]),
                     rep.fleet_median_s * 1e3)
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(state, state.step, metadata={"arch": args.arch})
    if mgr:
        mgr.save(state, state.step, metadata={"arch": args.arch})
        mgr.wait()
    dt = time.perf_counter() - t_start
    toks = (args.steps - start) * args.global_batch * args.seq
    if losses:
        log.info("done: %.1fs, %.0f tok/s, loss %.4f -> %.4f, median step "
                 "%.0fms", dt, toks / dt, losses[0], losses[-1],
                 mon.report().fleet_median_s * 1e3)
    return losses


def _train_sharded(args, d: int, m: int):
    """Spawn the D*M ranks of `--mesh DxM` and return rank 0's losses."""
    from repro_torch.launch.mesh import backend_for, make_mesh
    from repro_torch.launch.world import run_world
    mesh = make_mesh((d, m), ("data", "model"), device=args.device)
    if mesh.devices[0].type == "cuda":
        from repro_torch.kernels import build
        build.library()
    losses = run_world(_rank_main, d * m, (vars(args), d, m),
                       timeout=args.timeout, backend=backend_for(mesh),
                       threads=1 if mesh.devices[0].type == "cpu" else 0)
    return losses[0]


def _rank_main(rank: int, a: dict, d: int, m: int):
    """One rank of a sharded run: the reference's loop on its shards."""
    import torch
    from repro_torch.distribution import collectives as C
    from repro_torch.distribution.sharding import AxisRules
    from repro_torch.launch.cells import RULE_TABLES
    from repro_torch.launch.mesh import dp_width, make_mesh
    from repro_torch.launch.world import rank_device
    from repro_torch.train.elastic import elastic_restore

    args = argparse.Namespace(**a)
    mesh = make_mesh((d, m), ("data", "model"), device=args.device).bind()
    dev = rank_device(mesh)
    spec = get_arch(args.arch)
    cfg = spec.model
    if args.reduced:
        cfg = reduced_for_smoke(cfg, max_seq=args.seq)
    rules = AxisRules(dict(RULE_TABLES[spec.rules]))
    plan = elastic_plan(args.global_batch, dp_width(mesh))
    opt = make_optimizer(OptimizerConfig(
        name=spec.optimizer, peak_lr=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10)))
    source = make_source(DataConfig(seq_len=args.seq,
                                    global_batch=args.global_batch), cfg)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    mon = StragglerMonitor(num_workers=mesh.size)
    if args.resume and mgr and mgr.latest_step() is not None:
        state, _ = elastic_restore(mgr, cfg, opt, mesh, rules=rules)
    else:
        state = TS.init_train_state(cfg, opt, seed=0, mesh=mesh, rules=rules)
    step_fn = TS.make_train_step(cfg, opt, grad_accum=plan.grad_accum,
                                 mesh=mesh, rules=rules)
    shardings = step_fn.plan.shardings
    meta = {"arch": args.arch}
    if rank == 0:
        log.info("training %s (%s) on mesh %s (%d ranks, %s): %d steps, "
                 "plan=%s", args.arch, "reduced" if args.reduced else "full",
                 args.mesh, mesh.size, dev, args.steps, plan)
    losses = []
    start = state.step
    for i in range(start, args.steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, source.batch_at(state.step))
        loss = float(metrics["loss"])
        dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float32,
                          device=dev)
        times = C.all_gather(dt, mesh.group("world"), name="step_times")
        mon.record_step({r: float(t) for r, t in enumerate(times)})
        losses.append(loss)
        if rank == 0 and i == start:
            log.info("transport %s: %s", torch.distributed.get_backend(),
                     C.STATS.report())
        if rank == 0 and (i + 1) % args.log_every == 0:
            log.info("step %4d loss %.4f |g| %.3f med %.0fms", state.step,
                     loss, float(metrics["grad_norm"]),
                     mon.report().fleet_median_s * 1e3)
        if mgr and (i + 1) % args.ckpt_every == 0:
            TS.save_sharded(mgr, state, shardings, mesh, meta)
    if mgr:
        TS.save_sharded(mgr, state, shardings, mesh, meta)
        mgr.wait()
    return losses


if __name__ == "__main__":
    main()
