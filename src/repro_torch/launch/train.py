"""Training entry point: config -> data -> step -> checkpoints, on one
device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --steps 100 --global-batch 8 --seq 256 --reduced [--device cpu] \\
        [--ckpt-dir D --ckpt-every K] [--resume]

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
Meshes other than 1x1 (sharded state, per-host data slices) are sharded
training (ROADMAP.md queue A, A.6 part two (item 12)).
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
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL; only 1x1")
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
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training is not ported yet "
            f"(ROADMAP.md queue A, A.6 part two (item 12)); the port "
            f"trains on one device")
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


if __name__ == "__main__":
    main()
