"""End-to-end LM pretraining with the PyTorch port: the counterpart of
`examples/train_tiny_lm.py`.

    PYTHONPATH=src python examples/train_tiny_lm_torch.py \\
        --d-model 512 --layers 10 --vocab 16384 --steps 300

Default config is a ~100M-parameter llama-style model on the card (CUDA
unless `--device cpu`); `--cpu-budget` shrinks it (~15M, 250 steps) so the
whole loop (grad accumulation, async checkpointing, straggler monitor,
resume) finishes on a small CPU box.  The loss curve lands in
experiments/train_tiny_lm_torch.json.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.data import DataConfig, make_source
from repro_torch.models.config import ModelConfig
from repro_torch.train import train_step as TS
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.straggler import StepTimer, StragglerMonitor
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import tree_num_params

log = get_logger("train_tiny_lm")


def build_cfg(args) -> ModelConfig:
    return ModelConfig(
        name="tiny-lm", family="dense",
        num_layers=args.layers, d_model=args.d_model,
        vocab_size=args.vocab, num_heads=args.d_model // 64,
        num_kv_heads=max(1, args.d_model // 128), head_dim=64,
        d_ff=args.d_model * 4, tie_embeddings=True,
        attn_chunk=args.seq, max_seq=args.seq, remat="none")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=10)
    ap.add_argument("--vocab", type=int, default=16384)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir", default="experiments/tiny_lm_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--cpu-budget", action="store_true",
                    help="shrink to ~15M params / 250 steps for a CPU")
    ap.add_argument("--data", default="markov",
                    choices=["markov", "synthetic", "memmap"],
                    help="markov = learnable chain (CE: ln V -> ln 4)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--out", default="experiments/train_tiny_lm_torch.json")
    args = ap.parse_args(argv)
    if args.cpu_budget:
        args.d_model, args.layers, args.vocab = 384, 6, 4096
        args.seq, args.steps = 128, 250

    device = resolve_device(args.device)
    cfg = build_cfg(args)
    cfg.validate()
    opt = make_optimizer(OptimizerConfig(
        name="adamw", peak_lr=args.lr, total_steps=args.steps,
        warmup_steps=max(10, args.steps // 20)))
    src = make_source(DataConfig(source=args.data, seq_len=args.seq,
                                 global_batch=args.global_batch), cfg)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    mon = StragglerMonitor(num_workers=1)

    state = TS.init_train_state(cfg, opt, seed=0, device=device)
    if args.resume and mgr.latest_step() is not None:
        like = TS.state_like(state)
        del state
        state, manifest = TS.restore_train_state(mgr, like, device=device)
        log.info("resumed from step %d", manifest["step"])
    n_params = tree_num_params(state.params)
    log.info("params: %.1fM; %d steps x %d tokens on %s", n_params / 1e6,
             args.steps, args.global_batch * args.seq, device)

    step_fn = TS.make_train_step(cfg, opt, grad_accum=args.grad_accum)
    curve, t0 = [], time.perf_counter()
    start = state.step
    for i in range(start, args.steps):
        batch = TS.batch_to(src.batch_at(i), device)
        with StepTimer(mon, device=device):
            state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        curve.append(loss)
        if (i + 1) % 25 == 0:
            log.info("step %4d/%d loss %.4f (med %.2fs/step)", i + 1,
                     args.steps, loss, mon.report().fleet_median_s)
        if (i + 1) % args.ckpt_every == 0:
            mgr.save(state, state.step, metadata={"loss": loss})
    mgr.save(state, state.step,
             metadata={"final_loss": curve[-1] if curve else None})
    mgr.wait()
    dt = time.perf_counter() - t0
    toks = (args.steps - start) * args.global_batch * args.seq
    summary = {
        "params_m": n_params / 1e6,
        "device": str(device),
        "steps": args.steps,
        "tokens": toks,
        "tok_per_s": toks / dt,
        "wall_s": dt,
        "loss_first": curve[0] if curve else None,
        "loss_last": curve[-1] if curve else None,
        "curve_every_5": curve[::5],
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    if curve:
        log.info("done in %.0fs: loss %.3f -> %.3f (%.0f tok/s); wrote %s",
                 dt, curve[0], curve[-1], toks / dt, args.out)


if __name__ == "__main__":
    main()
