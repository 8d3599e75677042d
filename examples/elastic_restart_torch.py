"""Elastic restart / fault-tolerance demo on the PyTorch port.

    PYTHONPATH=src python examples/elastic_restart_torch.py [--device cpu]

Port of `examples/elastic_restart.py`.  Trains a reduced internlm2 on a
(2, 2) = data x model mesh of 4 ranks to step 20 and checkpoints (rank 0
writes the gathered full arrays), then "loses a node": the run stops and
resumes on a (1, 2) mesh of 2 ranks with a DIFFERENT execution plan, the
same global batch split into 4 microbatches of 2 rows, restoring its
shards with `elastic_restore`.  The post-restart losses must match an
uninterrupted one-rank run step for step, because data is indexed by
step and `elastic_plan` preserves the global-batch contract.  Without
`--device cpu` the ranks train on CUDA.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

TOTAL, CRASH_AT, BATCH, SEQ = 30, 20, 8, 64


def make_parts():
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, make_source
    from repro_torch.models.config import reduced_for_smoke
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    cfg = reduced_for_smoke(get_arch("internlm2-1.8b").model, max_seq=SEQ)
    opt = make_optimizer(OptimizerConfig(total_steps=TOTAL, peak_lr=1e-3,
                                         warmup_steps=3))
    src = make_source(DataConfig(seq_len=SEQ, global_batch=BATCH), cfg)
    return cfg, opt, src


def segment(rank: int, run: dict) -> dict:
    """One rank of a run on `run["mesh"]`: from a fresh state, or the
    latest checkpoint (`elastic_restore`), to step `run["until"]`,
    checkpointing at `run["ckpt_at"]`.  Returns {step: loss}."""
    from repro_torch.launch.mesh import dp_width, make_mesh
    from repro_torch.launch.world import rank_device
    from repro_torch.train import train_step as TS
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.elastic import elastic_plan, elastic_restore
    cfg, opt, src = make_parts()
    mesh = make_mesh(run["mesh"], ("data", "model"),
                     device=run["device"]).bind()
    rank_device(mesh)
    plan = elastic_plan(BATCH, dp_width(mesh), run["max_per_device"])
    if run["resume"]:
        state, manifest = elastic_restore(CheckpointManager(run["ckpt"]),
                                          cfg, opt, mesh)
        if rank == 0:
            print(f"run B resumed at step {manifest['step']} on mesh "
                  f"{dict(mesh.shape)} with {plan} (was grad_accum "
                  f"{manifest['metadata']['grad_accum']} on "
                  f"{manifest['metadata']['mesh']})", flush=True)
    else:
        state = TS.init_train_state(cfg, opt, seed=0, mesh=mesh)
    step = TS.make_train_step(cfg, opt, grad_accum=plan.grad_accum,
                              mesh=mesh)
    mgr = (CheckpointManager(run["ckpt"], async_save=False)
           if rank == 0 and run["ckpt_at"] else None)
    losses = {}
    while state.step < run["until"]:
        i = state.step
        state, metrics = step(state, src.batch_at(i))
        losses[i] = float(metrics["loss"])
        if state.step == run["ckpt_at"]:
            TS.save_sharded(mgr, state, step.plan.shardings, mesh,
                            {"grad_accum": plan.grad_accum})
    return losses


def reference_run(device) -> dict:
    """The run that never crashed: one rank, the original plan."""
    from repro_torch.train import train_step as TS
    cfg, opt, src = make_parts()
    state = TS.init_train_state(cfg, opt, seed=0, device=device)
    step = TS.make_train_step(cfg, opt, grad_accum=1)
    losses = {}
    while state.step < TOTAL:
        i = state.step
        state, metrics = step(state, TS.batch_to(src.batch_at(i), device))
        losses[i] = float(metrics["loss"])
    return losses


def main(argv=None):
    from repro_torch.launch.world import run_world
    from repro_torch.utils.device import resolve_device
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ckpt = tempfile.mkdtemp(prefix="elastic_demo_ckpt_")
    backend = "gloo"             # several ranks may share one card
    threads = 1 if device.type == "cpu" else 0
    try:
        base = {"device": args.device, "ckpt": ckpt}
        # run A: (2, 2), 4 rows a data rank in one microbatch
        run_world(segment, 4, (dict(base, mesh=(2, 2), resume=False,
                                    until=CRASH_AT, ckpt_at=CRASH_AT,
                                    max_per_device=0),),
                  backend=backend, threads=threads)
        print(f"run A crashed after step {CRASH_AT}; checkpoint saved")
        # run B: a node lost; (1, 2), 2 rows a microbatch, 4 microbatches
        losses_b = run_world(segment, 2, (dict(
            base, mesh=(1, 2), resume=True, until=TOTAL, ckpt_at=0,
            max_per_device=2),), backend=backend, threads=threads)[0]
        losses_ref = reference_run(device)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    print(f"{'step':>5} {'restarted':>10} {'reference':>10} {'delta':>9}")
    max_delta = 0.0
    for s in sorted(losses_b):
        d = abs(losses_b[s] - losses_ref[s])
        max_delta = max(max_delta, d)
        print(f"{s:>5} {losses_b[s]:>10.5f} {losses_ref[s]:>10.5f} {d:>9.2e}")
    assert max_delta < 5e-3, f"trajectory diverged: {max_delta}"
    print(f"elastic restart preserved the trajectory "
          f"(max loss delta {max_delta:.2e} across the restart boundary).")
    return max_delta


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main()
