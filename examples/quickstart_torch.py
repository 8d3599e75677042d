"""Quickstart with the PyTorch port: the counterpart of
`examples/quickstart.py`.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
        [--ckpt-dir DIR]

Builds a tiny llama-style model from the config system (internlm2-1.8b
`reduced_for_smoke`), trains 20 steps with gradient accumulation 2,
checkpoints, restores the checkpoint into a fresh state, and serves two
requests from the restored weights through the UniMem
continuous-batching engine.  It runs on the card unless `--device`
names another.  The checkpoint goes to `--ckpt-dir`, or to a temporary
directory removed at the end.  The port runs on one device, so there is
no mesh to build (the reference's `use_mesh`).
"""
from __future__ import annotations

import argparse
import tempfile


def main(argv=None) -> dict:
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, make_source
    from repro_torch.models.config import reduced_for_smoke
    from repro_torch.serve import Request, ServingEngine
    from repro_torch.train import train_step as TS
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. any assigned architecture, shrunk to laptop scale
    spec = get_arch("internlm2-1.8b")
    cfg = reduced_for_smoke(spec.model, max_seq=128)
    print(f"model: {cfg.name} ({cfg.family}), d_model={cfg.d_model}, "
          f"layers={cfg.num_layers}, on {device}")

    # 2. train state and a step with two microbatches a step
    opt = make_optimizer(OptimizerConfig(total_steps=20, peak_lr=1e-3))
    state = TS.init_train_state(cfg, opt, seed=0, device=device)
    step = TS.make_train_step(cfg, opt, grad_accum=2)

    # 3. deterministic data pipeline
    src = make_source(DataConfig(seq_len=64, global_batch=8), cfg)
    losses = []
    for i in range(20):
        state, metrics = step(state, TS.batch_to(src.batch_at(i), device))
        losses.append(float(metrics["loss"]))
        if (i + 1) % 5 == 0:
            print(f"  step {i + 1:2d} loss {losses[-1]:.4f}")

    # 4. checkpoint + restore into a fresh state of the same shapes
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(args.ckpt_dir or tmp, keep=2)
        mgr.save(state, int(state.step), metadata={"device": str(device)})
        mgr.wait()
        restored, manifest = TS.restore_train_state(
            mgr, TS.state_like(state), device=device)
    print(f"checkpoint roundtrip ok at step {manifest['step']}")

    # 5. serve with continuous batching over the UniMem page pool
    engine = ServingEngine(cfg, restored.params, device=device, max_batch=2,
                           max_seq=128, page_size=16)
    rng = np.random.default_rng(0)
    for uid in range(2):
        engine.submit(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab_size, 12).astype(np.int32),
            max_new_tokens=8))
    results = engine.run()
    for r in results:
        print(f"  request {r.uid}: {r.tokens}")
    print("quickstart done.")
    return {"losses": losses, "step": manifest["step"],
            "tokens": {r.uid: r.tokens for r in results}}


if __name__ == "__main__":
    main()
