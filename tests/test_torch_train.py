"""The port's training substrate, case for case with tests/test_train.py:
optimizers, gradient accumulation, checkpointing, elastic plans,
straggler detection; and the data sources against the reference's
arrays, the tree names, the training CLI and the families' refusals."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from conftest import TINY
from repro.data import pipeline as JD
from repro.models import registry as jax_registry
from repro.utils.tree import tree_flatten_with_names as jax_names
from repro_torch.configs import get_arch
from repro_torch.configs.base import SHAPES, train_batch_specs
from repro_torch.data import pipeline as PD
from repro_torch.launch import train as launch_train
from repro_torch.models import registry
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import ElasticError, elastic_plan
from repro_torch.train.optimizer import (OptimizerConfig, clip_by_global_norm,
                                         lr_schedule, make_optimizer)
from repro_torch.train.straggler import StepTimer, StragglerMonitor
from repro_torch.train.train_step import (batch_to, init_train_state,
                                          make_eval_step, make_grad_fn,
                                          make_train_step,
                                          restore_train_state, state_like)
from repro_torch.utils.tree import (tree_allclose, tree_any_nan,
                                    tree_flatten_with_names, tree_leaves,
                                    tree_num_params, tree_size_bytes)
from torch_port_helpers import port_cfg

CFG = port_cfg(TINY["dense"])


def _opt(name="adamw", **kw):
    return make_optimizer(OptimizerConfig(name=name, total_steps=100, **kw))


def _state(seed=0, opt=None, cfg=CFG):
    return init_train_state(cfg, opt or _opt(), seed=seed, device="cpu")


def _batch(cfg=CFG, batch=4, seq=32, seed=0):
    return batch_to(PD.synthetic_batch(cfg, batch, seq, seed), "cpu")


# ----------------------------------------------------------- optimizers

def test_adamw_first_step_matches_manual_math():
    cfg = OptimizerConfig(name="adamw", total_steps=100, warmup_steps=10,
                          weight_decay=0.0)
    opt = make_optimizer(cfg)
    p = {"w": torch.ones((4, 4))}
    g = {"w": torch.full((4, 4), 0.5)}
    state = opt.init(p)
    newp, _ = opt.update(g, state, p, 0)
    # step 0: lr = 0 (warmup from zero) -> params unchanged
    np.testing.assert_allclose(newp["w"].numpy(), np.ones((4, 4)))
    p2 = {"w": torch.ones((4, 4))}
    newp2, _ = opt.update(g, opt.init(p2), p2, 5)
    lr = float(lr_schedule(cfg, 5))
    # bias-corrected first moment of a constant gradient = g
    expect = 1.0 - lr * 1.0   # m_hat/sqrt(v_hat) = g/|g| = 1 for constant g
    np.testing.assert_allclose(newp2["w"].numpy(), np.full((4, 4), expect),
                               rtol=1e-4)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_optimizers_reduce_loss(name):
    opt = _opt(name, peak_lr=1e-2 if name != "sgdm" else 1e-3)
    state = _state(opt=opt)
    step = make_train_step(CFG, opt)
    batch = _batch()
    losses = []
    for _ in range(8):
        state, m = step(state, batch)      # same batch: loss must drop
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], f"{name}: {losses[0]} -> {losses[-1]}"


def test_adafactor_state_is_factored_and_small():
    opt = _opt("adafactor", min_dim_size_to_factor=32)
    state = _state(opt=opt)
    p_bytes = tree_size_bytes(state.params)
    o_bytes = tree_size_bytes(state.opt_state)
    assert o_bytes < p_bytes  # factored moments beat one full copy


def test_adafactor_state_has_the_reference_structure():
    """The factored leaves drop a dimension each, in the reference's
    stacked layout: vr (.., rows), vc (.., cols) per matrix, v elsewhere
    (the port's counterpart of the reference's state-axes check)."""
    opt = _opt("adafactor", min_dim_size_to_factor=32)
    state = _state(opt=opt)
    params = dict(tree_flatten_with_names(state.params))
    names = dict(tree_flatten_with_names(state.opt_state))
    for name, p in params.items():
        if f"f/{name}/vr" in names:
            assert names[f"f/{name}/vr"].shape == p.shape[:-1]
            assert names[f"f/{name}/vc"].shape == p.shape[:-2] + p.shape[-1:]
        else:
            assert names[f"f/{name}/v"].shape == p.shape
    assert names["f/layers/mlp/wi/vr"].shape == (2, 64)


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(90 + 160))
    total = np.sqrt(sum(float(torch.sum(x ** 2)) for x in clipped.values()))
    assert total == pytest.approx(1.0, rel=1e-5)


# ------------------------------------------------------ grad accumulation

def test_grad_accum_invariance():
    """accum=1 over batch B == accum=4 over the same batch (mean loss and
    identical update, up to fp tolerance)."""
    opt = _opt("sgdm", peak_lr=1e-3)
    batch = _batch(batch=8, seq=16)
    s1, s4 = _state(2, opt), _state(2, opt)
    st1, m1 = make_train_step(CFG, opt, grad_accum=1)(s1, batch)
    st4, m4 = make_train_step(CFG, opt, grad_accum=4)(s4, batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    assert tree_allclose(st1.params, st4.params, rtol=1e-4, atol=1e-5)


def test_grad_fn_averages_microbatches_in_f32():
    """make_grad_fn with grad_accum 2: the mean of the two halves' losses
    and the mean of their gradients, summed in f32."""
    state = _state()
    batch = _batch(batch=4, seq=16)
    loss, grads = make_grad_fn(CFG, grad_accum=2)(state.params, batch)
    one = make_grad_fn(CFG)
    halves = [one(state.params, {k: v[i:i + 2] for k, v in batch.items()})
              for i in (0, 2)]
    assert float(loss) == pytest.approx(
        (float(halves[0][0]) + float(halves[1][0])) / 2, rel=1e-6)
    mean = {n: (a.float() + b.float()) / 2 for (n, a), (_, b) in zip(
        tree_flatten_with_names(halves[0][1]),
        tree_flatten_with_names(halves[1][1]))}
    for n, g in tree_flatten_with_names(grads):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, mean[n], rtol=1e-5, atol=1e-7)


def test_eval_step_is_the_loss_without_grad():
    state = _state()
    batch = _batch()
    loss = make_eval_step(CFG)(state.params, batch)
    assert loss.grad_fn is None
    _, m = make_train_step(CFG, _opt())(state, batch)
    assert float(loss) == pytest.approx(float(m["loss"]), abs=1e-6)


# ---------------------------------------------------------- checkpointing

def test_checkpoint_roundtrip_and_retention(tmp_path):
    state = _state(3)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(state.replace(step=s), s, metadata={"mesh": {"data": 1}})
    assert mgr.all_steps() == [3, 4]           # retention keeps newest 2
    assert mgr.latest_step() == 4
    restored, manifest = mgr.restore(state_like(state), device="cpu")
    assert manifest["step"] == 4
    assert restored.step == 4
    assert tree_allclose(restored.params, state.params)
    assert tree_allclose(restored.opt_state, state.opt_state)


def test_checkpoint_async_and_crash_safety(tmp_path):
    state = _state(4)
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(state, 7)
    mgr.wait()
    # simulate an interrupted save: stray tmp dir must be GC'd on init
    os.makedirs(tmp_path / "tmp.step_00000009.999")
    mgr2 = CheckpointManager(str(tmp_path))
    assert mgr2.all_steps() == [7]
    assert not any(n.startswith("tmp.") for n in os.listdir(tmp_path))


def test_checkpoint_async_failure_surfaces_at_wait(tmp_path, monkeypatch):
    """A write that fails on the background thread raises from wait(),
    and leaves no checkpoint and no tmp dir behind."""
    from repro_torch.train import checkpoint as PC

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(PC.np, "savez", broken)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(_state(8), 3)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                                 # reported once
    assert mgr.all_steps() == [] and os.listdir(tmp_path) == []


def test_checkpoint_milestone_retention(tmp_path):
    state = _state(5)
    mgr = CheckpointManager(str(tmp_path), keep=1, keep_period=10,
                            async_save=False)
    for s in (5, 10, 15, 20, 25):
        mgr.save(state, s)
    assert mgr.all_steps() == [10, 20, 25]     # milestones + newest


def test_checkpoint_bf16_leaves_survive_the_uint16_layout(tmp_path):
    cfg = CFG.replace(dtype="bfloat16", param_dtype="bfloat16")
    state = _state(6, cfg=cfg)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(state, 3)
    arrays, manifest = mgr.restore_arrays()
    leaf = manifest["leaves"]["params/layers/attn/wq"]
    assert leaf["dtype"] == "bfloat16" and leaf["shape"] == [2, 64, 64]
    assert arrays["params/layers/attn/wq"].dtype == np.uint16
    assert manifest["leaves"]["opt_state/m/embed"]["dtype"] == "float32"
    restored, _ = restore_train_state(mgr, state_like(state), device="cpu")
    for (n, a), (_, b) in zip(tree_flatten_with_names(restored.params),
                              tree_flatten_with_names(state.params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), n
        assert a.requires_grad


def test_checkpoint_names_are_the_reference_names():
    """The leaves of the port's state carry the reference's names and
    stacked shapes."""
    import jax
    from repro.train import optimizer as JO
    from repro.train import train_step as JTS
    ref = JTS.state_shapes(TINY["dense"], JO.make_optimizer(
        JO.OptimizerConfig(name="adamw")))
    want = {n: tuple(a.shape) for n, a in jax_names(ref)}
    got = {n: tuple(np.shape(a)) for n, a in tree_flatten_with_names(_state())}
    assert got == want
    assert jax is not None


# --------------------------------------------------------------- elastic

def test_elastic_plan_preserves_global_batch():
    for dp in (1, 2, 4, 8, 16, 32):
        plan = elastic_plan(256, dp)
        assert plan.dp_width * plan.per_device_batch * plan.grad_accum == 256


def test_elastic_plan_respects_memory_cap():
    plan = elastic_plan(256, 4, max_per_device_batch=16)
    assert plan.per_device_batch <= 16
    assert plan.dp_width * plan.per_device_batch * plan.grad_accum == 256


def test_elastic_plan_rejects_indivisible():
    with pytest.raises(ElasticError):
        elastic_plan(100, 48)


@pytest.mark.parametrize("gb", [64, 128, 256, 512])
@pytest.mark.parametrize("dp", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("cap", [0, 1, 2, 8, 64])
def test_property_elastic_plan_contract(gb, dp, cap):
    plan = elastic_plan(gb, dp, max_per_device_batch=cap)
    assert plan.global_batch == gb
    assert plan.dp_width * plan.per_device_batch * plan.grad_accum == gb
    if cap:
        assert plan.per_device_batch <= cap


# -------------------------------------------------------------- straggler

def test_straggler_detection_and_escalation():
    mon = StragglerMonitor(num_workers=4, slow_factor=1.5, persist_steps=3)
    rep = None
    for step in range(6):
        durs = {w: 0.1 for w in range(4)}
        durs[2] = 0.5 if step >= 2 else 0.1     # worker 2 degrades
        rep = mon.record_step(durs)
    assert 2 in rep.stragglers
    assert rep.action == "exclude"              # persisted past threshold
    assert mon.excluded_workers() == [2]


def test_straggler_transient_recovers():
    mon = StragglerMonitor(num_workers=2, slow_factor=1.5, persist_steps=5,
                           window=4)
    mon.record_step({0: 0.1, 1: 0.8})           # one slow step
    for _ in range(6):
        rep = mon.record_step({0: 0.1, 1: 0.1})
    assert rep.stragglers == {} and rep.action == "none"


def test_step_timer_records_each_step():
    mon = StragglerMonitor(num_workers=1)
    for _ in range(3):
        with StepTimer(mon, device="cpu"):
            pass
    assert len(mon._times[0]) == 3 and mon.report().fleet_median_s >= 0


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("source", ["synthetic", "markov"])
@pytest.mark.parametrize("step", [0, 3])
def test_sources_give_the_reference_arrays(source, step):
    kw = dict(source=source, seq_len=16, global_batch=4, seed=5)
    ref = JD.make_source(JD.DataConfig(**kw), TINY["dense"]).batch_at(step)
    got = PD.make_source(PD.DataConfig(**kw), CFG).batch_at(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])


def test_memmap_source_gives_the_reference_windows(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 128, 1000).astype(np.int32).tofile(
        path)
    kw = dict(source="memmap", path=str(path), seq_len=16, global_batch=4)
    for host in (0, 1):
        ref = JD.make_source(JD.DataConfig(**kw), TINY["dense"], 2,
                             host).batch_at(7)
        got = PD.make_source(PD.DataConfig(**kw), CFG, 2, host).batch_at(7)
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])
        np.testing.assert_array_equal(got["labels"], ref["labels"])


@pytest.mark.parametrize("family", ["encoder", "vlm"])
def test_frontend_families_get_batches_their_losses_take(family):
    """The vlm's batches are the token source's plus seeded patch rows;
    the encoder's are frames, a mask and labels at the masked positions.
    Both are stateless in the step, and the family's loss takes them."""
    cfg = port_cfg(TINY[family])
    kw = dict(source="markov", seq_len=16, global_batch=4, seed=5)
    src = PD.make_source(PD.DataConfig(**kw), cfg)
    b3 = src.batch_at(3)
    for k, v in src.batch_at(3).items():
        np.testing.assert_array_equal(v, b3[k])
    if family == "vlm":
        assert isinstance(src, PD.WithPatches)
        ref = JD.make_source(JD.DataConfig(**kw), TINY[family]).batch_at(3)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b3[k], ref[k])
        assert b3["patch_embeds"].shape == (4, cfg.num_patches,
                                            cfg.frontend_dim)
        assert b3["patch_embeds"].dtype == np.float32
        assert not np.array_equal(b3["patch_embeds"],
                                  src.batch_at(4)["patch_embeds"])
    else:
        assert isinstance(src, PD.SyntheticFrames)
        assert b3["frames"].shape == (4, 16, cfg.frontend_dim)
        assert b3["frames"].dtype == np.float32
        np.testing.assert_array_equal(b3["labels"] >= 0, b3["mask"])
        assert (b3["labels"] < cfg.vocab_size).all()
    fam = registry.get_family(cfg)
    loss = fam.loss_fn(fam.init(0, cfg, "cpu"), cfg, batch_to(b3, "cpu"))
    assert loss.dim() == 0 and torch.isfinite(loss)


def test_host_slice_and_synthetic_batch_match_the_reference():
    assert PD.host_slice(8, 4, 3) == JD.host_slice(8, 4, 3) == slice(6, 8)
    got = PD.synthetic_batch(CFG, 2, 8, seed=1)
    ref = JD.synthetic_batch(TINY["dense"], 2, 8, seed=1)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


# ------------------------------------------------------- trees, configs

def test_tree_helpers_count_like_the_reference():
    import jax
    params = jax_registry.get_family(TINY["dense"]).init(
        jax.random.key(0), TINY["dense"])
    from repro.utils.tree import tree_num_params as jnum
    from repro.utils.tree import tree_size_bytes as jbytes
    state = _state()
    assert tree_num_params(state.params) == jnum(params)
    assert tree_size_bytes(state.params) == jbytes(params)
    assert not tree_any_nan(state.params)
    state.params["ln_f"].data[0] = float("nan")
    assert tree_any_nan(state.params)


def test_internlm2_training_fields_and_batch_specs():
    spec = get_arch("internlm2-1.8b")
    assert (spec.optimizer, spec.train_grad_accum) == ("adamw", 4)
    specs = train_batch_specs(spec.model, SHAPES["train_4k"])
    assert {k: (tuple(v.shape), v.dtype) for k, v in specs.items()} == {
        "tokens": ((256, 4096), torch.int32),
        "labels": ((256, 4096), torch.int32)}
    assert all(v.device.type == "meta" for v in specs.values())


@pytest.mark.parametrize("family", ["moe", "hybrid", "ssm"])
def test_other_families_train_from_their_own_init(family):
    """The MoE, hybrid and ssm families train
    (tests/test_torch_train_families.py and test_torch_train_hybrid.py
    hold them to the reference): a finite loss from their own init."""
    cfg = port_cfg(TINY[family])
    fam = registry.get_family(cfg)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    loss = fam.loss_fn(fam.init(0, cfg, "cpu"), cfg,
                       {"tokens": tokens, "labels": tokens})
    assert loss.dim() == 0 and torch.isfinite(loss)


# ------------------------------------------------------------------- CLI

def test_train_cli_runs_on_the_cpu_and_resumes(tmp_path):
    args = ["--reduced", "--device", "cpu", "--global-batch", "4", "--seq",
            "32", "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    full = launch_train.main(args + ["--steps", "4", "--ckpt-every", "9"])
    assert len(full) == 4 and all(np.isfinite(full))
    resumed_dir = tmp_path / "resumed"
    launch_train.main(["--reduced", "--device", "cpu", "--global-batch", "4",
                       "--seq", "32", "--steps", "2", "--ckpt-dir",
                       str(resumed_dir)])
    rest = launch_train.main(["--reduced", "--device", "cpu",
                              "--global-batch", "4", "--seq", "32",
                              "--steps", "4", "--ckpt-dir", str(resumed_dir),
                              "--resume"])
    # steps 3-4 after a restore equal the same steps of one run
    np.testing.assert_allclose(rest, full[2:], rtol=1e-6)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "phi-3-vision-4.2b"])
def test_train_cli_runs_the_encoder_and_vlm_archs(arch):
    losses = launch_train.main(["--arch", arch, "--reduced", "--device",
                                "cpu", "--steps", "2", "--seq", "16",
                                "--global-batch", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_train_cli_wants_cuda_and_one_device(monkeypatch):
    """Without --device the CLI wants CUDA, on one device and on a mesh
    (whose ranks it places before it starts any)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--steps", "1", "--mesh", "2x1"])


def test_init_train_state_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """The trainer's state init resolves no device to CUDA, as every
    entry point of the port, and raises without a card; an explicit
    device="cpu" still builds the state there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(CFG, _opt())
    state = init_train_state(CFG, _opt(), device="cpu")
    assert all(p.device.type == "cpu" for p in tree_leaves(state.params))
