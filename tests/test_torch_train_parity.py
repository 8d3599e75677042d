"""The port's dense training against the JAX reference on the CPU.

The same numpy-made batches go through the reference (`jax.value_and_grad`
over `repro.models.transformer.loss_fn`, `repro.train.train_step`) and
the port, with the reference's own init carried across
(`convert.params_from_jax`).  f32 at TINY["dense"]: the loss to 1e-5 and
every gradient leaf to atol 1e-5 / rtol 1e-4, under each remat policy and
attention path; three optimizer steps of each optimizer give equal
params; a checkpoint the reference wrote resumes in the port.  bf16: the
loss and gradients within the stated bounds.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY
from repro.data.pipeline import synthetic_batch
from repro.models import layers as JL
from repro.models import registry as jax_registry
from repro.train import checkpoint as JC
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro_torch.kernels.flash_attention import ops as fk
from repro_torch.models import registry
from repro_torch.train import optimizer as PO
from repro_torch.train import train_step as PTS
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.utils.tree import (tree_flatten_with_names, tree_leaves,
                                    tree_map)
from torch_port_helpers import port_cfg, port_params
from torch_port_helpers import one_torch_thread  # noqa: F401

CFG = TINY["dense"]
# bf16 at TINY: the loss within 1 %, each gradient leaf within 3 % in
# relative L2 (measured: see test_bf16_loss_and_gradients_track_the_reference)
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_REL_L2 = 3e-2


def _batch(cfg, batch=4, seq=32, seed=0):
    return synthetic_batch(cfg, batch, seq, seed)


def _port_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _ref_params(cfg, seed=0):
    return jax_registry.get_family(cfg).init(jax.random.key(seed), cfg)


def _ref_loss_and_grads(cfg, params, batch):
    fam = jax_registry.get_family(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: fam.loss_fn(p, cfg, jb)))(params)
    return float(loss), {"params/" + n: np.asarray(a, np.float32)
                         for n, a in _jax_names(grads)}


def _jax_names(tree):
    from repro.utils.tree import tree_flatten_with_names as jflat
    return jflat(tree)


def _port_loss_and_grads(cfg, params, batch):
    state_params = port_params(params, cfg)
    pcfg = port_cfg(cfg)
    leaves = [p.requires_grad_() for p in tree_leaves(state_params)]
    loss = registry.get_family(pcfg).loss_fn(state_params, pcfg,
                                             _port_batch(batch))
    grads = torch.autograd.grad(loss, leaves)
    by_id = {id(p): g for p, g in zip(leaves, grads)}
    gtree = tree_map(lambda p: by_id[id(p)], state_params)
    return float(loss.detach()), {"params/" + n: a.float().numpy()
                                  for n, a in tree_flatten_with_names(gtree)}


@pytest.mark.parametrize("impl", ["flash_xla", "dense"])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_gradients_match_the_reference(remat, impl):
    cfg = CFG.replace(remat=remat, attention_impl=impl)
    params = _ref_params(cfg)
    batch = _batch(cfg)
    l_ref, g_ref = _ref_loss_and_grads(cfg, params, batch)
    l_port, g_port = _port_loss_and_grads(cfg, params, batch)
    assert l_port == pytest.approx(l_ref, abs=1e-5)
    assert sorted(g_port) == sorted(g_ref)
    for name, want in g_ref.items():
        np.testing.assert_allclose(g_port[name], want, atol=1e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_chunked_loss_matches_the_reference(remat):
    """logits_chunk 8 over 32 positions: four checkpointed chunks."""
    cfg = CFG.replace(remat=remat, logits_chunk=8, tie_embeddings=True)
    params = _ref_params(cfg)
    batch = _batch(cfg)
    batch["labels"] = batch["labels"].copy()         # a view of tokens
    batch["labels"][0, :5] = -1                      # ignored positions
    l_ref, g_ref = _ref_loss_and_grads(cfg, params, batch)
    l_port, g_port = _port_loss_and_grads(cfg, params, batch)
    assert l_port == pytest.approx(l_ref, abs=1e-5)
    for name, want in g_ref.items():
        np.testing.assert_allclose(g_port[name], want, atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_remat_changes_no_value():
    """The port's three policies give the same loss and gradients."""
    params = _ref_params(CFG)
    batch = _batch(CFG)
    runs = [_port_loss_and_grads(CFG.replace(remat=r), params, batch)
            for r in ("none", "full", "dots")]
    for loss, grads in runs[1:]:
        assert loss == runs[0][0]
        for name, g in grads.items():
            np.testing.assert_array_equal(g, runs[0][1][name])


def test_forward_logits_match_the_reference():
    params = _ref_params(CFG)
    batch = _batch(CFG)
    want = jax_registry.get_family(CFG).forward(
        params, CFG, {k: jnp.asarray(v) for k, v in batch.items()})
    pcfg = port_cfg(CFG)
    with torch.no_grad():
        got = registry.get_family(pcfg).forward(
            port_params(params, CFG), pcfg, _port_batch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_attention_backward_matches_the_reference_vjp():
    """The flash backward's plain version against `jax.vjp` of the
    reference's attention, GQA, causal with a q_offset."""
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((2, 6, 4, 16), (2, 11, 2, 16), (2, 11, 2, 16),
                    (2, 6, 4, 16)))
    _, vjp = jax.vjp(lambda a, b, c: JL.dense_attention(
        a, b, c, causal=True, q_offset=5), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fk.flash_attention_lse_plain(tq, tk, tv, causal=True, q_offset=5)
    got = fk.flash_attention_backward_plain(tq, tk, tv, o, tdo, lse,
                                            causal=True, q_offset=5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)


# ------------------------------------------------------------ optimizers

OPT_KW = {"adamw": dict(peak_lr=1e-2), "sgdm": dict(peak_lr=1e-2),
          "adafactor": dict(peak_lr=1e-2, min_dim_size_to_factor=32)}


def _opt_cfg(name, cls):
    return cls(name=name, total_steps=20, warmup_steps=2, **OPT_KW[name])


def _ref_steps(cfg, opt, batches, grad_accum=1, params=None):
    state = JTS.init_train_state(jax.random.key(0), cfg, opt)
    if params is not None:
        state = state.replace(params=params)
    step = jax.jit(JTS.make_train_step(cfg, opt, grad_accum=grad_accum))
    losses = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return state, losses


def _port_steps(cfg, opt, batches, params, grad_accum=1):
    pcfg = port_cfg(cfg)
    state = PTS.init_train_state(pcfg, opt, params=port_params(params, cfg))
    step = PTS.make_train_step(pcfg, opt, grad_accum=grad_accum)
    losses = []
    for b in batches:
        state, m = step(state, _port_batch(b))
        losses.append(float(m["loss"]))
    return state, losses


def _assert_params_equal(port_state, ref_state, atol=1e-5):
    got = dict(tree_flatten_with_names(port_state.params))
    want = dict(_jax_names(ref_state.params))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().float().numpy(),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_three_optimizer_steps_give_the_reference_params(name):
    batches = [_batch(CFG, seed=s) for s in range(3)]
    ref_opt = JO.make_optimizer(_opt_cfg(name, JO.OptimizerConfig))
    ref_state, ref_losses = _ref_steps(CFG, ref_opt, batches)
    params = JTS.init_train_state(jax.random.key(0), CFG, ref_opt).params
    port_opt = PO.make_optimizer(_opt_cfg(name, PO.OptimizerConfig))
    port_state, port_losses = _port_steps(CFG, port_opt, batches, params)
    np.testing.assert_allclose(port_losses, ref_losses, atol=1e-5)
    assert port_state.step == int(ref_state.step) == 3
    _assert_params_equal(port_state, ref_state)
    # the moments too, under the reference's names
    got = dict(tree_flatten_with_names(port_state.opt_state))
    want = dict(_jax_names(ref_state.opt_state))
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-4, err_msg=n)


def test_lr_schedule_equals_the_reference():
    cfg_kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    ref = JO.OptimizerConfig(**cfg_kw)
    port = PO.OptimizerConfig(**cfg_kw)
    got = np.array([PO.lr_schedule(port, s).item() for s in range(0, 130, 3)],
                   np.float32)
    want = np.array([JO.lr_schedule(ref, jnp.int32(s))
                     for s in range(0, 130, 3)], np.float32)
    np.testing.assert_allclose(got, want, rtol=2 ** -23, atol=0)


def test_grad_accum_two_equals_one_and_the_reference():
    batch = _batch(CFG, batch=8, seed=4)
    opt_cfg = dict(name="sgdm", peak_lr=1e-3, total_steps=100)
    ref_opt = JO.make_optimizer(JO.OptimizerConfig(**opt_cfg))
    port_opt = PO.make_optimizer(PO.OptimizerConfig(**opt_cfg))
    params = JTS.init_train_state(jax.random.key(0), CFG, ref_opt).params
    s1, l1 = _port_steps(CFG, port_opt, [batch], params, grad_accum=1)
    s2, l2 = _port_steps(CFG, port_opt, [batch], params, grad_accum=2)
    assert l2[0] == pytest.approx(l1[0], rel=1e-5)
    r2, lr2 = _ref_steps(CFG, ref_opt, [batch], grad_accum=2, params=params)
    assert l2[0] == pytest.approx(lr2[0], abs=1e-5)
    _assert_params_equal(s2, r2)
    g1 = dict(tree_flatten_with_names(s1.params))
    for n, a in tree_flatten_with_names(s2.params):
        np.testing.assert_allclose(a.detach().numpy(),
                                   g1[n].detach().numpy(), atol=1e-5,
                                   rtol=1e-4)


def test_a_reference_checkpoint_resumes_in_the_port(tmp_path):
    batches = [_batch(CFG, seed=s) for s in range(3)]
    ref_opt = JO.make_optimizer(_opt_cfg("adamw", JO.OptimizerConfig))
    ref_state, _ = _ref_steps(CFG, ref_opt, batches[:2])
    mgr = JC.CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(ref_state, int(ref_state.step))
    # the reference's third step from its own restored state
    like = JTS.state_shapes(CFG, ref_opt)
    restored, _ = mgr.restore(like)
    jstep = jax.jit(JTS.make_train_step(CFG, ref_opt))
    ref_next, m = jstep(restored, {k: jnp.asarray(v)
                                   for k, v in batches[2].items()})
    # the port restores the same files into its own TrainState
    pcfg = port_cfg(CFG)
    port_opt = PO.make_optimizer(_opt_cfg("adamw", PO.OptimizerConfig))
    fresh = PTS.init_train_state(pcfg, port_opt, seed=1, device="cpu")
    state, manifest = PTS.restore_train_state(
        CheckpointManager(str(tmp_path)), PTS.state_like(fresh),
        device="cpu")
    assert manifest["step"] == state.step == 2
    _assert_params_equal(state, restored, atol=0)
    state, pm = PTS.make_train_step(pcfg, port_opt)(state,
                                                    _port_batch(batches[2]))
    assert float(pm["loss"]) == pytest.approx(float(m["loss"]), abs=1e-5)
    _assert_params_equal(state, ref_next)


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    """The layout is shared both ways: the reference restores what the
    port wrote (the port's lists stacked under the reference's names)."""
    pcfg = port_cfg(CFG)
    port_opt = PO.make_optimizer(_opt_cfg("adafactor", PO.OptimizerConfig))
    ref_opt = JO.make_optimizer(_opt_cfg("adafactor", JO.OptimizerConfig))
    params = _ref_params(CFG)
    state, _ = _port_steps(CFG, port_opt, [_batch(CFG)], params)
    CheckpointManager(str(tmp_path), async_save=False).save(state)
    restored, manifest = JC.CheckpointManager(str(tmp_path)).restore(
        JTS.state_shapes(CFG, ref_opt))
    assert int(restored.step) == 1 == manifest["step"]
    _assert_params_equal(state, restored, atol=0)


# ------------------------------------------------------------------ bf16

def test_bf16_loss_and_gradients_track_the_reference():
    """bf16 compute and params: the two frameworks round at other places
    (XLA fuses and keeps some bf16 intermediates in f32; the port's CPU
    GEMMs round once per product), so the loss is held within 1 % and each
    gradient leaf within 3 % relative L2 error (measured at TINY on the
    CPU: the loss 2.1e-5 relative, the worst leaf, layers/ln2, 0.78 %)."""
    cfg = CFG.replace(dtype="bfloat16", param_dtype="bfloat16")
    params = _ref_params(cfg)
    batch = _batch(cfg)
    l_ref, g_ref = _ref_loss_and_grads(cfg, params, batch)
    l_port, g_port = _port_loss_and_grads(cfg, params, batch)
    assert l_port == pytest.approx(l_ref, rel=BF16_LOSS_RTOL)
    for name, want in g_ref.items():
        rel = np.linalg.norm(g_port[name] - want) / max(
            np.linalg.norm(want), 1e-30)
        assert rel < BF16_GRAD_REL_L2, (name, rel)
