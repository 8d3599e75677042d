"""The port's MoE and SSM training against the JAX reference on the CPU.

The same numpy-made batches go through the reference (`jax.value_and_grad`
over `repro.models.moe.loss_fn` / `repro.models.mamba2.loss_fn`,
`repro.train.train_step`) and the port, with the reference's own init
carried across.  f32 at TINY["moe"] and TINY["ssm"]: the loss to 1e-5
and every gradient leaf to atol 1e-5 / rtol 1e-4, under each dispatch
and SSD impl and each remat policy.  The reference cannot differentiate
through its Pallas kernels (its grouped matmul and SSD scan have no VJP
under jax 0.9.0), so the port's kernel routes ("grouped", "pallas") are
held to the reference's differentiable twins ("scatter", "xla").  Three
optimizer steps give equal params, checkpoints cross both ways, and bf16
stays within the stated bounds.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY
from repro.models import moe as JM
from repro.models import registry as jax_registry
from repro.train import checkpoint as JC
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro.utils.tree import tree_flatten_with_names as jax_flat
from repro_torch.models import moe as PM
from repro_torch.models import registry
from repro_torch.train import optimizer as PO
from repro_torch.train import train_step as PTS
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.utils.tree import (tree_flatten_with_names, tree_leaves,
                                    tree_map)
from test_torch_train_parity import (_assert_params_equal, _batch,
                                     _opt_cfg, _port_batch, _port_steps,
                                     _ref_loss_and_grads, _ref_params,
                                     _ref_steps)
from torch_port_helpers import port_cfg, port_params
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

MOE, SSM = TINY["moe"], TINY["ssm"]
REMATS = ["none", "full", "dots"]
# bf16 at TINY: the loss within 1 %, each gradient leaf within the
# relative L2 error below.  Measured on the CPU: MoE's loss 4.8e-6
# relative, its worst leaf (layers/ln2) 0.81 %, the dense family's bound;
# SSM's loss 1.9e-5, its worst leaf layers/mixer/D at 4.0 % (D's gradient
# sums dy x over every position of its head, which the two frameworks
# round at other places), the next conv_b at 1.6 %
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_REL_L2 = {"moe": 3e-2, "ssm": 8e-2}


def _port_loss_and_grads(ref_cfg, params, batch, pcfg=None):
    """The port's loss and gradients (named as the reference names them)
    at the reference's params; `pcfg` overrides the port's config (the
    kernel routes the reference cannot differentiate)."""
    pcfg = pcfg or port_cfg(ref_cfg)
    pp = port_params(params, ref_cfg)
    leaves = [p.requires_grad_() for p in tree_leaves(pp)]
    loss = registry.get_family(pcfg).loss_fn(pp, pcfg, _port_batch(batch))
    grads = torch.autograd.grad(loss, leaves)
    by_id = {id(p): g for p, g in zip(leaves, grads)}
    gtree = tree_map(lambda p: by_id[id(p)], pp)
    return float(loss.detach()), {"params/" + n: a.float().numpy()
                                  for n, a in tree_flatten_with_names(gtree)}


def _assert_match(ref_cfg, batch, pcfg=None, params=None):
    params = _ref_params(ref_cfg) if params is None else params
    l_ref, g_ref = _ref_loss_and_grads(ref_cfg, params, batch)
    l_port, g_port = _port_loss_and_grads(ref_cfg, params, batch, pcfg)
    assert l_port == pytest.approx(l_ref, abs=1e-5)
    assert sorted(g_port) == sorted(g_ref)
    for name, want in g_ref.items():
        np.testing.assert_allclose(g_port[name], want, atol=1e-5, rtol=1e-4,
                                   err_msg=name)


# ---------------------------------------------------------------- MoE

@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("dispatch", ["dense", "scatter", "ep"])
def test_moe_loss_and_gradients_match_the_reference(dispatch, remat):
    cfg = MOE.replace(moe_dispatch=dispatch, remat=remat)
    _assert_match(cfg, _batch(cfg))


@pytest.mark.parametrize("remat", REMATS)
def test_moe_grouped_gradients_match_the_reference_scatter(remat):
    """The grouped route (`GroupedMatmulFn`, plain on the CPU) against the
    reference's scatter dispatch, which it computes by other means."""
    cfg = MOE.replace(moe_dispatch="scatter", remat=remat)
    _assert_match(cfg, _batch(cfg),
                  pcfg=port_cfg(cfg.replace(moe_dispatch="grouped")))


@pytest.mark.parametrize("dispatch", ["scatter", "grouped", "dense"])
def test_moe_dropped_assignments_match_the_reference(dispatch, monkeypatch):
    """capacity_factor 0.5: experts overflow and assignments drop."""
    cfg = MOE.replace(capacity_factor=0.5,
                      moe_dispatch="dense" if dispatch == "dense"
                      else "scatter")
    seen = []
    orig = PM._sorted_positions

    def spy(e, E):
        out = orig(e, E)
        seen.append(int(out[2].max()))
        return out
    monkeypatch.setattr(PM, "_sorted_positions", spy)
    batch = _batch(cfg)
    _assert_match(cfg, batch,
                  pcfg=port_cfg(cfg.replace(moe_dispatch=dispatch)))
    C = PM._capacity(cfg, batch["tokens"].size)
    if dispatch != "dense":          # the one-hot oracle does not sort
        assert seen and max(seen) > C, (seen, C)


def test_moe_router_aux_matches_the_reference():
    """`_route`'s load-balance + z loss, its value and its gradients with
    respect to the router weights and the tokens."""
    cfg = MOE
    rng = np.random.default_rng(3)
    xf = rng.standard_normal((40, cfg.d_model)).astype(np.float32)
    rw = (rng.standard_normal((cfg.d_model, cfg.num_experts)) * 0.3).astype(
        np.float32)
    (aux, (gw, gx)) = jax.value_and_grad(
        lambda w, x: JM._route(w, cfg, x)[2], argnums=(0, 1))(
            jnp.asarray(rw), jnp.asarray(xf))
    tw, tx = (torch.from_numpy(a).requires_grad_() for a in (rw, xf))
    w, e, taux = PM._route(tw, port_cfg(cfg), tx, with_aux=True)
    assert taux.dtype == torch.float32 and taux.dim() == 0
    assert float(taux.detach()) == pytest.approx(float(aux), rel=1e-6)
    got = torch.autograd.grad(taux, (tw, tx))
    for g, want in zip(got, (gw, gx)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=1e-7,
                                   rtol=1e-4)
    assert len(PM._route(tw, port_cfg(cfg), tx)) == 2     # serving: no aux


def test_moe_apply_returns_the_router_loss_only_in_training():
    cfg = port_cfg(MOE)
    pp = port_params(_ref_params(MOE), MOE)["layers"][0]["moe"]
    x = torch.randn(2, 5, cfg.d_model)
    y, aux = PM.moe_apply(pp, cfg, x)
    assert y.shape == x.shape and aux.dim() == 0
    assert PM.moe_apply(pp, cfg, x, dropless=True).shape == x.shape


# ---------------------------------------------------------------- SSM

@pytest.mark.parametrize("seq", [32, 24])
@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ssm_loss_and_gradients_match_the_reference(impl, remat, seq):
    """seq 32 is two chunks of 16; 24 pads the second.  "pallas"
    (`SsdIntraChunkFn`, plain on the CPU) is held to the reference's
    "xla"."""
    cfg = SSM.replace(remat=remat)
    _assert_match(cfg, _batch(cfg, seq=seq),
                  pcfg=port_cfg(cfg.replace(ssd_impl=impl)))


@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_forward_logits_match_the_reference(family):
    cfg = TINY[family]
    params = _ref_params(cfg)
    batch = _batch(cfg)
    want = jax_registry.get_family(cfg).forward(
        params, cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    pcfg = port_cfg(cfg)
    with torch.no_grad():
        got = registry.get_family(pcfg).forward(
            port_params(params, cfg), pcfg, _port_batch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------- optimizers

@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_three_optimizer_steps_give_the_reference_params(family, name):
    """Weight decay by the stacked leaf's rank and Adafactor's factoring
    of the stacked (L, E, d, f) expert leaves, as the reference sees
    them."""
    cfg = TINY[family]
    batches = [_batch(cfg, seed=s) for s in range(3)]
    ref_opt = JO.make_optimizer(_opt_cfg(name, JO.OptimizerConfig))
    ref_state, ref_losses = _ref_steps(cfg, ref_opt, batches)
    params = JTS.init_train_state(jax.random.key(0), cfg, ref_opt).params
    port_opt = PO.make_optimizer(_opt_cfg(name, PO.OptimizerConfig))
    port_state, port_losses = _port_steps(cfg, port_opt, batches, params)
    np.testing.assert_allclose(port_losses, ref_losses, atol=1e-5)
    _assert_params_equal(port_state, ref_state)


# ------------------------------------------------------- checkpoints

@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_a_reference_checkpoint_resumes_in_the_port(family, tmp_path):
    cfg = TINY[family]
    batches = [_batch(cfg, seed=s) for s in range(3)]
    ref_opt = JO.make_optimizer(_opt_cfg("adamw", JO.OptimizerConfig))
    ref_state, _ = _ref_steps(cfg, ref_opt, batches[:2])
    JC.CheckpointManager(str(tmp_path), async_save=False).save(
        ref_state, int(ref_state.step))
    restored, _ = JC.CheckpointManager(str(tmp_path)).restore(
        JTS.state_shapes(cfg, ref_opt))
    ref_next, m = jax.jit(JTS.make_train_step(cfg, ref_opt))(
        restored, {k: jnp.asarray(v) for k, v in batches[2].items()})
    pcfg = port_cfg(cfg)
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


@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_a_port_checkpoint_restores_in_the_reference(family, tmp_path):
    cfg = TINY[family]
    port_opt = PO.make_optimizer(_opt_cfg("adamw", PO.OptimizerConfig))
    ref_opt = JO.make_optimizer(_opt_cfg("adamw", JO.OptimizerConfig))
    state, _ = _port_steps(cfg, port_opt, [_batch(cfg)], _ref_params(cfg))
    CheckpointManager(str(tmp_path), async_save=False).save(state)
    restored, manifest = JC.CheckpointManager(str(tmp_path)).restore(
        JTS.state_shapes(cfg, ref_opt))
    assert int(restored.step) == 1 == manifest["step"]
    _assert_params_equal(state, restored, atol=0)
    got = dict(tree_flatten_with_names(state.opt_state))
    want = {n: np.asarray(a) for n, a in jax_flat(restored.opt_state)}
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        np.testing.assert_array_equal(got[n].numpy(), w, err_msg=n)


# --------------------------------------------------------------- bf16

@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_bf16_loss_and_gradients_track_the_reference(family):
    """bf16 compute and params: the two frameworks round at other places,
    so the loss is held within 1 % and each gradient leaf within the
    relative L2 error `BF16_GRAD_REL_L2` (measured at TINY on the CPU:
    see its comment)."""
    cfg = TINY[family].replace(dtype="bfloat16", param_dtype="bfloat16")
    params = _ref_params(cfg)
    batch = _batch(cfg)
    l_ref, g_ref = _ref_loss_and_grads(cfg, params, batch)
    l_port, g_port = _port_loss_and_grads(cfg, params, batch)
    assert l_port == pytest.approx(l_ref, rel=BF16_LOSS_RTOL)
    for name, want in g_ref.items():
        rel = np.linalg.norm(g_port[name] - want) / max(
            np.linalg.norm(want), 1e-30)
        assert rel < BF16_GRAD_REL_L2[family], (name, rel)
